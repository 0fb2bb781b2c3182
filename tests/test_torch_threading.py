"""Threaded superstep determinism and autotune of the PyTorch port against
the reference (``tests/test_threading.py``).

The worker count never changes the assignment: shard tasks read frozen
snapshots and write disjoint output slices. These tests pin bit-parity for
``max_workers`` in {1, 2, 8} at fixed S across all four stream orders and
both parallel algorithms - equal to the reference's assignment - and use the
port executor's ``JITTER`` hook to show that parity survives adversarial
scheduling."""
import json
import random

import numpy as np
import pytest
import torch

import repro_torch.api as tapi
from repro.core import autotune as ref_autotune
from repro.core import executor as ref_executor
from repro.core.parallel import fennel_parallel as ref_fennel_parallel
from repro.core.parallel import partition_parallel as ref_partition_parallel
from repro.graph import rmat_graph
from repro_torch.convert import graph_from_arrays
from repro_torch.core import autotune, executor
from repro_torch.core.parallel import fennel_parallel, partition_parallel
from repro_torch.core.profile import PHASES

ORDERS = ("natural", "random", "bfs", "dfs")
CPU = torch.device("cpu")
ALGOS = {
    "cuttana-parallel": (ref_partition_parallel, partition_parallel),
    "fennel-parallel": (ref_fennel_parallel, fennel_parallel),
}


@pytest.fixture(scope="module")
def graphs():
    g = rmat_graph(2000, avg_degree=8, seed=7)
    return g, graph_from_arrays(g.indptr, g.indices, CPU)


# ------------------------------------------------------ worker-count parity
@pytest.mark.parametrize("algo", sorted(ALGOS))
@pytest.mark.parametrize("order", ORDERS)
def test_bit_parity_across_worker_counts(graphs, algo, order):
    rg, tg = graphs
    ref_fn, fn = ALGOS[algo]
    want = ref_fn(rg, 4, num_shards=4, max_workers=1, order=order, seed=0)
    for workers in (1, 2, 8):
        tel = {}
        got = fn(tg, 4, num_shards=4, max_workers=workers, order=order, seed=0,
                 telemetry=tel, device=CPU)
        np.testing.assert_array_equal(
            got, want, err_msg=f"{algo} order={order} max_workers={workers}"
        )
        assert tel["max_workers"] == min(workers, 4)


def test_parity_with_seeded_scheduling_jitter(graphs):
    """Random per-task sleeps shuffle shard completion order; the vectorised
    merge and the device-mirror writes (main thread) must still commute."""
    rg, tg = graphs
    want = {
        a: ref_fn(rg, 4, num_shards=4, max_workers=1, seed=0)
        for a, (ref_fn, _) in ALGOS.items()
    }
    executor.JITTER = random.Random(0xC0FFEE)
    try:
        for a, (_, fn) in ALGOS.items():
            got = fn(tg, 4, num_shards=4, max_workers=8, seed=0, device=CPU)
            np.testing.assert_array_equal(got, want[a], err_msg=a)
    finally:
        executor.JITTER = None


# --------------------------------------------------------- profile telemetry
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_profile_telemetry(graphs, algo):
    _, tg = graphs
    tel: dict = {}
    ALGOS[algo][1](
        tg, 4, num_shards=4, max_workers=2, chunk=128, seed=0, telemetry=tel, device=CPU
    )
    prof = tel["profile"]
    assert prof["workers"] == tel["max_workers"] == 2
    # the profiler records supersteps that place vertices; the stream-level
    # count also includes empty rounds of the buffered policy
    assert 1 <= prof["supersteps"] <= tel["supersteps"]
    assert prof["supersteps"] == tel["kernel_calls"]
    for phase in PHASES:
        assert prof[f"{phase}_s"] >= 0.0
    assert prof["parallel_wall_s"] >= 0.0
    assert prof["queue_wait_s"] >= 0.0
    rows = prof["per_superstep"]
    assert 1 <= len(rows) <= 64
    assert all(set(r) >= {"score", "place", "exchange", "merge"} for r in rows)
    if prof["supersteps"] <= 64:
        total = sum(r["score"] for r in rows)
        assert total == pytest.approx(prof["score_s"], abs=1e-4)


def test_profile_serializes_and_reaches_the_result(graphs):
    _, tg = graphs
    tel: dict = {}
    fennel_parallel(tg, 4, num_shards=2, telemetry=tel, device=CPU)
    json.dumps(tel["profile"])  # plain floats/ints only
    res = tapi.partition(tg, "fennel-parallel", k=4, params={"num_shards": 2}, device=CPU)
    assert set(res.profile) == set(tel["profile"])
    json.dumps(res.profile)


# ------------------------------------------------------------------ autotune
KNEE_ROWS = [
    {"num_shards": 1, "stream_seconds": 1.00, "boundary_conflicts": 0},
    {"num_shards": 2, "stream_seconds": 0.60, "boundary_conflicts": 40},
    {"num_shards": 4, "stream_seconds": 0.52, "boundary_conflicts": 90},
    {"num_shards": 8, "stream_seconds": 0.50, "boundary_conflicts": 400},
]


@pytest.mark.parametrize("rows", [KNEE_ROWS, [], [{"num_shards": 2}], KNEE_ROWS[1:]])
def test_choose_num_shards_knee(rows):
    got = autotune.choose_num_shards(rows)
    assert got == ref_autotune.choose_num_shards(rows)
    if rows is KNEE_ROWS:
        # 4 and 8 are within 10% of best (0.50); 2 is not; fewest conflicts wins
        assert got == 4


def test_choose_chunk():
    rows = [
        {"chunk": 256, "stream_seconds": 0.40},
        {"chunk": 512, "stream_seconds": 0.30},
        {"chunk": 1024, "stream_seconds": 0.30},
    ]
    assert autotune.choose_chunk(rows) == ref_autotune.choose_chunk(rows) == 512
    assert autotune.choose_chunk([]) is None


def test_build_and_resolve_artifact(tmp_path, monkeypatch):
    curves = {
        "cuttana-parallel": [
            {"num_shards": 1, "stream_seconds": 2.0, "boundary_conflicts": 0},
            {"num_shards": 4, "stream_seconds": 1.0, "boundary_conflicts": 10},
        ],
        "fennel-parallel": [
            {"num_shards": 1, "stream_seconds": 0.2, "boundary_conflicts": 0},
            {"num_shards": 2, "stream_seconds": 0.1, "boundary_conflicts": 5},
        ],
    }
    chunk_rows = [{"chunk": 256, "stream_seconds": 0.1}]
    art = autotune.build_artifact(curves, chunk_rows=chunk_rows)
    assert art == ref_autotune.build_artifact(curves, chunk_rows=chunk_rows)
    assert art["chosen"]["cuttana-parallel"]["num_shards"] == 4
    assert art["chosen"]["default"]["num_shards"] == 2  # smallest knee
    p = tmp_path / "TUNING_partition.json"
    p.write_text(json.dumps(art))
    monkeypatch.setenv(autotune.ENV_PATH, str(p))
    t = autotune.resolve(0, 0, algo="cuttana-parallel")
    assert (t.num_shards, t.chunk) == (4, 256)
    assert t.source == f"artifact:{p}"
    assert autotune.resolve(0, 512, algo="mystery").num_shards == 2
    assert autotune.resolve(3, 64, algo="cuttana-parallel") == autotune.Tuning(3, 64, "explicit")


def test_repo_artifact_resolves_like_the_reference(tmp_path, monkeypatch):
    """With the committed artifact at the repository root (found from the
    port's own file), "auto" resolves to the reference's shard count."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(autotune.ENV_PATH, raising=False)
    for algo in ("cuttana-parallel", "fennel-parallel", "restream"):
        got = autotune.resolve(0, 512, algo=algo, num_vertices=50_000)
        want = ref_autotune.resolve(0, 512, algo=algo, num_vertices=50_000)
        assert (got.num_shards, got.chunk) == (want.num_shards, want.chunk)
        assert got.source == want.source


def test_resolve_heuristic_fallback(tmp_path):
    missing = tmp_path / "missing.json"
    t = autotune.resolve(0, 0, algo="fennel-parallel", num_vertices=100_000, path=missing)
    assert t.source == "heuristic"
    assert 1 <= t.num_shards <= 8
    assert t.chunk == 512
    want = ref_autotune.resolve(0, 0, algo="fennel-parallel", num_vertices=100_000, path=missing)
    assert (t.num_shards, t.chunk, t.source) == (want.num_shards, want.chunk, want.source)
    tiny = autotune.resolve(0, 512, algo="fennel-parallel", num_vertices=500, path=missing)
    assert tiny.num_shards == 1
    with pytest.raises(ValueError, match="num_shards"):
        autotune.resolve(-1, 512, algo="fennel-parallel")
    with pytest.raises(ValueError, match="chunk"):
        autotune.resolve(2, -5, algo="fennel-parallel")


# ------------------------------------------------------- executor primitives
@pytest.mark.parametrize("requested,s", [(1, 8), (16, 4), (0, 4), (None, 3), (3, 1)])
def test_resolve_workers(requested, s):
    got = executor.resolve_workers(requested, s)
    assert got == ref_executor.resolve_workers(requested, s)
    assert 1 <= got <= s


def test_resolve_workers_rejects_negative():
    with pytest.raises(ValueError, match="max_workers"):
        executor.resolve_workers(-2, 4)


def _raise():
    raise RuntimeError("boom")


def test_shard_pool_inline_and_chained():
    pool = executor.ShardPool(1, 4)
    assert pool.workers == 1 and pool._ex is None
    assert pool.submit(lambda a, b: a + b, 2, 3).result() == 5
    with pytest.raises(RuntimeError, match="boom"):
        pool.submit(_raise).result()
    order: list[int] = []
    f = None
    for i in range(4):
        f = pool.submit_after(f, order.append, i)
    f.result()
    assert order == [0, 1, 2, 3]
    pool.shutdown()


def test_shard_pool_chain_is_fifo_under_threads():
    pool = executor.ShardPool(2, 4)
    assert pool.workers == 2
    executor.JITTER = random.Random(42)
    try:
        order: list[int] = []
        f = None
        for i in range(32):
            f = pool.submit_after(f, order.append, i)
        f.result()
        assert order == list(range(32))
        assert pool.queue_wait_s >= 0.0
    finally:
        executor.JITTER = None
        pool.shutdown()


@pytest.mark.parametrize("bench", ["scaling/cuttana-parallel/s4/w1", "scaling/fennel-parallel/s4/w1"])
def test_committed_scaling_edge_cuts(bench):
    """The committed baseline's S=4 scaling rows (``BENCH_partition.json``;
    the suite's graph is R-MAT 20,000 vertices, average degree 12, seed 0):
    the port's spec run gives the same edge-cut, at every worker count."""
    from pathlib import Path

    from repro_torch.graph.generators import rmat_graph

    rows = json.loads((Path(__file__).resolve().parents[1] / "BENCH_partition.json").read_text())
    stack, row = [rows], None
    while stack and row is None:
        x = stack.pop()
        if isinstance(x, dict):
            row = x if x.get("bench") == bench else None
            stack.extend(x.values())
        elif isinstance(x, list):
            stack.extend(x)
    assert row is not None, bench
    g = rmat_graph(20_000, avg_degree=12, seed=0)
    res = tapi.partition(g, tapi.PartitionSpec.from_dict(row["spec"]), device=CPU)
    assert res.quality()["edge_cut"] == row["edge_cut"]
