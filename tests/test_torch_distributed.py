"""The analytics engine's sharded mode (one process per partition, the halo
over ``torch.distributed.all_to_all_single``) on the CPU with gloo ranks,
against the port's simulated mode and the reference.

One start of four ranks (``run_sharded``) runs pagerank, cc and sssp on
``tests/test_shard_map_engine.py``'s graph (``rmat_graph(1200, 8, seed=5)``,
``cuttana`` at k=4; the reference's check of its own ``shard_map`` mode);
the values equal the port's ``run_simulated`` with ``==`` (both modes run
the same step, and a device's rows never depend on another's), the
reference's ``run_simulated`` (cc and sssp ``==``, pagerank rtol 1e-5: the
port sums in float64, the reference in float32) and its dense oracles
(``test_shard_map_engine.py``'s tolerances). The exchange counters stand in
for the reference's ``lower_sharded``. The card's run (gloo ranks sharing
the one H100, NCCL waits for a box with a card a rank) is in
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 23.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.analytics import GraphEngine as RefEngine
from repro.analytics import localize as ref_localize
from repro.analytics import programs as ref_programs
from repro.core import get_partitioner
from repro.graph import rmat_graph
from repro_torch.analytics import PROGRAMS, GraphEngine
from repro_torch.analytics.programs import VertexProgram
from repro_torch.analytics.engine import (RankLayout, check_backend, rank_devices, run_rank,
                                          run_sharded)
from repro_torch.convert import localized_from_arrays

K = 4
RUNS = {"pagerank": 10, "cc": 25, "sssp": 20}
SOURCE = 7


def _program(name, table=PROGRAMS):
    return table[name](source=SOURCE) if name == "sssp" else table[name]()


@functools.cache
def _layouts():
    g = rmat_graph(1200, avg_degree=8, seed=5)
    part = get_partitioner("cuttana")(g, K, balance_mode="edge", seed=0)
    ref = ref_localize(g, part, K)
    return g, ref, localized_from_arrays(**dataclasses.asdict(ref))


@pytest.fixture(scope="module")
def sharded():
    """One start of K gloo ranks running the three programs."""
    _, _, lg = _layouts()
    values, report = run_sharded(lg, [(_program(p), None, it) for p, it in RUNS.items()],
                                 device="cpu")
    return dict(zip(RUNS, values)), report


def _assert_values(prog, got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    if prog == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prog", list(RUNS))
def test_sharded_equals_simulated(sharded, prog):
    _, _, lg = _layouts()
    want = GraphEngine(lg, _program(prog), device="cpu").run_simulated(RUNS[prog])
    assert sharded[0][prog].dtype == np.float32
    np.testing.assert_array_equal(sharded[0][prog], want)


@pytest.mark.parametrize("prog", list(RUNS))
def test_sharded_matches_reference_engine(sharded, prog):
    _, ref, _ = _layouts()
    want = RefEngine(ref, _program(prog, ref_programs.PROGRAMS)).run_simulated(RUNS[prog])
    _assert_values(prog, sharded[0][prog], np.asarray(want))


def test_sharded_matches_dense_oracles(sharded):
    """``tests/test_shard_map_engine.py``'s checks of the reference's mode."""
    g, _, _ = _layouts()
    np.testing.assert_allclose(sharded[0]["pagerank"],
                               ref_programs.reference_pagerank(g, iters=RUNS["pagerank"]),
                               rtol=3e-4, atol=1e-9)
    np.testing.assert_allclose(sharded[0]["cc"], ref_programs.reference_cc(g, iters=RUNS["cc"]))


def test_exchange_counters(sharded):
    _, _, lg = _layouts()
    report = sharded[1]
    assert report["backend"] == "gloo" and report["k"] == K and report["route"] == "gloo_host"
    assert report["devices"] == ["cpu"] * K
    padded = GraphEngine(lg, _program("cc"), device="cpu").stats(1).padded_halo_elements_per_iter
    assert [r["program"] for r in report["runs"]] == list(RUNS)
    for run, iters in zip(report["runs"], RUNS.values()):
        assert run["iters"] == iters
        assert run["all_to_all_calls"] == [iters] * K
        assert run["elements_sent_per_iter"] == padded == K * K * lg.h_max
        assert run["staged_bytes"] == [0] * K  # CPU state: nothing staged
        assert run["spmv_launches"] == [0] * K  # the plain version on the CPU
        assert len(run["iter_ms"]) == K and min(run["iter_ms"]) > 0
    assert report["spawn_seconds"] > 0


def test_engine_run_sharded_keeps_its_exchange_report():
    _, _, lg = _layouts()
    eng = GraphEngine(lg, _program("sssp"), device="cpu")
    assert eng.exchange is None
    got = eng.run_sharded(6)
    np.testing.assert_array_equal(got, eng.run_simulated(6))
    (run,) = eng.exchange["runs"]
    assert run["program"] == "sssp" and run["all_to_all_calls"] == [6] * K
    assert run["elements_sent_per_iter"] == eng.stats(6).padded_halo_elements_per_iter


def test_rank_body_refuses_a_group_of_another_size(tmp_path):
    """The SPMD body, under a process group of one rank, for a k=4 layout
    (the reference's ``build_sharded`` raises on a mesh axis != k)."""
    import torch.distributed as dist

    _, _, lg = _layouts()
    dist.init_process_group("gloo", init_method=(tmp_path / "store").as_uri(), rank=0,
                            world_size=1)
    try:
        layout = RankLayout.from_localized(lg, 0)
        assert layout.cols.shape == (lg.e_max,) and layout.send_gather.shape == (K, lg.h_max)
        with pytest.raises(ValueError, match="1 ranks != k=4"):
            run_rank(layout, _program("cc"), {"num_vertices": lg.num_vertices}, 3,
                     np.zeros(lg.v_max, np.float32), "cpu")
        one = dataclasses.replace(layout, k=1, rank=0)
        other = dataclasses.replace(one, rank=1)
        with pytest.raises(ValueError, match="rank 0, the layout is rank 1"):
            run_rank(other, _program("cc"), {"num_vertices": lg.num_vertices}, 3,
                     np.zeros(lg.v_max, np.float32), "cpu")
    finally:
        dist.destroy_process_group()


def test_nccl_refuses_ranks_that_share_a_card():
    """Decided from the rank mapping alone, before any process starts."""
    shared = rank_devices(8, "cuda", 1)
    assert shared == ["cuda:0"] * 8
    assert rank_devices(4, "cuda", 3) == ["cuda:0", "cuda:1", "cuda:2", "cuda:0"]
    with pytest.raises(ValueError, match='backend="gloo"'):
        check_backend("nccl", shared)
    with pytest.raises(ValueError, match='backend="gloo"'):
        check_backend("nccl", rank_devices(4, "cuda", 3))
    check_backend("gloo", shared)
    check_backend("nccl", rank_devices(4, "cuda", 4))
    with pytest.raises(ValueError, match="CUDA ranks"):
        check_backend("nccl", rank_devices(4, "cpu", 0))
    with pytest.raises(ValueError, match="backend must be one of"):
        check_backend("mpi", shared)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_devices(2, "cuda", 0)


def test_run_sharded_refuses_before_starting_ranks():
    _, _, lg = _layouts()
    eng = GraphEngine(lg, _program("cc"), device="cpu")
    with pytest.raises(ValueError, match="CUDA ranks"):
        eng.run_sharded(2, backend="nccl")
    local = VertexProgram(name="local", identity=0.0, reduce_kind="sum",
                          init=lambda l2g, count, ctx: np.zeros(l2g.shape[0], np.float32),
                          message=lambda s, d: s, apply=lambda old, agg, ctx: agg)
    with pytest.raises(ValueError, match="must pickle"):
        GraphEngine(lg, local, device="cpu").run_sharded(2)
    assert torch.multiprocessing.active_children() == []
