"""The rest of the partitioner zoo in the PyTorch port against ``repro`` on
the CPU: the registry and spec layer, every algorithm's assignment (or
vertex-cut edge partition), the stale/sampled chunk scoring of
``cuttana-batched``, the ``gain`` and ``completeness`` buffer strategies, the
device mirror under HeiStream's FM passes, and the committed quality rows of
``BENCH_partition.json`` reproduced by the port alone."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.api.registry as rreg
import repro_torch.api as tapi
import repro_torch.api.registry as treg
from repro.core.buffer import PriorityBuffer as RefBuffer
from repro.core.engine import EngineConfig as RefConfig
from repro.core.engine import FennelScorer as RefScorer
from repro.core.engine import ImmediatePolicy as RefImmediate
from repro.core.engine import StreamEngine as RefEngine
from repro.core.base import PartitionState as RefState
from repro.core.parallel import partition_parallel as ref_parallel
from repro.core.priority import make_priority as ref_priority
from repro.graph.generators import rmat_graph
from repro_torch.convert import graph_from_arrays
from repro_torch.core import engine as tengine
from repro_torch.core import heistream_like
from repro_torch.core.base import PartitionState
from repro_torch.core.buffer import PriorityBuffer
from repro_torch.core.parallel import partition_parallel
from repro_torch.core.priority import BUFFER_STRATEGIES, make_priority

CPU = torch.device("cpu")
ORDERS = ("natural", "random", "bfs", "dfs")
ZOO = sorted(set(rreg.REGISTRY) - {
    "fennel", "ldg", "cuttana", "fennel-parallel", "cuttana-parallel", "cuttana-restream",
})
ENGINE_ZOO = [n for n in ZOO if rreg.REGISTRY[n].engine == "engine"]
# the committed rows of BENCH_partition.json (web-s, edge, random, k=8, seed 0)
COMMITTED = {
    "cuttana-buffcut": 0.5029367961311267,
    "cluster+cuttana": 0.5425709934905203,
    "heistream": 0.6341471577502971,
}


@pytest.fixture(scope="module")
def graph():
    rg = rmat_graph(2000, avg_degree=8, seed=4)
    return rg, graph_from_arrays(rg.indptr, rg.indices, CPU)


def _fields(name: str, balance_mode: str, order: str, k: int = 8, **extra) -> dict:
    """Spec fields for ``name`` at seed 0; ``balance_mode`` and ``order``
    only where the algorithm takes them."""
    info = rreg.REGISTRY[name]
    out = dict(algo=name, k=k, seed=0, **extra)
    if info.balance_modes:
        out["balance_mode"] = balance_mode
    if "order" in info.common:
        out["order"] = order
    return out


def _assert_same_run(want, got):
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.is_vertex_cut == want.is_vertex_cut
    if want.is_vertex_cut:
        for f in ("edge_part", "replicas", "masters", "edge_counts"):
            np.testing.assert_array_equal(
                getattr(got.edge_partition, f), getattr(want.edge_partition, f))
        np.testing.assert_array_equal(got.vertex_assignment(), want.vertex_assignment())
    assert got.quality() == want.quality()
    assert got.telemetry.get("kernel_calls") == want.telemetry.get("kernel_calls")


def _run_both(rg, tg, **fields):
    want = rapi.partition(rg, rapi.PartitionSpec(**fields))
    got = tapi.partition(tg, tapi.PartitionSpec(**fields), device="cpu")
    return want, got


# ------------------------------------------------------------ registry/spec
def test_registry_names_and_kinds_match_reference():
    assert sorted(treg.REGISTRY) == sorted(rreg.REGISTRY)
    for kind in (None, "edge-cut", "vertex-cut"):
        assert treg.list_algorithms(kind) == rreg.list_algorithms(kind)
    assert not hasattr(treg, "_LATER")


@pytest.mark.parametrize("name", sorted(rreg.REGISTRY))
def test_registry_entry_matches_reference(name):
    want, got = rreg.get_info(name), treg.get_info(name)
    for f in dataclasses.fields(want):
        if f.name in ("entry", "params_cls"):
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.entry == want.entry.replace("repro.", "repro_torch.", 1)
    assert got.param_names() == want.param_names()
    if want.params_cls is None:
        assert got.params_cls is None
    else:
        assert dataclasses.asdict(got.params_cls()) == dataclasses.asdict(want.params_cls())
        assert [f.type for f in dataclasses.fields(got.params_cls)] == [
            f.type for f in dataclasses.fields(want.params_cls)]
    assert callable(got.resolve())


BAD_SPECS = [
    dict(algo="hdrf", k=4, order="random"),
    dict(algo="hash", k=4, epsilon=0.1),
    dict(algo="chunked", k=4, balance_mode="vertex"),
    dict(algo="random", k=4, params={"lam": 2.0}),
    dict(algo="hdrf", k=4, params={"lam": "big"}),
    dict(algo="cuttana-buffcut", k=4, params={"strategy": "eq6"}),
    dict(algo="cuttana-legacy", k=4, params={"strategy": "gain"}),
    dict(algo="cuttana", k=4, params={"strategy": "best"}),
    dict(algo="cuttana-incremental", k=4, params={"num_batches": 0}),
    dict(algo="cuttana-incremental", k=4, params={"drift_threshold": -0.1}),
    dict(algo="cuttana-incremental", k=4, params={"window_frac": 0.0}),
    dict(algo="cluster+fennel", k=4, params={"hub_degree": 1}),
    dict(algo="cluster+cuttana", k=4, params={"cluster_cap_frac": 1.5}),
    dict(algo="cuttana-batched", k=4, params={"chunk": 0}),
    dict(algo="heistream", k=4, params={"batch_size": 1.5}),
    dict(algo="ginger", k=4, params={}, replication_budget=-1),
    dict(algo="heistream-legacy", k=4, params={"fm": 2}),
    dict(algo="ldg-legacy", k=4, params={"chunk": 8}),
    dict(algo="cuttana-batch", k=4),
]


@pytest.mark.parametrize("fields", BAD_SPECS, ids=lambda f: f["algo"])
def test_bad_spec_raises_the_reference_error(fields):
    with pytest.raises(ValueError) as want:
        rapi.PartitionSpec(**fields)
    with pytest.raises(ValueError) as got:
        tapi.PartitionSpec(**fields)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ZOO)
def test_spec_json_round_trips_with_reference(name):
    fields = _fields(name, "vertex", "bfs", k=4, source="rmat:500:6")
    spec = tapi.PartitionSpec(**fields)
    ref = rapi.PartitionSpec(**fields)
    assert spec.to_json() == ref.to_json()
    assert tapi.PartitionSpec.from_json(ref.to_json()) == spec


# ------------------------------------------------------- assignment parity
@pytest.mark.parametrize("balance_mode", ["vertex", "edge"])
@pytest.mark.parametrize("name", ZOO)
def test_assignment_matches_reference(graph, name, balance_mode):
    """Every zoo algorithm at the random order (the default order where it
    takes none) in both balance modes; vertex-cut algorithms take no balance
    mode, so their vertex case runs k=4."""
    rg, tg = graph
    info = rreg.REGISTRY[name]
    k = 8 if info.balance_modes or balance_mode == "edge" else 4
    fields = _fields(name, balance_mode, "random", k=k)
    want, got = _run_both(rg, tg, **fields)
    _assert_same_run(want, got)
    if want.is_vertex_cut:
        assert got.analytics("pagerank", 10, mode="model") == want.analytics(
            "pagerank", 10, mode="model")
        with pytest.raises(ValueError, match="vertex-cut results only support"):
            got.analytics("pagerank", 10, mode="simulated")


@pytest.mark.parametrize("order", [o for o in ORDERS if o != "random"])
@pytest.mark.parametrize("name", ENGINE_ZOO)
def test_engine_zoo_matches_reference_on_every_order(graph, name, order):
    rg, tg = graph
    want, got = _run_both(rg, tg, **_fields(name, "edge", order))
    _assert_same_run(want, got)


@pytest.mark.parametrize("strategy", ["gain", "completeness"])
@pytest.mark.parametrize("algo", ["cuttana", "cuttana-buffcut"])
def test_strategies_in_buffered_algorithms_match_reference(graph, algo, strategy):
    rg, tg = graph
    fields = _fields(algo, "edge", "random", params={"strategy": strategy})
    want, got = _run_both(rg, tg, **fields)
    _assert_same_run(want, got)
    assert got.telemetry["buffer_strategy"] == strategy


@pytest.mark.parametrize("base", ["cuttana-buffcut", "heistream", "cuttana-batched", "random",
                                  "cluster+fennel"])
def test_restream_over_zoo_bases_matches_reference(graph, base):
    """``cuttana-restream`` over the zoo's edge-cut bases (``cuttana-buffcut``
    brings the ``gain`` buffer into its first pass; ``random`` takes no
    telemetry)."""
    rg, tg = graph
    fields = _fields("cuttana-restream", "edge", "random", params={"base": base, "passes": 2})
    want, got = _run_both(rg, tg, **fields)
    _assert_same_run(want, got)


@pytest.mark.parametrize("num_shards", [1, 2, 4])
@pytest.mark.parametrize("strategy", ["gain", "completeness"])
def test_parallel_strategies_match_reference(graph, strategy, num_shards):
    rg, tg = graph
    kw = dict(epsilon=0.05, balance_mode="edge", order="random", seed=3,
              num_shards=num_shards, strategy=strategy, use_refinement=False)
    rt, tt = {}, {}
    want = ref_parallel(rg, 4, telemetry=rt, **kw)
    got = partition_parallel(tg, 4, telemetry=tt, device=CPU, **kw)
    np.testing.assert_array_equal(got, want)
    assert tt["buffer_strategy"] == rt["buffer_strategy"] == strategy
    for key in ("buffer_evictions", "buffer_drained", "buffer_peak", "kernel_calls"):
        assert tt[key] == rt[key], key


# ------------------------------------------------------------------ sampling
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("chunk,sample_cap", [(512, 16), (64, 9)])
def test_sampled_stale_engine_matches_reference(graph, order, chunk, sample_cap):
    """``exact=False`` with a sample cap low enough that most chunks hold
    sampled rows (one dense-entry call each, on top of the gather call)."""
    rg, tg = graph
    assert (rg.degrees > sample_cap).sum() > 50
    parts = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            st = RefState.create(rg, 6, 0.05, "edge", 2)
            eng = RefEngine(rg, st, RefScorer(rg, 6), RefImmediate(), order=order, seed=2,
                            config=RefConfig(chunk=chunk, sample_cap=sample_cap, exact=False))
        else:
            st = PartitionState.create(tg, 6, 0.05, "edge", 2, device=CPU)
            eng = tengine.StreamEngine(
                tg, st, tengine.FennelScorer(tg, 6), tengine.ImmediatePolicy(),
                order=order, seed=2,
                config=tengine.EngineConfig(chunk=chunk, sample_cap=sample_cap, exact=False))
        eng.run()
        parts.append(st.part_of.copy())
        if pkg == "port":
            np.testing.assert_array_equal(st.part_of_dev.numpy(), st.part_of)
    np.testing.assert_array_equal(parts[1], parts[0])


def test_cuttana_batched_sample_cap_matches_reference(graph):
    rg, tg = graph
    for params in ({"sample_cap": 16}, {"sample_cap": 16, "chunk": 100, "use_refinement": False}):
        want, got = _run_both(rg, tg, **_fields("cuttana-batched", "edge", "random",
                                                params=params))
        _assert_same_run(want, got)
        want, got = _run_both(rg, tg, **_fields("cuttana-batched-legacy", "edge", "random",
                                                params=params))
        _assert_same_run(want, got)


# ------------------------------------------------------------ buffer strategy
def _drive_buffers(strategy: str, seed: int) -> int:
    """The op stream of ``tests/test_priority.py::_run_against_reference``
    (random push / notify_many / pop_best on standalone buffers) applied to
    the port's and the reference's buffers alike: every pop and every
    completion list must agree. Returns the number of pops."""
    rng = np.random.default_rng(seed)
    n = 40
    d_max = int(rng.integers(5, 50))
    bufs = [PriorityBuffer(capacity=12, priority=make_priority(strategy, d_max=d_max)),
            RefBuffer(capacity=12, priority=ref_priority(strategy, d_max=d_max))]
    model: dict[int, list] = {}
    pops = 0
    for _ in range(120):
        op = rng.integers(0, 3)
        if op == 0 and len(model) < 12:
            free = [v for v in range(n) if v not in model]
            v = int(rng.choice(free))
            deg = int(rng.integers(1, 8))
            nbrs = rng.integers(0, n, size=deg).astype(np.int64)
            parts = rng.integers(-1, 3, size=deg).astype(np.int64)
            asg = int((parts >= 0).sum())
            for b in bufs:
                b.push(v, nbrs=nbrs, assigned_count=asg, nbr_parts=parts)
            model[v] = [deg, asg]
        elif op == 1 and model:
            m = int(rng.integers(1, 6))
            vs = rng.integers(0, n, size=m).astype(np.int64)
            part = int(rng.integers(0, 3))
            got, want = (b.notify_many(vs, part) for b in bufs)
            assert got == want, (strategy, seed)
            for v in vs.tolist():
                if v in model:
                    model[v][1] += 1
            for v in want:
                for b in bufs:
                    b.remove(v)
                del model[v]
        elif op == 2 and model:
            (got, gn), (want, wn) = (b.pop_best() for b in bufs)
            assert got == want, (strategy, seed)
            np.testing.assert_array_equal(gn, wn)
            del model[want]
            pops += 1
    assert len(bufs[0]) == len(bufs[1]) == len(model)
    return pops


@pytest.mark.parametrize("seed", [0, 1, 17, 123456, 2**31 - 1, 59160])
@pytest.mark.parametrize("strategy", BUFFER_STRATEGIES)
def test_buffer_pop_order_matches_reference(strategy, seed):
    assert _drive_buffers(strategy, seed) > 0


def test_completeness_keeps_the_reference_ulp():
    """The scalar and vectorised completeness formulas differ by one ulp on
    some inputs; the port computes each as the reference does."""
    p, r = make_priority("completeness", 37), ref_priority("completeness", 37)
    deg = np.arange(1, 200, dtype=np.int64)
    asg = deg // 3
    many = p.score_counts_many(deg, deg, asg)
    np.testing.assert_array_equal(many, r.score_counts_many(deg, deg, asg))
    scalar = [p.score_counts(0, int(d), int(a)) for d, a in zip(deg, asg)]
    assert scalar == [r.score_counts(0, int(d), int(a)) for d, a in zip(deg, asg)]
    assert (np.asarray(scalar) != many).any()  # the ulp exists at these inputs


# -------------------------------------------------------------- device mirror
def test_heistream_mirror_follows_fm_moves(graph, monkeypatch):
    """Before every launch the device mirror equals the host ``part_of``,
    FM moves of the previous batch included, and the run equals the
    reference's."""
    rg, tg = graph
    checks = []

    class Checked(tengine.StreamEngine):
        def chunk_histograms(self, start, batch, expanded):
            checks.append(np.array_equal(self.state.part_of_dev.numpy(), self.state.part_of))
            return super().chunk_histograms(start, batch, expanded)

    monkeypatch.setattr(heistream_like, "StreamEngine", Checked)
    tel = {}
    got = heistream_like.partition(tg, 8, balance_mode="edge", batch_size=300, order="random",
                                   seed=1, telemetry=tel, device=CPU)
    assert tel["fm_moves"] > 0
    assert len(checks) == tel["kernel_calls"] == -(-tg.num_vertices // 300)
    assert all(checks)
    from repro.core.heistream_like import partition as ref_heistream

    np.testing.assert_array_equal(
        got, ref_heistream(rg, 8, balance_mode="edge", batch_size=300, order="random", seed=1))


# ------------------------------------------------------------ committed rows
@pytest.mark.parametrize("algo", sorted(COMMITTED))
def test_committed_quality_rows_reproduced(algo):
    spec = tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0,
                              source="dataset:web-s")
    res = tapi.partition(spec, device="cpu")
    assert res.quality()["edge_cut"] == COMMITTED[algo]


def test_missing_card_raises_for_host_algorithms_too():
    """The runner resolves the device first: host algorithms (no kernel)
    refuse a missing card like the engine-backed ones."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    for name in ("hdrf", "random", "fennel-legacy", "cuttana-incremental"):
        spec = tapi.PartitionSpec(algo=name, k=2, source="rmat:64:4")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tapi.partition(spec)
