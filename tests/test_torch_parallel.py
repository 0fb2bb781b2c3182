"""Parallel CUTTANA in the PyTorch port against the reference
(``tests/test_parallel.py``'s graphs and contracts): sharded stream cursors,
``num_shards=1`` bit-identical to the sequential partitioners, and for every
S the same assignments and superstep counters as ``repro``'s
``fennel_parallel`` / ``partition_parallel`` / ``partition_restream``."""
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro_torch.api as tapi
from repro.core import cuttana as ref_cuttana
from repro.core import parallel as ref_parallel
from repro.core import restream as ref_restream
from repro.graph import rmat_graph
from repro.graph.generators import load_dataset
from repro.graph.stream import ShardedStream as RefShardedStream
from repro_torch.convert import graph_from_arrays
from repro_torch.core import cuttana, fennel, parallel, restream
from repro_torch.graph.stream import ShardedStream, stream_order
from repro_torch.kernels.partition_score import ops

ORDERS = ("natural", "random", "bfs", "dfs")
CPU = torch.device("cpu")
COUNTERS = ("supersteps", "sync_rounds", "boundary_conflicts", "kernel_calls", "num_shards")
ALGOS = {
    "fennel-parallel": (ref_parallel.fennel_parallel, parallel.fennel_parallel),
    "cuttana-parallel": (ref_parallel.partition_parallel, parallel.partition_parallel),
}


def _pair(g):
    return g, graph_from_arrays(g.indptr, g.indices, CPU)


@pytest.fixture(scope="module")
def graph():
    return _pair(rmat_graph(4000, avg_degree=10, seed=3))


@pytest.fixture(scope="module")
def small_graph():
    return _pair(rmat_graph(1200, avg_degree=8, seed=4))


def _run_both(ref_fn, port_fn, rg, tg, k, **kw):
    want_tel, got_tel = {}, {}
    want = ref_fn(rg, k, telemetry=want_tel, **kw)
    got = port_fn(tg, k, telemetry=got_tel, device=CPU, **kw)
    np.testing.assert_array_equal(got, want)
    for key in COUNTERS:
        assert got_tel.get(key) == want_tel.get(key), key
    return got, got_tel


# ------------------------------------------------------------ sharded stream
@pytest.mark.parametrize("s", [1, 2, 3, 7])
def test_sharded_stream_partitions_the_order(graph, s):
    rg, tg = graph
    sharded = ShardedStream.from_order(tg, s, order="random", seed=5)
    want = RefShardedStream.from_order(rg, s, order="random", seed=5)
    assert sharded.num_shards == s
    assert sharded.num_vertices == tg.num_vertices
    base = stream_order(tg, "random", 5)
    for i, shard in enumerate(sharded.shards):
        assert shard.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(shard, base[i::s])
        np.testing.assert_array_equal(shard, want.shards[i])
    one = ShardedStream.from_order(tg, 1, order="bfs", seed=0)
    np.testing.assert_array_equal(one.shards[0], stream_order(tg, "bfs", 0))


def test_sharded_stream_superstep_batches(graph):
    rg, tg = graph
    sharded = ShardedStream.from_order(tg, 4, order="natural")
    want = RefShardedStream.from_order(rg, 4, order="natural")
    chunk = 128
    steps = list(sharded.superstep_batches(chunk))
    assert len(steps) == sharded.num_supersteps(chunk) == want.num_supersteps(chunk)
    for got_b, want_b in zip(steps, want.superstep_batches(chunk)):
        assert len(got_b) == 4
        for a, b in zip(got_b, want_b):
            assert a.shape[0] <= chunk
            np.testing.assert_array_equal(a, b)
    seen = np.concatenate([b for batches in steps for b in batches])
    np.testing.assert_array_equal(np.sort(seen), np.arange(tg.num_vertices))


def test_sharded_stream_shard_of(graph):
    _, tg = graph
    sharded = ShardedStream.from_order(tg, 3, order="random", seed=1)
    shard_of = sharded.shard_of(tg.num_vertices)
    for s, shard in enumerate(sharded.shards):
        assert (shard_of[shard] == s).all()
    assert (shard_of >= 0).all()
    # an ids subset leaves the other vertices in no shard
    part = ShardedStream.from_ids(np.arange(0, 10, 2, dtype=np.int64), 2)
    np.testing.assert_array_equal(part.shard_of(10)[1::2], -1)


@pytest.mark.parametrize(
    "num_shards,expected_dtype",
    [(1, np.int8), (127, np.int8), (128, np.int16), (200, np.int16),
     (32767, np.int16), (32768, np.int32)],
)
def test_sharded_stream_shard_of_dtype(num_shards, expected_dtype):
    n = max(num_shards * 2, 512)
    ids = np.arange(n, dtype=np.int64)
    shard_of = ShardedStream.from_ids(ids, num_shards).shard_of(n)
    assert shard_of.dtype == np.dtype(expected_dtype)
    np.testing.assert_array_equal(shard_of, RefShardedStream.from_ids(ids, num_shards).shard_of(n))
    assert int(shard_of.max()) == num_shards - 1


@pytest.mark.parametrize("bad", [0, -3])
def test_sharded_stream_rejects_bad_shard_count(bad):
    with pytest.raises(ValueError, match="num_shards"):
        ShardedStream.from_ids(np.arange(10), bad)


# -------------------------------------------------------- num_shards=1 parity
@pytest.mark.parametrize("order", ORDERS)
def test_parallel_cuttana_single_shard_bit_identical(graph, small_graph, order):
    kw = dict(d_max=32, max_qsize=256, theta=0.7, seed=1, order=order)
    for _, tg in (graph, small_graph):
        want = cuttana.partition(tg, 4, device=CPU, **kw)
        tel = {}
        got = parallel.partition_parallel(tg, 4, num_shards=1, telemetry=tel, device=CPU, **kw)
        np.testing.assert_array_equal(got, want)
        assert (tel["supersteps"], tel["num_shards"], tel["kernel_calls"]) == (0, 1, 0)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("balance_mode", ["vertex", "edge"])
def test_parallel_fennel_single_shard_bit_identical(small_graph, order, balance_mode):
    _, tg = small_graph
    kw = dict(balance_mode=balance_mode, order=order, seed=7, device=CPU)
    want_tel, got_tel = {}, {}
    want = fennel.partition(tg, 4, telemetry=want_tel, **kw)
    got = parallel.fennel_parallel(tg, 4, num_shards=1, telemetry=got_tel, **kw)
    np.testing.assert_array_equal(got, want)
    assert got_tel["kernel_calls"] == want_tel["kernel_calls"] == -(-1200 // 512)


# ---------------------------------------------- S >= 2: equal to the reference
@pytest.mark.parametrize("num_shards", [2, 4, 8])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("balance_mode", ["vertex", "edge"])
def test_fennel_parallel_matches_reference(small_graph, num_shards, order, balance_mode):
    rg, tg = small_graph
    _, tel = _run_both(
        ref_parallel.fennel_parallel, parallel.fennel_parallel, rg, tg, 4,
        num_shards=num_shards, order=order, balance_mode=balance_mode, seed=2, chunk=64,
    )
    longest = -(-1200 // num_shards)
    assert tel["supersteps"] == tel["kernel_calls"] == -(-longest // 64)


@pytest.mark.parametrize("num_shards", [2, 4, 8])
@pytest.mark.parametrize("order", ORDERS)
def test_cuttana_parallel_matches_reference(small_graph, num_shards, order):
    rg, tg = small_graph
    _, tel = _run_both(
        ref_parallel.partition_parallel, parallel.partition_parallel, rg, tg, 4,
        num_shards=num_shards, order=order, seed=1, chunk=64, d_max=32, max_qsize=128,
    )
    assert 0 < tel["kernel_calls"] == tel["sync_rounds"] <= tel["supersteps"]


@pytest.mark.parametrize("num_shards", [2, 4, 8])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_parallel_matches_reference_default_knobs(graph, algo, num_shards):
    """The 4000-vertex graph, random order, chunk 128, default buffer knobs;
    the superstep counters must equal the reference's too."""
    rg, tg = graph
    ref_fn, port_fn = ALGOS[algo]
    _, tel = _run_both(ref_fn, port_fn, rg, tg, 4, num_shards=num_shards,
                       order="random", seed=1, chunk=128)
    assert tel["boundary_conflicts"] > 0  # cross-shard edges exist on R-MAT
    assert tel["max_workers"] >= 1


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_prefetch_off_matches_reference(small_graph, algo):
    """prefetch="off" turns the ahead-of-time frontier expansion off (the
    synchronous baseline); the assignment stays the reference's."""
    rg, tg = small_graph
    ref_fn, port_fn = ALGOS[algo]
    _run_both(ref_fn, port_fn, rg, tg, 4, num_shards=3, order="random", seed=4,
              chunk=96, prefetch="off")


def test_parallel_spec_single_shard_matches_sequential_spec(graph):
    _, tg = graph
    seq = tapi.partition(tg, tapi.PartitionSpec(algo="cuttana", k=4, order="random"), device=CPU)
    par = tapi.partition(tg, tapi.PartitionSpec(
        algo="cuttana-parallel", k=4, order="random", params={"num_shards": 1},
    ), device=CPU)
    np.testing.assert_array_equal(par.assignment, seq.assignment)
    assert par.telemetry["supersteps"] == 0
    assert par.telemetry["num_shards"] == 1
    assert par.profile is None and seq.profile is None


def test_sharded_run_keeps_the_device_mirror_in_step(small_graph):
    """The mirror the kernel reads is a separate copy on the CPU too, so a
    stale write at a superstep boundary would show here."""
    from repro_torch.core.base import FennelParams, PartitionState
    from repro_torch.core.engine import FennelScorer, ShardedImmediatePolicy, StreamEngine

    _, tg = small_graph
    state = PartitionState.create(tg, 4, 0.05, "edge", seed=0, device=CPU)
    assert state.part_of_dev.data_ptr() != state.part_of.ctypes.data
    eng = StreamEngine(tg, state, FennelScorer(tg, 4, FennelParams(), "edge"),
                       ShardedImmediatePolicy(3), order="random", seed=0)
    before = (ops.launches, ops.sharded_launches)
    eng.run()
    np.testing.assert_array_equal(state.part_of_dev.numpy(), state.part_of)
    # the CPU takes the plain versions: no launch is counted
    assert (ops.launches, ops.sharded_launches) == before
    assert eng.telemetry["kernel_calls"] > 0


# ------------------------------------------------------------------- restream
@pytest.mark.parametrize("num_shards", [1, 2, 4])
@pytest.mark.parametrize("order", ORDERS)
def test_restream_matches_reference(small_graph, num_shards, order):
    rg, tg = small_graph
    _, tel = _run_both(
        ref_restream.partition_restream, restream.partition_restream, rg, tg, 4,
        num_shards=num_shards, order=order, seed=7,
    )
    assert tel["passes"] == 3 and tel["base"] == "cuttana"


@pytest.mark.parametrize("base,balance_mode", [("fennel", "vertex"), ("cuttana-parallel", "edge")])
def test_restream_other_bases_match_reference(small_graph, base, balance_mode):
    rg, tg = small_graph
    _, tel = _run_both(
        ref_restream.partition_restream, restream.partition_restream, rg, tg, 4,
        base=base, balance_mode=balance_mode, num_shards=2, passes=2, chunk=128, seed=3,
    )
    assert tel["base_telemetry"]["kernel_calls"] > 0


def test_restream_reassign_preserves_load_accounting(small_graph):
    """After a sharded restream pass the shared counts equal the actual
    assignment histogram, and the mirror equals the host assignment."""
    from repro_torch.convert import state_from_arrays
    from repro_torch.core.base import FennelParams
    from repro_torch.core.engine import FennelScorer, ShardedImmediatePolicy, StreamEngine

    _, g = small_graph
    k = 4
    start = np.random.default_rng(0).integers(0, k, size=g.num_vertices)
    deg = g.degrees.astype(np.float64)
    state = state_from_arrays(
        start, np.bincount(start, minlength=k), np.bincount(start, weights=deg, minlength=k),
        k=k, epsilon=0.05, balance_mode="edge", seed=0,
        total_degree=int(g.indices.shape[0]), device=CPU,
    )
    eng = StreamEngine(g, state, FennelScorer(g, k, FennelParams(hybrid=True), "edge"),
                       ShardedImmediatePolicy(3, reassign=True), order="random", seed=1)
    eng.run()
    np.testing.assert_allclose(state.v_counts, np.bincount(state.part_of, minlength=k))
    np.testing.assert_allclose(
        state.e_counts, np.bincount(state.part_of, weights=deg, minlength=k)
    )
    np.testing.assert_array_equal(state.part_of_dev.numpy(), state.part_of)
    assert eng.telemetry["supersteps"] > 0
    assert eng.telemetry["num_shards"] == 3


def test_restream_unported_base_names_its_slice(small_graph):
    """Every edge-cut base runs (the zoo is ported); a vertex-cut or unknown
    base raises the reference's error."""
    rg, tg = small_graph
    for base in ("hdrf", "nope"):
        with pytest.raises(ValueError) as want:
            ref_restream.partition_restream(rg, 4, base=base)
        with pytest.raises(ValueError) as got:
            restream.partition_restream(tg, 4, base=base, device=CPU)
        assert str(got.value) == str(want.value)
    np.testing.assert_array_equal(
        restream.partition_restream(tg, 4, base="heistream", passes=2, device=CPU),
        ref_restream.partition_restream(rg, 4, base="heistream", passes=2))


@pytest.mark.parametrize("balance_mode", ["vertex", "edge"])
def test_refine_any_matches_reference(small_graph, balance_mode):
    rg, tg = small_graph
    part = np.random.default_rng(3).integers(0, 4, size=rg.num_vertices).astype(np.int32)
    want = ref_cuttana.refine_any(rg, part, 4, balance_mode=balance_mode, seed=2)
    got = cuttana.refine_any(tg, part, 4, balance_mode=balance_mode, seed=2, device=CPU)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- validation
def test_parallel_num_shards_validation(graph):
    _, tg = graph
    with pytest.raises(ValueError, match="num_shards"):
        parallel.partition_parallel(tg, 4, num_shards=-1, device=CPU)
    with pytest.raises(ValueError, match="num_shards"):
        parallel.fennel_parallel(tg, 4, num_shards=-2, device=CPU)
    with pytest.raises(ValueError, match="num_shards"):
        restream.partition_restream(tg, 4, num_shards=-1, device=CPU)
    bad_specs = [
        ("cuttana-parallel", {"num_shards": -1}, "num_shards"),
        ("fennel-parallel", {"num_shards": 1.5}, "num_shards"),
        ("cuttana-restream", {"num_shards": -1}, "num_shards"),
        ("fennel-parallel", {"max_workers": -1}, "max_workers"),
        ("cuttana-parallel", {"chunk": -1}, "chunk"),
        # chunk=0 ("auto") is reserved to the parallel algos
        ("cuttana-restream", {"chunk": 0}, "chunk"),
        ("cuttana-parallel", {"strategy": "best"}, "strategy"),
    ]
    for algo, params, match in bad_specs:
        with pytest.raises(ValueError, match=match):
            tapi.PartitionSpec(algo=algo, k=4, params=params)
        with pytest.raises(ValueError, match=match):  # the reference refuses these too
            rapi.PartitionSpec(algo=algo, k=4, params=params)
    # prefetch="on" (refused before the out-of-core slice was ported) is the
    # reference's spec
    fields = dict(algo="cuttana-parallel", k=4, params={"prefetch": "on"})
    assert tapi.PartitionSpec(**fields).to_json() == rapi.PartitionSpec(**fields).to_json()
    # every buffer strategy is accepted, as in the reference
    fields = dict(algo="cuttana-parallel", k=4, params={"strategy": "completeness"})
    assert tapi.PartitionSpec(**fields).to_json() == rapi.PartitionSpec(**fields).to_json()
    # chunk=0 is accepted where the reference accepts it
    for algo in ("cuttana-parallel", "fennel-parallel"):
        assert tapi.PartitionSpec(algo=algo, k=4, params={"chunk": 0}).params.chunk == 0


def test_num_shards_auto_spec_normalization(graph):
    _, tg = graph
    spec = tapi.PartitionSpec(algo="fennel-parallel", k=4, params={"num_shards": "auto"})
    assert spec.params.num_shards == 0
    assert tapi.PartitionSpec.from_json(spec.to_json()) == spec
    ref = rapi.PartitionSpec(algo="fennel-parallel", k=4, params={"num_shards": "auto"})
    assert ref.to_json() == spec.to_json()
    res = tapi.partition(tg, spec, device=CPU)
    assert res.assignment.shape == (tg.num_vertices,)
    auto = res.telemetry["autotune"]
    assert auto["num_shards"] == res.telemetry["num_shards"] >= 1
    assert auto["source"] == "heuristic" or auto["source"].startswith("artifact:")


def test_sharded_policy_requires_affine_scorer(small_graph):
    from repro_torch.core.base import FennelParams, PartitionState
    from repro_torch.core.engine import FennelScorer, ShardedImmediatePolicy, StreamEngine

    class NoAffine:
        def __init__(self, inner):
            self._inner = inner

        def begin(self, state):
            self._inner.begin(state)

        def scores(self, state, hist):
            return self._inner.scores(state, hist)

        def on_assign(self, state, p, deg):
            self._inner.on_assign(state, p, deg)

    _, tg = small_graph
    scorer = NoAffine(FennelScorer(tg, 4, FennelParams(), "vertex"))
    state = PartitionState.create(tg, 4, 0.05, "vertex", seed=0, device=CPU)
    eng = StreamEngine(tg, state, scorer, ShardedImmediatePolicy(2), order="natural")
    with pytest.raises(ValueError, match="affine"):
        eng.run()


# ------------------------------------------------ web-s against the reference
@pytest.fixture(scope="module")
def web_s():
    return _pair(load_dataset("web-s", seed=0))


@pytest.mark.parametrize("algo", ["fennel-parallel", "cuttana-parallel", "cuttana-restream"])
def test_web_s_values_match_reference(web_s, algo):
    """The spec of the port's chip check (k=8, edge balance, random order,
    seed 0, S=4): the reference's edge-cut and counters, computed here."""
    rg, tg = web_s
    fields = dict(algo=algo, k=8, epsilon=0.05, balance_mode="edge", order="random",
                  seed=0, params={"num_shards": 4})
    want = rapi.partition(rg, rapi.PartitionSpec(**fields))
    got = tapi.partition(tg, tapi.PartitionSpec(**fields), device=CPU)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.quality()["edge_cut"] == want.quality()["edge_cut"]
    for key in COUNTERS:
        assert got.telemetry.get(key) == want.telemetry.get(key), key
    assert set(got.timings) == set(want.timings)


@pytest.mark.parametrize("fn", [parallel.fennel_parallel, parallel.partition_parallel,
                                restream.partition_restream, cuttana.refine_any])
def test_entry_points_default_to_the_card(small_graph, fn):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    _, tg = small_graph
    args = (tg, np.zeros(tg.num_vertices, np.int32), 4) if fn is cuttana.refine_any else (tg, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn(*args)
