"""Streaming partitioners of the PyTorch port against the reference: the
assignments must be bit-identical for every stream order and balance mode
(the port keeps numpy's generators and the reference's IEEE arithmetic)."""
import numpy as np
import pytest
import torch

from repro.core import cuttana as ref_cuttana
from repro.core import fennel as ref_fennel
from repro.core import ldg as ref_ldg
from repro.graph import powerlaw_cluster_graph, rmat_graph
from repro_torch.convert import graph_from_arrays
from repro_torch.core import cuttana, fennel, ldg

ORDERS = ("natural", "random", "bfs", "dfs")
CPU = torch.device("cpu")

# small d_max / max_qsize exercise the D_max bypass, overflow evictions and
# complete-eviction cascades
_BUFFERED = dict(d_max=32, max_qsize=128, theta=0.7)
CASES = {
    "fennel": (ref_fennel.partition, fennel.partition, {}),
    "ldg": (ref_ldg.partition, ldg.partition, {}),
    "cuttana": (ref_cuttana.partition, cuttana.partition, _BUFFERED),
    "cuttana-nobuffer": (ref_cuttana.partition, cuttana.partition, dict(use_buffer=False)),
}


@pytest.fixture(scope="module")
def graphs():
    pairs = []
    for g in (
        rmat_graph(1200, avg_degree=10, seed=3),
        powerlaw_cluster_graph(900, avg_degree=8, seed=4),
    ):
        pairs.append((g, graph_from_arrays(g.indptr, g.indices, CPU)))
    return pairs


@pytest.mark.parametrize("algo", list(CASES))
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("balance_mode", ["vertex", "edge"])
def test_assignments_match_reference(graphs, algo, order, balance_mode):
    ref_fn, port_fn, kw = CASES[algo]
    for rg, tg in graphs:
        want_tel, got_tel = {}, {}
        want = ref_fn(rg, 4, balance_mode=balance_mode, order=order, seed=7,
                      telemetry=want_tel, **kw)
        got = port_fn(tg, 4, balance_mode=balance_mode, order=order, seed=7,
                      telemetry=got_tel, device=CPU, **kw)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert got_tel["kernel_calls"] == want_tel["kernel_calls"]
        assert got_tel["single_place_calls"] == want_tel["single_place_calls"]


def test_fennel_matches_reference_pallas_path(graphs):
    """The reference run through its Pallas kernel (interpret mode)."""
    rg, tg = graphs[0]
    want = ref_fennel.partition(rg, 4, order="random", seed=7, use_pallas=True, interpret=True)
    got = fennel.partition(tg, 4, order="random", seed=7, device=CPU)
    np.testing.assert_array_equal(got, want)


def test_cuttana_telemetry_matches_reference(graphs):
    rg, tg = graphs[1]
    want_tel, got_tel = {}, {}
    want = ref_cuttana.partition(rg, 4, order="bfs", seed=2, telemetry=want_tel, **_BUFFERED)
    got = cuttana.partition(tg, 4, order="bfs", seed=2, telemetry=got_tel, device=CPU, **_BUFFERED)
    np.testing.assert_array_equal(got, want)
    for key in ("buffer_evictions", "buffer_drained", "buffer_peak", "degree_bypass",
                "refine_moves", "refine_improvement", "subpartitions", "kernel_calls"):
        assert got_tel[key] == want_tel[key], key


def test_device_mirror_tracks_host_state(graphs):
    """After a run the device mirror of part_of equals the host array, for
    the chunked policy (per-chunk flushes) and the buffered one (one sync)."""
    from repro_torch.core.base import PartitionState
    from repro_torch.core.engine import BufferedPolicy, FennelScorer, ImmediatePolicy, StreamEngine

    _, tg = graphs[0]
    for policy in (ImmediatePolicy(), BufferedPolicy(128, 32)):
        state = PartitionState.create(tg, 4, 0.05, "edge", seed=0, device=CPU)
        StreamEngine(tg, state, FennelScorer(tg, 4), policy, order="random").run()
        assert (state.part_of >= 0).all()
        np.testing.assert_array_equal(state.part_of_dev.numpy(), state.part_of)


def test_prefetch_on_is_not_ported(graphs):
    # prefetch="on" (refused before the out-of-core slice was ported) decodes
    # ahead on a resident graph too and gives the reference's assignment
    rg, tg = graphs[0]
    np.testing.assert_array_equal(
        fennel.partition(tg, 4, prefetch="on", order="random", device=CPU),
        ref_fennel.partition(rg, 4, prefetch="on", order="random"))
    # the gain and completeness buffers (refused before the zoo was
    # ported) give the reference's assignment
    rg = graphs[0][0]
    for strategy in ("gain", "completeness"):
        np.testing.assert_array_equal(
            cuttana.partition(tg, 4, strategy=strategy, order="random", device=CPU),
            ref_cuttana.partition(rg, 4, strategy=strategy, order="random"))


@pytest.mark.parametrize("chunk", [1, 10**6])
@pytest.mark.parametrize("k", [1, 3])
def test_degenerate_shapes_match_reference(chunk, k):
    """Chunk of one vertex and one chunk for the whole stream, k=1, and an
    edgeless graph (LDG's 0/0 capacity path in edge mode)."""
    from repro.graph.csr import CSRGraph as RefCSR

    for rg in (RefCSR.from_edges(np.zeros((0, 2), int), num_vertices=50),
               rmat_graph(300, avg_degree=6, seed=1)):
        tg = graph_from_arrays(rg.indptr, rg.indices, CPU)
        for algo, (ref_fn, port_fn, kw) in CASES.items():
            for balance_mode in ("vertex", "edge"):
                args = dict(balance_mode=balance_mode, chunk=chunk, order="random", seed=2)
                with np.errstate(invalid="ignore"):
                    want = ref_fn(rg, k, **args, **kw)
                    got = port_fn(tg, k, **args, device=CPU, **kw)
                np.testing.assert_array_equal(got, want, err_msg=f"{algo} {balance_mode}")


@pytest.mark.parametrize("balance_mode", ["vertex", "edge"])
def test_scores_match_reference_on_a_mid_stream_state(graphs, balance_mode):
    """Eq. 7 (make_fennel_score, FennelScorer) and LDG scores on a state the
    reference built, carried across with the converters."""
    from repro.core.base import FennelParams as RefParams
    from repro.core.base import PartitionState as RefState
    from repro.core.base import make_fennel_score as ref_make
    from repro.core.engine import FennelScorer as RefFennel
    from repro.core.engine import LDGScorer as RefLDG
    from repro_torch.convert import state_from_arrays
    from repro_torch.core.base import FennelParams, make_fennel_score
    from repro_torch.core.engine import FennelScorer, LDGScorer

    rg, tg = graphs[0]
    ref = RefState.create(rg, 4, 0.05, balance_mode, seed=0)
    rng = np.random.default_rng(3)
    for v in rng.permutation(rg.num_vertices)[:700].tolist():
        ref.assign(v, int(rng.integers(4)), rg.degree(v))
    state = state_from_arrays(
        ref.part_of, ref.v_counts, ref.e_counts, k=4, epsilon=0.05,
        balance_mode=balance_mode, seed=0, total_degree=ref.total_degree, device=CPU,
    )
    hist = rng.integers(0, 9, size=4).astype(np.float64)
    for hybrid in (False, True):
        want = ref_make(rg, 4, RefParams(hybrid=hybrid), balance_mode)(ref, hist)
        got = make_fennel_score(tg, 4, FennelParams(hybrid=hybrid), balance_mode)(state, hist)
        np.testing.assert_array_equal(got, want)
        rs, ts = RefFennel(rg, 4, RefParams(hybrid=hybrid), balance_mode), FennelScorer(tg, 4, FennelParams(hybrid=hybrid), balance_mode)
        rs.begin(ref)
        ts.begin(state)
        np.testing.assert_array_equal(ts.scores(state, hist), rs.scores(ref, hist))
    rl, tl = RefLDG(rg, 4, balance_mode), LDGScorer(tg, 4, balance_mode)
    rl.begin(ref)
    tl.begin(state)
    np.testing.assert_array_equal(tl.scores(state, hist), rl.scores(ref, hist))
    nbrs = tg.neighbors(int(rg.degrees.argmax()))
    np.testing.assert_array_equal(state.neighbor_histogram(nbrs), ref.neighbor_histogram(nbrs))
