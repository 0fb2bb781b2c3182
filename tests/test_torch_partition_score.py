"""The partition-score kernel of the PyTorch port: its plain version against
the reference Pallas kernel (interpret mode) and host histograms, the
engine's chunk histograms against the reference engine's, and the
wrapper's argument checks. The CUDA kernel itself is held against the plain
version in ``test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro.core.base import PartitionState as RefState
from repro.core.engine import StreamEngine as RefEngine
from repro.core.engine import _expand_csr_batch
from repro.core.engine import EngineConfig as RefConfig
from repro.core.engine import FennelScorer as RefScorer
from repro.core.engine import ImmediatePolicy as RefPolicy
from repro.graph.generators import rmat_graph
from repro.kernels.partition_score.ops import fennel_scores as ref_fennel_scores
from repro.kernels.partition_score.ops import neighbor_histograms_host
from repro_torch.convert import graph_from_arrays, state_from_arrays
from repro_torch.core.engine import FennelScorer, ImmediatePolicy, StreamEngine
from repro_torch.kernels.partition_score import ops

CPU = torch.device("cpu")
SHAPES = [(8, 16, 4), (128, 128, 8), (200, 100, 16), (256, 64, 128), (64, 256, 32)]


def _dense_inputs(b, d, k):
    rng = np.random.default_rng(b * 1000 + d + k)
    nbr = rng.integers(-1, k, size=(b, d)).astype(np.int32)
    sizes = rng.random(k).astype(np.float32) * 100
    return nbr, sizes


@pytest.mark.parametrize("b,d,k", SHAPES)
def test_dense_matches_reference_kernel(b, d, k):
    nbr, sizes = _dense_inputs(b, d, k)
    alpha, gamma = 0.37, 1.5
    want = np.asarray(
        ref_fennel_scores(nbr, sizes, alpha, gamma, use_pallas=True, interpret=True)
    )
    got = ops.fennel_scores(torch.from_numpy(nbr), torch.from_numpy(sizes), alpha, gamma)
    assert got.dtype == torch.float32 and got.shape == (b, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # alpha = 0 (the engine's call): exact counts
    zeros = np.zeros(k, np.float32)
    want0 = np.asarray(
        ref_fennel_scores(nbr, zeros, 0.0, 1.5, use_pallas=True, interpret=True)
    )
    got0 = ops.fennel_scores(torch.from_numpy(nbr), torch.from_numpy(zeros), 0.0)
    np.testing.assert_array_equal(got0.numpy(), want0)


@pytest.fixture(scope="module")
def hub_graph():
    g = rmat_graph(20_000, avg_degree=16, seed=3)
    assert g.degrees.max() > 1024
    return g


def _chunks(g, rng):
    hub = int(g.degrees.argmax())
    order = rng.permutation(g.num_vertices)
    yield order[:512]
    yield np.concatenate([[hub], order[512:1023]])  # a row wider than 1024
    yield order[1023:1030]  # a ragged tail chunk
    yield np.flatnonzero(g.degrees == 0)[:3] if (g.degrees == 0).any() else order[:1]


@pytest.mark.parametrize("k", [2, 8, 64])
def test_gather_matches_host_histograms(hub_graph, k):
    g = hub_graph
    rng = np.random.default_rng(k)
    part_of = rng.integers(0, k, size=g.num_vertices).astype(np.int32)
    part_of[rng.random(g.num_vertices) < 0.3] = -1
    tg = graph_from_arrays(g.indptr, g.indices, CPU).to(CPU)
    zeros = torch.zeros(k, dtype=torch.float32)
    for batch in _chunks(g, rng):
        batch = batch.astype(np.int64)
        degs = (g.indptr[batch + 1] - g.indptr[batch]).astype(np.int64)
        rows, _, cols = _expand_csr_batch(g.indptr, g.indices, batch, degs)
        want = neighbor_histograms_host(rows, part_of[cols], batch.shape[0], k)
        got = ops.fennel_scores_gather(
            tg.indptr, tg.indices, torch.from_numpy(part_of),
            torch.from_numpy(batch), zeros, 0.0, 1.5,
        )
        np.testing.assert_array_equal(got.numpy().astype(np.float64), want)


def test_gather_penalty_matches_dense_reference(hub_graph):
    """With a penalty the gather entry is the dense entry on the padded
    neighbour matrix of the same rows."""
    g = hub_graph
    k = 16
    rng = np.random.default_rng(5)
    part_of = rng.integers(-1, k, size=g.num_vertices).astype(np.int32)
    batch = rng.permutation(g.num_vertices)[:40].astype(np.int64)
    sizes = (rng.random(k) * 100).astype(np.float32)
    degs = g.indptr[batch + 1] - g.indptr[batch]
    nbr = np.full((batch.shape[0], int(degs.max())), -1, np.int32)
    for i, v in enumerate(batch):
        nb = g.indices[g.indptr[v] : g.indptr[v + 1]]
        nbr[i, : nb.size] = part_of[nb]
    want = np.asarray(
        ref_fennel_scores(nbr, sizes, 0.37, 1.5, use_pallas=True, interpret=True)
    )
    tg = graph_from_arrays(g.indptr, g.indices, CPU).to(CPU)
    got = ops.fennel_scores_gather(
        tg.indptr, tg.indices, torch.from_numpy(part_of), torch.from_numpy(batch),
        torch.from_numpy(sizes), 0.37, 1.5,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("balance_mode", ["vertex", "edge"])
def test_engine_chunk_histograms_match_reference(hub_graph, balance_mode):
    """Mid-stream state built by the reference, carried across with the
    converters: both engines give the same chunk histograms and corrections."""
    g = hub_graph
    k = 8
    ref = RefState.create(g, k, 0.05, balance_mode, seed=0)
    rng = np.random.default_rng(1)
    for v in rng.permutation(g.num_vertices)[:9000].tolist():
        ref.assign(v, int(rng.integers(k)), g.degree(v))
    ids = rng.permutation(g.num_vertices).astype(np.int64)
    ref_eng = RefEngine(
        g, ref, RefScorer(g, k), RefPolicy(), ids=ids, config=RefConfig(use_pallas=False)
    )
    tg = graph_from_arrays(g.indptr, g.indices, CPU)
    state = state_from_arrays(
        ref.part_of, ref.v_counts, ref.e_counts, k=k, epsilon=0.05,
        balance_mode=balance_mode, seed=0, total_degree=ref.total_degree, device=CPU,
    )
    eng = StreamEngine(tg, state, FennelScorer(tg, k), ImmediatePolicy(), ids=ids)
    hub = int(g.degrees.argmax())
    start = int(np.flatnonzero(ids == hub)[0]) // 512 * 512
    for s in (0, start):
        batch = ids[s : s + 512]
        degs = (g.indptr[batch + 1] - g.indptr[batch]).astype(np.int64)
        want_h, want_corr = ref_eng.chunk_histograms(batch, degs)
        rows, _, cols = _expand_csr_batch(g.indptr, g.indices, batch, degs)
        got_h, got_corr = eng.chunk_histograms(s, batch, (rows, cols))
        np.testing.assert_array_equal(np.asarray(got_h), want_h)
        assert got_corr == want_corr
    assert eng.telemetry["kernel_calls"] == 2


def _gather_args(**over):
    args = dict(
        indptr=torch.tensor([0, 2, 3, 3], dtype=torch.int64),
        indices=torch.tensor([1, 2, 0], dtype=torch.int32),
        part_of=torch.tensor([0, 1, -1], dtype=torch.int32),
        batch=torch.tensor([0, 1, 2], dtype=torch.int64),
        sizes=torch.zeros(2, dtype=torch.float32),
    )
    args.update(over)
    return args


def test_wrapper_rejects_bad_arguments():
    got = ops.fennel_scores_gather(**_gather_args(), alpha=0.0, gamma=1.5)
    np.testing.assert_array_equal(got.numpy(), [[0, 1], [1, 0], [0, 0]])
    bad = [
        (TypeError, dict(indptr=torch.tensor([0, 2, 3, 3], dtype=torch.int32))),
        (TypeError, dict(part_of=torch.tensor([0, 1, -1], dtype=torch.int64))),
        (TypeError, dict(sizes=torch.zeros(2, dtype=torch.float64))),
        (ValueError, dict(batch=torch.tensor([[0, 1]], dtype=torch.int64))),
        (ValueError, dict(batch=torch.arange(6, dtype=torch.int64)[::2])),
        (ValueError, dict(part_of=torch.zeros(2, dtype=torch.int32))),
        (ValueError, dict(sizes=torch.zeros(0, dtype=torch.float32))),
        (ValueError, dict(sizes=torch.zeros(ops.MAX_K + 1, dtype=torch.float32))),
        (ValueError, dict(batch=torch.zeros(3, dtype=torch.int64, device="meta"))),
    ]
    for exc, over in bad:
        with pytest.raises(exc):
            ops.fennel_scores_gather(**_gather_args(**over), alpha=0.0, gamma=1.5)
    meta = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fennel_scores(meta, torch.zeros(2, device="meta"), 0.0)
    with pytest.raises(TypeError):
        ops.fennel_scores(torch.zeros((2, 3), dtype=torch.int64), torch.zeros(2), 0.0)
    # CPU calls take the plain version and launch nothing
    before = ops.launches
    ops.fennel_scores(torch.zeros((2, 3), dtype=torch.int32), torch.zeros(2), 0.0)
    assert ops.launches == before
