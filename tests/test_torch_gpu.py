"""The partition-score CUDA kernel (sequential and sharded entries; the
partitioner zoo's paths through them: sampled dense rows, 4,096-row chunks,
long coarse rows, one engine per arrival batch; the rows entries of a
memory-mapped graph and its bounded device memory), the
gather/reduce CUDA kernel (segment and ELL entries), the flash-attention and
the selective-scan kernels against their plain PyTorch versions on the card,
and the partitioners, the analytics engine and the reduced LMs on the card
against the same runs on the CPU. A CUDA kernel has no CPU mode, so these
tests are marked ``gpu`` and skip without a card. The file imports only the port, so it also runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import graph_from_arrays
from repro_torch.core.fennel import partition as fennel_partition
from repro_torch.graph.generators import rmat_graph
from repro_torch.kernels.partition_score import ops
from repro_torch.kernels.partition_score.ref import (
    fennel_scores_gather_ref,
    fennel_scores_ref,
    fennel_scores_sharded_gather_ref,
    fennel_scores_sharded_ref,
)

DENSE_SHAPES = [(8, 16, 4), (128, 128, 8), (200, 100, 16), (256, 64, 128), (64, 256, 32)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def hub_graph():
    g = rmat_graph(20_000, avg_degree=16, seed=3)
    assert g.degrees.max() > 1024
    return g


def _batches(g, rng):
    hub = int(g.degrees.argmax())
    order = rng.permutation(g.num_vertices)
    yield order[:512]
    yield np.concatenate([[hub], order[512:1023]])  # a row wider than 1024
    yield order[1023:1030]  # a ragged tail chunk


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 64, ops.MAX_K])
def test_gather_kernel_matches_plain_version(cuda_device, hub_graph, k):
    g = hub_graph
    dg = graph_from_arrays(g.indptr, g.indices, cuda_device).to(cuda_device)
    rng = np.random.default_rng(k)
    part_of = rng.integers(0, k, size=g.num_vertices).astype(np.int32)
    part_of[rng.random(g.num_vertices) < 0.3] = -1
    p_dev = torch.from_numpy(part_of).to(cuda_device)
    for batch in _batches(g, rng):
        b_dev = torch.from_numpy(batch.astype(np.int64)).to(cuda_device)
        for alpha, sizes in ((0.0, np.zeros(k)), (0.37, rng.random(k) * 100)):
            s_dev = torch.from_numpy(sizes.astype(np.float32)).to(cuda_device)
            before = ops.launches
            got = ops.fennel_scores_gather(dg.indptr, dg.indices, p_dev, b_dev, s_dev, alpha, 1.5)
            torch.cuda.synchronize()
            assert ops.launches == before + 1
            want = fennel_scores_gather_ref(dg.indptr, dg.indices, p_dev, b_dev, s_dev, alpha, 1.5)
            if alpha == 0.0:
                assert torch.equal(got, want)  # small integer counts: exact
            else:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,k", DENSE_SHAPES)
def test_dense_kernel_matches_plain_version(cuda_device, b, d, k):
    rng = np.random.default_rng(b * 1000 + d + k)
    nbr = torch.from_numpy(rng.integers(-1, k, size=(b, d)).astype(np.int32)).to(cuda_device)
    sizes = torch.from_numpy((rng.random(k) * 100).astype(np.float32)).to(cuda_device)
    got = ops.fennel_scores(nbr, sizes, 0.37, 1.5)
    torch.testing.assert_close(got, fennel_scores_ref(nbr, sizes, 0.37, 1.5), rtol=1e-6, atol=1e-6)
    zeros = torch.zeros_like(sizes)
    assert torch.equal(ops.fennel_scores(nbr, zeros, 0.0), fennel_scores_ref(nbr, zeros, 0.0, 1.5))


@pytest.mark.gpu
def test_wrapper_rejects_mixed_devices(cuda_device):
    nbr = torch.zeros((2, 3), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="is on cpu"):
        ops.fennel_scores(nbr, torch.zeros(2), 0.0)


@pytest.mark.gpu
def test_fennel_on_card_matches_cpu_and_launches_per_chunk(cuda_device):
    g = rmat_graph(5000, avg_degree=12, seed=1)
    tel = {}
    before = ops.launches
    got = fennel_partition(g, 8, balance_mode="edge", order="random", seed=0,
                           telemetry=tel, device=cuda_device)
    assert ops.launches - before == tel["kernel_calls"] == -(-5000 // 512)
    want = fennel_partition(g, 8, balance_mode="edge", order="random", seed=0, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("counts", [(512, 512, 512, 512), (0, 300, 0, 511), (1, 0, 0, 0)])
def test_sharded_gather_kernel_matches_plain_version(cuda_device, hub_graph, k, counts):
    g = hub_graph
    dg = graph_from_arrays(g.indptr, g.indices, cuda_device).to(cuda_device)
    rng = np.random.default_rng(k + sum(counts))
    part_of = rng.integers(0, k, size=g.num_vertices).astype(np.int32)
    part_of[rng.random(g.num_vertices) < 0.3] = -1
    p_dev = torch.from_numpy(part_of).to(cuda_device)
    hub = int(g.degrees.argmax())
    order = rng.permutation(g.num_vertices)
    batch = np.concatenate([[hub], order[order != hub]])[: sum(counts)]
    b_dev = torch.from_numpy(batch.astype(np.int64)).to(cuda_device)
    start = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int64,
                         device=cuda_device)
    s = len(counts)
    for alpha, sizes in ((0.0, np.zeros((s, k))), (0.37, rng.random((s, k)) * 100)):
        s_dev = torch.from_numpy(sizes.astype(np.float32)).to(cuda_device)
        args = (dg.indptr, dg.indices, p_dev, b_dev, start, s_dev, alpha, 1.5)
        before = ops.sharded_launches
        got = ops.fennel_scores_sharded_gather(*args)
        torch.cuda.synchronize()
        assert ops.sharded_launches == before + 1
        want = fennel_scores_sharded_gather_ref(*args)
        if alpha == 0.0:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("s,c,d,k", [(4, 33, 17, 6), (8, 512, 64, 8), (2, 128, 300, 64)])
def test_sharded_dense_kernel_matches_plain_version(cuda_device, s, c, d, k):
    rng = np.random.default_rng(s * c + d + k)
    nbr = torch.from_numpy(rng.integers(-1, k, size=(s, c, d)).astype(np.int32)).to(cuda_device)
    sizes = torch.from_numpy((rng.random((s, k)) * 100).astype(np.float32)).to(cuda_device)
    got = ops.fennel_scores_sharded(nbr, sizes, 0.37, 1.5)
    torch.testing.assert_close(got, fennel_scores_sharded_ref(nbr, sizes, 0.37, 1.5),
                               rtol=1e-6, atol=1e-6)
    zeros = torch.zeros_like(sizes)
    assert torch.equal(ops.fennel_scores_sharded(nbr, zeros, 0.0),
                       fennel_scores_sharded_ref(nbr, zeros, 0.0, 1.5))


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["fennel-parallel", "cuttana-parallel", "cuttana-restream"])
def test_parallel_on_card_matches_cpu_and_launches_per_superstep(cuda_device, algo):
    import repro_torch.api as tapi
    from repro_torch.graph.generators import load_dataset

    web = load_dataset("web-s", seed=0)
    spec = tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0,
                              params={"num_shards": 4})
    before = ops.sharded_launches, ops.launches
    on_card = tapi.partition(web, spec, device=cuda_device)
    torch.cuda.synchronize()
    sharded = ops.sharded_launches - before[0]
    assert sharded == on_card.telemetry["kernel_calls"] > 0
    assert ops.launches == before[1]  # the sequential entries are not on this path
    on_cpu = tapi.partition(web, spec, device="cpu")
    np.testing.assert_array_equal(on_card.assignment, on_cpu.assignment)
    assert on_card.quality()["edge_cut"] == on_cpu.quality()["edge_cut"]


def _local_rows(rng, degs, num_vertices):
    """A chunk-local CSR (int64 offsets, int32 sorted-unique cols) of rows
    with ``degs`` entries over ``num_vertices`` vertices."""
    cols = [np.sort(rng.choice(num_vertices, size=d, replace=False)) for d in degs]
    local = np.concatenate(([0], np.cumsum(degs))).astype(np.int64)
    return local, np.concatenate(cols).astype(np.int32)


# rows of a chunk: short rows, empty rows, and a hub row of 9,000 entries,
# more than WHOLE_ROW, so the kernel splits it over its cluster's blocks
ROWS_DEGS = [0, 3, 9000, 17, 0, 1, 600] + [12] * 505


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 64])
def test_rows_kernel_matches_plain_version(cuda_device, k):
    from repro_torch.kernels.partition_score.ref import fennel_scores_rows_ref

    rng = np.random.default_rng(k)
    v = 50_000
    assert max(ROWS_DEGS) > ops.WHOLE_ROW
    local, cols = _local_rows(rng, ROWS_DEGS, v)
    part_of = rng.integers(-1, k, size=v).astype(np.int32)
    dev = [torch.from_numpy(a).to(cuda_device) for a in (local, cols, part_of)]
    for alpha, sizes in ((0.0, np.zeros(k)), (0.37, rng.random(k) * 100)):
        s_dev = torch.from_numpy(sizes.astype(np.float32)).to(cuda_device)
        before = ops.rows_launches
        got = ops.fennel_scores_rows(*dev, s_dev, alpha, 1.5)
        torch.cuda.synchronize()
        assert ops.rows_launches == before + 1
        want = fennel_scores_rows_ref(*dev, s_dev, alpha, 1.5)
        if alpha == 0.0:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("counts", [(128, 128, 128, 128), (0, 300, 0, 212), (512, 0, 0, 0)])
def test_sharded_rows_kernel_matches_plain_version(cuda_device, counts):
    from repro_torch.kernels.partition_score.ref import fennel_scores_sharded_rows_ref

    rng = np.random.default_rng(sum(counts))
    v, k, s = 50_000, 8, len(counts)
    local, cols = _local_rows(rng, ROWS_DEGS, v)
    part_of = rng.integers(-1, k, size=v).astype(np.int32)
    dev = [torch.from_numpy(a).to(cuda_device) for a in (local, cols, part_of)]
    start = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int64,
                         device=cuda_device)
    for alpha, sizes in ((0.0, np.zeros((s, k))), (0.37, rng.random((s, k)) * 100)):
        s_dev = torch.from_numpy(sizes.astype(np.float32)).to(cuda_device)
        before = ops.sharded_rows_launches
        got = ops.fennel_scores_sharded_rows(*dev, start, s_dev, alpha, 1.5)
        torch.cuda.synchronize()
        assert ops.sharded_rows_launches == before + 1
        want = fennel_scores_sharded_rows_ref(*dev, start, s_dev, alpha, 1.5)
        if alpha == 0.0:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["fennel", "fennel-parallel"])
def test_mapped_run_on_card_holds_one_chunk(cuda_device, tmp_path, algo):
    """A memory-mapped graph partitions on the card with the CPU's
    assignment, one rows-entry launch a chunk (or superstep), and a peak of
    device memory below the bytes of the graph's device arrays. (A CUTTANA
    run's peak is its phase-2 W, K' x K' float64: not the graph's.)"""
    import repro_torch.api as tapi
    from repro_torch.graph.external import ExternalCSRGraph, convert_csr

    g = rmat_graph(200_000, avg_degree=16, seed=2)
    path = str(tmp_path / "g.bin")
    convert_csr(g, path)
    graph_bytes = g.indptr.nbytes + g.indices.nbytes
    params = {"num_shards": 4} if algo.endswith("parallel") else {}
    spec = tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0,
                              params=params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counts = ops.rows_launches, ops.sharded_rows_launches, ops.launches, ops.sharded_launches
    on_card = tapi.partition(ExternalCSRGraph(path), spec, device=cuda_device)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launched = (ops.rows_launches - counts[0], ops.sharded_rows_launches - counts[1],
                ops.launches - counts[2], ops.sharded_launches - counts[3])
    calls = on_card.telemetry["kernel_calls"]
    assert launched == ((calls, 0, 0, 0) if algo == "fennel" else (0, calls, 0, 0))
    assert peak < graph_bytes, (peak, graph_bytes)
    on_cpu = tapi.partition(g, spec, device="cpu")
    np.testing.assert_array_equal(on_card.assignment, on_cpu.assignment)
    assert on_card.quality() == on_cpu.quality()


def _launch_counts():
    return ops.launches, ops.sharded_launches


def _launched_since(before):
    torch.cuda.synchronize()
    return ops.launches - before[0], ops.sharded_launches - before[1]


@pytest.mark.gpu
@pytest.mark.parametrize("sample_cap", [16, 512])
def test_cuttana_batched_on_card_launches_both_entries(cuda_device, hub_graph, sample_cap):
    """One gather-entry launch a chunk, plus one dense-entry launch for each
    chunk that holds a row above ``sample_cap``; the same assignment as on
    the CPU. The legacy loop launches the dense entry once a chunk."""
    from repro_torch.core.cuttana_batched import partition_batched
    from repro_torch.core.legacy import cuttana_batched_partition
    from repro_torch.graph.stream import stream_order

    g = hub_graph
    kw = dict(balance_mode="edge", order="random", seed=0, sample_cap=sample_cap)
    degs = g.degrees[stream_order(g, "random", 0)]
    sampled = sum(int((degs[s:s + 512] > sample_cap).any()) for s in range(0, g.num_vertices, 512))
    assert sampled > 0
    tel = {}
    before = _launch_counts()
    got = partition_batched(g, 8, telemetry=tel, device=cuda_device, **kw)
    assert _launched_since(before) == (tel["kernel_calls"] + sampled, 0)
    assert tel["kernel_calls"] == -(-g.num_vertices // 512)
    np.testing.assert_array_equal(got, partition_batched(g, 8, device="cpu", **kw))
    before = _launch_counts()
    got = cuttana_batched_partition(g, 8, device=cuda_device, **kw)
    assert _launched_since(before) == (-(-g.num_vertices // 512), 0)
    np.testing.assert_array_equal(got, cuttana_batched_partition(g, 8, device="cpu", **kw))


@pytest.mark.gpu
def test_heistream_on_card_4096_row_chunks(cuda_device, hub_graph):
    """Batches of 4,096 rows (8 groups of 512 a launch), FM moves between
    launches; the same assignment as on the CPU."""
    from repro_torch.core import heistream_like

    kw = dict(balance_mode="edge", order="random", seed=0)
    tel = {}
    before = _launch_counts()
    got = heistream_like.partition(hub_graph, 8, telemetry=tel, device=cuda_device, **kw)
    assert _launched_since(before) == (tel["kernel_calls"], 0)
    assert tel["kernel_calls"] == -(-hub_graph.num_vertices // 4096) and tel["fm_moves"] > 0
    np.testing.assert_array_equal(got, heistream_like.partition(hub_graph, 8, device="cpu", **kw))


@pytest.mark.gpu
def test_cluster_fennel_on_card_long_coarse_rows(cuda_device, hub_graph):
    """The coarse multigraph holds supervertex rows above 4,096 items (the
    kernel's split-row path); the same assignment as on the CPU."""
    from repro_torch.core.cluster import build_coarse_graph, partition_cluster, streaming_cluster
    from repro_torch.graph.stream import stream_order

    g, k = hub_graph, 4
    ids = stream_order(g, "random", 0)
    cl, nc, _ = streaming_cluster(g, ids, max(0.1 * g.indices.shape[0] / k, 1.0),
                                  max(int(0.1 * g.num_vertices / k), 1), 1000)
    assert build_coarse_graph(g, cl, nc).degrees.max() > 4096
    kw = dict(balance_mode="edge", order="random", seed=0, base="fennel")
    tel = {}
    before = _launch_counts()
    got = partition_cluster(g, k, telemetry=tel, device=cuda_device, **kw)
    assert _launched_since(before) == (tel["kernel_calls"], 0)
    assert tel["kernel_calls"] == -(-nc // 512)
    np.testing.assert_array_equal(got, partition_cluster(g, k, device="cpu", **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("num_shards", [1, 4])
def test_incremental_on_card_launches_per_batch(cuda_device, num_shards):
    """A new engine (and graph upload) per arrival batch and per re-stream
    window: the launches equal ``kernel_calls`` and the run equals the
    CPU's."""
    from repro_torch.core.incremental import partition_incremental
    from repro_torch.graph.generators import load_dataset

    web = load_dataset("web-s", seed=0)
    kw = dict(balance_mode="edge", order="random", seed=0, num_shards=num_shards,
              drift_threshold=0.02)
    tel = {}
    before = _launch_counts()
    got = partition_incremental(web, 8, telemetry=tel, device=cuda_device, **kw)
    seq, sharded = _launched_since(before)
    assert seq + sharded == tel["kernel_calls"] > 0
    assert (sharded > 0) == (num_shards > 1) and tel["restream_windows"] > 0
    np.testing.assert_array_equal(got, partition_incremental(web, 8, device="cpu", **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["gain", "completeness"])
def test_parallel_strategies_on_card(cuda_device, strategy):
    import repro_torch.api as tapi
    from repro_torch.graph.generators import load_dataset

    web = load_dataset("web-s", seed=0)
    spec = tapi.PartitionSpec(algo="cuttana-parallel", k=8, balance_mode="edge", order="random",
                              seed=0, params={"num_shards": 4, "strategy": strategy})
    before = _launch_counts()
    on_card = tapi.partition(web, spec, device=cuda_device)
    assert _launched_since(before) == (0, on_card.telemetry["kernel_calls"])
    on_cpu = tapi.partition(web, spec, device="cpu")
    np.testing.assert_array_equal(on_card.assignment, on_cpu.assignment)


def _hub_csr(rng, n=100_000, hub_degree=97_599):
    """A CSR graph whose vertex 0 has ``hub_degree`` neighbours (the 2^22
    R-MAT's hub) and whose other vertices have 0-40."""
    degs = rng.integers(0, 41, size=n).astype(np.int64)
    degs[0] = hub_degree
    indptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    return indptr, rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)


def _gather_twice(cuda_device, indptr, indices, part_of, batch, k, rng):
    """The gather kernel against its plain version (exact at alpha=0, 1e-6
    with a penalty), one launch a call, and a second call the same bits."""
    args = [torch.from_numpy(a).to(cuda_device) for a in (indptr, indices, part_of, batch)]
    for alpha, sizes in ((0.0, np.zeros(k)), (0.37, rng.random(k) * 100)):
        s_dev = torch.from_numpy(sizes.astype(np.float32)).to(cuda_device)
        before = ops.launches
        got = ops.fennel_scores_gather(*args, s_dev, alpha, 1.5)
        again = ops.fennel_scores_gather(*args, s_dev, alpha, 1.5)
        torch.cuda.synchronize()
        assert ops.launches == before + 2
        want = fennel_scores_gather_ref(*args, s_dev, alpha, 1.5)
        if alpha == 0.0:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8, 32, 33, 64, ops.MAX_K])
def test_gather_kernel_every_counting_width(cuda_device, hub_graph, k):
    """K on both sides of the warp's width (ballot counting up to 32, match
    counting above) and at MAX_K (one row a group), on the hub graph's
    chunks, a ragged tail and zero-degree rows."""
    g = hub_graph
    rng = np.random.default_rng(100 + k)
    part_of = rng.integers(-1, k, size=g.num_vertices).astype(np.int32)
    zero = np.flatnonzero(g.degrees == 0)[:5]
    for batch in list(_batches(g, rng)) + [np.concatenate([zero, [int(g.degrees.argmax())], zero])]:
        _gather_twice(cuda_device, g.indptr, g.indices, part_of, batch.astype(np.int64), k, rng)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 64])
def test_gather_kernel_97k_row(cuda_device, k):
    """A row of 97,599 entries alone, and among 511 short rows (the 2^22
    chunk that held one block for 0.13 ms), twice to the same bits."""
    rng = np.random.default_rng(k)
    indptr, indices = _hub_csr(rng)
    part_of = rng.integers(0, k, size=indptr.shape[0] - 1).astype(np.int32)
    part_of[rng.random(part_of.shape[0]) < 0.3] = -1
    _gather_twice(cuda_device, indptr, indices, part_of, np.array([0], np.int64), k, rng)
    chunk = np.concatenate([[0], rng.permutation(np.arange(1, 100_000))[:511]]).astype(np.int64)
    _gather_twice(cuda_device, indptr, indices, part_of, chunk, k, rng)
    _gather_twice(cuda_device, indptr, indices, part_of, chunk[::-1].copy(), k, rng)


@pytest.mark.gpu
def test_gather_kernel_all_neighbours_unassigned(cuda_device):
    rng = np.random.default_rng(3)
    indptr, indices = _hub_csr(rng, n=20_000, hub_degree=30_000)
    part_of = np.full(indptr.shape[0] - 1, -1, np.int32)
    batch = np.arange(512, dtype=np.int64)
    _gather_twice(cuda_device, indptr, indices, part_of, batch, 8, rng)
    out = ops.fennel_scores_gather(*[torch.from_numpy(a).to(cuda_device)
                                     for a in (indptr, indices, part_of, batch)],
                                   torch.zeros(8, device=cuda_device), 0.0, 1.5)
    assert not bool(out.any())


@pytest.mark.gpu
@pytest.mark.parametrize("counts", [(0, 512, 0, 511), (512, 0, 512, 512), (0, 0, 1, 0)])
def test_sharded_gather_kernel_97k_row_and_empty_shards(cuda_device, counts):
    """The sharded entry with empty shards and the 97,599-entry row first in
    its first non-empty shard; each row's size row picked once; twice to the
    same bits."""
    rng = np.random.default_rng(sum(counts))
    indptr, indices = _hub_csr(rng)
    k = 8
    part_of = rng.integers(-1, k, size=indptr.shape[0] - 1).astype(np.int32)
    batch = np.concatenate([[0], rng.permutation(np.arange(1, 100_000))])[: sum(counts)]
    dev = [torch.from_numpy(a).to(cuda_device) for a in (indptr, indices, part_of,
                                                         batch.astype(np.int64))]
    start = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int64,
                         device=cuda_device)
    for alpha, sizes in ((0.0, np.zeros((4, k))), (0.37, rng.random((4, k)) * 100)):
        s_dev = torch.from_numpy(sizes.astype(np.float32)).to(cuda_device)
        args = (*dev, start, s_dev, alpha, 1.5)
        before = ops.sharded_launches
        got = ops.fennel_scores_sharded_gather(*args)
        again = ops.fennel_scores_sharded_gather(*args)
        torch.cuda.synchronize()
        assert ops.sharded_launches == before + 2
        want = fennel_scores_sharded_gather_ref(*args)
        if alpha == 0.0:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,k", [(3, 40_000, 8), (2048, 64, 8), (1, 97_599, 64), (5, 0, 8)])
def test_dense_kernel_wide_and_empty_rows(cuda_device, b, d, k):
    """Dense rows wider than a block's share (split over the cluster) and of
    width 0, in the flat and the sharded dense entries."""
    rng = np.random.default_rng(b + d + k)
    nbr = torch.from_numpy(rng.integers(-1, k, size=(b, d)).astype(np.int32)).to(cuda_device)
    sizes = torch.from_numpy((rng.random(k) * 100).astype(np.float32)).to(cuda_device)
    got = ops.fennel_scores(nbr, sizes, 0.37, 1.5)
    torch.testing.assert_close(got, fennel_scores_ref(nbr, sizes, 0.37, 1.5), rtol=1e-6, atol=1e-6)
    zeros = torch.zeros_like(sizes)
    assert torch.equal(ops.fennel_scores(nbr, zeros, 0.0), fennel_scores_ref(nbr, zeros, 0.0, 1.5))
    nbr3 = nbr.reshape(1, b, d)
    assert torch.equal(ops.fennel_scores_sharded(nbr3, zeros[None], 0.0),
                       fennel_scores_sharded_ref(nbr3, zeros[None], 0.0, 1.5))


# ------------------------------------------------------------------ ell_spmv
@pytest.mark.gpu
@pytest.mark.parametrize("reduce", ["sum", "min"])
@pytest.mark.parametrize("r,d,v", [(16, 8, 64), (128, 32, 300), (333, 17, 1000), (64, 30_000, 5000)])
def test_ell_kernel_matches_plain_version(cuda_device, reduce, r, d, v):
    from repro_torch.kernels.ell_spmv import ops as spmv
    from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref

    rng = np.random.default_rng(r + d)
    x = np.concatenate([rng.random(v), [0.0 if reduce == "sum" else 3e38]]).astype(np.float32)
    cols = rng.integers(0, v + 1, size=(r, d)).astype(np.int32)
    x_dev, c_dev = torch.from_numpy(x).to(cuda_device), torch.from_numpy(cols).to(cuda_device)
    before = spmv.launches
    got = spmv.ell_spmv(x_dev, c_dev, reduce)
    torch.cuda.synchronize()
    assert spmv.launches == before + 1
    want = ell_spmv_ref(x_dev, c_dev, reduce)
    if reduce == "min":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("reduce", ["sum", "min"])
def test_segments_kernel_matches_plain_version(cuda_device, hub_graph, reduce):
    """The engine's layout of an R-MAT with a hub row, plus empty rows and
    an edgeless device."""
    from repro_torch.analytics import localize
    from repro_torch.kernels.ell_spmv import ops as spmv
    from repro_torch.kernels.ell_spmv.ref import ell_spmv_segments_ref

    g = hub_graph
    part = np.random.default_rng(0).integers(0, 7, size=g.num_vertices)  # device 7 is empty
    lg = localize(g, part, 8)
    dev = lg.to(cuda_device)
    assert lg.to("cuda") is dev and lg.to(torch.device("cuda", 0)) is dev  # one copy
    rng = np.random.default_rng(1)
    x = rng.random((8, lg.state_len)).astype(np.float32)
    x[:, -1] = 0.0 if reduce == "sum" else 3e38
    x_dev = torch.from_numpy(x).to(cuda_device)
    before = spmv.launches
    got = spmv.ell_spmv_segments(x_dev, dev.row_ptr, dev.cols, reduce)
    torch.cuda.synchronize()
    assert spmv.launches == before + 1
    want = ell_spmv_segments_ref(x_dev, dev.row_ptr, dev.cols, reduce)
    if reduce == "min":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    again = spmv.ell_spmv_segments(x_dev, dev.row_ptr, dev.cols, reduce)
    assert torch.equal(got, again)  # no atomics: the same bits every launch


def _segments_from_degrees(degrees, state_len, rng):
    """x f32[k, state_len], row_ptr int64[k, v_max+1], cols int32[k, e_max]
    for devices with the given row degrees (shorter lists padded with empty
    rows), e_max three past the widest device (pads at the identity slot)."""
    k, v_max = len(degrees), max(len(d) for d in degrees)
    row_ptr = np.zeros((k, v_max + 1), np.int64)
    for p, degs in enumerate(degrees):
        row_ptr[p, 1 : len(degs) + 1] = np.cumsum(degs)
        row_ptr[p, len(degs) + 1 :] = row_ptr[p, len(degs)]
    e_max = int(row_ptr[:, -1].max()) + 3
    cols = np.full((k, e_max), state_len - 1, np.int32)
    for p in range(k):
        n = int(row_ptr[p, -1])
        cols[p, :n] = rng.integers(0, state_len - 1, size=n)
    return rng.random((k, state_len)).astype(np.float32), row_ptr, cols


def _path_edge_degrees(tile, rng):
    """Row degrees that put the merge path's edge cases at ``tile`` items a
    block: degrees 0/1/31/32/33, a row over three or more tiles, a row whose
    end item is a tile's last item, an empty row then a row whose end item
    is a tile's first, a device whose first row starts long, an edgeless
    device, and random short rows."""
    def end_at(degs, where):  # append a row whose end item sits at path position where
        degs.append(where - len(degs) - sum(degs))

    def next_tile(degs):
        return ((len(degs) + sum(degs)) // tile + 1) * tile

    first = [0, 1, 31, 32, 33, 0, 0, 2, 3 * tile + 5, 1]
    end_at(first, next_tile(first) - 1)   # ends on the tile's last item
    first.append(0)                        # an empty row: the next tile's first item
    end_at(first, next_tile(first))        # its last entry is a tile's last item
    first += rng.integers(0, 41, size=30).tolist()
    long_head = [2 * tile + 1] + [1] * 40
    return [first, [0] * 12, long_head, rng.integers(0, 41, size=200).tolist()]


@pytest.mark.gpu
@pytest.mark.parametrize("reduce", ["sum", "min"])
def test_segments_kernel_path_edge_cases(cuda_device, reduce):
    """The merge path's edge cases at the kernel's tile size against the
    plain version; sum twice to the same bits."""
    from repro_torch.kernels.ell_spmv import ops as spmv
    from repro_torch.kernels.ell_spmv.ref import ell_spmv_segments_ref

    rng = np.random.default_rng(7)
    x, row_ptr, cols = _segments_from_degrees(_path_edge_degrees(spmv.TILE, rng), 97, rng)
    x[:, -1] = 0.0 if reduce == "sum" else 3e38
    args = [torch.from_numpy(a).to(cuda_device) for a in (x, row_ptr, cols)]
    got = spmv.ell_spmv_segments(*args, reduce)
    again = spmv.ell_spmv_segments(*args, reduce)
    torch.cuda.synchronize()
    want = ell_spmv_segments_ref(*args, reduce)
    if reduce == "min":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert torch.equal(got, again)
    empty = (args[1][:, 1:] - args[1][:, :-1]) == 0
    assert bool((got[empty] == float(x[0, -1])).all())


@pytest.mark.gpu
@pytest.mark.parametrize("prog,iters", [("pagerank", 30), ("cc", 20), ("sssp", 20)])
def test_analytics_on_card_matches_cpu_and_launches_per_iteration(cuda_device, prog, iters):
    import repro_torch.api as tapi
    from repro_torch.graph.generators import load_dataset
    from repro_torch.kernels.ell_spmv import ops as spmv

    web = load_dataset("web-s", seed=0)
    spec = tapi.PartitionSpec(algo="fennel", k=8, balance_mode="edge", order="random", seed=0)
    on_card = tapi.partition(web, spec, device=cuda_device)
    before = spmv.launches
    got = on_card.analytics(prog, iters, mode="simulated")
    assert spmv.launches - before == iters
    on_cpu = tapi.partition(web, spec, device="cpu")
    want = on_cpu.analytics(prog, iters, mode="simulated")
    if prog == "pagerank":
        np.testing.assert_allclose(got["values"], want["values"], rtol=1e-5, atol=1e-9)
        again = on_card.analytics(prog, iters, mode="simulated")
        np.testing.assert_array_equal(again["values"], got["values"])  # run to run
    else:
        np.testing.assert_array_equal(got["values"], want["values"])
    for key in ("halo_messages_per_iter", "padded_halo_elements_per_iter", "max_local_edges",
                "mean_local_edges"):
        assert got[key] == want[key]


# ------------------------------------------------------------ flash attention
FLASH_SHAPES = [  # tests/test_kernels.py: b, hq, hkv, tq, tk, dh, causal, window
    (1, 2, 2, 128, 128, 64, True, None),
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 2, 1, 256, 256, 32, False, None),
    (1, 2, 2, 128, 128, 64, True, 32),
    (2, 2, 2, 64, 64, 128, True, None),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py's


def _flash_case(cuda_device, dtype, b, hq, hkv, tq, tk, dh, seed, **kw):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda_device, dtype)
               for s in ((b, hq, tq, dh), (b, hkv, tk, dh), (b, hkv, tk, dh)))
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = flash_attention_ref(q, k, v, **kw)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,window", FLASH_SHAPES)
def test_flash_kernel_matches_plain_version(cuda_device, b, hq, hkv, tq, tk, dh, causal, window,
                                            dtype):
    _flash_case(cuda_device, dtype, b, hq, hkv, tq, tk, dh, tq + dh, causal=causal,
                window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("q_offset", [0, 1, 127, 128, 200])
@pytest.mark.parametrize("tq", [1, 4])
def test_flash_kernel_decode_offset_sweep(cuda_device, q_offset, tq):
    _flash_case(cuda_device, torch.float32, 2, 4, 4, tq, 256, 64, q_offset * 7 + tq,
                causal=True, q_offset=q_offset)


@pytest.mark.gpu
@pytest.mark.parametrize("tq,tk,causal,window,q_offset", [
    (4, 200, True, None, 196), (16, 77, False, None, 0), (33, 130, True, 50, 97),
    (1, 1, True, None, 0), (70, 70, True, 1, 0), (17, 300, True, 64, 283),
])
def test_flash_kernel_ragged_and_windowed(cuda_device, tq, tk, causal, window, q_offset):
    _flash_case(cuda_device, torch.float32, 1, 4, 2, tq, tk, 32, tq * 1000 + tk,
                causal=causal, window=window, q_offset=q_offset)


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,tq,q_offset", [
    (8, 2, 1, 99), (8, 2, 3, 64), (8, 2, 4, 0), (8, 2, 5, 130), (16, 2, 2, 63), (32, 8, 1, 300),
])
def test_flash_kernel_gqa_decode_rows(cuda_device, hq, hkv, tq, q_offset):
    """Short query tiles of GQA heads: g * Tq <= 16 takes the split-KV decode
    kernel (all g query heads of a KV head in one block), larger products
    take a block per head on the FMA kernel."""
    for dtype in (torch.float32, torch.bfloat16):
        _flash_case(cuda_device, dtype, 2, hq, hkv, tq, 320, 128, hq * 100 + tq, causal=True,
                    q_offset=q_offset)


@pytest.mark.gpu
def test_flash_kernel_unaligned_rows(cuda_device):
    """Key/value rows whose stride is no multiple of 16 bytes take the
    element-wise loads."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.standard_normal((1, 4, 9, 64)).astype(np.float32)).to(cuda_device)
    kv = torch.from_numpy(rng.standard_normal((2, 1, 2, 100, 65)).astype(np.float32))
    k, v = (t[..., :64] for t in kv.to(cuda_device))
    assert k.stride(2) == 65
    got = fa.flash_attention(q, k, v, causal=True, q_offset=91)
    want = flash_attention_ref(q, k.contiguous(), v.contiguous(), causal=True, q_offset=91)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_flash_kernel_reads_model_layout_in_place(cuda_device):
    """[B, T, H, Dh] tensors handed over as transposed views (no copy)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda_device)
               for s in ((2, 40, 8, 128), (2, 40, 2, 128), (2, 40, 2, 128)))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = fa.flash_attention(*views)
    assert got.transpose(1, 2).is_contiguous()  # the output is in the model's layout too
    want = flash_attention_ref(*(t.contiguous() for t in views))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def _row_rel_l2(got, want) -> float:
    """The largest relative L2 error of any (batch, head, query) row."""
    want = want.float()
    return float(((got.float() - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max())


def _tensor_core_case(cuda_device, b, hq, hkv, tq, tk, dh, seed, model_layout=False, **kw):
    """bf16 prefill on the tensor-core variant against the plain version:
    2e-2 elementwise and every row within 1e-2 relative L2 (chip_smoke.py's
    FLASH_ROW_RTOL)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rng = np.random.default_rng(seed)
    shapes = ((b, tq, hq, dh), (b, tk, hkv, dh), (b, tk, hkv, dh)) if model_layout else \
        ((b, hq, tq, dh), (b, hkv, tk, dh), (b, hkv, tk, dh))
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda_device,
                                                                           torch.bfloat16)
               for s in shapes)
    if model_layout:  # [B, T, H, Dh] handed over as transposed views, no copy
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    assert fa.kernel_variant(q.dtype, tq, hq // hkv, dh, fa.is_aligned(q, k, v)) == "wgmma_bf16"
    before = fa.launches, fa.variant_launches["wgmma_bf16"]
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fa.launches, fa.variant_launches["wgmma_bf16"]) == (before[0] + 1, before[1] + 1)
    want = flash_attention_ref(*(t.contiguous() for t in (q, k, v)), **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert _row_rel_l2(got, want) <= 1e-2
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,window", FLASH_SHAPES)
def test_tensor_core_kernel_matches_plain_version(cuda_device, b, hq, hkv, tq, tk, dh, causal,
                                                  window):
    _tensor_core_case(cuda_device, b, hq, hkv, tq, tk, dh, tq + dh, causal=causal, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("dh,tq,tk,causal,window,q_offset", [
    (32, 100, 100, True, None, 0),     # ragged Tq = Tk
    (64, 65, 129, True, None, 64),     # one row past a tile
    (128, 200, 333, True, None, 133),  # chunked prefill: q_offset > 0, Tq > 16
    (32, 17, 90, False, None, 0),      # the shortest prefill, bidirectional
    (64, 129, 129, True, 40, 0),       # a window
    (128, 300, 300, True, 100, 0),
    (32, 70, 70, True, 1, 0),          # each row sees itself only
    (64, 33, 500, True, 64, 467),      # chunked prefill under a window
    (128, 50, 1000, True, None, 950),
    (64, 40, 30, True, None, 10),      # rows past Tk see every key
])
def test_tensor_core_kernel_head_dims_ragged_and_masked(cuda_device, dh, tq, tk, causal, window,
                                                        q_offset):
    _tensor_core_case(cuda_device, 1, 4, 2, tq, tk, dh, dh * 1000 + tq + tk, causal=causal,
                      window=window, q_offset=q_offset)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [32, 64, 80, 128, 256])
def test_tensor_core_kernel_gqa_in_model_layout(cuda_device, dh):
    """g = 4 query heads a KV head, [B, T, H, Dh] read in place, the output
    written in the model's layout."""
    got = _tensor_core_case(cuda_device, 2, 8, 2, 96, 96, dh, dh, model_layout=True)
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.gpu
def test_flash_variant_counts_follow_the_dispatch(cuda_device):
    """Each variant's count moves only when the dispatch picks it: a bf16
    decode step takes the split-KV decode kernel; float32 prefill, a short
    bf16 tile and unaligned bf16 prefill rows stay on the FMA kernel."""
    from repro_torch.kernels.flash_attention import ops as fa

    def run(q, k, v, **kw):
        before = dict(fa.variant_launches)
        fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        return [n for n in fa.VARIANTS if fa.variant_launches[n] != before[n]]

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, device=cuda_device).to(dtype)

    assert run(rnd(1, 4, 64, 64), rnd(1, 2, 64, 64), rnd(1, 2, 64, 64)) == ["wgmma_bf16"]
    f32 = torch.float32
    assert run(rnd(1, 4, 64, 64, dtype=f32), rnd(1, 2, 64, 64, dtype=f32),
               rnd(1, 2, 64, 64, dtype=f32)) == ["fma"]
    assert run(rnd(2, 8, 1, 128), rnd(2, 2, 300, 128), rnd(2, 2, 300, 128),
               q_offset=299) == ["decode_split"]
    assert run(rnd(1, 4, 16, 32), rnd(1, 2, 64, 32), rnd(1, 2, 64, 32)) == ["fma_short"]
    kv = rnd(2, 1, 2, 100, 68)
    k, v = kv[0, ..., :64], kv[1, ..., :64]  # rows of 136 bytes
    assert not fa.is_aligned(k)
    assert run(rnd(1, 4, 40, 64), k, v) == ["fma"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hq,tq,variant", [
    (torch.float32, 1, 1, "decode_split"), (torch.bfloat16, 1, 1, "decode_split"),
    (torch.float32, 1, 17, "fma"), (torch.float32, 2, 16, "fma_short"),
    (torch.bfloat16, 2, 16, "fma_short")])
def test_flash_kernel_past_the_grid_y_cap(cuda_device, dtype, hq, tq, variant):
    """65,536 batches, one more than grid y holds, with Hkv = 1 and Tk = Tq:
    q [65536, 1, 1, 32] on the decode kernel (one split a block), Tq = 17 on
    the FMA kernel's 64-row tiling (65,536 head blocks on grid x) and Hq = 2
    at Tq = 16 on its 16-row tiling (131,072)."""
    from repro_torch.kernels.flash_attention import ops as fa

    assert fa.kernel_variant(dtype, tq, hq, 32, True) == variant
    before = fa.variant_launches[variant]
    _flash_case(cuda_device, dtype, 65536, hq, 1, tq, tq, 32, 65536 + tq, causal=True)
    assert fa.variant_launches[variant] == before + 1


@pytest.mark.gpu
def test_tensor_core_kernel_past_the_grid_y_cap(cuda_device):
    """65,536 (batch, head) blocks on the tensor-core variant (Tq = 17)."""
    _tensor_core_case(cuda_device, 65536, 1, 1, 17, 17, 32, 17)


# ------------------------------------------------- split-KV decode (decode_split)
def _decode_case(cuda_device, dtype, b, hq, hkv, tq, tk, dh, seed, model_layout=False,
                 unaligned=False, expect_split=None, **kw):
    """One call of the decode kernel against its plain version: one wrapper
    launch of ``decode_split``; float32 within 2e-5, bf16 within 2e-2
    elementwise and every row within 1e-2 relative L2 (chip_smoke.py's
    gates)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rng = np.random.default_rng(seed)
    width = dh + 3 if unaligned else dh  # rows of dh + 3 elements: no 16-byte alignment

    def make(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device,
                                                                                  dtype)
    q = make((b, hq, tq, dh))
    if model_layout:  # the model's [B, S, Hkv, Dh] cache, transposed, no copy
        k, v = (make((b, tk, hkv, width))[..., :dh].transpose(1, 2) for _ in range(2))
    else:
        k, v = (make((b, hkv, tk, width))[..., :dh] for _ in range(2))
    assert fa.kernel_variant(dtype, tq, hq // hkv, dh, fa.is_aligned(q, k, v)) == "decode_split"
    assert fa.is_aligned(k, v) != unaligned
    before = fa.launches, fa.variant_launches["decode_split"], dict(fa.split_launches)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fa.launches, fa.variant_launches["decode_split"]) == (before[0] + 1, before[1] + 1)
    ran = [n for n, c in fa.split_launches.items() if c != before[2].get(n, 0)]
    assert len(ran) == 1
    n_split = ran[0]  # the split count the launch used
    assert n_split == fa.decode_splits(
        b, hkv, tk, fa.sm_count(q.device),
        fa.decode_blocks_per_sm(q.device, dtype, dh, hq // hkv * tq))
    if expect_split is not None:
        assert expect_split(n_split), n_split
    want = flash_attention_ref(q, k.contiguous(), v.contiguous(), **kw)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _row_rel_l2(got, want) <= 1e-2
    return n_split


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("b,hq,hkv,tq,tk", [
    (2, 8, 2, 1, 4096),    # B * Hkv = 4: the cache splits
    (2, 32, 8, 1, 32768),  # qwen3-8b's heads, B * Hkv = 16, 32k cache
    (1, 16, 1, 1, 4096),   # g * Tq = 16 rows
    (3, 6, 2, 1, 5000),    # g = 3 (a row capacity of 4, one row unused); ragged Tk
])
def test_decode_kernel_splits_long_caches(cuda_device, b, hq, hkv, tq, tk, dh, dtype):
    _decode_case(cuda_device, dtype, b, hq, hkv, tq, tk, dh, b * tk + dh, causal=True,
                 q_offset=tk - 1, expect_split=lambda n: n > 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("hq,hkv,tq", [(2, 2, 1), (4, 2, 1), (8, 2, 1), (8, 2, 2), (16, 1, 1)])
def test_decode_kernel_every_row_capacity(cuda_device, hq, hkv, tq, dh, dtype):
    """g * Tq = 1, 2, 4, 8 and 16 rows: each compiled instance of the decode
    kernel (row capacity x Dh x dtype; float32 at Dh = 128 and one row has
    the largest ring, 221 KB) over a ragged cache it splits."""
    _decode_case(cuda_device, dtype, 2, hq, hkv, tq, 2100, dh, hq * tq + dh, causal=True,
                 q_offset=2099, expect_split=lambda n: n > 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,causal,window,q_offset", [
    (1, 4000, True, None, 3999),   # Tk not a multiple of 64
    (1, 4096, True, 40, 4095),     # a window narrower than a tile
    (1, 4096, True, 1500, 4095),   # a window across split boundaries
    (2, 4096, True, 700, 3000),    # rows in the middle of the cache
    (1, 4096, True, None, 100),    # q_offset far below Tk: whole splits empty
    (4, 4096, True, None, 5000),   # q_offset >= Tk: every key visible
    (1, 4096, False, None, 0),     # bidirectional
    (4, 2048, True, 33, 2040),     # g * Tq = 16 under a window
    (1, 1, True, None, 0),         # Tk = 1
])
def test_decode_kernel_masks_and_offsets(cuda_device, tq, tk, causal, window, q_offset, dtype):
    _decode_case(cuda_device, dtype, 2, 8, 2, tq, tk, 64, tq * 1000 + tk + q_offset,
                 causal=causal, window=window, q_offset=q_offset)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 80, 128, 256])
def test_decode_kernel_unaligned_rows(cuda_device, dh, dtype):
    """K/V rows that are not 16-byte aligned take the same variant's element
    loads, with and without a split."""
    for tk in (300, 4096):
        _decode_case(cuda_device, dtype, 2, 8, 2, 1, tk, dh, tk + dh, unaligned=True,
                     causal=True, q_offset=tk - 1)


# every variant at head dims 80 (hubert-xlarge) and 256 (gemma3-12b), with the
# slice-14 shapes: bidirectional Tq != Tk (cross-attention over 1,024 image
# tokens), the sliding window, and a ring cache read past its length
# (causal, q_offset >= Tk: every slot counts)
NEW_DIM_CASES = [  # variant, dtype, b, hq, hkv, tq, tk, causal, window, q_offset
    ("fma", torch.float32, 1, 4, 2, 100, 150, True, None, 50),
    ("fma", torch.float32, 1, 8, 2, 64, 1024, False, None, 0),
    ("fma", torch.float32, 1, 4, 2, 70, 300, True, 64, 230),
    ("fma_short", torch.float32, 1, 8, 2, 8, 1024, False, None, 0),
    ("fma_short", torch.bfloat16, 2, 16, 2, 16, 200, True, 40, 184),
    ("decode_split", torch.float32, 2, 16, 8, 1, 1024, True, None, 2000),
    ("decode_split", torch.bfloat16, 8, 16, 8, 1, 1024, True, None, 8195),
    ("decode_split", torch.bfloat16, 2, 16, 2, 1, 1024, False, None, 0),
    ("decode_split", torch.bfloat16, 1, 8, 8, 1, 1024, True, None, 500),
    ("wgmma_bf16", torch.bfloat16, 1, 4, 2, 200, 333, True, 64, 133),
    ("wgmma_bf16", torch.bfloat16, 1, 8, 2, 300, 1024, False, None, 0),
    ("wgmma_bf16", torch.bfloat16, 2, 4, 4, 150, 150, False, None, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [80, 256])
@pytest.mark.parametrize("variant,dtype,b,hq,hkv,tq,tk,causal,window,q_offset", NEW_DIM_CASES)
def test_flash_kernel_at_the_new_head_dims(cuda_device, dh, variant, dtype, b, hq, hkv, tq, tk,
                                          causal, window, q_offset):
    """Each variant at Dh 80 and 256 against ``flash_attention_ref``, in
    the model's layout (transposed views, as the model hands them over)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rng = np.random.default_rng(dh * 100 + tq + tk)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda_device, dtype)
               .transpose(1, 2) for s in ((b, tq, hq, dh), (b, tk, hkv, dh), (b, tk, hkv, dh)))
    assert fa.kernel_variant(dtype, tq, hq // hkv, dh, fa.is_aligned(q, k, v)) == variant
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = dict(fa.variant_launches)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {n: fa.variant_launches[n] - before[n] for n in fa.VARIANTS} == \
        {n: int(n == variant) for n in fa.VARIANTS}
    want = flash_attention_ref(*(t.contiguous() for t in (q, k, v)), **kw)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _row_rel_l2(got, want) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_reads_the_model_cache_in_place(cuda_device, dtype):
    """The model's [B, S, Hkv, Dh] cache as a transposed view, a split cache."""
    _decode_case(cuda_device, dtype, 2, 32, 8, 1, 8192, 128, 8192, model_layout=True,
                 causal=True, q_offset=8000, expect_split=lambda n: n > 1)


@pytest.mark.gpu
def test_decode_split_counts_one_launch_per_call(cuda_device):
    """The serve loop's short cache runs one share (no merge); a 32k cache at
    B = 8 runs several and merges them; each wrapper call counts one launch
    of decode_split and no other variant."""
    from repro_torch.kernels.flash_attention import ops as fa

    for tk in (160, 32768):
        q = torch.randn(8, 32, 1, 128, device=cuda_device).bfloat16()
        k = torch.randn(8, 8, tk, 128, device=cuda_device).bfloat16()
        fa.reset()
        fa.flash_attention(q, k, k, causal=True, q_offset=tk - 1)
        torch.cuda.synchronize()
        assert fa.variant_launches == {n: int(n == "decode_split") for n in fa.VARIANTS}
        assert fa.launches == 1
        assert len(fa.split_launches) == 1 and sum(fa.split_launches.values()) == 1
        n_split = next(iter(fa.split_launches))
        assert n_split == 1 if tk == 160 else n_split > 1



# ------------------------------------------------------------------ MLA pairs
# every instance built at MLA's (Dqk, Dv) pairs: variant, dtype, (dqk, dv), b,
# hq, hkv, tq, tk, causal, q_offset, latent (v the first Dv columns of a
# [B, S, Dqk] latent buffer, Hkv = 1, as the absorbed decode reads its cache;
# otherwise the model's prefill layout, v a view of a wider kv tensor)
MLA_CASES = [
    ("wgmma_bf16", torch.bfloat16, (192, 128), 1, 4, 4, 200, 200, True, 0, False),
    ("wgmma_bf16", torch.bfloat16, (192, 128), 2, 8, 8, 130, 333, True, 203, False),
    ("wgmma_bf16", torch.bfloat16, (192, 128), 1, 2, 2, 70, 90, False, 0, False),
    ("fma", torch.float32, (192, 128), 1, 4, 4, 100, 100, True, 0, False),
    ("fma", torch.float32, (192, 128), 2, 2, 2, 65, 200, True, 135, False),
    ("fma", torch.float32, (48, 32), 2, 4, 4, 24, 24, True, 0, False),
    ("fma", torch.bfloat16, (48, 32), 2, 4, 4, 40, 40, True, 0, False),
    ("decode_latent", torch.bfloat16, (192, 128), 1, 4, 4, 16, 16, True, 0, False),
    ("decode_latent", torch.float32, (192, 128), 2, 8, 8, 7, 40, True, 33, False),
    ("decode_latent", torch.float32, (192, 128), 1, 4, 4, 1, 1, True, 0, False),
    ("decode_latent", torch.float32, (576, 512), 2, 128, 1, 1, 160, True, 159, True),
    ("latent_wgmma", torch.bfloat16, (576, 512), 8, 128, 1, 1, 160, True, 100, True),
    ("decode_latent", torch.float32, (576, 512), 1, 128, 1, 1, 8192, True, 5000, True),
    ("latent_wgmma", torch.bfloat16, (576, 512), 2, 128, 1, 1, 8192, True, 8191, True),
    # latent_wgmma: a ragged last tile (4,097 keys), one key at pos 0
    ("latent_wgmma", torch.bfloat16, (576, 512), 1, 128, 1, 1, 4097, True, 4096, True),
    ("latent_wgmma", torch.bfloat16, (576, 512), 2, 128, 1, 1, 1, True, 0, True),
    # latent_wgmma's rows mixing heads and query rows: 60 (a ragged row
    # tile) and 128 (16 rows a head, each with its own causal limit)
    ("latent_wgmma", torch.bfloat16, (576, 512), 2, 20, 1, 3, 300, True, 250, True),
    ("latent_wgmma", torch.bfloat16, (576, 512), 1, 8, 1, 16, 1000, True, 984, True),
    ("decode_latent", torch.float32, (48, 32), 2, 4, 1, 1, 8192, True, 8191, True),
    ("decode_latent", torch.bfloat16, (48, 32), 3, 4, 1, 1, 300, True, 17, True),
]


def _mla_inputs(cuda_device, dtype, pair, b, hq, hkv, tq, tk, latent, seed):
    dqk, dv = pair
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device,
                                                                                 dtype)

    q = randn(b, tq, hq, dqk).transpose(1, 2)
    if latent:
        buf = randn(b, tk, dqk)
        return q, buf[:, None], buf[:, None, :, :dv]
    kv = randn(b, tk, hkv, 2 * dv)
    return q, randn(b, tk, hkv, dqk).transpose(1, 2), kv[..., dv:].transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("variant,dtype,pair,b,hq,hkv,tq,tk,causal,q_offset,latent", MLA_CASES)
def test_flash_kernel_at_the_mla_pairs(cuda_device, variant, dtype, pair, b, hq, hkv, tq, tk,
                                       causal, q_offset, latent):
    """Each variant built at an MLA pair against ``flash_attention_ref``
    (Dqk^-0.5 scale, a [B, Hq, Tq, Dv] output), with the inputs as the model
    hands them over: no copy of the strided value."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = _mla_inputs(cuda_device, dtype, pair, b, hq, hkv, tq, tk, latent,
                          sum(pair) + tq + tk)
    assert fa.kernel_variant(dtype, tq, hq // hkv, pair[0], fa.is_aligned(q, k, v),
                             pair[1]) == variant
    kw = dict(causal=causal, q_offset=q_offset)
    fa.reset()
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.variant_launches == {n: int(n == variant) for n in fa.VARIANTS}
    assert got.shape == (b, hq, tq, pair[1])
    if variant in ("decode_latent", "latent_wgmma") and tk >= 8192:  # a long cache is split
        assert list(fa.split_launches) != [1]
    want = flash_attention_ref(q, k, v, **kw)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _row_rel_l2(got, want) <= 1e-2


@pytest.mark.gpu
def test_flash_kernel_refuses_what_the_mla_library_lacks(cuda_device):
    """A pair that is not built, and a variant that its pair lacks, raise
    before any launch."""
    from repro_torch.kernels.flash_attention import ops as fa

    fa.reset()
    q = torch.randn(1, 2, 32, 96, device=cuda_device)
    with pytest.raises(ValueError, match="pairs"):
        fa.flash_attention(q, q, q[..., :64])
    q = torch.randn(1, 2, 32, 576, device=cuda_device).bfloat16()  # Tq = 32: no prefill there
    with pytest.raises(ValueError, match="not built"):
        fa.flash_attention(q, q, q[..., :512])
    assert fa.launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_flash_decode_on_card_matches_cpu(cuda_device, dtype):
    """The absorbed decode at deepseek-v2-236b's widths (128 heads, r = 512,
    rope 64) over the model's latent cache (one [B, S, 576] buffer, ``ckv``
    and ``kpe`` its views) against the same call on the CPU, at pos 0, 1, the
    middle and the last slot; one launch each, of ``latent_wgmma`` in bf16
    and of ``decode_latent`` in float32."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.attention import mla_flash_decode

    variant = "latent_wgmma" if dtype == torch.bfloat16 else "decode_latent"
    rng = np.random.default_rng(7)
    b, s, h, r, rope = 4, 2048, 128, 512, 64
    ql, qp = (torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32)).to(dtype)
              for d in (r, rope))
    buf = torch.from_numpy(rng.standard_normal((b, s, r + rope)).astype(np.float32)).to(dtype)
    dbuf = buf.to(cuda_device)
    for pos in (0, 1, s // 2, s - 1):
        fa.reset()
        got = mla_flash_decode(ql.to(cuda_device), qp.to(cuda_device), dbuf[..., :r],
                               dbuf[..., r:], pos)
        torch.cuda.synchronize()
        assert fa.variant_launches == {n: int(n == variant) for n in fa.VARIANTS}
        want = mla_flash_decode(ql, qp, buf[..., :r], buf[..., r:], pos)
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["offset_view", "own_value"])
def test_latent_decode_without_the_tensor_core_layout(cuda_device, layout):
    """bf16 at (576, 512) that ``latent_wgmma`` cannot read: a latent buffer
    one element off 16 bytes (v still its view), or a value that is not a
    view of the key. Both take ``decode_latent`` and agree with the plain
    version at the bf16 tolerances."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    b, hq, tk, pos = 2, 128, 300, 250
    rng = np.random.default_rng(11)

    def randn(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda_device,
                                                                              torch.bfloat16)

    q = randn(b * hq * 576).view(b, hq, 1, 576)
    if layout == "offset_view":
        k = randn(b * tk * 576 + 1)[1:].view(b, tk, 576)[:, None]
        v = k[..., :512]
    else:
        k = randn(b * tk * 576).view(b, 1, tk, 576)
        v = randn(b * tk * 512).view(b, 1, tk, 512)
    assert fa.is_aligned(q, k, v) == (layout == "own_value")
    assert fa.value_in_key(k, v) == (layout == "offset_view")
    fa.reset()
    got = fa.flash_attention(q, k, v, causal=True, q_offset=pos)
    torch.cuda.synchronize()
    assert fa.variant_launches == {n: int(n == "decode_latent") for n in fa.VARIANTS}
    want = flash_attention_ref(q, k, v, causal=True, q_offset=pos)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _row_rel_l2(got, want) <= 1e-2

# --------------------------------------------------------------- mamba scan
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,t,d,n", [(1, 16, 64, 8), (2, 32, 128, 16), (2, 8, 512, 16),
                                       (1, 200, 1000, 16), (3, 1, 24, 8)])
def test_scan_kernel_matches_plain_version(cuda_device, bsz, t, d, n, dtype):
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

    rng = np.random.default_rng(d + t)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)  # noqa: E731
    x = f32(rng.standard_normal((bsz, t, d))).to(dtype)
    dt = f32(np.abs(rng.standard_normal((bsz, t, d))) * 0.1 + 0.01).to(dtype)
    a = f32(-np.abs(rng.standard_normal((d, n))) - 0.1)
    b = f32(rng.standard_normal((bsz, t, n))).to(dtype)
    c = f32(rng.standard_normal((bsz, t, n))).to(dtype)
    d_skip = f32(rng.standard_normal(d))
    before = scan.launches
    y, h = scan.selective_scan(x, dt, a, b, c, d_skip)
    torch.cuda.synchronize()
    assert scan.launches == before + 1
    y_want, h_want = selective_scan_ref(x, dt, a, b, c, d_skip)
    tol = 1e-4 if dtype == torch.float32 else 3e-2  # tests/test_kernels.py's
    torch.testing.assert_close(y.float(), y_want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_want, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("t,d", [(1, 96), (200, 96), (200, 30), (8192, 64)])
def test_scan_kernel_time_lengths(cuda_device, t, d, n, dtype):
    """T = 1, T = 200 (not a multiple of the kernel's chunk) and T = 8192 at
    a reduced width; D = 96 leaves a part-filled channel block and D = 30
    rows that are not 16-byte aligned. T = 8192 runs the model's
    A = -(1..N) at ``chip_smoke.py``'s SCAN_LAYER_TOL (1e-3 in float32: each
    rounding is carried over the state's decay horizon); the rest random A
    at ``tests/test_kernels.py``'s tolerances."""
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

    rng = np.random.default_rng(t + d + n)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)  # noqa: E731
    x = f32(rng.standard_normal((2, t, d))).to(dtype)
    dt = f32(np.abs(rng.standard_normal((2, t, d))) * 0.1 + 0.01).to(dtype)
    if t == 8192:
        a = -torch.arange(1, n + 1, dtype=torch.float32, device=cuda_device).expand(d, n)
        a = a.contiguous()
    else:
        a = f32(-np.abs(rng.standard_normal((d, n))) - 0.1)
    b = f32(rng.standard_normal((2, t, n))).to(dtype)
    c = f32(rng.standard_normal((2, t, n))).to(dtype)
    d_skip = f32(rng.standard_normal(d))
    y, h = scan.selective_scan(x, dt, a, b, c, d_skip)
    torch.cuda.synchronize()
    y_want, h_want = selective_scan_ref(x, dt, a, b, c, d_skip)
    tol = (1e-3 if t == 8192 else 1e-4) if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(y.float(), y_want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_want, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_scan_kernel_past_the_grid_y_cap(cuda_device):
    """Batch 65,536, one more row than grid y holds, at the smallest width
    (D = 1, N = 8)."""
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

    bsz, t, d, n = 65536, 3, 1, 8
    rng = np.random.default_rng(65536)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)  # noqa: E731
    args = (f32(rng.standard_normal((bsz, t, d))),
            f32(np.abs(rng.standard_normal((bsz, t, d))) * 0.1 + 0.01),
            f32(-np.abs(rng.standard_normal((d, n))) - 0.1),
            f32(rng.standard_normal((bsz, t, n))), f32(rng.standard_normal((bsz, t, n))),
            f32(rng.standard_normal(d)))
    before = scan.launches
    y, h = scan.selective_scan(*args)
    torch.cuda.synchronize()
    assert scan.launches == before + 1
    y_want, h_want = selective_scan_ref(*args)
    torch.testing.assert_close(y, y_want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, h_want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ models
def _params_to(tree, device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_params_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b"])
def test_reduced_model_on_card_matches_cpu(cuda_device, arch):
    """float32, the same weights on both devices: prefill logits within
    1e-4, decode logits within 1e-4, greedy tokens equal; each forward
    launches one kernel per mixer layer."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    cpu = Model(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    card = Model(cfg, cuda_device)
    dparams = _params_to(params, card.device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)))
    counts = fa.launches, scan.launches
    got, _ = card.forward(dparams, {"tokens": toks.to(card.device)})
    torch.cuda.synchronize()
    launched = fa.launches - counts[0], scan.launches - counts[1]
    assert launched == ((cfg.num_layers, 0) if arch == "qwen3-8b" else (0, cfg.num_layers))
    want, _ = cpu.forward(params, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    prompts = toks[:, :8]
    g_card, _ = serve(card, dparams, prompts.to(card.device), 6)
    g_cpu, _ = serve(cpu, params, prompts, 6)
    assert torch.equal(g_card.cpu(), g_cpu)


# ---------------------------------------------------------- graph serving
def _sim_report(rep) -> dict:
    d = rep.to_dict()
    for key in ("wall_s", "qps_wall"):
        d.pop(key)
    d["latency_ms"] = {"sim": d["latency_ms"]["sim"]}
    return d


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["fennel", "cuttana", "hdrf"])
def test_served_partition_on_card_matches_cpu(cuda_device, algo):
    """A partition made on the card serves the same report (sim floats,
    counters, replication) and answers as the one made on the CPU; the
    gather entry launches once per ``kernel_calls``."""
    import repro_torch.api as tapi
    from repro_torch.serve.graph import QueryMix, build_workload, run_load

    g = rmat_graph(6000, avg_degree=12, seed=1)
    fields = dict(algo=algo, k=8, seed=0)
    if algo != "hdrf":
        fields.update(balance_mode="edge", order="random")
    ops.reset()
    on_card = tapi.partition(g, tapi.PartitionSpec(**fields), device=cuda_device)
    torch.cuda.synchronize()
    assert ops.launches == on_card.telemetry.get("kernel_calls", 0)
    if algo == "fennel":
        assert ops.launches > 0
    on_cpu = tapi.partition(g, tapi.PartitionSpec(**fields), device="cpu")
    np.testing.assert_array_equal(on_card.vertex_assignment(), on_cpu.vertex_assignment())
    workload = build_workload(g, 400, QueryMix(), seed=1)
    reports = [run_load(r.serve(replication_budget=0.05, max_workers=w), workload=workload,
                        concurrency=100) for r, w in ((on_card, 0), (on_cpu, 1))]
    assert _sim_report(reports[0]) == _sim_report(reports[1])
    a, b = reports[0].answers(), reports[1].answers()
    assert set(a) == set(b)
    for qid, want in b.items():
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(a[qid], want)
        else:
            assert a[qid] == want
    assert on_card.db(hops=2) == on_cpu.db(hops=2)


@pytest.mark.gpu
def test_cli_partition_on_card_matches_cpu(cuda_device, tmp_path):
    """``repro_torch.api.cli partition --device cuda`` gives the CPU run's
    report (quality, DB study, analytics model) and assignment, with the
    kernel's launches."""
    import json

    from repro_torch.api.cli import main

    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"algo": "fennel", "k": 8, "balance_mode": "edge",
                                "order": "random", "seed": 0}))
    reports = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.json"
        ops.reset()
        assert main(["partition", "--spec", str(spec), "--rmat", "8000", "--avg-degree", "12",
                     "--with-db", "--with-analytics", "--device", dev, "--out", str(out),
                     "--assignment-out", str(tmp_path / dev)]) == 0
        reports[dev] = (json.loads(out.read_text()), ops.launches)
    (card, launches), (cpu, cpu_launches) = reports["cuda"], reports["cpu"]
    assert card["device"].startswith("cuda") and cpu["device"] == "cpu"
    assert launches == card["telemetry"]["kernel_calls"] == 16 and cpu_launches == 0
    for key in ("spec", "graph", "quality", "analytics", "db"):
        assert card[key] == cpu[key], key
    np.testing.assert_array_equal(np.load(card["assignment_path"]),
                                  np.load(cpu["assignment_path"]))


# ------------------------------------------------- gradients (training slice)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # relative L2 per tensor


def _rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_flash_kernel_gradient_matches_plain_autograd(cuda_device, dtype, dh, causal, window):
    """The kernel forward under autograd carries the plain version's
    gradient: output within the kernel's tolerance, every input's gradient
    within ``GRAD_TOL`` of plain autograd on the card, one launch."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rng = np.random.default_rng(dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda_device, dtype)
               .requires_grad_(True) for s in ((2, 4, 160, dh), (2, 2, 160, dh), (2, 2, 160, dh)))
    grad_out = torch.from_numpy(rng.standard_normal((2, 4, 160, dh)).astype(np.float32)) \
        .to(cuda_device, dtype)
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), grad_out)
    assert fa.launches == before + 1  # the backward launches nothing
    want_out = flash_attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(want_out, (q, k, v), grad_out)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol, atol=tol)
    for g, w in zip(got, want):
        assert g.dtype == dtype and _rel_l2(g, w) <= GRAD_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_gradient_matches_plain_autograd(cuda_device, dtype):
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

    rng = np.random.default_rng(5)
    bsz, t, d, n = 2, 64, 96, 16

    def leaf(shape, dt, scale=1.0):
        arr = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(arr).to(cuda_device, dt).requires_grad_(True)

    x = leaf((bsz, t, d), dtype)
    dt = torch.nn.functional.softplus(leaf((bsz, t, d), torch.float32)).to(dtype)
    a = -torch.exp(leaf((d, n), torch.float32, 0.5))
    b, c = leaf((bsz, t, n), dtype), leaf((bsz, t, n), dtype)
    d_skip = leaf((d,), torch.float32)
    inputs = (x, dt, a, b, c, d_skip)
    before = scan.launches
    y, h = scan.selective_scan(*inputs)
    assert scan.launches == before + 1 and y.grad_fn is not None and h.grad_fn is not None
    weights = torch.linspace(-1, 1, d, device=cuda_device)
    got = torch.autograd.grad((y.float() * weights).sum() + h.sum(), inputs)
    wy, wh = selective_scan_ref(*inputs)
    want = torch.autograd.grad((wy.float() * weights).sum() + wh.sum(), inputs)
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= GRAD_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("remat_policy", [None, "dots", "nothing"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b"])
def test_card_outputs_under_grad_carry_a_gradient(cuda_device, arch, remat_policy):
    """The fault this slice repaired: every weight of a reduced model gets a
    gradient on the card, equal to the CPU's within 1e-4 relative L2
    (float32), with and without remat (the kernel launched again inside a
    checkpointed layer), and a forward without grad carries none."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import Model
    from repro_torch.train.pytree import tree_flatten, tree_unflatten
    from repro_torch.train.step import make_loss_fn

    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    cpu = Model(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    if remat_policy is not None:
        cfg = dataclasses.replace(cfg, remat=True, remat_policy=remat_policy)
    card = Model(cfg, cuda_device)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 33))
    grads = []
    for model, p in ((card, _params_to(params, card.device)), (cpu, params)):
        leaves, treedef = tree_flatten(p)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(model.device),
                 "labels": torch.from_numpy(toks[:, 1:]).to(model.device)}
        loss, _ = make_loss_fn(model)(tree_unflatten(treedef, leaves), batch)
        grads.append([g.cpu() for g in torch.autograd.grad(loss, leaves)])
    for g, w in zip(*grads):
        assert _rel_l2(g, w) <= 1e-4
    with torch.no_grad():
        out, _ = card.forward(_params_to(params, card.device),
                              {"tokens": torch.from_numpy(toks).to(card.device)})
    assert out.grad_fn is None


@pytest.mark.gpu
def test_sharded_analytics_on_card_equals_simulated(cuda_device):
    """Two gloo ranks on the card (one card: NCCL takes a rank a card), the
    halo staged through pinned host buffers: the simulated values, one
    kernel launch and one all-to-all a rank an iteration."""
    import repro_torch.api as tapi
    from repro_torch.analytics import PROGRAMS, GraphEngine
    from repro_torch.graph.generators import load_dataset

    web = load_dataset("web-s", seed=0)
    res = tapi.partition(web, tapi.PartitionSpec(algo="fennel", k=2, balance_mode="edge",
                                                 order="random", seed=0), device=cuda_device)
    lg = res.localized()
    for prog, iters in (("pagerank", 10), ("cc", 12)):
        eng = GraphEngine(lg, PROGRAMS[prog](), device=cuda_device)
        with pytest.raises(ValueError, match='backend="gloo"'):
            eng.run_sharded(iters)  # NCCL on one card
        got = eng.run_sharded(iters, backend="gloo")
        want = eng.run_simulated(iters)
        if prog == "pagerank":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got, want)
        (run,) = eng.exchange["runs"]
        assert eng.exchange["route"] == "gloo_pinned_host"
        assert run["spmv_launches"] == [iters] * 2 and run["all_to_all_calls"] == [iters] * 2
        assert run["elements_sent_per_iter"] == eng.stats(iters).padded_halo_elements_per_iter
        assert run["staged_bytes"] == [2 * 4 * 2 * lg.h_max * iters] * 2


@pytest.mark.gpu
def test_train_launcher_steps_on_card(cuda_device, tmp_path):
    """Three steps of the train driver on the card (reduced qwen3-8b, bf16):
    finite losses, one attention launch a layer a step, the last step's
    checkpoint."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import train as train_mod
    from repro_torch.train.checkpoint import latest_step

    history = []
    before = fa.launches
    loss = train_mod.main(["--arch", "reduced:qwen3-8b", "--steps", "3", "--global-batch", "4",
                           "--seq-len", "64", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                           "--log-every", "1", "--lr", "1e-3"], history)
    assert fa.launches - before == 3 * 2  # 2 layers, no remat
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in history) and np.isfinite(loss)
    assert latest_step(str(tmp_path)) == 3


# --------------------------------- MoE families, minitron-8b, deepseek-coder-33b
def _record_expert_ids(monkeypatch):
    """Every MoE layer's chosen expert ids, in call order, on the CPU."""
    from repro_torch.models import layers

    chosen, top_k = [], layers.top_k

    def recording(probs, k):
        vals, idx = top_k(probs, k)
        chosen.append(idx.cpu())
        return vals, idx

    monkeypatch.setattr(layers, "top_k", recording)
    return chosen


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "arctic-480b", "deepseek-coder-33b",
                                  "minitron-8b", "deepseek-v2-236b"])
def test_reduced_family_on_card_matches_cpu(cuda_device, arch, monkeypatch):
    """float32, the same weights on both devices: logits and the router loss
    within 1e-4, every MoE layer's expert ids equal, greedy tokens equal;
    the forward launches one kernel per attention and per Mamba layer
    (deepseek-v2-236b: MLA's prefill at (48, 32), its dense prefix layer,
    then the absorbed decode on ``decode_latent`` in the serve loop)."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    cpu = Model(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    card = Model(cfg, cuda_device)
    dparams = _params_to(params, card.device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)))
    chosen = _record_expert_ids(monkeypatch)
    counts = fa.launches, scan.launches
    got, got_aux = card.forward(dparams, {"tokens": toks.to(card.device)})
    torch.cuda.synchronize()
    launched = fa.launches - counts[0], scan.launches - counts[1]
    assert launched == (sum(s.mixer == "attn" for s in cfg.layers()),
                        sum(s.mixer == "mamba" for s in cfg.layers()))
    on_card = list(chosen)
    chosen.clear()
    want, want_aux = cpu.forward(params, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=1e-4, atol=1e-12)
    assert len(on_card) == len(chosen) == sum(s.ffn in ("moe", "moe_dense")
                                              for s in cfg.layers())
    for a, b in zip(on_card, chosen):
        assert torch.equal(a, b)
    prompts = toks[:, :8]
    g_card, _ = serve(card, dparams, prompts.to(card.device), 6)
    g_cpu, _ = serve(cpu, params, prompts, 6)
    assert torch.equal(g_card.cpu(), g_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("b,tq,tk", [(1, 256, 256), (2, 333, 333), (1, 64, 200)])
def test_tensor_core_kernel_at_seven_query_heads_a_kv_head(cuda_device, b, tq, tk):
    """g = 7 (arctic-480b and deepseek-coder-33b: 56 query heads, 8 KV
    heads) on the tensor-core prefill variant, in the model's layout."""
    got = _tensor_core_case(cuda_device, b, 56, 8, tq, tk, 128, tq + tk, model_layout=True,
                            causal=True, q_offset=tk - tq)
    assert got.shape == (b, 56, tq, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,tk", [(8, 160), (8, 8192), (1, 32768)])
def test_decode_kernel_at_seven_query_heads_a_kv_head(cuda_device, dtype, b, tk):
    """g = 7 decode rows (a row capacity of 8, one row unused) over the
    model's cache in place: the serve loop's 160 keys, an 8,192 cache and a
    32k cache at B=1 (which splits)."""
    _decode_case(cuda_device, dtype, b, 56, 8, 1, tk, 128, b * tk + 7, model_layout=True,
                 causal=True, q_offset=tk - 1)


@pytest.mark.gpu
def test_reduced_jamba_train_step_on_card_matches_cpu(cuda_device):
    """One train step of reduced jamba-v0.1-52b (float32) on the card: the
    scan's and attention's autograd Functions with the MoE in one backward;
    loss, router loss and grad norm within 1e-4 of the CPU port, both
    moments (the clipped gradients) within 1e-4 relative L2."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.models import Model
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.pytree import tree_leaves
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_reduced_config("jamba-v0.1-52b"), dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 33))
    outs = []
    for device in (cuda_device, torch.device("cpu")):
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(device),
                 "labels": torch.from_numpy(toks[:, 1:]).to(device)}
        p = _params_to(params, device)
        counts = fa.launches, scan.launches
        step = make_train_step(Model(cfg, device), warmup=1, total_steps=10)
        _, opt, metrics = step(p, adamw_init(p), batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert (fa.launches - counts[0], scan.launches - counts[1]) == (2, 14)
        outs.append(({k: float(v) for k, v in metrics.items()},
                     [t.cpu() for t in tree_leaves((opt.m, opt.v))]))
    (m_card, s_card), (m_cpu, s_cpu) = outs
    assert m_cpu["aux"] > 0
    for key in ("loss", "ce", "aux", "grad_norm"):
        assert m_card[key] == pytest.approx(m_cpu[key], rel=1e-4), key
    for a, b in zip(s_card, s_cpu):
        assert _rel_l2(a, b) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,cap", [(1, 512, 160), (4, 1, 1)])
def test_bf16_moe_layer_on_card_matches_cpu(cuda_device, b, s, cap, monkeypatch):
    """One bf16 MoE layer (reduced arctic-480b's experts) on both devices
    from the same bf16 inputs: the same expert ids, and outputs within the
    bf16 ulp of their magnitude (both devices multiply float32 copies of the
    bf16 weights), at a prefill capacity and at the serve loop's cap = 1."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import Model
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_reduced_config("arctic-480b"), dtype="bfloat16")
    assert layers.moe_capacity(b * s, cfg) == cap
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(3))["layers"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((b, s, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    chosen = _record_expert_ids(monkeypatch)
    got, got_aux = layers.moe_ffn(x.to(cuda_device), _params_to(params, cuda_device), cfg)
    want, want_aux = layers.moe_ffn(x, params, cfg)
    assert len(chosen) == 2 and torch.equal(chosen[0], chosen[1])
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=1e-5, atol=1e-7)
