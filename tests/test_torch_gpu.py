"""The partition-score CUDA kernel (sequential and sharded entries) and the
gather/reduce CUDA kernel (segment and ELL entries) against their plain
PyTorch versions on the card, and the partitioners and the analytics engine
on the card against the same runs on the CPU. A CUDA kernel has no CPU mode, so these
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
