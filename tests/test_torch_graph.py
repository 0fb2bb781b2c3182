"""Graph layer of the PyTorch port against the reference: generators,
stream orders, quality metrics and the array converters."""
import numpy as np
import pytest
import torch

from repro.graph import generators as rgen
from repro.graph.metrics import quality_report as ref_quality_report
from repro.graph.stream import stream_order as ref_stream_order
from repro_torch.convert import graph_from_arrays, state_from_arrays
from repro_torch.graph import generators as tgen
from repro_torch.graph.metrics import quality_report
from repro_torch.graph.stream import stream_order

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["social-s", "web-s", "road-s", "ldbc-s"])
def test_datasets_byte_identical(name):
    want = rgen.load_dataset(name, seed=0)
    got = tgen.load_dataset(name, seed=0)
    assert got.indptr.dtype == np.int64 and got.indices.dtype == np.int32
    assert got.indptr.tobytes() == want.indptr.tobytes()
    assert got.indices.tobytes() == want.indices.tobytes()


@pytest.mark.parametrize(
    "gen,kwargs",
    [
        ("rmat_graph", dict(num_vertices=1200, avg_degree=10, seed=3)),
        ("powerlaw_cluster_graph", dict(num_vertices=900, avg_degree=8, seed=4)),
        ("road_graph", dict(num_vertices=777, seed=5, rewire=0.05)),
        ("ldbc_like_graph", dict(num_vertices=3000, avg_degree=12, seed=6)),
    ],
)
def test_generators_byte_identical(gen, kwargs):
    want = getattr(rgen, gen)(**kwargs)
    got = getattr(tgen, gen)(**kwargs)
    assert got.indptr.tobytes() == want.indptr.tobytes()
    assert got.indices.tobytes() == want.indices.tobytes()


@pytest.mark.parametrize("order", ["natural", "random", "bfs", "dfs"])
def test_stream_orders_identical(order):
    rg = rgen.powerlaw_cluster_graph(900, avg_degree=8, seed=4)
    tg = graph_from_arrays(rg.indptr, rg.indices, CPU)
    for seed in (0, 11):
        want = ref_stream_order(rg, order, seed)
        got = stream_order(tg, order, seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 8, 33])
def test_quality_report_matches_reference(k):
    rg = rgen.rmat_graph(3000, avg_degree=12, seed=1)
    tg = graph_from_arrays(rg.indptr, rg.indices, CPU)
    part = np.random.default_rng(k).integers(0, k, size=rg.num_vertices).astype(np.int32)
    want = ref_quality_report(rg, part, k)
    got = quality_report(tg, part, k, CPU)
    assert got["k"] == want["k"]
    assert got["edge_cut"] == want["edge_cut"]
    assert got["comm_volume"] == want["comm_volume"]
    for key in ("vertex_imbalance", "edge_imbalance"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=0)


def test_quality_report_rejects_bad_assignments():
    tg = tgen.rmat_graph(100, avg_degree=4, seed=0)
    with pytest.raises(ValueError, match="shape"):
        quality_report(tg, np.zeros(99, np.int32), 2, CPU)
    with pytest.raises(ValueError, match="invalid partition ids"):
        quality_report(tg, np.full(100, 2, np.int32), 2, CPU)


def test_graph_from_arrays_round_trip():
    rg = rgen.rmat_graph(500, avg_degree=6, seed=2)
    tg = graph_from_arrays(rg.indptr, rg.indices, CPU)
    assert tg.indptr.tobytes() == rg.indptr.tobytes()
    assert tg.indices.tobytes() == rg.indices.tobytes()
    assert tg.indptr is not rg.indptr  # the port holds its own copy
    dev = tg.to(CPU)
    assert dev.indptr.dtype == torch.int64 and dev.indices.dtype == torch.int32
    np.testing.assert_array_equal(dev.indptr.numpy(), rg.indptr)
    np.testing.assert_array_equal(dev.indices.numpy(), rg.indices)
    np.testing.assert_array_equal(dev.sources().numpy(), np.repeat(np.arange(500), rg.degrees))
    assert tg.to("cpu") is dev  # placed once per device
    with pytest.raises(ValueError, match="rise"):
        graph_from_arrays(rg.indptr[::-1], rg.indices, CPU)
    with pytest.raises(ValueError, match="vertex ids"):
        graph_from_arrays(rg.indptr, rg.indices + 1000, CPU)


def test_state_from_arrays_round_trip():
    from repro.core.base import PartitionState as RefState

    rg = rgen.rmat_graph(400, avg_degree=6, seed=2)
    ref = RefState.create(rg, 4, 0.05, "edge", seed=9)
    rng = np.random.default_rng(0)
    for v in rng.permutation(rg.num_vertices)[:250]:
        ref.assign(int(v), int(rng.integers(4)), rg.degree(int(v)))
    state = state_from_arrays(
        ref.part_of, ref.v_counts, ref.e_counts, k=4, epsilon=0.05,
        balance_mode="edge", seed=9, total_degree=ref.total_degree, device=CPU,
    )
    np.testing.assert_array_equal(state.part_of, ref.part_of)
    np.testing.assert_array_equal(state.part_of_dev.numpy(), ref.part_of)
    np.testing.assert_array_equal(state.v_counts, ref.v_counts)
    np.testing.assert_array_equal(state.e_counts, ref.e_counts)
    assert state.edge_capacity == ref.edge_capacity
    assert state.vertex_capacity == ref.vertex_capacity
    # same tie-break stream as a fresh reference state with the same seed
    assert state.rng.integers(1 << 30) == np.random.default_rng(9).integers(1 << 30)
    # the mirror is a copy: a host write shows only after a sync
    state.part_of[0] = 3 - max(int(state.part_of[0]), 0)
    assert int(state.part_of_dev[0]) != int(state.part_of[0])
    state.sync_mirror()
    assert int(state.part_of_dev[0]) == int(state.part_of[0])
    with pytest.raises(ValueError, match="ids in"):
        state_from_arrays(
            np.full(5, 7), np.zeros(4), np.zeros(4), k=4, epsilon=0.05,
            balance_mode="edge", seed=0, total_degree=10, device=CPU,
        )


@pytest.mark.parametrize("num_vertices,avg_degree", [(600, 2), (1500, 6)])
def test_degree_matches_reference(num_vertices, avg_degree):
    """``CSRGraph.degree(v)`` (the router's point query) equals the
    reference's on every vertex, isolated vertices included."""
    want = rgen.rmat_graph(num_vertices, avg_degree=avg_degree, seed=1)
    got = tgen.rmat_graph(num_vertices, avg_degree=avg_degree, seed=1)
    degs = [got.degree(v) for v in range(got.num_vertices)]
    assert degs == [want.degree(v) for v in range(want.num_vertices)]
    assert all(type(d) is int for d in degs)
    assert 0 in degs  # isolated vertices are covered
    assert degs == got.degrees.tolist()
