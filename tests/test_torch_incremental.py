"""Churn streams and the incremental partitioner of the PyTorch port against
``repro.graph.churn`` / ``repro.core.incremental`` on the CPU: the same
streams and ``.npz`` files, the same per-batch bookkeeping and assignments,
the device mirror through re-stream windows, and the churn suite's committed
edge cut reproduced by the port alone."""
import numpy as np
import pytest
import torch

import repro.core.incremental as rinc
import repro.graph.churn as rchurn
import repro_torch.api as tapi
from repro.core import fennel as ref_fennel
from repro.graph.csr import CSRGraph as RefCSR
from repro.graph.generators import rmat_graph
from repro_torch.convert import graph_from_arrays
from repro_torch.core import engine as tengine
from repro_torch.core import fennel
from repro_torch.core import incremental as tinc
from repro_torch.graph import churn as tchurn
from repro_torch.graph.metrics import quality_report

CPU = torch.device("cpu")
K = 8
# BENCH_partition.json churn/rmat25000/incremental (benchmarks/churn.py)
CHURN_EDGE_CUT = 0.7724772058256066


@pytest.fixture(scope="module")
def graphs():
    """R-MAT plus a path so no vertex is isolated (the one-batch parity pin
    needs every vertex in the edge stream)."""
    g0 = rmat_graph(3000, avg_degree=8, seed=1)
    path = np.stack([np.arange(g0.num_vertices - 1), np.arange(1, g0.num_vertices)], axis=1)
    rg = RefCSR.from_edges(np.concatenate([g0.edges_array(), path]), num_vertices=g0.num_vertices)
    return rg, graph_from_arrays(rg.indptr, rg.indices, CPU)


def _same_stream(a, b):
    np.testing.assert_array_equal(a.edges, b.edges)
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    assert a.num_vertices == b.num_vertices


# -------------------------------------------------------------- ChurnStream
@pytest.mark.parametrize("ordering", ["growth", "random"])
def test_rmat_churn_matches_reference(ordering):
    want = rchurn.rmat_churn(1500, avg_degree=8, seed=5, ordering=ordering)
    got = tchurn.rmat_churn(1500, avg_degree=8, seed=5, ordering=ordering)
    _same_stream(got, want)
    for n in (1, 7, 20):
        for g, w in zip(got.batches(n), want.batches(n)):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(got.windows(300.0), want.windows(300.0)):
        np.testing.assert_array_equal(g, w)
    fg, fw = got.final_graph(), want.final_graph()
    np.testing.assert_array_equal(fg.indptr, fw.indptr)
    np.testing.assert_array_equal(fg.indices, fw.indices)


@pytest.mark.parametrize("order", ["natural", "random", "bfs", "dfs"])
def test_churn_from_graph_matches_reference(graphs, order):
    rg, tg = graphs
    _same_stream(tchurn.churn_from_graph(tg, order, seed=2),
                 rchurn.churn_from_graph(rg, order, seed=2))


def test_from_edges_canonicalizes_like_reference():
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 50, size=(400, 2))
    ts = rng.random(400).round(1)
    for kw in ({}, {"timestamps": ts}, {"timestamps": ts, "num_vertices": 60}):
        _same_stream(tchurn.ChurnStream.from_edges(edges, **kw),
                     rchurn.ChurnStream.from_edges(edges, **kw))
    with pytest.raises(ValueError, match="out of range"):
        tchurn.ChurnStream.from_edges(edges, num_vertices=10)
    with pytest.raises(ValueError, match="num_batches"):
        tchurn.ChurnStream.from_edges(edges).batches(0)


def test_save_in_one_package_load_in_the_other(tmp_path):
    want = rchurn.rmat_churn(800, avg_degree=6, seed=3)
    got = tchurn.rmat_churn(800, avg_degree=6, seed=3)
    want.save(tmp_path / "ref.npz")
    got.save(tmp_path / "port.npz")
    _same_stream(tchurn.ChurnStream.load(tmp_path / "ref.npz"), want)
    _same_stream(rchurn.ChurnStream.load(tmp_path / "port.npz"), got)


# ---------------------------------------------------------------- ingesting
@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("balance_mode", ["vertex", "edge"])
def test_ingest_bookkeeping_matches_reference(balance_mode, num_shards):
    """Per-batch return values, counters and the live state after every
    batch; a low drift threshold makes re-stream windows fire."""
    st = rchurn.rmat_churn(2500, avg_degree=10, seed=9, ordering="random")
    kw = dict(balance_mode=balance_mode, seed=9, drift_threshold=0.02, num_shards=num_shards)
    want = rinc.IncrementalPartitioner(st.num_vertices, K, **kw)
    got = tinc.IncrementalPartitioner(st.num_vertices, K, device=CPU, **kw)
    for batch in st.batches(8):
        assert got.ingest(batch) == want.ingest(batch)
        np.testing.assert_array_equal(got.state.part_of, want.state.part_of)
        np.testing.assert_array_equal(got.state.part_of_dev.numpy(), got.state.part_of)
        np.testing.assert_array_equal(got.state.e_counts, want.state.e_counts)
        assert got.state.num_vertices == want.state.num_vertices
    assert want.restream_windows > 0
    np.testing.assert_array_equal(got.finalize(), want.finalize())
    np.testing.assert_array_equal(got.state.part_of_dev.numpy(), got.state.part_of)
    assert got.telemetry() == want.telemetry()


@pytest.mark.parametrize("num_shards", [1, 2])
def test_mirror_equals_part_of_before_every_launch(monkeypatch, num_shards):
    """Re-stream windows and the live-load writes between batches: before
    every partition-score launch the device mirror equals the host state."""
    checks = []
    seq = tengine.StreamEngine.chunk_histograms
    sharded = tengine._SuperstepRunner._histograms

    def seq_checked(self, *args):
        checks.append(np.array_equal(self.state.part_of_dev.numpy(), self.state.part_of))
        return seq(self, *args)

    def sharded_checked(self, *args):
        st = self.eng.state
        checks.append(np.array_equal(st.part_of_dev.numpy(), st.part_of))
        return sharded(self, *args)

    monkeypatch.setattr(tengine.StreamEngine, "chunk_histograms", seq_checked)
    monkeypatch.setattr(tengine._SuperstepRunner, "_histograms", sharded_checked)
    st = tchurn.rmat_churn(2500, avg_degree=10, seed=9, ordering="random")
    inc = tinc.IncrementalPartitioner(st.num_vertices, K, seed=9, drift_threshold=0.02,
                                      num_shards=num_shards, device=CPU)
    for batch in st.batches(8):
        inc.ingest(batch)
    assert inc.restream_windows > 0
    assert len(checks) == inc.kernel_calls > 0
    assert all(checks)


@pytest.mark.parametrize("balance_mode", ["vertex", "edge"])
@pytest.mark.parametrize("order", ["natural", "random", "bfs", "dfs"])
def test_single_batch_equals_one_shot_fennel(graphs, order, balance_mode):
    """The reference's parity pin, in the port: one arrival batch is the
    one-shot ``fennel`` run; and both equal the reference's."""
    rg, tg = graphs
    got = tinc.partition_incremental(tg, K, balance_mode=balance_mode, order=order, seed=3,
                                     num_batches=1, device=CPU)
    base = fennel.partition(tg, K, balance_mode=balance_mode, order=order, seed=3, device=CPU)
    np.testing.assert_array_equal(got, base)
    np.testing.assert_array_equal(
        got, ref_fennel.partition(rg, K, balance_mode=balance_mode, order=order, seed=3))


@pytest.mark.parametrize("num_shards", [1, 4])
def test_partition_incremental_matches_reference(graphs, num_shards):
    rg, tg = graphs
    kw = dict(balance_mode="edge", order="random", seed=5, num_batches=6, num_shards=num_shards,
              drift_threshold=0.02)
    rt, tt = {}, {}
    want = rinc.partition_incremental(rg, K, telemetry=rt, **kw)
    got = tinc.partition_incremental(tg, K, telemetry=tt, device=CPU, **kw)
    np.testing.assert_array_equal(got, want)
    rt.pop("stream_seconds"), tt.pop("stream_seconds")
    assert tt == rt


def test_update_warm_start_matches_reference():
    st = rchurn.rmat_churn(2000, avg_degree=8, seed=5)
    half = st.num_edges // 2
    first = rchurn.ChurnStream.from_edges(st.edges[:half], num_vertices=st.num_vertices)
    rest = rchurn.ChurnStream.from_edges(st.edges[half:], num_vertices=st.num_vertices)
    t_first = tchurn.ChurnStream.from_edges(st.edges[:half], num_vertices=st.num_vertices)
    t_rest = tchurn.ChurnStream.from_edges(st.edges[half:], num_vertices=st.num_vertices)
    want_cold = rinc.update(None, first, k=4)
    got_cold = tinc.update(None, t_first, k=4, device=CPU)
    np.testing.assert_array_equal(got_cold.assignment, want_cold.assignment)
    want = rinc.update(want_cold, rest)
    got = tinc.update(got_cold, t_rest)
    assert isinstance(got, tapi.PartitionResult) and got.device == CPU
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.spec.to_json() == want.spec.to_json()
    assert got.telemetry["warm_start"] is True
    for key in ("batches", "new_vertices", "moved_vertices", "edge_cut_live", "kernel_calls"):
        assert got.telemetry[key] == want.telemetry[key], key
    assert got.quality() == want.quality()
    with pytest.raises(ValueError, match="needs k"):
        tinc.update(None, [np.array([[0, 1]])], device=CPU)


def test_churn_suite_edge_cut_reproduced():
    """``benchmarks/churn.py``'s incremental row, port only: rmat_churn(25000,
    avg_degree=16, seed=7, ordering="random") in 20 batches, k=8, edge."""
    stream = tchurn.rmat_churn(25_000, avg_degree=16, seed=7, ordering="random")
    inc = tinc.IncrementalPartitioner(stream.num_vertices, K, balance_mode="edge", seed=7,
                                      device=CPU)
    for batch in stream.batches(20):
        inc.ingest(batch)
    part = inc.finalize()
    assert quality_report(stream.final_graph(), part, K, CPU)["edge_cut"] == CHURN_EDGE_CUT
