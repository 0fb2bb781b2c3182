"""The graph-DB study of the PyTorch port against ``repro.db``: the LDBC-like
query mix, the ``QueryEngine``'s answers, counters and cost-model floats,
and ``PartitionResult.db``, compared with ``==`` (paper §IV-B, Table V).
Sizes are ``tests/test_db.py``'s."""
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro_torch.api as tapi
from repro.db import engine as rengine
from repro.db import ldbc_query_mix as ref_mix
from repro.graph import generators as rgen
from repro_torch.db import QueryEngine, QueryStats, engine as tengine, ldbc_query_mix
from repro_torch.graph import generators as tgen

CPU = torch.device("cpu")
SPEC = dict(algo="cuttana", k=4, seed=0)


@pytest.fixture(scope="module")
def graphs():
    rg = rgen.ldbc_like_graph(4000, avg_degree=14, seed=0)
    tg = tgen.ldbc_like_graph(4000, avg_degree=14, seed=0)
    assert tg.indices.tobytes() == rg.indices.tobytes()
    return rg, tg


@pytest.fixture(scope="module")
def results(graphs):
    rg, tg = graphs
    want = rapi.partition(rg, rapi.PartitionSpec(**SPEC))
    got = tapi.partition(tg, tapi.PartitionSpec(**SPEC), device="cpu")
    np.testing.assert_array_equal(got.assignment, want.assignment)
    return want, got


def _stats_equal(got, want):
    for field in ("num_queries", "hops", "total_scanned_edges", "total_rpcs",
                  "total_net_values"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("per_worker_cpu", "per_worker_net", "latencies_s", "per_worker_busy_s"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("degree_biased", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 17])
def test_ldbc_query_mix_equal(graphs, degree_biased, seed):
    rg, tg = graphs
    want = ref_mix(rg, 300, seed=seed, degree_biased=degree_biased)
    got = ldbc_query_mix(tg, 300, seed=seed, degree_biased=degree_biased)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hops,fanout_cap", [(1, 64), (2, 64), (2, 3)])
@pytest.mark.parametrize("mix_seed", [1, 2])
def test_query_engine_equal(graphs, results, hops, fanout_cap, mix_seed):
    """Results per query, totals, per-worker work and traffic, busy times
    and latencies: every value, every float."""
    rg, tg = graphs
    part = results[0].assignment
    seeds = ref_mix(rg, 120, seed=mix_seed)
    ref_eng = rengine.QueryEngine(rg, part, 4)
    eng = QueryEngine(tg, part, 4)
    if hops == 1:
        want_res, want = ref_eng.one_hop(seeds)
        got_res, got = eng.one_hop(seeds)
    else:
        want_res, want = ref_eng.two_hop(seeds, fanout_cap=fanout_cap)
        got_res, got = eng.two_hop(seeds, fanout_cap=fanout_cap)
    assert len(got_res) == len(want_res) == 120
    for a, b in zip(got_res, want_res):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _stats_equal(got, want)
    for s, r in zip(seeds, got_res):  # tests/test_db.py's invariants
        one = tg.neighbors(int(s))
        assert np.isin(one, r).all()
        if hops == 1:
            np.testing.assert_array_equal(np.sort(r), np.sort(one))
    for c in (24, 1, 256):
        assert got.throughput_qps(c) == want.throughput_qps(c)
    assert got.p99_latency_s() == want.p99_latency_s()


def test_throughput_without_busy_times_equal():
    """Stats built without the cost model reconstruct the busy times from
    the defaults, as the reference does."""
    rng = np.random.default_rng(5)
    fields = dict(
        num_queries=100, hops=1, total_scanned_edges=0, total_rpcs=0,
        total_net_values=0, per_worker_cpu=rng.random(3) * 1e7,
        per_worker_net=rng.random(3) * 1e4, latencies_s=rng.random(100) * 1e-3,
    )
    want = rengine.QueryStats(**fields)
    got = QueryStats(**fields)
    for c in (1, 2, 24, 10**6):
        assert got.throughput_qps(c) == want.throughput_qps(c)
    assert got.p99_latency_s() == want.p99_latency_s()
    empty = dict(fields, num_queries=0)
    assert QueryStats(**empty).throughput_qps() == rengine.QueryStats(**empty).throughput_qps() == 0.0
    assert tengine.DBCostModel() == tengine.DBCostModel(**vars(rengine.DBCostModel()))


def test_throughput_two_resource_bounds():
    """tests/test_serving.py's bounds on the port's QueryStats: concurrency
    scales the client bound only, the busiest worker caps it."""
    lat = np.full(100, 0.01)
    st = QueryStats(
        num_queries=100, hops=1, total_scanned_edges=0, total_rpcs=0,
        total_net_values=0, per_worker_cpu=np.zeros(2),
        per_worker_net=np.zeros(2), latencies_s=lat,
        per_worker_busy_s=np.array([0.2, 0.05]),
    )
    assert st.throughput_qps(concurrency=1) == pytest.approx(100.0)
    assert st.throughput_qps(concurrency=1000) == pytest.approx(500.0)
    qs = [st.throughput_qps(c) for c in (1, 2, 8, 32, 128, 1024)]
    assert all(a <= b + 1e-9 for a, b in zip(qs, qs[1:]))


@pytest.mark.parametrize("hops", [1, 2])
@pytest.mark.parametrize("how", ["seeds", "drawn", "uniform"])
def test_result_db_equal(graphs, results, hops, how):
    rg, _ = graphs
    want_res, got_res = results
    if how == "seeds":
        seeds = ref_mix(rg, 64, seed=9)
        want = want_res.db(hops=hops, seeds=seeds)
        got = got_res.db(hops=hops, seeds=seeds)
        assert got["num_queries"] == 64
    elif how == "drawn":
        want = want_res.db(hops=hops, num_queries=100, seed=3, concurrency=8)
        got = got_res.db(hops=hops, num_queries=100, seed=3, concurrency=8)
    else:
        want = want_res.db(hops=hops, num_queries=80, degree_biased=False)
        got = got_res.db(hops=hops, num_queries=80, degree_biased=False)
    assert got == want
    assert list(got) == list(want)


def test_result_db_vertex_cut_equal(graphs):
    """A vertex-cut result runs the study on its replica masters."""
    rg, tg = graphs
    want = rapi.partition(rg, rapi.PartitionSpec(algo="hdrf", k=4, seed=0))
    got = tapi.partition(tg, tapi.PartitionSpec(algo="hdrf", k=4, seed=0), device="cpu")
    np.testing.assert_array_equal(got.vertex_assignment(), want.vertex_assignment())
    for hops in (1, 2):
        assert got.db(hops=hops, num_queries=64) == want.db(hops=hops, num_queries=64)


def test_single_partition_no_rpcs(graphs):
    rg, tg = graphs
    part = np.zeros(tg.num_vertices, dtype=np.int32)
    seeds = ldbc_query_mix(tg, 25, seed=4)
    _, got = QueryEngine(tg, part, 1).two_hop(seeds)
    _, want = rengine.QueryEngine(rg, part, 1).two_hop(seeds)
    assert got.total_rpcs == got.total_net_values == 0
    _stats_equal(got, want)


@pytest.mark.parametrize("kwargs", [{"workload": "x"}, {"hops": 3}, {"hops": 0}])
def test_db_errors_equal(results, kwargs):
    want_res, got_res = results
    with pytest.raises(ValueError) as want:
        want_res.db(**kwargs)
    with pytest.raises(ValueError) as got:
        got_res.db(**kwargs)
    assert str(got.value) == str(want.value)
