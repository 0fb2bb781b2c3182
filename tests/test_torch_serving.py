"""Partition-aware graph serving of the PyTorch port against
``repro.serve.graph``: workloads, replication plans, the router's answers,
counters and sim floats (``qps_sim``, sim quantiles and histogram) compared
with ``==`` across partitioners, worker counts, replication budgets,
scheduling jitter and both arrival disciplines; the wall clock is the only
thing left out. On ``tests/test_serving.py``'s fixture (R-MAT 600, degree
10, seed 3; a 120-query workload, seed 4). The last test reproduces
``BENCH_partition.json``'s ``serving/rmat8000/*`` rows with the port alone.
"""
import json
import random
from pathlib import Path

import numpy as np
import pytest

import repro.api as rapi
import repro.serve.graph as rsg
import repro_torch.api as tapi
import repro_torch.serve.graph as tsg
from repro.core import executor as rexecutor
from repro.graph import generators as rgen
from repro.graph.csr import CSRGraph as RefCSRGraph
from repro.serve.graph import replication as rrepl
from repro.serve.graph import router as rrouter
from repro_torch.core import executor
from repro_torch.db import QueryEngine
from repro_torch.graph import generators as tgen
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.metrics import quality_report
from repro_torch.serve.graph import replication as trepl

ROOT = Path(__file__).resolve().parents[1]
ALGOS = ("cuttana", "fennel", "hdrf", "random")
WALL = ("wall_s", "qps_wall")


def _spec_fields(algo, k, seed=3):
    if algo in ("random", "hdrf"):
        return dict(algo=algo, k=k, seed=seed)
    return dict(algo=algo, k=k, balance_mode="edge", order="random", seed=seed)


@pytest.fixture(scope="module")
def graphs():
    rg = rgen.rmat_graph(600, avg_degree=10, seed=3)
    tg = tgen.rmat_graph(600, avg_degree=10, seed=3)
    assert tg.indices.tobytes() == rg.indices.tobytes()
    return rg, tg


@pytest.fixture(scope="module")
def workload(graphs):
    rg, tg = graphs
    want = rsg.build_workload(rg, 120, rsg.QueryMix(), seed=4)
    got = tsg.build_workload(tg, 120, tsg.QueryMix(), seed=4)
    assert got == want
    return got


@pytest.fixture(scope="module")
def results(graphs):
    """``(reference, port)`` results per (algo, k), made once."""
    rg, tg = graphs
    cache = {}

    def get(algo, k=4):
        if (algo, k) not in cache:
            fields = _spec_fields(algo, k)
            want = rapi.partition(rg, rapi.PartitionSpec(**fields))
            got = tapi.partition(tg, tapi.PartitionSpec(**fields), device="cpu")
            np.testing.assert_array_equal(got.vertex_assignment(), want.vertex_assignment())
            cache[(algo, k)] = (want, got)
        return cache[(algo, k)]

    return get


def _sim_dict(rep) -> dict:
    d = rep.to_dict()
    for key in WALL:
        d.pop(key)
    d["latency_ms"] = {"sim": d["latency_ms"]["sim"]}
    return d


def _records(rep) -> list:
    return [(r.qid, r.kind, r.seed, r.master, r.sim_s, r.rounds, r.rpcs, r.wire_bytes,
             r.scanned_edges) for r in rep.records]


def _same_answers(got, want):
    a, b = got.answers(), want.answers()
    assert set(a) == set(b)
    for qid, vb in b.items():
        va = a[qid]
        if isinstance(vb, np.ndarray):
            assert isinstance(va, np.ndarray) and va.dtype == vb.dtype, qid
            np.testing.assert_array_equal(va, vb, err_msg=f"qid={qid}")
        else:
            assert type(va) is type(vb) and va == vb, f"qid={qid}"


def _assert_reports_equal(got, want):
    assert _sim_dict(got) == _sim_dict(want)
    assert set(got.latency_ms["wall"]) == set(want.latency_ms["wall"])
    assert _records(got) == _records(want)
    _same_answers(got, want)


# ---------------------------------------------------------------- workloads
@pytest.mark.parametrize("seed", [0, 4, 7])
@pytest.mark.parametrize("degree_biased", [True, False])
@pytest.mark.parametrize("mix", ["point=0.2,one_hop=0.4,two_hop=0.4", "point=1.0,one_hop=0,two_hop=0",
                                 "point=0,one_hop=0.5,two_hop=0.5"])
def test_build_workload_equal(graphs, seed, degree_biased, mix):
    rg, tg = graphs
    want = rsg.build_workload(rg, 50, rsg.QueryMix.parse(mix), seed=seed,
                              degree_biased=degree_biased)
    got = tsg.build_workload(tg, 50, tsg.QueryMix.parse(mix), seed=seed,
                             degree_biased=degree_biased)
    assert got == want
    assert all(type(k) is str and type(s) is int for k, s in got)


# -------------------------------------------------------------- replication
@pytest.mark.parametrize("budget", [0.0, 0.05, 25, 10**6])
@pytest.mark.parametrize("algo", ["cuttana", "hdrf"])
def test_plan_replication_equal(graphs, results, budget, algo):
    rg, tg = graphs
    want_res, got_res = results(algo)
    part = got_res.vertex_assignment()
    want = rrepl.plan_replication(rg, part, 4, budget)
    got = trepl.plan_replication(tg, part, 4, budget)
    assert got.k == want.k and got.budget_pairs == want.budget_pairs
    for field in ("vertices", "partitions", "demand"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got.stats() == want.stats()
    for p in range(4):
        np.testing.assert_array_equal(got.replicas_into(p), want.replicas_into(p))
    if budget:
        assert got.num_replicas > 0
        assert np.all(part[got.vertices] != got.partitions)


def test_plan_replication_degenerate_equal(graphs):
    """k=1, and a graph whose assignment cuts no edge: empty plans."""
    rg, tg = graphs
    ones = np.zeros(tg.num_vertices, dtype=np.int64)
    assert trepl.plan_replication(tg, ones, 1, 0.5).stats() == \
        rrepl.plan_replication(rg, ones, 1, 0.5).stats()
    edges = np.array([[0, 1], [1, 2], [3, 4]])
    rsmall = RefCSRGraph.from_edges(edges, num_vertices=6)
    tsmall = CSRGraph.from_edges(edges, num_vertices=6)
    part = np.array([0, 0, 0, 1, 1, 1])
    got = trepl.plan_replication(tsmall, part, 2, 10)
    assert got.num_replicas == 0 and got.budget_pairs == 10
    assert got.stats() == rrepl.plan_replication(rsmall, part, 2, 10).stats()


@pytest.mark.parametrize("budget,n", [(0.0, 1000), (0.25, 1000), (40, 1000), (0.999, 7),
                                      (1.0, 7), (-0.5, 10)])
def test_resolve_budget_equal(budget, n):
    if budget < 0:
        with pytest.raises(ValueError) as want:
            rrepl.resolve_budget(budget, n)
        with pytest.raises(ValueError) as got:
            trepl.resolve_budget(budget, n)
        assert str(got.value) == str(want.value)
    else:
        assert trepl.resolve_budget(budget, n) == rrepl.resolve_budget(budget, n)


# ------------------------------------------------------------ router parity
@pytest.mark.parametrize("budget", [0.0, 0.05])
@pytest.mark.parametrize("workers", [1, 2, 0])
@pytest.mark.parametrize("algo", ALGOS)
def test_report_equal(workload, results, algo, workers, budget):
    want_res, got_res = results(algo)
    want = rsg.run_load(want_res.serve(replication_budget=budget, max_workers=workers),
                        workload=workload, concurrency=16)
    got = tsg.run_load(got_res.serve(replication_budget=budget, max_workers=workers),
                       workload=workload, concurrency=16)
    _assert_reports_equal(got, want)
    assert got.num_queries == 120 and got.rpcs > 0
    assert (got.replication["num_replicas"] > 0) == (budget > 0)


def test_report_equal_k2_and_store_results_off(graphs, workload, results):
    want_res, got_res = results("cuttana", 2)
    want = rsg.run_load(want_res.serve(store_results=False), workload=workload, concurrency=7)
    got = tsg.run_load(got_res.serve(store_results=False), workload=workload, concurrency=7)
    assert _sim_dict(got) == _sim_dict(want)
    assert all(r.result is None for r in got.records)


def test_answers_under_jitter_equal_synchronous(workload, results):
    """The port's own ``executor.JITTER`` sleeps on every routed message:
    answers and every counter equal the synchronous run's (and the
    reference's)."""
    want_res, got_res = results("cuttana")
    sync = tsg.run_load(got_res.serve(max_workers=1), workload=workload, concurrency=16)
    assert rexecutor.JITTER is None
    executor.JITTER = random.Random(0xBADBEEF)
    try:
        jit = tsg.run_load(got_res.serve(max_workers=8), workload=workload, concurrency=16)
    finally:
        executor.JITTER = None
    _assert_reports_equal(jit, sync)
    want = rsg.run_load(want_res.serve(max_workers=1), workload=workload, concurrency=16)
    _assert_reports_equal(jit, want)


def test_threaded_stress_equal_synchronous(workload, results):
    """k=8 striped over 8 threads (more than this host's cores) with a short
    switch interval: a lost counter update or a record dropped between
    threads would change the report."""
    import sys

    _, got_res = results("fennel", 8)
    sync = tsg.run_load(got_res.serve(max_workers=1), workload=workload, concurrency=64)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reps = [tsg.run_load(got_res.serve(max_workers=8), workload=workload, concurrency=64)
                for _ in range(3)]
    finally:
        sys.setswitchinterval(old)
    for rep in reps:
        _assert_reports_equal(rep, sync)


def test_open_loop_equal(graphs, results):
    want_res, got_res = results("cuttana")
    kw = dict(num_queries=60, concurrency=8, seed=5, mode="open", rate_qps=5000.0)
    want = rsg.run_load(want_res.serve(), **kw)
    got = tsg.run_load(got_res.serve(), **kw)
    assert got.mode == "open" and got.num_queries == 60
    assert got.kind_counts == want.kind_counts
    assert (got.rpcs, got.messages, got.wire_bytes, got.scanned_edges, got.local_queries) == (
        want.rpcs, want.messages, want.wire_bytes, want.scanned_edges, want.local_queries)
    _assert_reports_equal(got, want)
    with pytest.raises(ValueError, match="rate_qps"):
        tsg.run_load(got_res.serve(), num_queries=4, mode="open")


def test_answers_match_db_engine(graphs, workload, results):
    """point == degree; one_hop/two_hop equal the port's QueryEngine."""
    _, tg = graphs
    _, got_res = results("cuttana")
    rep = tsg.run_load(got_res.serve(max_workers=1), workload=workload, concurrency=16)
    engine = QueryEngine(tg, got_res.vertex_assignment(), 4)
    answers = rep.answers()
    for qid, (kind, seed) in enumerate(workload):
        got = answers[qid]
        if kind == "point":
            assert got == tg.degree(seed)
        elif kind == "one_hop":
            (want,), _ = engine.one_hop(np.array([seed]))
            np.testing.assert_array_equal(got, want.astype(np.int64))
        else:
            (want,), _ = engine.two_hop(np.array([seed]))
            np.testing.assert_array_equal(got, want)


def test_replication_reduces_rpcs_at_fixed_answers(workload, results):
    _, got_res = results("cuttana")
    base = tsg.run_load(got_res.serve(), workload=workload, concurrency=16)
    repl = tsg.run_load(got_res.serve(replication_budget=0.1), workload=workload,
                        concurrency=16)
    _same_answers(repl, base)
    assert repl.rpcs < base.rpcs and repl.wire_bytes < base.wire_bytes


def test_result_serve_uses_spec_budget(graphs):
    _, tg = graphs
    res = tapi.partition(tg, tapi.PartitionSpec(
        algo="cuttana", k=4, replication_budget=0.1, balance_mode="edge",
        order="random", seed=3), device="cpu")
    assert res.serve().replication_stats()["num_replicas"] > 0
    assert res.serve(replication_budget=0.0).replication_stats()["num_replicas"] == 0


def test_serve_bench_equal(graphs, results):
    want_res, got_res = results("fennel")
    kw = dict(num_queries=90, concurrency=12, mix="point=0.1,one_hop=0.3,two_hop=0.6",
              seed=2, replication_budget=0.05)
    want = want_res.serve_bench(**kw)
    got = got_res.serve_bench(**kw)
    json.dumps(got)
    for d in (want, got):
        for key in WALL:
            d.pop(key)
        d["latency_ms"].pop("wall")
    assert got == want


# ----------------------------------------------------------- errors and api
@pytest.mark.parametrize("args", [
    dict(point=0.5, one_hop=0.5, two_hop=0.5),
    dict(point=-0.1, one_hop=0.6, two_hop=0.5),
    "pnt=1.0",
    "point=0.3",
])
def test_query_mix_errors_equal(args):
    def build(mod):
        return mod.QueryMix(**args) if isinstance(args, dict) else mod.QueryMix.parse(args)

    with pytest.raises(ValueError) as want:
        build(rsg)
    with pytest.raises(ValueError) as got:
        build(tsg)
    assert str(got.value) == str(want.value)
    assert tsg.QueryMix.parse("point=0.5,one_hop=0.25,two_hop=0.25") == tsg.QueryMix(0.5, 0.25, 0.25)


@pytest.mark.parametrize("case", ["kind", "seed_high", "seed_low", "not_running",
                                  "mode", "assignment", "k"])
def test_service_errors_equal(graphs, results, case):
    rg, tg = graphs
    want_res, got_res = results("cuttana")

    def attempt(mod, graph, res):
        part = res.vertex_assignment()
        if case == "assignment":
            return mod.GraphService(graph, part[:-1], 4)
        if case == "k":
            return mod.GraphService(graph, part, 0)
        svc = mod.GraphService(graph, part, 4, max_workers=1)
        if case == "not_running":
            return svc.submit("point", 0)
        if case == "mode":
            load = rsg.run_load if mod is rrouter else tsg.run_load
            return load(svc, num_queries=3, mode="burst")
        with svc:
            if case == "kind":
                svc.submit("three_hop", 0)
            elif case == "seed_high":
                svc.submit("point", graph.num_vertices)
            else:
                svc.submit("one_hop", -1)

    with pytest.raises((ValueError, RuntimeError)) as want:
        attempt(rrouter, rg, want_res)
    with pytest.raises((ValueError, RuntimeError)) as got:
        attempt(tsg.router, tg, got_res)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_serve_namespace_lazy():
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import repro_torch.serve as s\n"
        "import repro_torch.serve.graph as sg\n"
        "assert 'repro_torch.serve.lm' not in sys.modules\n"
        "assert not [m for m in sys.modules if m.startswith('repro_torch.models')]\n"
        "assert hasattr(sg, 'GraphService') and hasattr(sg, 'run_load')\n"
        "assert s.graph is sg and 'graph' in dir(s) and 'lm' in dir(s)\n"
        "import repro_torch.serve.lm as lm\n"
        "assert s.make_prefill_step is lm.make_prefill_step\n"
        "assert s.make_decode_step is lm.make_decode_step\n"
        "try:\n"
        "    s.nothing\n"
        "except AttributeError:\n"
        "    pass\n"
        "else:\n"
        "    raise SystemExit('no AttributeError')\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------------------- the committed rows
def _bench_spec(algo):
    # benchmarks/serving.py's _spec at k=8, seed 0
    return tapi.PartitionSpec(**_spec_fields(algo, 8, seed=0))


def test_committed_serving_rows():
    """``benchmarks/serving.py``'s recipe run with the port alone (R-MAT
    8000, degree 12, seed 0, k=8; 2,000 queries seeded 1 at concurrency
    1,000) gives every field of the six committed ``serving/rmat8000/*``
    rows but ``qps_wall``."""
    committed = {
        row["bench"]: row
        for row in json.loads((ROOT / "BENCH_partition.json").read_text())
        ["suites"]["serving"]["rows"]
        if row["bench"].startswith("serving/rmat8000/")
    }
    assert len(committed) == 6
    graph = tgen.rmat_graph(8000, avg_degree=12, seed=0)
    workload = tsg.build_workload(graph, 2000, tsg.QueryMix(), seed=1)
    reports = {}
    for algo in ALGOS:
        res = tapi.partition(graph, _bench_spec(algo), device="cpu")
        part = res.vertex_assignment()
        rep = tsg.run_load(res.serve(store_results=False), workload=workload,
                           concurrency=1000)
        reports[algo] = rep
        q = quality_report(graph, part, 8, res.device)
        row = dict(
            bench=f"serving/rmat8000/{algo}", algo=algo, num_queries=rep.num_queries,
            concurrency=rep.concurrency, qps_sim=rep.qps_sim,
            p99_sim_ms=rep.latency_ms["sim"]["p99"], p50_sim_ms=rep.latency_ms["sim"]["p50"],
            rpcs=rep.rpcs, messages=rep.messages, wire_bytes=rep.wire_bytes,
            local_queries=rep.local_queries, edge_cut=q["edge_cut"],
            communication_volume=q["comm_volume"],
        )
        want = {k: v for k, v in committed[row["bench"]].items() if k != "qps_wall"}
        assert row == want
    res = tapi.partition(graph, _bench_spec("cuttana"), device="cpu")
    base = tsg.run_load(res.serve(replication_budget=0.0), workload=workload[:500],
                        concurrency=1000)
    repl = tsg.run_load(res.serve(replication_budget=0.05), workload=workload[:500],
                        concurrency=1000)
    a, b = base.answers(), repl.answers()
    parity = all(
        np.array_equal(va, b[qid]) if isinstance(va, np.ndarray) else va == b[qid]
        for qid, va in a.items()
    )
    row = dict(
        bench="serving/rmat8000/cuttana/replication", algo="cuttana",
        replication_budget=0.05, rpcs_base=base.rpcs, rpcs_replicated=repl.rpcs,
        rpc_reduction=1.0 - repl.rpcs / max(base.rpcs, 1), answers_identical=parity,
        **{f"replication_{k}": v for k, v in repl.replication.items()},
    )
    assert row == committed[row["bench"]]
    qps = {a_: reports[a_].qps_sim for a_ in ALGOS}
    p99 = {a_: reports[a_].latency_ms["sim"]["p99"] for a_ in ALGOS}
    row = dict(
        bench="serving/rmat8000/ordering",
        qps_cuttana_over_random=qps["cuttana"] / qps["random"],
        p99_cuttana_over_fennel=p99["cuttana"] / p99["fennel"],
        p99_cuttana_over_hdrf=p99["cuttana"] / p99["hdrf"],
        throughput_ordering_ok=bool(qps["cuttana"] > qps["random"]),
        tail_ordering_ok=bool(p99["cuttana"] <= 1.05 * min(p99["fennel"], p99["hdrf"])),
    )
    assert row == committed[row["bench"]]
