"""The reference's public surface on the port: every function, method and
re-export of ``repro`` that the port's users and CI scripts call, held
against ``repro`` on seeded inputs on the CPU, and the CI smoke scripts
(``scripts/torch/``) against the reference's (``scripts/``).

Metrics are ``==`` (bit for bit) on resident and memory-mapped graphs; the
graph helpers, ``PartitionState.at_capacity``, the scorers'
``on_unassign``, the refinement swaps and ``cuttana(return_detail=True)``
give the reference's values; the deprecated ``repro_torch.core`` shims give
the reference's assignments for every registered name; the kernel packages
export their wrappers without building anything; and each package imports
first in a fresh interpreter. The smoke scripts' ``run()`` at small sizes
passes their deterministic gates and prints the reference's lines (timings
masked; the reference's scripts run as child processes, started together).
Host-timing gates (threaded's 0.9, out-of-core's prefetch 0.9) are not
applied: at these sizes they fail in both packages.
"""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as rcore
from repro.core import cuttana as rcuttana
from repro.core.base import FennelParams as RefFennelParams
from repro.core.base import PartitionState as RefState
from repro.core.engine import FennelScorer as RefFennel
from repro.core.engine import LDGScorer as RefLDG
from repro.core.refinement import Refiner as RefRefiner
from repro.core.refinement import best_swap as ref_best_swap
from repro.core.refinement import refine_with_swaps as ref_refine_with_swaps
from repro.graph import metrics as rmetrics
from repro.graph.csr import CSRGraph as RefCSR
from repro.graph.generators import rmat_graph as ref_rmat
from repro.graph.stream import vertex_stream as ref_vertex_stream
from repro.kernels.partition_score.ops import neighbor_histograms_host as ref_histograms

import repro_torch.core as tcore
import repro_torch.graph as tgraph
from repro_torch.core import cuttana as tcuttana
from repro_torch.core.base import FennelParams, PartitionState
from repro_torch.core.engine import (
    BufferedPolicy,
    FennelScorer,
    ImmediatePolicy,
    LDGScorer,
    PlacementPolicy,
    Scorer,
    ShardedBufferedPolicy,
)
from repro_torch.core.refinement import Refiner, best_swap, refine_with_swaps
from repro_torch.graph import metrics as tmetrics
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.external import ExternalCSRGraph, write_external_csr
from repro_torch.graph.generators import rmat_graph
from repro_torch.kernels.partition_score.ops import neighbor_histograms_host

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
K = 5
# the smoke scripts at small sizes (the same arguments for both packages)
SMOKE_ARGS = {
    "churn_smoke": ["--n", "3000"],
    "serving_smoke": ["--n", "2000", "--queries", "200"],
    "outofcore_smoke": ["--n", "4000"],
}
SMALL_THREADED = ["--n", "3000"]


def _graphs(n: int = 1500, seed: int = 3):
    return ref_rmat(n, avg_degree=8, seed=seed), rmat_graph(n, avg_degree=8, seed=seed)


def _part(n: int, k: int = K, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, k, n).astype(np.int32)


# ------------------------------------------------------------------ metrics
@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """The port's graph as a v1 and a v2 file, memory-mapped."""
    _, graph = _graphs()
    out = {}
    for version in (1, 2):
        path = tmp_path_factory.mktemp("surface") / f"g.v{version}.bin"
        write_external_csr(path, graph.indptr, graph.indices, version=version)
        out[version] = ExternalCSRGraph(path)
    return out


@pytest.mark.parametrize("backing", ["resident", "v1", "v2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_metric_functions_equal_the_reference(backing, seed, mapped):
    ref, graph = _graphs()
    if backing != "resident":
        graph = mapped[int(backing[1])]
        assert graph.backing == "mapped"
    part = _part(graph.num_vertices, seed=seed)
    cases = {
        "edge_cut": ((ref, part), (graph, part)),
        "communication_volume": ((ref, part, K), (graph, part, K)),
        "partition_edge_counts": ((ref, part, K), (graph, part, K)),
        "edge_imbalance": ((ref, part, K), (graph, part, K)),
        "partition_vertex_counts": ((part, K), (part, K)),
        "vertex_imbalance": ((part, K), (part, K)),
    }
    for name, (want_args, got_args) in cases.items():
        want = getattr(rmetrics, name)(*want_args)
        got = getattr(tmetrics, name)(*got_args, device=CPU)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        else:
            assert type(got) is type(want) and got == want, name
    assert tmetrics.quality_report(graph, part, K, CPU) == rmetrics.quality_report(ref, part, K)


def test_quality_report_is_the_single_functions():
    _, graph = _graphs()
    part = _part(graph.num_vertices, seed=4)
    assert tmetrics.quality_report(graph, part, K, CPU) == {
        "k": K,
        "edge_cut": tmetrics.edge_cut(graph, part, device=CPU),
        "comm_volume": tmetrics.communication_volume(graph, part, K, device=CPU),
        "vertex_imbalance": tmetrics.vertex_imbalance(part, K, device=CPU),
        "edge_imbalance": tmetrics.edge_imbalance(graph, part, K, device=CPU),
    }


def test_metrics_on_an_edgeless_graph_and_one_partition():
    ref = RefCSR.from_edges(np.zeros((0, 2), int), num_vertices=7)
    graph = CSRGraph.from_edges(np.zeros((0, 2), int), num_vertices=7)
    part = np.zeros(7, dtype=np.int32)
    assert tmetrics.edge_cut(graph, part, device=CPU) == rmetrics.edge_cut(ref, part) == 0.0
    for k in (1, 3):
        assert tmetrics.communication_volume(graph, part, k, device=CPU) == \
            rmetrics.communication_volume(ref, part, k)
        assert tmetrics.edge_imbalance(graph, part, k, device=CPU) == \
            rmetrics.edge_imbalance(ref, part, k)
        assert tmetrics.vertex_imbalance(part, k, device=CPU) == rmetrics.vertex_imbalance(part, k)


@pytest.mark.parametrize("sizes,total,k,eps", [
    (np.array([10.0, 10.0, 10.0]), 30.0, 3, 0.0),
    (np.array([11.0, 9.0, 10.0]), 30.0, 3, 0.0),
    (np.array([11.0, 9.0, 10.0]), 30.0, 3, 0.1),
    (np.array([10.5, 9.5]), 20.0, 2, 0.05),
    (np.array([5, 7, 3, 1]), 16.0, 4, 0.75),
])
def test_check_balance_equals_the_reference(sizes, total, k, eps):
    assert tmetrics.check_balance(sizes, total, k, eps) is rmetrics.check_balance(sizes, total, k, eps)


def test_graph_package_reexports():
    import repro.graph as rgraph
    from repro_torch.graph import churn

    assert set(rgraph.__all__) <= set(tgraph.__all__)
    for name in ("ChurnStream", "churn_from_graph", "rmat_churn"):
        assert getattr(tgraph, name) is getattr(churn, name)
    for name in tmetrics.__all__:
        assert getattr(tgraph, name) is getattr(tmetrics, name)


# ------------------------------------------------------------ graph helpers
def test_iter_adjacency_subgraph_edge_count_and_vertex_stream():
    ref, graph = _graphs(600, seed=5)
    rng = np.random.default_rng(2)
    order = rng.permutation(graph.num_vertices)
    for o in (None, order, order[:50].tolist()):
        got = list(graph.iter_adjacency(o))
        want = list(ref.iter_adjacency(o))
        assert [v for v, _ in got] == [v for v, _ in want]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    for density in (0.0, 0.3, 1.0):
        mask = rng.random(graph.num_vertices) < density
        assert graph.subgraph_edge_count(mask) == ref.subgraph_edge_count(mask)
    for stream_order in ("natural", "random", "bfs", "dfs"):
        got = list(tgraph.vertex_stream(graph, stream_order, seed=3))
        want = list(ref_vertex_stream(ref, stream_order, seed=3))
        assert [v for v, _ in got] == [v for v, _ in want]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))


def test_permute_equals_the_reference():
    ref, graph = _graphs(600, seed=6)
    perm = np.random.default_rng(4).permutation(graph.num_vertices)
    got, want = graph.permute(perm), ref.permute(perm)
    assert isinstance(got, CSRGraph)
    assert got.indptr.dtype == want.indptr.dtype and np.array_equal(got.indptr, want.indptr)
    assert got.indices.dtype == want.indices.dtype and np.array_equal(got.indices, want.indices)
    back = got.permute(np.argsort(perm))
    assert np.array_equal(back.indptr, graph.indptr) and np.array_equal(back.indices, graph.indices)


# ------------------------------------------------------------------ state
@pytest.mark.parametrize("mode", ["vertex", "edge"])
def test_at_capacity_in_both_balance_modes(mode):
    ref, graph = _graphs(400, seed=7)
    mine = PartitionState.create(graph, 4, 0.05, mode, 0, device=CPU)
    theirs = RefState.create(ref, 4, 0.05, mode, 0)
    assert mine.at_capacity().dtype == theirs.at_capacity().dtype == np.bool_
    seen_full = False
    # fill partition 0 then 1 in vertex order, checking after every placement
    for v in range(graph.num_vertices):
        p = 0 if not mine.at_capacity()[0] else 1
        deg = graph.degree(v)
        mine.assign(v, p, deg)
        theirs.assign(v, p, deg)
        got, want = mine.at_capacity(), theirs.at_capacity()
        assert np.array_equal(got, want)
        seen_full |= bool(got[0])
        if got[1]:
            break
    assert seen_full and mine.at_capacity()[1]


# ---------------------------------------------------------------- scorers
def test_scorer_and_policy_protocols():
    _, graph = _graphs(300)
    assert isinstance(FennelScorer(graph, 4), Scorer)
    assert isinstance(LDGScorer(graph, 4), Scorer)
    assert not isinstance(object(), Scorer)
    for policy in (ImmediatePolicy(), BufferedPolicy(1024, 1000, 1.0), ShardedBufferedPolicy(4, 1024, 1000, 1.0)):
        assert isinstance(policy, PlacementPolicy)
    assert not isinstance(FennelScorer(graph, 4), PlacementPolicy)
    for name in ("Scorer", "PlacementPolicy", "StreamEngine", "FennelScorer", "LDGScorer"):
        assert getattr(tcore, name) is not None


@pytest.mark.parametrize("mode", ["vertex", "edge"])
@pytest.mark.parametrize("which", ["fennel", "ldg"])
def test_on_unassign_after_on_assign_restores_the_penalty(mode, which):
    ref, graph = _graphs(400, seed=8)
    mine = PartitionState.create(graph, 4, 0.05, mode, 0, device=CPU)
    theirs = RefState.create(ref, 4, 0.05, mode, 0)
    if which == "fennel":
        scorers = (FennelScorer(graph, 4, FennelParams(), mode),
                   RefFennel(ref, 4, RefFennelParams(), mode))
        attr = "_penalty"
    else:
        scorers = (LDGScorer(graph, 4, mode), RefLDG(ref, 4, mode))
        attr = "_factor"
    for v in range(60):  # some mass everywhere
        for st in (mine, theirs):
            st.assign(v, v % 4, graph.degree(v))
    for sc, st in zip(scorers, (mine, theirs)):
        sc.begin(st)
    before = getattr(scorers[0], attr).copy()
    assert np.array_equal(before, getattr(scorers[1], attr))
    v, p = 200, 2
    deg = graph.degree(v)
    for sc, st in zip(scorers, (mine, theirs)):
        st.assign(v, p, deg)
        sc.on_assign(st, p, deg)
    assert not np.array_equal(getattr(scorers[0], attr), before)
    assert np.array_equal(getattr(scorers[0], attr), getattr(scorers[1], attr))
    for sc, st in zip(scorers, (mine, theirs)):
        st.part_of[v] = -1
        st.v_counts[p] -= 1
        st.e_counts[p] -= deg
        sc.on_unassign(st, p, deg)
    assert np.array_equal(getattr(scorers[0], attr), before)
    assert np.array_equal(getattr(scorers[1], attr), before)


# ------------------------------------------------------------- refinement
def _refiner_inputs(seed: int, equal: bool):
    """(w, sub_part, size, k, epsilon): 48 sub-partitions over 4 partitions.
    ``equal``: 0/1 weights and unit sizes at epsilon 0, so every single
    trade is balance-blocked and many swaps tie."""
    rng = np.random.default_rng(seed)
    kp, k = 48, 4
    if equal:
        w = (rng.random((kp, kp)) < 0.25).astype(np.float64)
        size, eps = np.ones(kp), 0.0
    else:
        w = rng.integers(0, 5, (kp, kp)).astype(np.float64)
        size, eps = rng.integers(1, 4, kp).astype(np.float64), 0.02
    w = np.triu(w, 1)
    w = w + w.T
    sub_part = rng.permutation(np.repeat(np.arange(k), kp // k))
    return w, sub_part, size, k, eps


def _pair(seed, equal):
    w, sub_part, size, k, eps = _refiner_inputs(seed, equal)
    return (Refiner(w.copy(), sub_part, size, k, eps),
            RefRefiner(w.copy(), sub_part, size, k, eps))


@pytest.mark.parametrize("equal", [True, False], ids=["equal_weights", "random_weights"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_swap_and_refine_with_swaps_equal_the_reference(seed, equal):
    mine, theirs = _pair(seed, equal)
    assert mine.current_cut() == theirs.current_cut()
    mine.check_invariants()
    # best_swap step by step (the tie-break: the first pair in scan order)
    for _ in range(6):
        got, want = best_swap(mine), ref_best_swap(theirs)
        assert got == want
        if got is None:
            break
        i, j, _ = got
        a, b = int(mine.sub_part[i]), int(mine.sub_part[j])
        for r in (mine, theirs):
            r.apply_move(i, b)
            r.apply_move(j, a)
        assert mine.current_cut() == theirs.current_cut()
    mine, theirs = _pair(seed, equal)
    got, want = refine_with_swaps(mine), ref_refine_with_swaps(theirs)
    assert got == want
    assert got["swaps"] > 0
    assert np.array_equal(mine.sub_part, theirs.sub_part)
    assert mine.current_cut() == theirs.current_cut()
    assert np.array_equal(mine.part_load, theirs.part_load)
    mine.check_invariants()
    assert best_swap(mine) is None


def test_equal_weights_tie_break_picks_the_first_pair():
    """Two cross pairs with the same gain: the reference's scan keeps the
    first (smaller i, then smaller j); so does the port."""
    w = np.zeros((4, 4))
    for i, j in ((0, 3), (1, 2)):
        w[i, j] = w[j, i] = 1.0
    sub_part = np.array([0, 0, 1, 1])
    args = (sub_part, np.ones(4), 2, 0.0)
    mine, theirs = Refiner(w.copy(), *args), RefRefiner(w.copy(), *args)
    assert best_swap(mine) == ref_best_swap(theirs)
    # every pair gains the same; the first in scan order is (0, 2)
    w2 = np.ones((4, 4)) - np.eye(4)
    mine, theirs = Refiner(w2.copy(), *args), RefRefiner(w2.copy(), *args)
    assert best_swap(mine) == ref_best_swap(theirs)


def test_check_invariants_catches_a_stale_tree():
    mine, _ = _pair(0, False)
    mine.m[0, 1] += 5.0
    with pytest.raises(AssertionError):
        mine.check_invariants()


# ----------------------------------------------------------------- cuttana
@pytest.mark.parametrize("kwargs", [
    {},
    {"use_refinement": False},
    {"use_buffer": False, "balance_mode": "vertex"},
    {"max_moves": 3, "order": "bfs"},
])
def test_cuttana_return_detail_equals_the_reference(kwargs):
    ref, graph = _graphs(1200, seed=9)
    args = {"order": "random", "seed": 0, **kwargs}
    want = rcuttana.partition(ref, 4, return_detail=True, **args)
    got = tcuttana.partition(graph, 4, return_detail=True, device=CPU, **args)
    assert isinstance(got, tcuttana.CuttanaResult)
    for field in ("part", "sub_of", "sub_part"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got.refine_moves == want.refine_moves
    assert got.refine_improvement == want.refine_improvement
    assert got.phase1_seconds > 0 and got.phase2_seconds >= 0
    plain = tcuttana.partition(graph, 4, device=CPU, **args)
    assert np.array_equal(plain, got.part)


# ------------------------------------------------------------------- shims
@pytest.fixture(scope="module")
def shim_graphs():
    return _graphs(700, seed=11)


@pytest.mark.parametrize("name", sorted(rcore.PARTITIONERS))
def test_partitioner_shims_give_the_reference_assignments(name, shim_graphs):
    ref, graph = shim_graphs
    assert tcore.get_partitioner(name) is tcore.PARTITIONERS[name]
    want = rcore.PARTITIONERS[name](ref, 4, seed=0)
    got = tcore.get_partitioner(name)(graph, 4, seed=0, device=CPU)
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", sorted(rcore.EDGE_PARTITIONERS))
def test_edge_partitioner_shims_give_the_reference_partitions(name, shim_graphs):
    ref, graph = shim_graphs
    assert tcore.get_edge_partitioner(name) is tcore.EDGE_PARTITIONERS[name]
    want = rcore.EDGE_PARTITIONERS[name](ref, 4, seed=0)
    got = tcore.get_edge_partitioner(name)(graph, 4, seed=0, device=CPU)
    for field in ("edge_part", "replicas", "masters", "edge_counts"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field


def test_shim_names_and_errors_equal_the_reference():
    assert set(tcore.PARTITIONERS) == set(rcore.PARTITIONERS)
    assert set(tcore.EDGE_PARTITIONERS) == set(rcore.EDGE_PARTITIONERS)
    assert set(rcore.__all__) <= set(tcore.__all__)
    for shim, ref_shim, name in ((tcore.get_partitioner, rcore.get_partitioner, "fenel"),
                                 (tcore.get_partitioner, rcore.get_partitioner, "hdrf"),
                                 (tcore.get_edge_partitioner, rcore.get_edge_partitioner, "fennel")):
        with pytest.raises(ValueError) as got:
            shim(name)
        with pytest.raises(ValueError) as want:
            ref_shim(name)
        assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- kernels
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_out", [False, True])
def test_neighbor_histograms_host_equals_the_reference(seed, with_out):
    rng = np.random.default_rng(seed)
    rows_n, k, nnz = 37, 6, 900
    rows = np.sort(rng.integers(0, rows_n, nnz)).astype(np.int64)
    parts = rng.integers(-1, k, nnz).astype(np.int32)
    if with_out:
        mine, theirs = np.full((rows_n, k), 7.0), np.full((rows_n, k), 7.0)
        got = neighbor_histograms_host(rows, parts, rows_n, k, out=mine)
        want = ref_histograms(rows, parts, rows_n, k, out=theirs)
        assert got is mine
    else:
        got = neighbor_histograms_host(rows, parts, rows_n, k)
        want = ref_histograms(rows, parts, rows_n, k)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _fresh(code: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=180)


def test_kernel_packages_export_their_wrappers_without_a_build():
    code = (
        "import sys\n"
        "from repro_torch.kernels import nvcc\n"
        "def refuse(self):\n"
        "    raise AssertionError('a kernel was built at import')\n"
        "nvcc.KernelLibrary._build = refuse\n"
        "from repro_torch.kernels.partition_score import fennel_scores, fennel_scores_sharded\n"
        "from repro_torch.kernels.ell_spmv import ell_spmv\n"
        "from repro_torch.kernels.flash_attention import flash_attention\n"
        "from repro_torch.kernels.mamba_scan import selective_scan\n"
        "from repro_torch.kernels.partition_score import ops as ps\n"
        "from repro_torch.kernels.ell_spmv import ops as sp\n"
        "from repro_torch.kernels.flash_attention import ops as fa, build as fab\n"
        "from repro_torch.kernels.mamba_scan import ops as ms\n"
        "from repro_torch.kernels.partition_score import build as psb\n"
        "from repro_torch.kernels.ell_spmv import build as spb\n"
        "from repro_torch.kernels.mamba_scan import build as msb\n"
        "assert fennel_scores is ps.fennel_scores and fennel_scores_sharded is ps.fennel_scores_sharded\n"
        "assert ell_spmv is sp.ell_spmv and flash_attention is fa.flash_attention\n"
        "assert selective_scan is ms.selective_scan\n"
        "libs = [psb.LIBRARY, spb.LIBRARY, fab.LIBRARY, fab.MLA_LIBRARY, msb.LIBRARY]\n"
        "assert all(lib._lib is None and lib.build_seconds == 0.0 for lib in libs)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    proc = _fresh(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("first", ["repro_torch.core", "repro_torch.api", "repro_torch.graph",
                                   "repro_torch.core.engine", "repro_torch.api.registry"])
def test_each_package_imports_first_in_a_fresh_interpreter(first):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({first!r})\n"
        "import repro_torch.api as api, repro_torch.core as core, repro_torch.graph as graph\n"
        "assert core.PARTITIONERS['fennel'] is api.get_info('fennel').resolve()\n"
        "assert graph.edge_cut is not None and api.partition is not None\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    proc = _fresh(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def reference_scripts(tmp_path_factory):
    """name -> the reference smoke script's printed lines (``name:rc`` its
    exit code), the children started together."""
    out = tmp_path_factory.mktemp("reference_scripts")
    # the reference's serving smoke imports the ``benchmarks`` package
    env = {**os.environ, "PYTHONPATH": os.pathsep.join((str(ROOT / "src"), str(ROOT))),
           "JAX_PLATFORMS": "cpu"}
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "scripts" / f"{name}.py"), *args,
         "--out", str(out / f"{name}.json")], env=env, cwd=out,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, args in SMOKE_ARGS.items()}
    lines = {}

    def get(name: str):
        if name not in lines:
            stdout, _ = procs[name].communicate(timeout=600)
            lines[name] = stdout.splitlines()
            lines[name + ":rc"] = procs[name].returncode
        return lines[name]

    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"port_{name}", ROOT / "scripts" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mask(line: str) -> str:
    return re.sub(r"in [0-9.]+s", "in <t>s", line)


@pytest.mark.parametrize("name", sorted(SMOKE_ARGS))
def test_smoke_script_runs_pass_their_deterministic_gates(name, reference_scripts, tmp_path,
                                                         capsys):
    mod = _load_script(name)
    args = mod.parser().parse_args([*SMOKE_ARGS[name], "--device", "cpu",
                                    "--out", str(tmp_path / "out.json")])
    report = mod.run(args)
    failures = mod.gates(report, args, timing=False) if name == "outofcore_smoke" \
        else mod.gates(report, args)
    assert failures == []
    got = [_mask(line) for line in capsys.readouterr().out.splitlines()]
    printed = reference_scripts(name)
    assert reference_scripts(name + ":rc") in (0, 1), "\n".join(printed)  # 1: a timing gate
    want = [_mask(line) for line in printed
            if not line.startswith(("wrote", "FAILED", "FAIL: prefetch", "OK: prefetch"))]
    assert got == want


def test_smoke_script_mains_write_their_reports(tmp_path, capsys):
    import json

    mod = _load_script("churn_smoke")
    out = tmp_path / "churn.json"
    assert mod.main([*SMOKE_ARGS["churn_smoke"], "--device", "cpu", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["cut_ratio"] <= report["cut_ratio_bound"]
    assert f"wrote {out}" in capsys.readouterr().out
    mod = _load_script("serving_smoke")
    out = tmp_path / "serving.json"
    assert mod.main([*SMOKE_ARGS["serving_smoke"], "--device", "cpu", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["replication"]["answers_identical"] is True


def test_threaded_smoke_parallel_equals_one_thread_and_the_reference(tmp_path, capsys):
    from repro.api import PartitionSpec as RefSpec
    from repro.api import partition as ref_partition
    from repro.graph.generators import rmat_graph as ref_rmat
    from repro_torch.api import partition

    mod = _load_script("threaded_smoke")
    args = mod.parser().parse_args([*SMALL_THREADED, "--device", "cpu",
                                    "--out", str(tmp_path / "t.json")])
    report = mod.run(args)
    mod.gates(report, args)  # host timing: printed, not asserted
    lines = capsys.readouterr().out.splitlines()
    for (algo, base), line in zip(mod.ALGOS, lines):
        assert re.fullmatch(rf"(OK|FAIL): {algo} S=4 \S+s vs {base} \S+s "
                            r"\(ratio \S+, bound 0.9\)", line)
    ref_graph = ref_rmat(args.n, avg_degree=args.avg_degree, seed=0)
    for algo, base in mod.ALGOS:
        _, par_spec = mod.specs(args, algo, base)
        one = partition(report["_graph"], par_spec.replace(
            params={"num_shards": args.num_shards, "max_workers": 1}), device="cpu")
        assert np.array_equal(one.assignment, report["_assignments"][algo])
        want = ref_partition(ref_graph, RefSpec(algo=algo, k=args.k, balance_mode="edge",
                                                order="random",
                                                params={"num_shards": args.num_shards}))
        assert np.array_equal(report["_assignments"][algo], want.assignment)
