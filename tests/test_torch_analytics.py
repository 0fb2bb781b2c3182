"""The analytics slice of the PyTorch port against ``repro.analytics``:
``localize`` gives the same arrays, the engine the same values on one
layout, ``stats``/``workload_cost`` and ``PartitionResult.analytics`` the
same reports, and the gather/reduce kernel's plain versions agree with the
reference Pallas kernel (interpret mode) and the engine's segment reduce;
``_merge_path_model``, a model of the CUDA kernel's merge-path split and of
its float64 add order, agrees with the plain version. The CUDA kernel
itself is held against the plain versions in ``test_torch_gpu.py``."""
import dataclasses
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro_torch.api as tapi
from repro.analytics import GraphEngine as RefEngine
from repro.analytics import PROGRAMS as REF_PROGRAMS
from repro.analytics import localize as ref_localize
from repro.analytics import workload_cost as ref_workload_cost
from repro.analytics import programs as ref_programs
from repro.analytics.costmodel import CostModel as RefCostModel
from repro.analytics.engine import _segment_reduce
from repro.core import get_partitioner
from repro.core.hdrf import partition_hdrf
from repro.graph.generators import load_dataset, rmat_graph, road_graph
from repro.kernels.ell_spmv.ops import ell_spmv as ref_ell_spmv
from repro.kernels.ell_spmv.ref import ell_spmv_ref as ref_ell_spmv_ref
from repro_torch.analytics import PROGRAMS, CostModel, GraphEngine, localize, workload_cost
from repro_torch.analytics import programs
from repro_torch.convert import graph_from_arrays, localized_from_arrays
from repro_torch.kernels.ell_spmv import ops
from repro_torch.kernels.ell_spmv.ref import ell_spmv_segments_ref, segment_entries
from test_torch_gpu import _path_edge_degrees, _segments_from_degrees

CPU = torch.device("cpu")
GRAPHS = {
    "rmat1500": lambda: rmat_graph(1500, avg_degree=10, seed=3),
    "road2000": lambda: road_graph(2000, seed=1),
    "web-s": lambda: load_dataset("web-s", seed=0),
}
# the reference's cuttana takes ~3 s a run on web-s, so web-s gets cuttana at
# k=8 only; every other graph runs both algorithms at every k
LAYOUTS = [
    (g, a, k)
    for g in GRAPHS
    for a in ("fennel", "cuttana")
    for k in (2, 4, 8)
    if not (g == "web-s" and a == "cuttana" and k != 8)
]
ITERS = {"pagerank": 15, "cc": 30, "sssp": 25}
KERNEL_SHAPES = [(16, 8, 64), (128, 32, 300), (333, 17, 1000)]


@functools.cache
def _graph(name):
    g = GRAPHS[name]()
    return g, graph_from_arrays(g.indptr, g.indices, CPU)


@functools.cache
def _layout(name, algo, k):
    g, tg = _graph(name)
    part = get_partitioner(algo)(g, k, balance_mode="edge", seed=0)
    return g, tg, part, ref_localize(g, part, k)


def _program(name, ref: bool):
    table = REF_PROGRAMS if ref else PROGRAMS
    return table[name](source=7) if name == "sssp" else table[name]()


def _assert_values(prog, got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    if prog == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("graph,algo,k", LAYOUTS)
def test_localize_matches_reference(graph, algo, k):
    g, tg, part, want = _layout(graph, algo, k)
    got = localize(tg, part, k)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    # each device's CSR row pointer covers exactly its real edge slots
    row_ptr = got.row_ptr()
    assert row_ptr.dtype == np.int64 and row_ptr.shape == (k, got.v_max + 1)
    real = (got.rows != got.v_max).sum(axis=1)
    np.testing.assert_array_equal(row_ptr[:, -1], real)
    for p in range(k):
        expanded = np.repeat(np.arange(got.v_max), np.diff(row_ptr[p]))
        np.testing.assert_array_equal(expanded, got.rows[p, : real[p]])
    assert got.true_halo_messages() == want.true_halo_messages()
    assert got.max_local_edges() == want.max_local_edges()


@pytest.mark.parametrize("layout", [("rmat1500", "cuttana", 4), ("road2000", "fennel", 4),
                                    ("web-s", "fennel", 8)])
@pytest.mark.parametrize("prog", ["pagerank", "cc", "sssp"])
def test_engine_matches_reference_on_one_layout(layout, prog):
    _, _, _, lg = _layout(*layout)
    want_eng = RefEngine(lg, _program(prog, ref=True))
    want = want_eng.run_simulated(ITERS[prog])
    eng = GraphEngine(localized_from_arrays(**dataclasses.asdict(lg)), _program(prog, ref=False),
                      device="cpu")
    _assert_values(prog, eng.run_simulated(ITERS[prog]), want)
    assert dataclasses.asdict(eng.stats(ITERS[prog])) == dataclasses.asdict(
        want_eng.stats(ITERS[prog]))


@pytest.mark.parametrize("graph", ["rmat1500", "road2000"])
def test_engine_matches_dense_references(graph):
    """The tolerances of ``tests/test_analytics.py``; the port's float64
    oracles are copies of the reference's."""
    g, tg = _graph(graph)
    part = get_partitioner("cuttana")(g, 4, balance_mode="edge", seed=0)
    lg = localize(tg, part, 4)
    pr = GraphEngine(lg, programs.pagerank_program(), device="cpu").run_simulated(15)
    want = programs.reference_pagerank(tg, 15)
    np.testing.assert_array_equal(want, ref_programs.reference_pagerank(g, 15))
    np.testing.assert_allclose(pr, want, rtol=2e-4, atol=1e-9)
    assert (pr > 0).all()
    cc = GraphEngine(lg, programs.cc_program(), device="cpu").run_simulated(30)
    want = programs.reference_cc(tg, 30)
    np.testing.assert_array_equal(want, ref_programs.reference_cc(g, 30))
    np.testing.assert_allclose(cc, want)
    sp = GraphEngine(lg, programs.sssp_program(source=7), device="cpu").run_simulated(25)
    want = programs.reference_sssp(tg, 25, source=7)
    np.testing.assert_array_equal(want, ref_programs.reference_sssp(g, 25, source=7))
    finite = np.isfinite(want)
    np.testing.assert_allclose(sp[finite], want[finite])
    assert (sp[~finite] > 1e30).all()


@pytest.mark.parametrize("graph,algo,k", [("rmat1500", "fennel", 2), ("road2000", "cuttana", 8),
                                          ("web-s", "fennel", 4)])
def test_workload_cost_matches_reference(graph, algo, k):
    g, tg, part, _ = _layout(graph, algo, k)
    assert workload_cost(tg, part, k, 30) == ref_workload_cost(g, part, k, 30)
    fields = dict(edge_rate=3.0e9, bandwidth=1.0e10, msg_bytes=12.0, per_iter_overhead_s=2e-5)
    assert dataclasses.asdict(CostModel()) == dataclasses.asdict(RefCostModel())
    assert workload_cost(tg, part, k, 7, CostModel(**fields)) == ref_workload_cost(
        g, part, k, 7, RefCostModel(**fields))


def test_workload_cost_rejects_what_it_cannot_model():
    g, tg = _graph("rmat1500")
    # a vertex-cut edge partition is modelled as in the reference
    from repro_torch.core.hdrf import partition_hdrf as port_hdrf

    assert workload_cost(tg, port_hdrf(tg, 4, seed=0), 4, 10) == ref_workload_cost(
        g, partition_hdrf(g, 4, seed=0), 4, 10)
    with pytest.raises(ValueError, match="vertex partition"):
        workload_cost(tg, np.zeros(3, np.int32), 4, 10)


@pytest.mark.parametrize("mode", ["model", "simulated"])
@pytest.mark.parametrize("prog", ["pagerank", "cc", "sssp"])
def test_result_analytics_matches_reference(mode, prog):
    g, tg = _graph("rmat1500")
    fields = dict(algo="fennel", k=4, balance_mode="edge", order="random", seed=0)
    want = rapi.partition(g, rapi.PartitionSpec(**fields)).analytics(prog, 12, mode=mode)
    res = tapi.partition(tg, tapi.PartitionSpec(**fields), device="cpu")
    got = res.analytics(prog, 12, mode=mode)
    assert got.keys() == want.keys()
    if mode == "simulated":
        assert got.pop("seconds") >= 0.0
        want.pop("seconds")
        _assert_values(prog, got.pop("values"), want.pop("values"))
        assert res.timings["localize_seconds"] >= 0.0
        assert res.localized() is res.localized()  # built once, shared by programs
    assert got == want


def test_analytics_rejects_bad_requests():
    g, tg = _graph("rmat1500")
    res = tapi.partition(tg, "fennel", k=2, device="cpu")
    with pytest.raises(ValueError, match="unknown analytics mode"):
        res.analytics("pagerank", 3, mode="sharded")
    with pytest.raises(ValueError, match="unknown program"):
        res.analytics("bfs", 3, mode="simulated")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            GraphEngine(res.localized(), programs.cc_program())


# ------------------------------------------------------------------ kernel
def _ell_inputs(r, d, v, reduce):
    """The inputs of ``tests/test_kernels.py``'s ell_spmv cases."""
    rng = np.random.default_rng(r + d)
    x = np.concatenate([
        rng.random(v).astype(np.float32),
        [0.0 if reduce == "sum" else 3e38],
    ]).astype(np.float32)
    cols = rng.integers(0, v + 1, size=(r, d)).astype(np.int32)
    return x, cols


@pytest.mark.parametrize("reduce", ["sum", "min"])
@pytest.mark.parametrize("r,d,v", KERNEL_SHAPES)
def test_ell_plain_version_matches_reference_kernel(reduce, r, d, v):
    x, cols = _ell_inputs(r, d, v, reduce)
    before = ops.launches
    got = ops.ell_spmv(torch.from_numpy(x), torch.from_numpy(cols), reduce)
    assert ops.launches == before  # CPU calls do not count
    assert got.dtype == torch.float32 and got.shape == (r,)
    want_ref = np.asarray(ref_ell_spmv_ref(jnp.asarray(x), jnp.asarray(cols), reduce))
    want_pallas = np.asarray(ref_ell_spmv(x, cols, reduce=reduce, use_pallas=True, interpret=True))
    if reduce == "min":
        np.testing.assert_array_equal(got.numpy(), want_ref)
        np.testing.assert_array_equal(got.numpy(), want_pallas)
    else:
        np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-6)
        np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-6)


def _segment_case(seed=0):
    """Three devices: one with empty rows between full ones (and a trailing
    empty row), one with no edges at all, one with a row far wider than the
    rest; pads past each device's last row point at the identity slot."""
    rng = np.random.default_rng(seed)
    k, v_max, state_len = 3, 9, 40
    degs = np.array([[3, 0, 0, 5, 1, 0, 2, 4, 0],
                     [0] * 9,
                     [1, 2, 1, 60, 1, 0, 3, 1, 2]])
    e_max = int(degs.sum(axis=1).max()) + 4
    row_ptr = np.zeros((k, v_max + 1), np.int64)
    row_ptr[:, 1:] = np.cumsum(degs, axis=1)
    cols = np.full((k, e_max), state_len - 1, np.int32)
    for p in range(k):
        n = int(row_ptr[p, -1])
        cols[p, :n] = rng.integers(0, state_len - 1, size=n)
    x = rng.random((k, state_len)).astype(np.float32) * 10
    return x, row_ptr, cols


@pytest.mark.parametrize("reduce", ["sum", "min"])
def test_segments_plain_version_matches_engine_segment_reduce(reduce):
    x, row_ptr, cols = _segment_case()
    identity = 0.0 if reduce == "sum" else 3e38
    x[:, -1] = identity
    got = ops.ell_spmv_segments(torch.from_numpy(x), torch.from_numpy(row_ptr),
                                torch.from_numpy(cols), reduce).numpy()
    k, v_max = row_ptr.shape[0], row_ptr.shape[1] - 1
    for p in range(k):
        # the reference engine's segment reduce over the device's edge slots
        rows = np.full(cols.shape[1], v_max, np.int32)
        rows[: row_ptr[p, -1]] = np.repeat(np.arange(v_max), np.diff(row_ptr[p]))
        want = np.asarray(_segment_reduce(jnp.asarray(x[p][cols[p]]), jnp.asarray(rows),
                                          v_max + 1, reduce, identity))[:v_max]
        if reduce == "min":
            np.testing.assert_array_equal(got[p], want)
        else:
            np.testing.assert_allclose(got[p], want, rtol=1e-6)
    # empty rows write the identity: 0 for sum, x[p, -1] for min
    empty = np.diff(row_ptr, axis=1) == 0
    assert (got[empty] == identity).all()


def test_segments_and_ell_entries_agree_on_packed_rows():
    """Device ``p``'s CSR rows packed into an ELL matrix (pads at the
    identity slot) give the same result through either entry, as
    ``tests/test_kernels.py::test_ell_spmv_engine_equivalence`` packs them
    for the reference kernel."""
    x, row_ptr, cols = _segment_case(seed=1)
    x[:, -1] = 0.0
    seg = ops.ell_spmv_segments(torch.from_numpy(x), torch.from_numpy(row_ptr),
                                torch.from_numpy(cols), "sum")
    for p in range(x.shape[0]):
        degs = np.diff(row_ptr[p])
        ell = np.full((degs.shape[0], max(int(degs.max()), 1)), x.shape[1] - 1, np.int32)
        for r in range(degs.shape[0]):
            ell[r, : degs[r]] = cols[p, row_ptr[p, r]: row_ptr[p, r + 1]]
        got = ops.ell_spmv(torch.from_numpy(x[p]), torch.from_numpy(ell), "sum")
        torch.testing.assert_close(got, seg[p], rtol=0, atol=0)


def test_segment_entries_positions():
    _, row_ptr, cols = _segment_case()
    rows, pos = segment_entries(torch.from_numpy(row_ptr), cols.shape[1])
    want_rows, want_pos = [], []
    for p in range(row_ptr.shape[0]):
        for r in range(row_ptr.shape[1] - 1):
            for j in range(row_ptr[p, r], row_ptr[p, r + 1]):
                want_rows.append(p * (row_ptr.shape[1] - 1) + r)
                want_pos.append(p * cols.shape[1] + j)
    assert rows.tolist() == want_rows and pos.tolist() == want_pos


def test_engine_uses_segments_reduce_per_iteration(monkeypatch):
    """One gather/reduce call per iteration, over all devices' rows."""
    _, _, _, lg = _layout("rmat1500", "fennel", 4)
    calls = []
    import repro_torch.analytics.engine as eng_mod

    def spy(x, row_ptr, cols, reduce):
        calls.append((tuple(x.shape), tuple(row_ptr.shape), reduce))
        return ell_spmv_segments_ref(x, row_ptr, cols, reduce)

    monkeypatch.setattr(eng_mod, "ell_spmv_segments", spy)
    tlg = localized_from_arrays(**dataclasses.asdict(lg))
    GraphEngine(tlg, programs.cc_program(), device="cpu").run_simulated(6)
    assert calls == [((4, lg.state_len), (4, lg.v_max + 1), "min")] * 6
    assert tlg.to(CPU) is tlg.to("cpu")  # one copy per device, however it is named


# ------------------------------------------ the kernel's merge-path model
def _merge_path_model(x, row_ptr, cols, reduce, threads=ops.THREADS,
                      items=ops.ITEMS_PER_THREAD, warp=32, min_init=None):
    """A plain-Python model of ``csrc/ell_spmv.cu`` and of its order of adds:
    device ``p``'s rows and entries merged into one path (a row's end item
    after its last entry), cut into tiles of ``threads * items`` items. A
    row belongs to the tile holding its end item.
    - The tile's first row's entries before the tile: thread ``t`` sums
      entries ``t, t + threads, ...``; lane ``l`` of the first warp joins
      partials ``l, l + warp, ...``; then a shuffle-down tree to lane 0.
    - Each thread walks ``items`` items of the tile's own rows and entries
      and writes the rows it opens and closes.
    - The carries (the row open at a thread's end, its partial) go through a
      segmented inclusive scan over each warp's lanes (Hillis-Steele, equal
      rows joined); the first row a thread closes takes the head partial,
      then the tails of earlier warps that end in it, then the scanned
      carry of the lane before, then its own partial.
    Sums are Python floats (IEEE doubles), as the kernel's, rounded once to
    float32; so the model gives the kernel's bits."""
    import bisect

    k, v_max, e_max = x.shape[0], row_ptr.shape[1] - 1, cols.shape[1]
    tile, warps = threads * items, threads // warp
    out = np.zeros((k, v_max), np.float32)
    add = (lambda a, v: a + v) if reduce == "sum" else min
    for p in range(k):
        xs = x[p].astype(np.float64).tolist()
        base = int(row_ptr[p, 0])
        ends = (row_ptr[p, 1:] - base).tolist()
        cp = cols[p, base: base + ends[-1]].tolist()
        init = 0.0 if reduce == "sum" else float(x[p, -1] if min_init is None else min_init)
        path_ends = [i + e for i, e in enumerate(ends)]  # each row's end item on the path
        path = v_max + ends[-1]
        for d0 in range(0, v_max + e_max, tile):  # the grid covers every device's longest path
            if d0 >= path:
                break
            i0 = bisect.bisect_left(path_ends, d0)
            i1 = bisect.bisect_left(path_ends, min(d0 + tile, path))
            if i0 == i1:
                continue
            j0 = d0 - i0
            head = 0 if i0 == 0 else ends[i0 - 1]
            pre_n = j0 - head
            vals = [xs[c] for c in cp[j0: ends[i1 - 1]]]
            local = [ends[i0 + i] - j0 for i in range(i1 - i0)]
            local_path = [i + e for i, e in enumerate(local)]
            pre = [init] * threads
            for e in range(pre_n):
                pre[e % threads] = add(pre[e % threads], xs[cp[head + e]])
            head_total = init
            if pre_n > 0:
                v = [pre[lane] for lane in range(warp)]
                for w in range(1, warps):
                    v = [add(v[lane], pre[lane + w * warp]) for lane in range(warp)]
                off = warp // 2
                while off > 0:
                    v = [add(v[lane], v[lane + off] if lane + off < warp else v[lane])
                         for lane in range(warp)]
                    off //= 2
                head_total = v[0]
            n_items = len(local) + len(vals)
            keys, carry, firsts = [], [], []
            for t in range(threads):
                t0 = min(t * items, n_items)
                t1 = min(t0 + items, n_items)
                r = bisect.bisect_left(local_path, t0)
                j, acc, first = t0 - r, init, None
                for _ in range(t0, t1):
                    if j < local[r]:
                        acc = add(acc, vals[j])
                        j += 1
                    else:
                        if first is None:
                            first = (r, acc)
                        else:
                            out[p, i0 + r] = acc
                        acc = init
                        r += 1
                keys.append(r if t0 < t1 else len(local))
                carry.append(acc)
                firsts.append(first)
            scanned = []
            for w in range(warps):
                kw, vw = keys[w * warp: (w + 1) * warp], carry[w * warp: (w + 1) * warp]
                off = 1
                while off < warp:
                    vw = [add(vw[lane - off], vw[lane])
                          if lane >= off and kw[lane - off] == kw[lane] else vw[lane]
                          for lane in range(warp)]
                    off *= 2
                scanned += vw
            for t, first in enumerate(firsts):
                if first is None:
                    continue
                r, own = first
                w, lane = divmod(t, warp)
                total = head_total if r == 0 and pre_n > 0 else init
                if lane == 0 or keys[w * warp] == r:
                    for w2 in range(w):
                        if keys[w2 * warp + warp - 1] == r:
                            total = add(total, scanned[w2 * warp + warp - 1])
                if lane > 0 and keys[t - 1] == r:
                    total = add(total, scanned[t - 1])
                out[p, i0 + r] = add(total, own)
    return torch.from_numpy(out)


def _hub_layout():
    """The engine's layout of ``tests/test_torch_gpu.py``'s hub graph (an
    R-MAT of 20,000 vertices with a row over 1,024 entries) on 8 devices,
    the last one edgeless."""
    g = rmat_graph(20_000, avg_degree=16, seed=3)
    part = np.random.default_rng(0).integers(0, 7, size=g.num_vertices)
    lg = localize(graph_from_arrays(g.indptr, g.indices, CPU), part, 8)
    assert int(np.diff(lg.row_ptr(), axis=1).max()) > 1024
    return lg.state_len, lg.row_ptr(), lg.cols


def _assert_model_matches_plain(x, row_ptr, cols, reduce, **tiling):
    got = _merge_path_model(x, row_ptr, cols, reduce, **tiling)
    want = ell_spmv_segments_ref(torch.from_numpy(x), torch.from_numpy(row_ptr),
                                 torch.from_numpy(cols), reduce)
    if reduce == "min":
        assert torch.equal(got, want)
    else:  # both sum in float64 and round once: within one float32 rounding
        ulp = np.spacing(np.abs(want.numpy()))
        assert (np.abs(got.numpy() - want.numpy()) <= ulp).all()
    return got


@pytest.mark.parametrize("reduce", ["sum", "min"])
@pytest.mark.parametrize("threads,items,warp", [(4, 2, 2), (8, 4, 4), (16, 2, 4),
                                                (ops.THREADS, ops.ITEMS_PER_THREAD, 32)])
def test_merge_path_model_edge_cases(reduce, threads, items, warp):
    """Empty rows, degrees 1/31/32/33, a row over three or more tiles, rows
    ending on a tile's boundary, a long first row, an edgeless device and
    the e_max padding, at small tiles and at the kernel's."""
    rng = np.random.default_rng(threads + items)
    x, row_ptr, cols = _segments_from_degrees(_path_edge_degrees(threads * items, rng), 97, rng)
    x[:, -1] = 0.0 if reduce == "sum" else 3e38
    got = _assert_model_matches_plain(x, row_ptr, cols, reduce, threads=threads, items=items,
                                      warp=warp)
    empty = np.diff(row_ptr, axis=1) == 0
    assert (got.numpy()[empty] == x[0, -1]).all()


@pytest.mark.parametrize("reduce", ["sum", "min"])
def test_merge_path_model_hub_layout(reduce):
    state_len, row_ptr, cols = _hub_layout()
    x = np.random.default_rng(1).random((8, state_len)).astype(np.float32)
    x[:, -1] = 0.0 if reduce == "sum" else 3e38
    _assert_model_matches_plain(x, row_ptr, cols, reduce)


@pytest.mark.parametrize("reduce", ["sum", "min"])
@pytest.mark.parametrize("r,d,v", KERNEL_SHAPES + [(64, 3000, 5000)])
def test_merge_path_model_ell_rows(reduce, r, d, v):
    """The ELL entry on the same design: row r ends at entry (r + 1) * D,
    min starts from +inf."""
    x, cols = _ell_inputs(r, d, v, reduce)
    got = _merge_path_model(x[None], (np.arange(r + 1) * d)[None], cols.reshape(1, -1), reduce,
                            min_init=np.inf)[0]
    want = ops.ell_spmv(torch.from_numpy(x), torch.from_numpy(cols), reduce)
    if reduce == "min":
        assert torch.equal(got, want)
    else:
        ulp = np.spacing(np.abs(want.numpy()))
        assert (np.abs(got.numpy() - want.numpy()) <= ulp).all()


def test_tiles_rule():
    """One block per TILE items of rows + entries; 32-bit offsets checked."""
    assert ops.TILE == ops.THREADS * ops.ITEMS_PER_THREAD
    assert ops.tiles(1, 0) == 1
    assert ops.tiles(ops.TILE, 0) == 1 and ops.tiles(ops.TILE, 1) == 2
    assert ops.tiles(524_288, 8_200_000) == -(-(524_288 + 8_200_000) // ops.TILE)
    assert ops.tiles(2**31 - ops.TILE - 2, 1) > 0
    with pytest.raises(ValueError, match="32-bit"):
        ops.tiles(2**31 - ops.TILE - 1, 1)


def test_tiling_constants_match_the_kernel_source():
    src = (Path(ops.__file__).parent / "csrc" / "ell_spmv.cu").read_text()
    assert f"constexpr int kThreads = {ops.THREADS};" in src
    assert f"constexpr int kItemsPerThread = {ops.ITEMS_PER_THREAD};" in src


def test_wrappers_check_arguments():
    x = torch.zeros(5, dtype=torch.float32)
    cols = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="reduce"):
        ops.ell_spmv(x, cols, "max")
    with pytest.raises(TypeError, match="int32"):
        ops.ell_spmv(x, cols.long(), "sum")
    with pytest.raises(ValueError, match="at least one column"):
        ops.ell_spmv(x, torch.zeros((2, 0), dtype=torch.int32), "sum")
    with pytest.raises(ValueError, match="1-D"):
        ops.ell_spmv(x[None], cols, "sum")
    xs = torch.zeros((2, 5), dtype=torch.float32)
    rp = torch.zeros((3, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="device count"):
        ops.ell_spmv_segments(xs, rp, torch.zeros((2, 3), dtype=torch.int32), "sum")
    with pytest.raises(TypeError, match="int64"):
        ops.ell_spmv_segments(xs, rp[:2].int(), torch.zeros((2, 3), dtype=torch.int32), "sum")
    with pytest.raises(ValueError, match="contiguous"):
        ops.ell_spmv_segments(xs, rp[:2], torch.zeros((3, 2), dtype=torch.int32).t(), "sum")


def test_localized_from_arrays_checks_the_layout():
    _, _, _, lg = _layout("rmat1500", "fennel", 2)
    fields = dataclasses.asdict(lg)
    rows = fields["rows"].copy()
    rows[0, [0, 1]] = rows[0, [1, 0]] + np.array([1, 0])  # out of CSR order
    with pytest.raises(ValueError, match="non-decreasing"):
        localized_from_arrays(**{**fields, "rows": rows})
    with pytest.raises(ValueError, match="shape"):
        localized_from_arrays(**{**fields, "cols": fields["cols"][:, 1:]})
    cols = fields["cols"].copy()
    cols[1, 0] = lg.state_len
    with pytest.raises(ValueError, match="cols must index"):
        localized_from_arrays(**{**fields, "cols": cols})
