"""Out-of-core graphs in the PyTorch port against ``repro`` on the CPU: the
delta-varint codec, the v1/v2 on-disk files (written by either package and
read by the other), the bounded-memory converter and its entry, spec
sources, the decode-ahead prefetcher, the partition-score kernel's rows
entries, and every registry name partitioning a memory-mapped graph with the
reference's result under every ``prefetch`` mode."""
import importlib.util
import os
import struct

import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.graph.compress as rcomp
import repro.graph.external as rext
import repro.graph.prefetch as rpf
import repro_torch.api as tapi
import repro_torch.graph.compress as tcomp
import repro_torch.graph.external as text
import repro_torch.graph.prefetch as tpf
from repro.core.refinement import build_subpartition_graph as ref_build_w
from repro.graph.csr import CSRGraph as RefCSR
from repro.graph.generators import rmat_graph
from repro.graph.metrics import quality_report as ref_quality
from repro.kernels.partition_score import fennel_scores as ref_fennel_scores
from repro_torch.core import engine as tengine
from repro_torch.core.refinement import build_subpartition_graph
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.metrics import quality_report
from repro_torch.kernels.partition_score import ops

CPU = torch.device("cpu")
ROOT = os.path.join(os.path.dirname(__file__), "..")
NAMES = sorted(rapi.REGISTRY)
PREFETCH_NAMES = sorted(
    n for n in NAMES
    if rapi.get_info(n).params_cls is not None and "prefetch" in rapi.get_info(n).param_names()
)
TELEMETRY_BYTES = ("graph_backing", "peak_graph_bytes", "mapped_graph_bytes",
                   "compressed_graph_bytes")


@pytest.fixture(scope="module")
def graph():
    return rmat_graph(1500, avg_degree=8, seed=3)


@pytest.fixture(scope="module")
def files(graph, tmp_path_factory):
    """The graph written by the reference as v1 and v2."""
    d = tmp_path_factory.mktemp("ooc")
    out = {}
    for v in (1, 2):
        out[v] = str(d / f"g{v}.bin")
        rext.convert_csr(graph, out[v], format_version=v)
    return out


def _messy_edges(seed=0, n=400, m=4000):
    """Edge list with duplicates in both directions and self-loops."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(m, 2))
    dupes = edges[::5][:, ::-1]
    loops = np.stack([np.arange(0, n, 7)] * 2, axis=1)
    return np.concatenate([edges, dupes, edges[::11], loops])


def _raises_same(fn_ref, fn_port, exc=ValueError):
    with pytest.raises(exc) as want:
        fn_ref()
    with pytest.raises(exc) as got:
        fn_port()
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------- codec
def _rows(case: str, seed: int = 0):
    """(flat, degs) of strictly sorted rows for one codec case."""
    rng = np.random.default_rng(seed)
    if case == "random":
        degs = rng.integers(0, 40, size=60)
        hi = 5000
    elif case == "empty_rows":
        degs = np.array([0, 0, 3, 0, 1, 0, 0, 2, 0])
        hi = 50
    elif case == "single_entries":
        degs = np.ones(30, dtype=np.int64)
        hi = 1 << 20
    elif case == "long_rows":
        degs = np.array([64, 65, 129, 300, 1, 63])
        hi = 100_000
    else:  # large ids, near the int32 limit of the format and beyond it
        degs = np.array([3, 5, 2])
        hi = 2**40
    rows = [np.sort(rng.choice(hi, size=int(d), replace=False)) for d in degs]
    if case == "large_ids":
        rows[0] = np.array([0, 2**31 - 2, 2**31 - 1])
    flat = np.concatenate(rows).astype(np.int64) if rows else np.empty(0, np.int64)
    return flat, np.asarray(degs, dtype=np.int64)


@pytest.mark.parametrize("block_cap", [1, 3, 64])
@pytest.mark.parametrize(
    "case", ["random", "empty_rows", "single_entries", "long_rows", "large_ids"])
def test_encode_adjacency_bytes_equal_reference(case, block_cap):
    flat, degs = _rows(case)
    want_data, want_rb = rcomp.encode_adjacency(flat, degs, block_cap)
    got_data, got_rb = tcomp.encode_adjacency(flat, degs, block_cap)
    assert got_data.dtype == np.uint8 and got_data.tobytes() == want_data.tobytes()
    np.testing.assert_array_equal(got_rb, want_rb)
    off = np.concatenate(([0], np.cumsum(got_rb)))
    # round trip through both decoders, with the block index checked
    for dec in (tcomp.decode_adjacency, rcomp.decode_adjacency):
        np.testing.assert_array_equal(dec(got_data, degs, block_cap, row_byte_off=off), flat)
    np.testing.assert_array_equal(
        tcomp._restart_mask(degs, block_cap), rcomp._restart_mask(degs, block_cap))


def test_varints_equal_reference():
    vals = np.array([0, 1, 127, 128, 16383, 16384, 2**31 - 1, 2**35, 2**56, 2**63 - 1],
                    dtype=np.int64)
    np.testing.assert_array_equal(tcomp.varint_sizes(vals), rcomp.varint_sizes(vals))
    got, nb = tcomp.varint_encode(vals)
    want, _ = rcomp.varint_encode(vals)
    assert got.tobytes() == want.tobytes() and int(nb.sum()) == got.shape[0]
    back, starts = tcomp.varint_decode(got, count=vals.shape[0])
    np.testing.assert_array_equal(back, vals)
    np.testing.assert_array_equal(starts, rcomp.varint_decode(want)[1])
    assert tcomp.DEFAULT_BLOCK_CAP == rcomp.DEFAULT_BLOCK_CAP == 64
    assert tcomp.MAX_VARINT_BYTES == rcomp.MAX_VARINT_BYTES


@pytest.mark.parametrize("bad", [
    ("varint_encode", (np.array([1, -2]),), {}),
    ("varint_decode", (np.array([0x81, 0x80], np.uint8),), {}),
    ("varint_decode", (np.array([1, 2, 3], np.uint8),), {"count": 2}),
    ("varint_decode", (np.array([0x80] * 10 + [1], np.uint8),), {}),
    ("varint_decode", (np.empty(0, np.uint8),), {"count": 3}),
    ("encode_adjacency", (np.array([3, 1]), np.array([2])), {}),
    ("encode_adjacency", (np.array([1, 1]), np.array([2])), {}),
    ("encode_adjacency", (np.array([1, 2]), np.array([3])), {}),
    ("encode_adjacency", (np.array([1, 2]), np.array([2])), {"block_cap": 0}),
    ("decode_adjacency", (np.array([1, 1, 1], np.uint8), np.array([1, 2])),
     {"row_byte_off": np.array([0, 2, 3])}),
], ids=["negative", "truncated", "count", "overlong", "empty", "unsorted",
        "duplicate", "degs", "block_cap", "shifted_rows"])
def test_codec_errors_equal_reference(bad):
    name, args, kw = bad
    _raises_same(lambda: getattr(rcomp, name)(*args, **kw),
                 lambda: getattr(tcomp, name)(*args, **kw))


# --------------------------------------------------------------------- files
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_files_load_in_both_packages(graph, tmp_path, version, writer):
    path = str(tmp_path / "g.bin")
    other = str(tmp_path / "other.bin")
    mine, theirs = (rext, text) if writer == "reference" else (text, rext)
    mine.write_external_csr(path, graph.indptr, graph.indices, version=version)
    theirs.write_external_csr(other, graph.indptr, graph.indices, version=version)
    assert open(path, "rb").read() == open(other, "rb").read()
    for pkg in (rext, text):
        ext = pkg.ExternalCSRGraph(path)
        assert ext.backing == "mapped" and ext.format_version == version
        assert (ext.num_vertices, ext.num_edges) == (graph.num_vertices, graph.num_edges)
        np.testing.assert_array_equal(np.asarray(ext.indptr), graph.indptr)
        np.testing.assert_array_equal(np.asarray(ext.indices), graph.indices)
        np.testing.assert_array_equal(ext.degrees, graph.degrees)
    port = text.ExternalCSRGraph(path)
    ref = rext.ExternalCSRGraph(path)
    for v in (0, 7, graph.num_vertices - 1):
        np.testing.assert_array_equal(port.neighbors(v), graph.neighbors(v))
        assert port.degree(v) == graph.degree(v)
    # the proxy's index forms (v2) and the chunked scans equal the reference's
    pos = np.array([0, 5, 17, 3, graph.indices.shape[0] - 1])
    mask = np.zeros(graph.indices.shape[0], dtype=bool)
    mask[::7] = True
    for key in (3, -1, slice(10, 200), slice(0, 50, 3), pos, mask):
        np.testing.assert_array_equal(port.indices[key], ref.indices[key])
    np.testing.assert_array_equal(port.edges_array(), graph.edges_array())
    vmask = np.zeros(graph.num_vertices, dtype=bool)
    vmask[::3] = True
    assert port.subgraph_edge_count(vmask) == graph.subgraph_edge_count(vmask)
    assert list(port.iter_adjacency([4, 2]))[1][0] == 2
    for attr in ("nbytes_mapped", "nbytes_compressed"):
        assert getattr(port, attr) == getattr(ref, attr)
    assert port.nbytes_resident == 0  # nothing materialized yet
    _ = port.degrees, ref.degrees
    assert port.nbytes_resident == ref.nbytes_resident == graph.degrees.nbytes
    back = port.to_csr()
    assert isinstance(back, CSRGraph)
    np.testing.assert_array_equal(back.indices, graph.indices)


def test_empty_graph_file(tmp_path):
    path = tmp_path / "empty.bin"
    text.write_external_csr(path, np.zeros(1, dtype=np.int64), np.empty(0, np.int32))
    for pkg in (rext, text):
        ext = pkg.ExternalCSRGraph(path)
        assert ext.num_vertices == 0 and ext.num_edges == 0


def _corrupt(case: str, graph, files, tmp_path) -> str:
    """Path of a damaged file for one of the reference's corruption cases."""
    path = tmp_path / f"{case}.bin"
    v1 = open(files[1], "rb").read()
    v2 = open(files[2], "rb").read()
    if case == "missing":
        return str(tmp_path / "nope.bin")
    if case == "tiny":
        path.write_bytes(b"XC")
    elif case == "bad_magic":
        path.write_bytes(b"NOTAGRPH" + b"\0" * 100)
    elif case == "version":
        head = struct.pack("<8sII qq", rext.MAGIC, rext.FORMAT_VERSION + 9, 0, 0, 0)
        path.write_bytes(head + b"\0" * (rext.HEADER_BYTES - len(head)) + b"\0" * 8)
    elif case == "truncated":
        path.write_bytes(v1[: len(v1) // 2])
    elif case == "trailing":
        path.write_bytes(v1 + b"\0" * 64)
    elif case == "indptr":
        bad = graph.indptr.copy()
        bad[-1] += 4
        rext.write_external_csr(path, bad, graph.indices)
    elif case == "v2_truncated":
        path.write_bytes(v2[:-10])
    elif case == "v2_header":
        data = bytearray(v2)
        struct.pack_into("<I", data, 40, 0)  # block_cap 0
        path.write_bytes(bytes(data))
    elif case == "v2_block_index":
        data = bytearray(v2)
        off = rext.HEADER_BYTES + 8 * (graph.num_vertices + 1)
        struct.pack_into("<I", data, off, 5)  # byte_off[0] != 0
        path.write_bytes(bytes(data))
    return str(path)


@pytest.mark.parametrize("case", [
    "missing", "tiny", "bad_magic", "version", "truncated", "trailing", "indptr",
    "v2_truncated", "v2_header", "v2_block_index",
])
def test_header_and_corruption_errors_equal_reference(graph, files, tmp_path, case):
    path = _corrupt(case, graph, files, tmp_path)
    _raises_same(lambda: rext.ExternalCSRGraph(path), lambda: text.ExternalCSRGraph(path))


def test_corrupt_data_region_raises_as_reference(graph, files, tmp_path):
    data = bytearray(open(files[2], "rb").read())
    for i in range(len(data) - 400, len(data) - 1):
        data[i] = 0xFF  # a run of continuation bytes: no value ends there
    path = tmp_path / "flipped.bin"
    path.write_bytes(bytes(data))
    _raises_same(lambda: np.asarray(rext.ExternalCSRGraph(path).indices),
                 lambda: np.asarray(text.ExternalCSRGraph(path).indices))


def test_wide_offsets_forced_small(graph, files, tmp_path, monkeypatch):
    """A data region past 4 GiB switches the block index to int64 offsets
    (header flag bit 0). Forced at a small size in the port's writer, the
    file equals the reference's narrow file with the flag set and the index
    widened, and both packages read it."""
    monkeypatch.setattr(text, "_MAX_NARROW_OFFSET", 0)
    path = str(tmp_path / "wide.bin")
    text.write_external_csr(path, graph.indptr, graph.indices, version=2)
    narrow = open(files[2], "rb").read()
    n = graph.num_vertices
    head = bytearray(narrow[: rext.HEADER_BYTES])
    struct.pack_into("<I", head, 12, 1)
    idx_off = rext.HEADER_BYTES + 8 * (n + 1)
    byte_off = np.frombuffer(narrow, "<u4", n + 1, idx_off).astype("<i8")
    want = bytes(head) + narrow[rext.HEADER_BYTES : idx_off] + byte_off.tobytes() + \
        narrow[idx_off + 4 * (n + 1) :]
    assert open(path, "rb").read() == want
    for pkg in (rext, text):
        ext = pkg.ExternalCSRGraph(path)
        assert ext.byte_off.dtype == np.dtype("<i8")
        np.testing.assert_array_equal(np.asarray(ext.indices), graph.indices)
    # the converter's v2 assembly takes the same switch
    edges = tmp_path / "e.npy"
    np.save(edges, graph.edges_array())
    out = str(tmp_path / "conv.bin")
    text.convert_edge_list(str(edges), out, num_vertices=n, max_workers=1)
    assert open(out, "rb").read() == want


# ----------------------------------------------------------------- converter
def _edge_file(tmp_path, via: str, edges: np.ndarray, extra: bool = False) -> str:
    if via == "npy":
        src = tmp_path / "e.npy"
        np.save(src, edges if not extra else np.concatenate(
            [edges, np.arange(edges.shape[0])[:, None]], axis=1))
        return str(src)
    sep = {"csv": ",", "txt": " ", "tsv": "\t"}[via]
    src = tmp_path / f"e.{via}"
    with open(src, "w") as f:
        f.write("# snap-style header comment\n")
        for i, (a, b) in enumerate(edges):
            f.write(f"{a}{sep}{b}{sep}{i * 0.25}\n" if extra else f"{a}{sep}{b}\n")
    return str(src)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("via,extra,chunk,block,workers", [
    ("npy", False, 1 << 22, 1 << 20, 0),
    ("txt", True, 1 << 22, 1 << 20, 1),
    ("csv", False, 1 << 22, 1 << 20, 2),
    ("npy", True, 257, 61, 0),   # many spill runs and merge blocks
    ("txt", False, 300, 97, 1),
])
def test_convert_edge_list_bytes_equal_reference(tmp_path, version, via, extra, chunk,
                                                 block, workers):
    edges = _messy_edges(seed=1, n=300, m=6000)
    src = _edge_file(tmp_path, via, edges, extra)
    kw = dict(num_vertices=300, chunk_edges=chunk, merge_block=block,
              format_version=version, max_workers=workers)
    want = rext.convert_edge_list(src, str(tmp_path / "ref.bin"), **kw)
    got = text.convert_edge_list(src, str(tmp_path / "port.bin"), **kw)
    assert got == want
    if chunk < 1000:
        assert got["runs"] > 10
    assert open(tmp_path / "port.bin", "rb").read() == open(tmp_path / "ref.bin", "rb").read()
    ref = RefCSR.from_edges(edges, num_vertices=300)
    ext = text.ExternalCSRGraph(tmp_path / "port.bin")
    np.testing.assert_array_equal(np.asarray(ext.indices), ref.indices)
    np.testing.assert_array_equal(np.asarray(ext.indptr), ref.indptr)


@pytest.mark.parametrize("case", ["negative", "beyond", "npy_shape", "version"])
def test_convert_errors_equal_reference(tmp_path, case):
    src = str(tmp_path / "e.npy")
    kw = {}
    if case == "negative":
        np.save(src, np.array([[0, 1], [-2, 3]]))
    elif case == "beyond":
        np.save(src, np.array([[0, 7]]))
        kw = dict(num_vertices=5)
    elif case == "npy_shape":
        np.save(src, np.arange(10))
    else:
        np.save(src, np.array([[0, 1]]))
        kw = dict(format_version=3)
    out = str(tmp_path / "g.bin")
    _raises_same(lambda: rext.convert_edge_list(src, out, **kw),
                 lambda: text.convert_edge_list(src, out, **kw))
    assert not os.path.exists(out)


def test_infers_num_vertices_and_drops_loops(tmp_path):
    src = str(tmp_path / "e.npy")
    np.save(src, np.array([[1, 1], [0, 5], [5, 0], [0, 5], [2, 2]]))
    stats = text.convert_edge_list(src, str(tmp_path / "g.bin"))
    assert stats["num_vertices"] == 6 and stats["num_edges"] == 1
    ext = text.ExternalCSRGraph(tmp_path / "g.bin")
    np.testing.assert_array_equal(ext.neighbors(0), [5])
    assert ext.degree(2) == 0


def test_converter_entry_matches_reference_script(tmp_path):
    from repro_torch.launch.convert_graph import main

    spec = importlib.util.spec_from_file_location(
        "convert_graph", os.path.join(ROOT, "scripts", "convert_graph.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    src = _edge_file(tmp_path, "tsv", _messy_edges(seed=5, n=200, m=1500))
    for fmt in ("1", "2"):
        args = [src, "--num-vertices", "200", "--format", fmt, "--chunk-edges", "400",
                "--block-cap", "16"]
        assert main([src, str(tmp_path / "port.bin")] + args[1:]) == 0
        assert script.main([src, str(tmp_path / "ref.bin")] + args[1:]) == 0
        assert open(tmp_path / "port.bin", "rb").read() == open(tmp_path / "ref.bin", "rb").read()


# ------------------------------------------------------------------- sources
def test_sources_and_npz_dumps(graph, files, tmp_path):
    for ok in ("some/dir/graph.bin", "dump.npz", "/data/run:3/graph.bin", "rmat:100:4",
               "dataset:web-s"):
        text.validate_source(ok)
        assert tapi.PartitionSpec(algo="fennel", k=2, source=ok).to_json() == \
            rapi.PartitionSpec(algo="fennel", k=2, source=ok).to_json()
    for bad in ("", "rmat:", "rmat:0", "rmat:x", "rmat:100:0", "rmat:1:2:3",
                "dataset:no-such-dataset"):
        _raises_same(lambda: rext.validate_source(bad), lambda: text.validate_source(bad))
    _raises_same(lambda: rext.load_graph_source("/data/run:3/graph.bin"),
                 lambda: text.load_graph_source("/data/run:3/graph.bin"))
    assert isinstance(text.load_graph_source(files[2]), text.ExternalCSRGraph)
    assert isinstance(text.load_graph_file(files[1]), text.ExternalCSRGraph)
    g = text.load_graph_source("rmat:500:6", seed=2)
    np.testing.assert_array_equal(g.indices, rmat_graph(500, avg_degree=6, seed=2).indices)
    # .npz dumps cross the packages both ways
    ref_npz, port_npz = str(tmp_path / "r.npz"), str(tmp_path / "p.npz")
    graph.save(ref_npz)
    CSRGraph(indptr=graph.indptr, indices=graph.indices).save(port_npz)
    for path in (ref_npz, port_npz):
        got, want = text.load_graph_file(path), rext.load_graph_file(path)
        assert isinstance(got, CSRGraph)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)


# ------------------------------------------------------------------ prefetch
def test_prefetcher_matches_reference():
    for pkg in (rpf, tpf):
        stats = pkg.PrefetchStats()
        with pkg.BatchPrefetcher(lambda i: i * i, range(20), depth=3, stats=stats) as pf:
            assert list(pf) == [i * i for i in range(20)]
        assert stats.hits + stats.misses == 20
        assert set(stats.to_telemetry()) == {"prefetch_hit_rate", "prefetch_wait_s",
                                             "decode_wall_s"}

    def boom(i):
        if i == 2:
            raise RuntimeError("fetch failed")
        return i

    pf = tpf.BatchPrefetcher(boom, range(5))
    assert [next(pf), next(pf)] == [0, 1]
    with pytest.raises(RuntimeError, match="fetch failed"):
        next(pf)
    pf.close()
    pf.close()
    _raises_same(lambda: rpf.BatchPrefetcher(boom, [], depth=0),
                 lambda: tpf.BatchPrefetcher(boom, [], depth=0))


# -------------------------------------------------------------- rows entries
def _chunk(graph, ids, rng, k=8):
    """A chunk's local CSR, the graph's ``part_of`` and sizes for the rows
    entries, plus the whole-graph inputs of the gather entry."""
    degs = graph.indptr[ids + 1] - graph.indptr[ids]
    cols = np.concatenate([graph.neighbors(v) for v in ids]).astype(np.int32)
    local = np.concatenate(([0], np.cumsum(degs))).astype(np.int64)
    part = rng.integers(-1, k, size=graph.num_vertices).astype(np.int32)
    sizes = rng.uniform(0, 500, size=k).astype(np.float32)
    return local, cols, part, sizes


@pytest.mark.parametrize("alpha", [0.0, 0.7])
def test_rows_entries_equal_gather_entries_and_reference(graph, alpha):
    rng = np.random.default_rng(0)
    hub = int(np.argmax(graph.degrees))
    ids = np.concatenate(([hub], rng.choice(graph.num_vertices, 300, replace=False),
                          [hub])).astype(np.int64)
    local, cols, part, sizes = _chunk(graph, ids, rng)
    t = torch.from_numpy
    got = ops.fennel_scores_rows(t(local), t(cols), t(part), t(sizes), alpha, 1.5)
    want = ops.fennel_scores_gather(t(graph.indptr), t(graph.indices), t(part), t(ids),
                                    t(sizes), alpha, 1.5)
    assert torch.equal(got, want)
    # the reference's dense scoring of the same rows (-1 padded)
    width = int((local[1:] - local[:-1]).max())
    dense = np.full((ids.shape[0], width), -1, np.int32)
    for r in range(ids.shape[0]):
        dense[r, : local[r + 1] - local[r]] = part[cols[local[r] : local[r + 1]]]
    ref = np.asarray(ref_fennel_scores(dense, sizes, alpha, 1.5, use_pallas=False))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=0 if alpha == 0 else 1e-4)
    # sharded: four shards, one empty, penalised by their own size rows
    bounds = np.array([0, 100, 100, 250, ids.shape[0]], np.int64)
    ssizes = rng.uniform(0, 500, size=(4, 8)).astype(np.float32)
    got_s = ops.fennel_scores_sharded_rows(t(local), t(cols), t(part), t(bounds),
                                           t(ssizes), alpha, 1.5)
    want_s = ops.fennel_scores_sharded_gather(t(graph.indptr), t(graph.indices), t(part),
                                              t(ids), t(bounds), t(ssizes), alpha, 1.5)
    assert torch.equal(got_s, want_s)
    assert ops.rows_launches == ops.sharded_rows_launches == 0  # CPU calls count in none


@pytest.mark.parametrize("bad", ["indptr_end", "indptr_start", "falling", "col_range",
                                 "cols_dtype", "shard_bounds"])
def test_rows_entries_check_their_inputs(bad):
    local = torch.tensor([0, 2, 3], dtype=torch.int64)
    cols = torch.tensor([0, 3, 1], dtype=torch.int32)
    part = torch.zeros(4, dtype=torch.int32)
    sizes = torch.zeros(2, dtype=torch.float32)
    bounds = torch.tensor([0, 1, 2], dtype=torch.int64)
    match = {"indptr_end": "rise from 0", "indptr_start": "rise from 0",
             "falling": "rise from 0", "col_range": "vertex ids",
             "cols_dtype": "int32", "shard_bounds": "shard_start"}[bad]
    if bad == "indptr_end":
        local = torch.tensor([0, 2, 4], dtype=torch.int64)
    elif bad == "indptr_start":
        local = torch.tensor([1, 2, 3], dtype=torch.int64)
    elif bad == "falling":
        local = torch.tensor([0, 3, 2, 3], dtype=torch.int64)
    elif bad == "col_range":
        cols = torch.tensor([0, 4, 1], dtype=torch.int32)
    elif bad == "cols_dtype":
        cols = cols.long()
    if bad == "shard_bounds":
        with pytest.raises(ValueError, match=match):
            ops.fennel_scores_sharded_rows(local, cols, part, torch.tensor([0, 1, 1]),
                                           torch.zeros(2, 2), 0.0, 1.5)
        return
    with pytest.raises((ValueError, TypeError), match=match):
        ops.fennel_scores_rows(local, cols, part, sizes, 0.0, 1.5)
    with pytest.raises((ValueError, TypeError), match=match):
        ops.fennel_scores_sharded_rows(local, cols, part, bounds, sizes[None].expand(2, 2)
                                       .contiguous(), 0.0, 1.5)


@pytest.mark.parametrize("head,degs", [
    ([], [0, 0]), ([np.arange(5)], [3, 0, 2]), ([np.arange(3), np.array([0, 1])], [1]),
    ([], [2, 2, 1]),
])
def test_pack_rows_round_trip(head, degs):
    degs = np.asarray(degs, np.int64)
    cols = np.arange(int(degs.sum()), dtype=np.int32) * 7 + 1
    buf = tengine._pack_rows(head, degs, cols, pin=False)
    h = sum(a.shape[0] for a in head)
    local, got = tengine._unpack_rows(buf, h, degs.shape[0], cols.shape[0])
    np.testing.assert_array_equal(local.numpy(), np.concatenate(([0], np.cumsum(degs))))
    np.testing.assert_array_equal(got.numpy(), cols)
    assert got.dtype == torch.int32
    if head:
        np.testing.assert_array_equal(buf[:h].numpy(), np.concatenate(head))


# --------------------------------------------------------------- partitioning
def _fields(name: str, **extra) -> dict:
    info = rapi.get_info(name)
    out = dict(algo=name, k=4, seed=0, **extra)
    if info.balance_modes:
        out["balance_mode"] = info.balance_modes[-1]
    if "order" in info.common:
        out["order"] = "random"
    return out


def _assert_same_run(want, got):
    np.testing.assert_array_equal(got.assignment, want.assignment)
    if want.is_vertex_cut:
        np.testing.assert_array_equal(got.edge_partition.edge_part,
                                      want.edge_partition.edge_part)
    assert got.quality() == want.quality()
    assert got.telemetry.get("kernel_calls") == want.telemetry.get("kernel_calls")
    for key in TELEMETRY_BYTES:
        assert got.telemetry[key] == want.telemetry[key], key


@pytest.fixture(scope="module")
def reference_runs(graph):
    return {}


@pytest.mark.parametrize("backing", ["v1", "v2", "resident"])
@pytest.mark.parametrize("name", NAMES)
def test_every_name_mapped_equals_reference(graph, files, reference_runs, name, backing):
    """Each registry name on a mapped v1 and v2 file and on the resident
    graph gives the reference's assignment (or edge partition), quality,
    launch count and graph-byte telemetry; the mapped run never copies the
    graph to the device whole (``ExternalCSRGraph`` has no ``to``)."""
    if name not in reference_runs:
        reference_runs[name] = rapi.partition(graph, rapi.PartitionSpec(**_fields(name)))
    resident = reference_runs[name]
    if backing == "resident":
        tg = CSRGraph(indptr=graph.indptr, indices=graph.indices)
        _assert_same_run(resident, tapi.partition(tg, _fields(name), device="cpu"))
        return
    path = files[int(backing[1])]
    want = rapi.partition(rext.ExternalCSRGraph(path), rapi.PartitionSpec(**_fields(name)))
    np.testing.assert_array_equal(want.assignment, resident.assignment)
    ext = text.ExternalCSRGraph(path)
    assert not hasattr(ext, "to")
    got = tapi.partition(ext, _fields(name), device="cpu")
    _assert_same_run(want, got)
    assert got.telemetry["graph_backing"] == "mapped"


@pytest.mark.parametrize("mode", ["on", "off", "auto"])
@pytest.mark.parametrize("name", PREFETCH_NAMES)
def test_prefetch_modes_equal_reference(graph, files, name, mode):
    params = {"prefetch": mode}
    if name.endswith("-parallel"):
        params.update(num_shards=4, max_workers=1 if mode == "on" else 2)
    fields = _fields(name, params=params)
    want = rapi.partition(rext.ExternalCSRGraph(files[2]), rapi.PartitionSpec(**fields))
    got = tapi.partition(text.ExternalCSRGraph(files[2]), fields, device="cpu")
    _assert_same_run(want, got)
    # the decode-ahead telemetry keys are the reference's (their values are
    # wall times)
    keys = set(tpf.PrefetchStats().to_telemetry())
    assert keys & set(got.telemetry) == keys & set(want.telemetry)
    if rapi.get_info(name).engine == "engine":
        assert got.telemetry["decode_wall_s"] > 0
        assert ("prefetch_hit_rate" in got.telemetry) == (mode != "off")
    if mode == "on":  # decode-ahead on a resident graph too
        rg = CSRGraph(indptr=graph.indptr, indices=graph.indices)
        _assert_same_run(rapi.partition(graph, rapi.PartitionSpec(**fields)),
                         tapi.partition(rg, fields, device="cpu"))


def test_partition_from_a_file_source(graph, files):
    for path in (files[1], files[2]):
        spec = tapi.PartitionSpec(algo="fennel", k=4, balance_mode="edge", order="random",
                                  source=path)
        got = tapi.partition(spec, device="cpu")
        want = rapi.partition(rapi.PartitionSpec(**spec.to_dict()))
        np.testing.assert_array_equal(got.assignment, want.assignment)
        assert got.telemetry["mapped_graph_bytes"] == os.path.getsize(path)


def test_range_scans_equal_reference(graph, files, monkeypatch):
    """quality_report and the sub-partition graph of a mapped graph, scanned
    in many row ranges, equal the reference's whole-graph scans."""
    monkeypatch.setattr(text, "SCAN_ROWS", 97)
    rng = np.random.default_rng(1)
    part = rng.integers(0, 5, size=graph.num_vertices)
    sub = rng.integers(0, 23, size=graph.num_vertices)
    want_w = ref_build_w(graph, sub, 23)
    want_q = ref_quality(graph, part, 5)
    for path in (files[1], files[2]):
        ext = text.ExternalCSRGraph(path)
        assert quality_report(ext, part, 5, CPU) == want_q
        got_w = build_subpartition_graph(ext, sub, 23, CPU)
        np.testing.assert_array_equal(got_w.numpy(), want_w)
    assert len(list(text.iter_row_ranges(ext))) == -(-graph.num_vertices // 97)


def test_mapped_cuttana_never_asks_for_a_device_copy(graph, files, monkeypatch):
    """A mapped cuttana run through phase 2 and ``quality()`` completes
    although ``ExternalCSRGraph`` has no ``to``; a whole-graph upload fails
    loudly."""
    ext = text.ExternalCSRGraph(files[2])
    with pytest.raises(AttributeError):
        ext.to(CPU)
    launched = []
    real = ops.fennel_scores_rows

    def spy(*args):
        launched.append(args[0].shape[0] - 1)
        return real(*args)

    monkeypatch.setattr(tengine, "fennel_scores_rows", spy)
    fields = _fields("cuttana", params={"use_buffer": False})
    got = tapi.partition(ext, fields, device="cpu")
    want = rapi.partition(graph, rapi.PartitionSpec(**fields))
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.quality() == want.quality()
    assert got.timings["phase2_seconds"] > 0
    assert len(launched) == got.telemetry["kernel_calls"] > 0
    assert max(launched) <= 512


def test_concurrent_decodes_lose_no_update(graph, files):
    """The v2 proxy is read from the prefetch thread and pool threads at
    once: 16 threads (more than this host's cores) decode rows under a
    tiny switch interval; every row decodes right and the decode
    accounting, kept under a lock, loses no call."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    ext = text.ExternalCSRGraph(files[2])
    rng = np.random.default_rng(0)
    batches = [rng.choice(graph.num_vertices, 64, replace=False) for _ in range(200)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            outs = list(pool.map(
                lambda b: tengine._expand_csr_batch(
                    ext.indptr, ext.indices, b, graph.indptr[b + 1] - graph.indptr[b]),
                batches, timeout=120))
    finally:
        sys.setswitchinterval(old)
    for b, (_, cols) in zip(batches, outs):
        np.testing.assert_array_equal(cols, np.concatenate([graph.neighbors(v) for v in b]))
    assert ext.indices.decode_calls == len(batches)
    assert ext.decode_wall_s > 0
