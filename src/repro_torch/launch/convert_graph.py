"""Convert an edge list into the on-disk external CSR format.

    PYTHONPATH=src python -m repro_torch.launch.convert_graph edges.txt graph.bin \\
        [--num-vertices N] [--chunk-edges 4194304] [--delimiter ,]

Accepts SNAP-style text edge lists (``.txt``/``.csv``/``.tsv``: one ``u v``
pair per line, ``#`` comments and extra columns ignored) and binary ``.npy``
``(m, 2)`` arrays. The conversion is two-pass and bounded-memory (one chunk
plus ``O(|V|)`` degree bookkeeping resident at a time), and the output is
bit-identical to ``CSRGraph.from_edges`` on the same input: self-loops
dropped, duplicates (either direction) deduplicated, symmetric adjacency with
rows sorted by neighbour id. The arguments and the bytes written are those
of the reference's ``scripts/convert_graph.py``.

The output partitions out-of-core, on the card or (``device="cpu"``) on the
host:

    import repro_torch.api as tapi
    tapi.partition(tapi.PartitionSpec(algo="fennel", k=8, source="graph.bin"))
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.convert_graph", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("input", help="edge list: .txt/.csv/.tsv text or .npy (m,2)")
    ap.add_argument("output", help="output .bin external CSR path")
    ap.add_argument("--num-vertices", type=int, default=None, metavar="N",
                    help="vertex-count override (default: max id + 1)")
    ap.add_argument("--chunk-edges", type=int, default=1 << 22,
                    help="edges parsed per chunk (bounds converter memory)")
    ap.add_argument("--merge-block", type=int, default=1 << 20,
                    help="keys per merge/scatter block")
    ap.add_argument("--delimiter", default=None,
                    help="text column delimiter (default: whitespace; "
                         ".csv implies ',')")
    ap.add_argument("--tmp-dir", default=None,
                    help="spill directory for sort runs (default: system tmp)")
    ap.add_argument("--format", type=int, choices=(1, 2), default=2,
                    help="on-disk format: 2 = block-compressed delta-varint "
                         "(default), 1 = raw int32 neighbour arrays")
    ap.add_argument("--block-cap", type=int, default=None,
                    help="values per compression block (v2 only; default 64)")
    ap.add_argument("--workers", type=int, default=0,
                    help="converter threads for sort/compress passes "
                         "(0 = auto: cpu_count)")
    args = ap.parse_args(argv)

    from repro_torch.graph.compress import DEFAULT_BLOCK_CAP
    from repro_torch.graph.external import convert_edge_list

    t0 = time.perf_counter()
    stats = convert_edge_list(
        args.input,
        args.output,
        num_vertices=args.num_vertices,
        chunk_edges=args.chunk_edges,
        merge_block=args.merge_block,
        delimiter=args.delimiter,
        tmp_dir=args.tmp_dir,
        format_version=args.format,
        block_cap=(
            args.block_cap if args.block_cap is not None else DEFAULT_BLOCK_CAP
        ),
        max_workers=args.workers,
    )
    seconds = time.perf_counter() - t0
    ratio = stats.get("compression_ratio")
    compressed = (
        f", {stats['raw_bytes']} raw -> {stats['file_bytes']} on disk "
        f"({ratio:.2f}x)"
        if ratio
        else f", {stats['file_bytes']} bytes"
    )
    print(
        f"wrote {args.output} (v{stats['format_version']}): "
        f"|V|={stats['num_vertices']} |E|={stats['num_edges']} "
        f"({stats['input_edges']} input rows, {stats['runs']} sort runs, "
        f"{stats['workers']} workers{compressed}) in {seconds:.1f}s",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
