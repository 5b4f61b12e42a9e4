"""Q-gram-seeded mapper CLI (examples/qmap equivalent).

Ref parity: examples/qmap/qmap.cu — q-gram index seeding + banded
extension on single-end reads; the q-gram index is built in memory
from the packed genome stored in the index container.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="qmap", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-x", "--index", required=True, help="index .npz")
    p.add_argument("-U", required=True, help="reads FASTQ(.gz)")
    p.add_argument("-S", "--sam", required=True, help="output SAM(.gz|.bam)")
    p.add_argument("-q", "--gram", type=int, default=14,
                   help="q-gram length")
    p.add_argument("--stride", type=int, default=8,
                   help="read q-gram sampling stride")
    p.add_argument("--max-hits", type=int, default=8)
    p.add_argument("--max-read-len", type=int, default=320)
    p.add_argument("--local", action="store_true")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--stats", help="write stats JSON here")
    p.add_argument("--cpu", action="store_true", help="force XLA/CPU path")
    args = p.parse_args(argv)

    from ..utils.jax_cache import enable_compilation_cache
    enable_compilation_cache()

    import numpy as np
    from ..io.index_file import load_index
    from ..io.sequence import ReadBatchIterator
    from ..io.sam import SamWriter
    from ..models import MapperParams
    from ..models.qgram_mapper import QGramMapper
    from ..strings import pack_reads
    from ..utils.stats import MappingStats

    fm, ssa, genome, meta = load_index(args.index)
    params = MapperParams(
        local=args.local,
        batch_size=args.batch,
        sa_sample=meta["sa_sample"],
        lut_k=meta.get("lut_k", 0),
        max_read_len=args.max_read_len,
    )
    contigs = {
        "names": meta["contig_names"],
        "starts": np.concatenate(
            [[0], np.cumsum(meta["contig_lens"][:-1])]
        ).astype(np.int64),
        "lens": np.array(meta["contig_lens"], dtype=np.int64),
    }
    mapper = QGramMapper(
        fm, ssa, genome, q=args.gram, stride=args.stride,
        max_hits=args.max_hits, params=params, contigs=contigs)
    stats = MappingStats()
    writer_cls = SamWriter
    if args.sam.endswith(".bam"):
        from ..io.bam import BamWriter as writer_cls
    writer = writer_cls(args.sam, meta["contig_names"], meta["contig_lens"],
                        cmdline=" ".join(argv or sys.argv[1:]),
                        program="nvbio_qmap")

    def packed():
        for names, seqs, quals in ReadBatchIterator(args.U, args.batch):
            reads, lens, qmat, _ = pack_reads(
                seqs, quals, max_len=args.max_read_len)
            yield names, reads, lens, qmat

    with stats.timer("total"):
        # double-buffered (InputThread/ComputeThread equiv)
        with stats.timer("compute"):
            for names, reads, lens, qmat, results in \
                    mapper.map_stream(packed()):
                stats.observe(results)
                with stats.timer("output"):
                    for rec in mapper.to_sam_records(
                            names, reads, lens, qmat, results):
                        writer.write(rec)
    writer.close()
    report = stats.report(file=sys.stderr)
    if args.stats:
        with open(args.stats, "w") as f:
            f.write(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
