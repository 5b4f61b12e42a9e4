"""Mapper CLI (nvBowtie equivalent): index + FASTQ -> SAM.

Ref parity: nvBowtie/nvBowtie.cpp main + params.cpp flags.  Option
names keep Bowtie2 conventions where they exist (-U/-1/-2/-S, -L
seed length, -i interval, --minins/--maxins, --local).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="map_reads", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-x", "--index", required=True, help="index .npz")
    p.add_argument("-U", help="unpaired reads FASTQ(.gz)")
    p.add_argument("-1", dest="m1", help="mate-1 FASTQ(.gz)")
    p.add_argument("-2", dest="m2", help="mate-2 FASTQ(.gz)")
    p.add_argument("-S", "--sam", required=True, help="output SAM(.gz)")
    p.add_argument("-L", "--seed-len", type=int, default=22)
    p.add_argument("-i", "--seed-interval", default="S,1,1.15",
                   help="seed interval: a constant (e.g. 11) or a "
                   "Bowtie2 function FN,A,B of read length x (C const, "
                   "L linear, S sqrt, G ln; default S,1,1.15). "
                   "Functions are evaluated once on the first read's "
                   "length (one static shape per run)")
    p.add_argument("-N", dest="seed_mm", type=int, default=0, choices=[0, 1],
                   help="mismatches allowed in seed (bowtie2 -N)")
    p.add_argument("--max-read-len", type=int, default=320,
                   help="pad/bucket reads to this many bp; raise for "
                   "long reads")
    p.add_argument("--band", type=int, default=None,
                   help="extension band half-width (default 15; long "
                   "reads want more indel drift room, e.g. 63)")
    p.add_argument("--minins", type=int, default=0)
    p.add_argument("--maxins", type=int, default=500)
    orient = p.add_mutually_exclusive_group()
    orient.add_argument("--fr", dest="pe_orient", action="store_const",
                        const="fr", help="mates: upstream forward / "
                        "downstream reverse (default; bowtie2 --fr)")
    orient.add_argument("--rf", dest="pe_orient", action="store_const",
                        const="rf", help="mates: upstream reverse / "
                        "downstream forward (bowtie2 --rf)")
    orient.add_argument("--ff", dest="pe_orient", action="store_const",
                        const="ff", help="mates: both same strand, "
                        "mate 1 upstream (bowtie2 --ff)")
    p.set_defaults(pe_orient="fr")
    p.add_argument("--no-mixed", action="store_true",
                   help="suppress single-end fallback for pairs that "
                   "fail to align as pairs (bowtie2 --no-mixed)")
    p.add_argument("--no-discordant", action="store_true",
                   help="suppress discordant pair reports "
                   "(bowtie2 --no-discordant)")
    p.add_argument("--dovetail", action="store_true",
                   help="mates that extend past each other can still "
                   "be concordant (bowtie2 --dovetail)")
    p.add_argument("--no-contain", action="store_true",
                   help="a mate containing the other is not "
                   "concordant (bowtie2 --no-contain)")
    p.add_argument("--no-overlap", action="store_true",
                   help="overlapping mates are not concordant "
                   "(bowtie2 --no-overlap)")
    p.add_argument("--un", metavar="FQ",
                   help="write reads that fail to align to this "
                   "FASTQ(.gz) (bowtie2 --un)")
    p.add_argument("--al", metavar="FQ",
                   help="write reads that align at least once to this "
                   "FASTQ(.gz) (bowtie2 --al)")
    p.add_argument("--rg-id", metavar="ID",
                   help="read group ID: adds @RG SAM header + RG:Z "
                   "tag on every record (bowtie2 --rg-id)")
    p.add_argument("--rg", action="append", default=[],
                   metavar="FIELD:VALUE",
                   help="add FIELD:VALUE to the @RG line (repeatable; "
                   "needs --rg-id; bowtie2 --rg)")
    p.add_argument("--local", action="store_true")
    p.add_argument("--ma", type=int, default=None,
                   help="match bonus (default: 2 in --local, 0 "
                   "end-to-end; bowtie2 --ma)")
    p.add_argument("--mp", default="6,2", metavar="MX,MN",
                   help="max,min mismatch penalty; actual penalty "
                   "scales with base quality (bowtie2 --mp)")
    p.add_argument("--np", dest="n_pen", type=int, default=1,
                   help="penalty for positions with N (bowtie2 --np)")
    p.add_argument("--rdg", default="5,3", metavar="O,E",
                   help="read gap open,extend penalties (CIGAR D; "
                   "bowtie2 --rdg)")
    p.add_argument("--rfg", default="5,3", metavar="O,E",
                   help="reference gap open,extend penalties (CIGAR "
                   "I; bowtie2 --rfg)")
    p.add_argument("--score-min", default=None, metavar="FN,A,B",
                   help="minimum score function of read length "
                   "(bowtie2 --score-min; default L,-0.6,-0.6 "
                   "end-to-end, G,20,8 --local)")
    p.add_argument("--phred64", action="store_true",
                   help="input qualities are Phred+64")
    p.add_argument("--solexa-quals", action="store_true",
                   help="input qualities are Solexa+64 (converted to "
                   "Phred)")
    p.add_argument("-a", "--all", dest="all_hits", action="store_true",
                   help="report all alignments above score-min "
                   "(nvBowtie --all; secondary records FLAG 0x100)")
    p.add_argument("--max-alns", type=int, default=8,
                   help="per-read alignment cap in --all mode")
    p.add_argument("--batch", type=int, default=4096,
                   help="reads per device batch")
    p.add_argument("--lut-k", type=int, default=None,
                   help="rebuild the seed-tail k-mer LUT at this "
                   "depth at load time (sharded indexes; deeper "
                   "shortens the backward-search LF chain — k=13 "
                   "costs ~20 s + 1 GB HBM per Gbp-scale shard)")
    p.add_argument("--locate-frac", type=float, default=None,
                   help="cross-read SSA-locate budget as a fraction of "
                   "the selected hit slots (default 0.25; 1.0 locates "
                   "every slot).  On hit-dense (repetitive) batches a "
                   "smaller budget drops the lowest-priority hits — the "
                   "run reports the dropped count as locate_dropped")
    p.add_argument("--extend-frac", type=float, default=None,
                   help="extension budget as a fraction of the "
                   "candidate slot matrix (default 0.25; 0.125 "
                   "measured drop-free on 1%%-error Illumina batches "
                   "— overflows self-heal via escalation)")
    p.add_argument("--stats", help="write stats JSON here")
    p.add_argument("--html", help="write HTML run report here")
    p.add_argument("--cpu", action="store_true",
                   help="run on the XLA/CPU platform (the same as "
                   "JAX_PLATFORMS=cpu)")
    p.add_argument("--num-shards", type=int, default=1,
                   help="total input shards (multi-host: one per host)")
    p.add_argument("--shard-id", type=int, default=0,
                   help="this process's shard index")
    p.add_argument("--resume", action="store_true",
                   help="restart an interrupted run: skip reads already "
                   "present in the output SAM and append (the batch-"
                   "restartable elastic story; plain .sam only)")
    p.add_argument("--mesh", default="auto", choices=["auto", "on", "off"],
                   help="sharded index: run shard-per-device over a "
                   "jax mesh when enough devices exist (candidate "
                   "stages run concurrently, one shard per device's "
                   "memory; 'auto' uses it when len(jax.devices()) >= "
                   "n_shards, 'on' requires it, 'off' forces the "
                   "sequential single-device schedule)")
    p.add_argument("--fm2-mode", default="auto",
                   choices=["auto", "off", "resident", "stream"],
                   help="sharded-index 2-step FM-index mode: resident "
                        "derives a pair-BWT per shard up front; stream "
                        "holds one shard's pair-BWT at a time and maps "
                        "shard-major (hg-scale; buffers the input)")
    p.add_argument("--xprof", metavar="DIR",
                   help="write a JAX profiler trace of the mapping loop")
    args = p.parse_args(argv)
    if args.resume and (args.sam.endswith(".gz")
                        or args.sam.endswith(".bam") or args.m1):
        p.error("--resume supports unpaired plain .sam output")
    if not args.U and not (args.m1 and args.m2):
        p.error("need -U or -1/-2")
    if args.rg and not args.rg_id:
        p.error("--rg needs --rg-id")

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from ..utils.jax_cache import enable_compilation_cache
    enable_compilation_cache()

    import numpy as np
    from ..io.index_file import load_index
    from ..io.fastq import FastqBatchReader
    from ..io.sequence import ReadBatchIterator
    from ..io.sam import SamWriter
    from ..models import MapperParams, Mapper
    from ..models.paired import PairedMapper
    from ..strings import pack_reads
    from ..utils.stats import MappingStats
    from ..alignment.types import GotohScheme

    def _pair(txt, flag):
        try:
            a, b = txt.split(",")
            return int(a), int(b)
        except ValueError:
            p.error(f"{flag} wants two comma-separated ints, got {txt!r}")

    def _func(txt, flag):
        """Bowtie2 SimpleFunc literal FN,A,B."""
        try:
            fn, a, b = txt.split(",")
            fn = fn.strip().upper()
            assert fn in "CLSG"
            return fn, float(a), float(b)
        except (ValueError, AssertionError):
            p.error(f"{flag} wants FN,A,B with FN in C/L/S/G, got {txt!r}")

    def _eval_func(fn, a, b, x):
        import math
        g = {"C": 1.0, "L": float(x), "S": math.sqrt(x),
             "G": math.log(max(x, 1))}[fn]
        return a if fn == "C" else a + b * g

    qual_enc = ("solexa64" if args.solexa_quals
                else "phred64" if args.phred64 else "phred33")
    mp_mx, mp_mn = _pair(args.mp, "--mp")
    rdg_o, rdg_e = _pair(args.rdg, "--rdg")
    rfg_o, rfg_e = _pair(args.rfg, "--rfg")
    ma = args.ma if args.ma is not None else (2 if args.local else 0)
    scheme = GotohScheme(
        match=ma, mismatch_min=mp_mn, mismatch_max=mp_mx,
        n_penalty=args.n_pen, gap_open=rdg_o, gap_extend=rdg_e,
        ref_gap_open=rfg_o, ref_gap_extend=rfg_e)
    sm = args.score_min or ("G,20,8" if args.local else "L,-0.6,-0.6")
    sm_fn, sm_a, sm_b = _func(sm, "--score-min")

    # seed interval: constant, or a function of read length that the
    # mapper re-evaluates per 32-wide length bucket (one jit variant
    # per bucket; Mapper._chunk_params) — the first read's length only
    # seeds the fallback for paths without bucket awareness
    ifn = None
    try:
        seed_interval = int(args.seed_interval)
    except ValueError:
        ifn = _func(args.seed_interval, "-i")
        from ..io.sequence import open_read_iter
        L0 = 100
        for _, s0, _ in open_read_iter(args.U or args.m1):
            L0 = len(s0)
            break
        seed_interval = max(1, int(_eval_func(*ifn, L0) + 0.5))

    # sharded index? (-x may be a manifest prefix or the .json itself)
    import os as _os
    _prefix = args.index
    if _prefix.endswith(".manifest.json"):
        _prefix = _prefix[: -len(".manifest.json")]
    if _os.path.exists(_prefix + ".manifest.json"):
        from ..fmindex.sharded import load_sharded_index

        sidx, genome_np, man = load_sharded_index(_prefix,
                                                  lut_k=args.lut_k)
        meta = {"sa_sample": man["sa_sample"], "lut_k": man["lut_k"],
                "contig_names": man["contig_names"],
                "contig_lens": man["contig_lens"]}
        fm = ssa = None
        genome = genome_np.astype(np.uint8)
        sharded = True
    else:
        fm, ssa, genome, meta = load_index(args.index)
        sharded = False
    params = MapperParams(
        seed_len=args.seed_len,
        seed_interval=seed_interval,
        **({"seed_interval_fn": ifn[0], "seed_interval_a": ifn[1],
            "seed_interval_b": ifn[2]} if ifn else {}),
        seed_mismatches=args.seed_mm,
        local=args.local,
        **({"band_w": args.band} if args.band is not None else {}),
        scheme=scheme,
        score_min_fn=sm_fn,
        score_min_a=sm_a,
        score_min_b=sm_b,
        minins=args.minins,
        maxins=args.maxins,
        pe_orient=args.pe_orient,
        pe_dovetail=args.dovetail,
        pe_no_contain=args.no_contain,
        pe_no_overlap=args.no_overlap,
        no_mixed=args.no_mixed,
        no_discordant=args.no_discordant,
        batch_size=args.batch,
        sa_sample=meta["sa_sample"],
        lut_k=meta.get("lut_k", 0),
        max_read_len=args.max_read_len,
        **({"locate_frac": args.locate_frac}
           if args.locate_frac is not None else {}),
        **({"extend_frac": args.extend_frac}
           if args.extend_frac is not None else {}),
    )
    contigs = {
        "names": meta["contig_names"],
        "starts": np.concatenate(
            [[0], np.cumsum(meta["contig_lens"][:-1])]
        ).astype(np.int64),
        "lens": np.array(meta["contig_lens"], dtype=np.int64),
    }
    if sharded:
        from ..models.sharded_mapper import ShardedMapper, PairedShardedMapper

        import jax
        n_shards = len(sidx.shards)
        use_mesh = (args.mesh == "on"
                    or (args.mesh == "auto"
                        and len(jax.devices()) >= n_shards > 1))
        if use_mesh:
            from ..models.mesh_sharded import (MeshShardedMapper,
                                               MeshPairedShardedMapper)

            if args.batch % n_shards:
                p.error(f"--mesh needs --batch divisible by the "
                        f"{n_shards}-shard mesh")
            scls = MeshPairedShardedMapper if args.m1 else MeshShardedMapper
            mapper = scls(sidx, genome, params=params, contigs=contigs)
            print(f"[map_reads] mesh: {n_shards} shards over "
                  f"{n_shards} devices (shard-per-chip)",
                  file=sys.stderr)
        else:
            scls = PairedShardedMapper if args.m1 else ShardedMapper
            mapper = scls(sidx, genome, params=params, contigs=contigs,
                          fm2_mode=args.fm2_mode)
    else:
        cls = PairedMapper if args.m1 else Mapper
        mapper = cls(fm, ssa, genome, params=params, contigs=contigs,
                     lut=meta.get("lut"))
    stats = MappingStats()
    import os
    n_done = 0
    if args.resume and os.path.exists(args.sam):
        with open(args.sam) as f:
            n_done = sum(1 for l in f if not l.startswith("@"))
        print(f"[map_reads] resume: {n_done} records already written",
              file=sys.stderr)
    writer_cls = SamWriter
    if args.sam.endswith(".bam"):
        from ..io.bam import BamWriter as writer_cls
    rg_line = None
    if args.rg_id:
        rg_line = "@RG\tID:" + args.rg_id + "".join(
            "\t" + f for f in args.rg)
    writer = writer_cls(args.sam, meta["contig_names"], meta["contig_lens"],
                        cmdline=" ".join(argv or sys.argv[1:]),
                        **({"append": True} if n_done else {}),
                        **({"rg_line": rg_line} if rg_line else {}))
    _write0 = writer.write
    if args.rg_id:
        def _write_rg(rec):
            rec.tags.append(("RG", "Z", args.rg_id))
            _write0(rec)
        writer.write = _write_rg

    # --un / --al: route reads by alignment outcome to FASTQ(.gz)
    # (bowtie2 --un/--al; PE mates carry /1 //2 suffixes)
    import gzip as _gzip

    def _open_fq(path):
        return (_gzip.open(path, "wt") if path.endswith(".gz")
                else open(path, "w"))

    un_f = _open_fq(args.un) if args.un else None
    al_f = _open_fq(args.al) if args.al else None

    def fq_route(names, reads, lens, qmat, aligned_flags, suffix=""):
        if un_f is None and al_f is None:
            return
        from ..basic.alphabet import dna_to_char
        for i, nm in enumerate(names):
            f = al_f if aligned_flags[i] else un_f
            if f is None:
                continue
            ln = int(lens[i])
            seq = dna_to_char(
                np.asarray(reads[i][:ln], np.uint8)).tobytes().decode()
            q = (np.asarray(qmat[i][:ln], np.uint8) + 33
                 ).clip(33, 126).astype(np.uint8).tobytes().decode()
            f.write(f"@{nm}{suffix}\n{seq}\n+\n{q}\n")

    def batches(path):
        """Input batches, optionally restricted to this host's shard
        (per-host byte-range input, SURVEY.md §5.8)."""
        if args.num_shards <= 1:
            yield from ReadBatchIterator(path, args.batch,
                                         qual_enc=qual_enc)
            return
        from ..parallel.distributed import shard_fastq, read_fastq_range

        start, end = shard_fastq(path, args.num_shards)[args.shard_id]
        names, seqs, quals = read_fastq_range(path, start, end)
        for i in range(0, len(names), args.batch):
            sl = slice(i, i + args.batch)
            yield names[sl], seqs[sl], quals[sl]

    def packed(path):
        skip = n_done
        for names, seqs, quals in batches(path):
            if skip >= len(names):  # whole batch already mapped
                skip -= len(names)
                continue
            if skip:
                names, seqs, quals = (names[skip:], seqs[skip:],
                                      quals[skip:])
                skip = 0
            reads, lens, qmat, _ = pack_reads(
                seqs, quals, max_len=args.max_read_len)
            yield names, reads, lens, qmat

    import contextlib
    prof = contextlib.nullcontext()
    if args.xprof:
        import jax

        prof = jax.profiler.trace(args.xprof)
    with prof, stats.timer("total"):
        if args.U and args.all_hits:
            from ..models.mapper import MapResult

            for names, reads, lens, qmat in packed(args.U):
                with stats.timer("compute"):
                    all_res = mapper.map_reads_all(
                        reads, lens, qmat, max_alns=args.max_alns)
                stats.observe([
                    a[0] if a else MapResult(aligned=False)
                    for a in all_res
                ])
                fq_route(names, reads, lens, qmat,
                         [bool(a and a[0].aligned) for a in all_res])
                with stats.timer("output"):
                    for rec in mapper.to_sam_records_all(
                            names, reads, lens, qmat, all_res):
                        writer.write(rec)
        elif args.U:
            # double-buffered: device work for batch k+1 overlaps host
            # SAM emit for batch k (InputThread/ComputeThread equiv)
            with stats.timer("compute"):
                for names, reads, lens, qmat, results in \
                        mapper.map_stream(packed(args.U)):
                    stats.observe(results)
                    fq_route(names, reads, lens, qmat,
                             [r.aligned for r in results])
                    with stats.timer("output"):
                        for rec in mapper.to_sam_records(
                                names, reads, lens, qmat, results):
                            writer.write(rec)
        else:
            # double-buffered PE path (ComputeThreadPE equivalent)
            def packed_pe():
                it1 = FastqBatchReader(args.m1, args.batch,
                                       qual_enc=qual_enc)
                it2 = FastqBatchReader(args.m2, args.batch,
                                       qual_enc=qual_enc)
                for (n1, s1, q1), (n2, s2, q2) in zip(it1, it2):
                    r1, l1, qm1, _ = pack_reads(
                        s1, q1, max_len=args.max_read_len)
                    r2, l2, qm2, _ = pack_reads(
                        s2, q2, max_len=args.max_read_len)
                    yield n1, r1, l1, qm1, r2, l2, qm2

            with stats.timer("compute"):
                for (n1, r1, l1, qm1, r2, l2, qm2, res1, res2,
                     info) in mapper.map_pairs_stream(packed_pe()):
                    stats.observe(res1)
                    stats.observe(res2)
                    stats.proper_pairs += sum(i["proper"] for i in info)
                    stats.discordant += sum(i["discordant"] for i in info)
                    fq_route(n1, r1, l1, qm1,
                             [r.aligned for r in res1], "/1")
                    fq_route(n1, r2, l2, qm2,
                             [r.aligned for r in res2], "/2")
                    with stats.timer("output"):
                        for rec in mapper.to_sam_records_pe(
                                n1, r1, l1, qm1, r2, l2, qm2,
                                res1, res2, info):
                            writer.write(rec)
    writer.close()
    for f in (un_f, al_f):
        if f is not None:
            f.close()
    stats.locate_dropped = getattr(mapper, "locate_dropped", 0)
    stats.escalated = getattr(mapper, "escalated", 0)
    stats.overflowed = getattr(mapper, "overflowed", 0)
    if stats.locate_dropped:
        print(f"[map_reads] locate budget overflow: "
              f"{stats.locate_dropped} candidate slots dropped "
              "(raise --locate-frac toward 1.0 to locate everything)",
              file=sys.stderr)
    if stats.escalated:
        print(f"[map_reads] effort escalation: {stats.overflowed} reads "
              f"overflowed round-1 budgets; {stats.escalated} re-maps "
              f"across {mapper.params.max_effort - 1} escalation "
              "round(s)", file=sys.stderr)
    report = stats.report(file=sys.stderr)
    if args.stats:
        with open(args.stats, "w") as f:
            f.write(report)
    if args.html:
        with open(args.html, "w") as f:
            f.write(stats.html(title=f"map_reads: {args.U or args.m1}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
