"""Sharded FM-index: references beyond the int32 / single-HBM budget.

The per-shard FM-index keeps the fast int32 layout (32-bit gather
indices; fmindex/index.py); genomes larger than ~2 Gbp (e.g.
hg38's 3.1 Gbp) are split into S shards, each indexed independently
over its slice plus an `overlap` tail so alignments crossing a shard
boundary are found in the left shard.  Mapping runs the shared
candidate stage against every shard (genome stays ONE global array;
only windows are gathered with the shard offset) and a cross-shard
reduction picks best/second-best per read, de-duplicating candidates
the overlap makes visible to two shards.

This also doubles as the multi-chip index-sharding story (SURVEY.md
§5.8): each shard can live on a different chip of a mesh with the read
batch broadcast, scores reduced with one `jnp.maximum` tree — the same
reduction implemented here on one chip.

No reference equivalent (nvbio is single-GPU, 32-bit indexes with the
same ~2 Gbp ceiling; hg38 forward+reverse is handled there by two
separate indexes — the same idea, generalized).
"""

from __future__ import annotations

import json
import os

import numpy as np
import jax.numpy as jnp

from .build import build_fm_index, build_kmer_lut
from ..sufsort import suffix_array


class ShardedIndex:
    """List of (fm, ssa, lut, start, length) over one global genome."""

    def __init__(self, shards, n_total, sa_sample, lut_k):
        self.shards = shards  # [(fm, ssa, lut_or_None, start, length)]
        self.n_total = int(n_total)
        self.sa_sample = int(sa_sample)
        self.lut_k = int(lut_k)


def _shard_bounds(n: int, shard_bp: int, overlap: int):
    bounds = []
    start = 0
    while start < n:
        end = min(start + shard_bp, n)
        if bounds and n - start <= overlap:
            # the tail's whole span already lies inside the previous
            # shard's overlap: its ownership folds left instead of
            # paying a full per-batch candidate stage for a sliver
            # (a 1 KB tail shard costs the same ~450 ms/batch as a
            # 1.6 Gbp one — the stage cost is batch-shaped, not
            # text-shaped)
            break
        bounds.append((start, min(end + overlap, n)))
        start = end
    return bounds


def _build_one_shard(symbols, start, seg_end, sa_sample, lut_k,
                     bi_sample, occ_device):
    import sys
    import time

    seg = np.ascontiguousarray(symbols[start:seg_end])
    t0 = time.time()
    sa = suffix_array(seg)
    t1 = time.time()
    fm, ssa = build_fm_index(seg, sa_sample=sa_sample, sa=sa,
                             bi_sample=bi_sample, occ_device=occ_device)
    t2 = time.time()
    lut = None
    if lut_k > 0:
        lo, hi = build_kmer_lut(seg, sa, k=lut_k)
        lut = (jnp.asarray(lo), jnp.asarray(hi))
    t3 = time.time()
    if len(seg) >= 50_000_000:  # stage table only at real scale
        print(f"[build_index] shard @{start}: {len(seg)/1e6:.0f} Mbp  "
              f"sa {t1-t0:.1f}s  bwt+occ{'(dev)' if occ_device else ''}"
              f"+ssa {t2-t1:.1f}s  lut {t3-t2:.1f}s",
              file=sys.stderr, flush=True)
    return (fm, ssa, lut, start, seg_end - start)


def _build_one_shard_np(args):
    """Process-pool worker: pure NumPy (build_fm_arrays) — a worker
    must never initialize a JAX backend (each child would claim the
    accelerator, and fork-after-JAX deadlocks; pools use the spawn
    context for the same reason)."""
    symbols, start, seg_end, sa_sample, lut_k, bi_sample = args
    from .build import build_fm_arrays, build_kmer_lut

    seg = np.ascontiguousarray(symbols[start:seg_end])
    sa = suffix_array(seg)
    fmt, ssat = build_fm_arrays(seg, sa_sample=sa_sample, sa=sa,
                                bi_sample=bi_sample)
    lut = build_kmer_lut(seg, k=lut_k) if lut_k > 0 else None
    return (fmt, ssat, int(sa_sample), int(bool(bi_sample)), lut,
            start, seg_end - start)


def build_sharded_index(symbols: np.ndarray, shard_bp: int,
                        overlap: int = 1024, sa_sample: int = 16,
                        lut_k: int = 11, bi_sample: bool = False,
                        occ_device: bool = False,
                        n_procs: int = 1) -> ShardedIndex:
    """Split `symbols` into ceil(n/shard_bp) shards (each extended by
    `overlap` into the next) and build per-shard indexes.

    `occ_device`: compute each shard's blocked occ tables on the
    accelerator (fmindex.build.occ_tables_device).  `n_procs > 1`:
    build shards in parallel worker processes (the builder is shard-
    independent — on an M-core host the wall time is ~1/min(M, S) of
    sequential; ref: nvBWT is a one-GPU serial tool, SURVEY.md §4.4 —
    this is the multi-core host-side analog)."""
    n = len(symbols)
    bounds = _shard_bounds(n, shard_bp, overlap)
    if n_procs > 1 and len(bounds) > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        from .index import FMIndex, SSA

        # spawn, not fork: forking a JAX-initialized parent deadlocks
        # in XLA's threads, and each child must start clean
        with ProcessPoolExecutor(
                max_workers=min(n_procs, len(bounds)),
                mp_context=mp.get_context("spawn")) as ex:
            outs = list(ex.map(_build_one_shard_np, [
                (symbols, s, e, sa_sample, lut_k, bi_sample)
                for s, e in bounds]))
        shards = []
        for fmt, ssat, k, bi, lut, start, length in outs:
            fm = FMIndex(*(jnp.asarray(x) for x in fmt[:4]),
                         primary=jnp.asarray(fmt[4]),
                         n=jnp.asarray(fmt[5]))
            ssa = SSA(*(jnp.asarray(x) for x in ssat), k=k, bi=bi)
            lut = (None if lut is None
                   else tuple(jnp.asarray(x) for x in lut))
            shards.append((fm, ssa, lut, start, length))
        return ShardedIndex(shards, n, sa_sample, lut_k)
    shards = [
        _build_one_shard(symbols, s, e, sa_sample, lut_k, bi_sample,
                         occ_device)
        for s, e in bounds
    ]
    return ShardedIndex(shards, n, sa_sample, lut_k)


def save_sharded_index(prefix: str, idx: ShardedIndex, genome, contig_names,
                       contig_lens):
    """Writes <prefix>.manifest.json + one .npz per shard + genome."""
    from ..io.index_file import save_index

    man = {
        "n_total": idx.n_total,
        "sa_sample": idx.sa_sample,
        "lut_k": idx.lut_k,
        "contig_names": list(contig_names),
        "contig_lens": [int(x) for x in contig_lens],
        "shards": [],
    }
    np.save(prefix + ".genome.npy", np.asarray(genome, dtype=np.int8))
    for i, (fm, ssa, lut, start, length) in enumerate(idx.shards):
        path = f"{prefix}.shard{i}.npz"
        save_index(path, fm, ssa, np.zeros(0, np.int8), [], [],
                   idx.sa_sample, lut=lut, lut_k=idx.lut_k)
        man["shards"].append({
            "file": os.path.basename(path), "start": int(start),
            "length": int(length),
        })
    with open(prefix + ".manifest.json", "w") as f:
        json.dump(man, f)


def _strip_bi_ssa(ssa):
    """Drop the SA % K == 1 marks from a bi-marked SSA (host NumPy).

    The sharded mappers run without the fm2 pair-BWT (HBM budget), so
    the LF^2 double-step never fires and the extra marks only double
    the vals upload; plain locate() is exact with either marking."""
    from .index import SSA
    import jax.numpy as jnp

    if not int(getattr(ssa, "bi", 0)):
        return ssa
    words = np.asarray(ssa.mark_words)
    vals = np.asarray(ssa.vals)
    bits = np.unpackbits(
        words.view(np.uint8), bitorder="little").astype(bool)
    keep_val = (vals % max(int(ssa.k), 1)) == 0
    rows = np.flatnonzero(bits)
    bits[rows[~keep_val]] = False
    packed = np.packbits(bits.reshape(-1, 32), axis=1, bitorder="little")
    mark_words = packed.view("<u4").reshape(-1)
    popc = bits.reshape(-1, 32).sum(axis=1)
    mark_abs = np.zeros(len(mark_words), np.int32)
    np.cumsum(popc[:-1], out=mark_abs[1:])
    return SSA(mark_words=jnp.asarray(mark_words),
               mark_abs=jnp.asarray(mark_abs),
               vals=jnp.asarray(vals[keep_val]),
               k=int(ssa.k), bi=0)


def load_sharded_index(prefix: str, lut_k: int | None = None):
    """Returns (ShardedIndex, genome int8 np array, meta dict).

    Bi-marked shard SSAs (older builds) are stripped back to mono
    marks at load (see _strip_bi_ssa).

    ``lut_k``: rebuild each shard's k-mer LUT at this depth from the
    stored genome (build_kmer_lut is a pure histogram cumsum — the
    native kmer_hist does a 1.6 Gbp shard in ~20 s).  Deeper LUTs
    shorten the backward-search LF chain (round-5: k=13 -> 9 steps
    instead of 11) without re-building or re-saving the index — the
    table is never worth storing (1 GB/shard at k=13, derivable
    faster than it loads)."""
    from ..io.index_file import load_index

    with open(prefix + ".manifest.json") as f:
        man = json.load(f)
    d = os.path.dirname(os.path.abspath(prefix + ".manifest.json"))
    entries = list(man["shards"])
    while (len(entries) > 1
           and entries[-2]["start"] + entries[-2]["length"]
           >= entries[-1]["start"] + entries[-1]["length"]):
        # older builds emitted a sliver tail shard fully covered by
        # the previous shard's overlap (see _shard_bounds): fold its
        # ownership left and skip loading it
        entries.pop()
    man = {**man, "shards": entries}
    shards = []
    for s in man["shards"]:
        fm, ssa, _g, meta = load_index(os.path.join(d, s["file"]))
        shards.append((fm, _strip_bi_ssa(ssa), meta.get("lut"),
                       s["start"], s["length"]))
    genome = np.load(prefix + ".genome.npy")
    eff_lut_k = man["lut_k"]
    if lut_k and lut_k != man["lut_k"]:
        for i, (fm, ssa, _lut, start, length) in enumerate(shards):
            seg = np.ascontiguousarray(
                genome[start:start + length]).astype(np.uint8)
            lo, hi = build_kmer_lut(seg, k=lut_k)
            shards[i] = (fm, ssa, (jnp.asarray(lo), jnp.asarray(hi)),
                         start, length)
        eff_lut_k = lut_k
        man = {**man, "lut_k": lut_k}
    idx = ShardedIndex(shards, man["n_total"], man["sa_sample"],
                       eff_lut_k)
    return idx, genome, man
