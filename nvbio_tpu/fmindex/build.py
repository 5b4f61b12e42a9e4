"""FM-index construction (host NumPy → device arrays).

Builds the blocked occurrence layout and sampled SA from a 2-bit text
(ambiguous bases must be substituted beforehand, as the reference's
nvBWT does — ref: nvBWT/nvBWT.cpp; io/fmindex/fmindex.cpp builds the
device occ tables the same way at load time).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..basic.packed import pack_2bit
from ..sufsort import suffix_array, bwt_from_sa
from .index import FMIndex, SSA

BLOCK = 128  # symbols per occ block
WORDS = BLOCK // 16


def _occ_tables_host(bwt_pad: np.ndarray, n_blocks: int):
    """Blocked occ tables on the host (NumPy slab loop)."""
    n_words16 = n_blocks * WORDS
    word_counts = np.empty((n_words16, 4), dtype=np.int16)
    w16 = bwt_pad.reshape(n_words16, 16)
    SLAB = 1 << 22
    for s in range(0, n_words16, SLAB):
        sl = w16[s : s + SLAB]
        for c in range(4):
            word_counts[s : s + SLAB, c] = (sl == c).sum(axis=1)
    word_cum = np.zeros((n_words16, 4), dtype=np.int64)  # exclusive
    np.cumsum(word_counts[:-1], axis=0, out=word_cum[1:])
    block_cum = word_cum[::WORDS]
    occ_abs = block_cum.astype(np.int32)
    word_starts = word_cum.reshape(n_blocks, WORDS, 4)
    # in-block word deltas are <= 112 (7 words x 16 symbols): int8
    # is lossless — the BASELINE 'int8 occurrence layout' (4x less
    # HBM per rank gather at hg scale)
    occ_sub = (word_starts - block_cum[:, None, :]).astype(np.int8)
    return occ_abs, occ_sub


def _popc_u32(x):
    """Vectorized 32-bit popcount (device)."""
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((x * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


# 2^20 occ blocks (128 Mbp of BWT) per device call: the in-flight
# working set (word counts + cumsum, both (8 * CH, 4) int32) stays
# ~270 MB regardless of shard size.  Round 3's unchunked version
# materialized the full-shard cumsum and OOMed a 16 GB chip at 1.1 Gbp.
OCC_CHUNK_BLOCKS = 1 << 20


def occ_tables_device(bwt_words: np.ndarray):
    """Blocked occ tables computed ON DEVICE from the packed BWT words
    (ref: io/fmindex/fmindex.cpp builds device occ tables at load; here
    the device does the counting itself — 2-bit-symbol popcounts per
    16-symbol word + a device cumsum; SURVEY.md §4.4, config 4).

    Upload = the packed BWT (0.25 B/symbol); download = occ_abs
    (int32 (n_blocks, 4)) + occ_sub (int8 (n_blocks, WORDS, 4)).
    Processed in OCC_CHUNK_BLOCKS-block chunks with a (4,) running
    carry so HBM use is O(chunk), not O(shard) — one fixed-shape
    executable serves every full chunk.  Bit-identical to
    _occ_tables_host (tested at 100 Mbp, tests/test_index_build.py).
    """
    n_blocks = bwt_words.shape[0]
    CH = OCC_CHUNK_BLOCKS

    @jax.jit
    def f(w, carry):
        ch = w.shape[0]
        w = w.reshape(-1)  # (ch * WORDS,) uint32, 16 symbols each
        b0 = w & jnp.uint32(0x55555555)
        b1 = (w >> 1) & jnp.uint32(0x55555555)
        c3 = _popc_u32(b0 & b1)
        c1 = _popc_u32(b0 & ~b1)
        c2 = _popc_u32(b1 & ~b0)
        c0 = 16 - c1 - c2 - c3
        wc = jnp.stack([c0, c1, c2, c3], axis=1)  # (ch * WORDS, 4) i32
        total = carry + jnp.sum(wc, axis=0)
        cum = carry[None, :] + jnp.concatenate(
            [jnp.zeros((1, 4), jnp.int32), jnp.cumsum(wc, axis=0)[:-1]])
        block_cum = cum[::WORDS]
        occ_sub = (cum.reshape(ch, WORDS, 4)
                   - block_cum[:, None, :]).astype(jnp.int8)
        return block_cum, occ_sub, total

    occ_abs = np.empty((n_blocks, 4), dtype=np.int32)
    occ_sub = np.empty((n_blocks, WORDS, 4), dtype=np.int8)
    carry = jnp.zeros((4,), jnp.int32)
    for s in range(0, n_blocks, CH):
        e = min(s + CH, n_blocks)
        a, b, carry = f(jnp.asarray(bwt_words[s:e]), carry)
        occ_abs[s:e] = np.asarray(a)
        occ_sub[s:e] = np.asarray(b)
    return occ_abs, occ_sub


def build_fm_arrays(
    text: np.ndarray,
    sa_sample: int = 32,
    sa: np.ndarray | None = None,
    bi_sample: bool = False,
    occ_device: bool = False,
):
    """NumPy core of build_fm_index: returns two plain-array tuples
    (fm fields, ssa fields) — usable from worker processes that must
    not touch a JAX backend (fmindex/sharded.py parallel builds)."""
    text = np.asarray(text, dtype=np.uint8)
    n = len(text)
    if sa is None:
        sa = suffix_array(text)
    m = n + 1  # BWT length including sentinel slot
    n_blocks = (m + BLOCK - 1) // BLOCK + 1  # +1: queries at i = n+1

    from ..native import fm_bwt_occ_native
    fused = None if occ_device else fm_bwt_occ_native(text, sa)
    if fused is not None:
        # one C++ pass: BWT gather + 2-bit packing + blocked occ
        # (bit-identical to the NumPy stages below; the dummy 'A' at
        # `primary` is counted and subtracted at query time)
        bwt_words, occ_abs, occ_sub, primary = fused
    else:
        bwt, primary = bwt_from_sa(text, sa)
        bwt_pad = np.zeros(n_blocks * BLOCK, dtype=np.uint8)
        bwt_pad[:m] = bwt
        # (the dummy 'A' at `primary` is counted by the occ build and
        # subtracted at query time)
        bwt_words = pack_2bit(bwt_pad).reshape(n_blocks, WORDS)
        if occ_device:
            occ_abs, occ_sub = occ_tables_device(bwt_words)
        else:
            occ_abs, occ_sub = _occ_tables_host(bwt_pad, n_blocks)

    counts = np.bincount(text, minlength=4)
    C = np.zeros(5, dtype=np.int32)
    C[0] = 1  # sentinel
    C[1:] = 1 + np.cumsum(counts)[:4]
    # C[4] = n + 1 == total rows
    assert C[4] == m

    # sampled SA over rows of T+'$' (row 0 is the sentinel suffix)
    thresh = 2 if bi_sample else 1
    n_words = (n_blocks * BLOCK) // 32
    from ..native import ssa_build_native
    ssa_t = ssa_build_native(np.asarray(sa), n, sa_sample, thresh,
                             n_words)
    if ssa_t is not None:
        # one C++ pass: marks + per-word rank prefix + sampled values
        mark_words, mark_abs, vals = ssa_t
    else:
        sa_full = np.empty(m, dtype=np.int32)
        sa_full[0] = n
        sa_full[1:] = sa
        if sa_sample & (sa_sample - 1) == 0:
            marked = (sa_full & (sa_sample - 1)) < thresh
        else:
            marked = (sa_full % sa_sample) < thresh
        vals = sa_full[marked]
        bits = np.zeros(n_words * 32, dtype=bool)
        bits[:m] = marked
        # LSB-first packing: bit r of word w = bits[32*w + r]
        words = np.packbits(bits.reshape(n_words, 32), axis=1,
                            bitorder="little")
        mark_words = words.view("<u4").reshape(n_words)
        popc = bits.reshape(n_words, 32).sum(axis=1)
        mark_abs = np.zeros(n_words, dtype=np.int32)
        np.cumsum(popc[:-1], out=mark_abs[1:])

    return ((bwt_words, occ_abs, occ_sub, C,
             np.int32(primary), np.int32(n)),
            (mark_words, mark_abs, vals))


def build_fm_index(
    text: np.ndarray,
    sa_sample: int = 32,
    sa: np.ndarray | None = None,
    bi_sample: bool = False,
    occ_device: bool = False,
):
    """Build (FMIndex, SSA) for `text` (uint8 symbols 0..3).

    `sa` may be passed to reuse a precomputed suffix array.
    `bi_sample` marks SA values % sa_sample in {0, 1} (2x the samples)
    so fm2.locate2 can walk in LF² double-steps — parity-safe, and any
    single-step locate() still works (it stops at the first mark).
    `occ_device` computes the blocked occ tables on the accelerator
    (occ_tables_device) instead of the host slab loop.
    Returns device-ready structures (jnp arrays).
    """
    fmt, ssat = build_fm_arrays(text, sa_sample=sa_sample, sa=sa,
                                bi_sample=bi_sample,
                                occ_device=occ_device)
    fm = FMIndex(
        bwt_words=jnp.asarray(fmt[0]),
        occ_abs=jnp.asarray(fmt[1]),
        occ_sub=jnp.asarray(fmt[2]),
        C=jnp.asarray(fmt[3]),
        primary=jnp.asarray(fmt[4], jnp.int32),
        n=jnp.asarray(fmt[5], jnp.int32),
    )
    ssa = SSA(
        mark_words=jnp.asarray(ssat[0]),
        mark_abs=jnp.asarray(ssat[1]),
        vals=jnp.asarray(ssat[2]),
        k=int(sa_sample),
        bi=int(bool(bi_sample)),
    )
    return fm, ssa


def build_kmer_lut(text: np.ndarray, sa: np.ndarray | None = None,
                   k: int = 11):
    """k-mer -> SA-range lookup table (lut_lo, lut_hi), each (4^k,)
    int32: the starting range for backward search after resolving the
    last k pattern symbols in one gather (SURVEY.md §7.3(2)).

    Short suffixes (len < k) sort before any full k-mer with the same
    prefix under the sentinel-smallest convention, encoded with a key
    LSB: key2 = packed_prefix * 2 + is_full.

    The ranges depend only on the MULTISET of suffix keys — each
    k-mer's SA range is [1 + #(key2 < probe), 1 + #(key2 <= probe)] —
    so a single histogram + cumsum over key2 replaces the old
    SA-gather + 1.1G-element searchsorted (round 3: hg-scale LUT
    8.5 min -> seconds; `sa` is accepted and ignored for API compat).
    """
    if k > 15:
        raise ValueError("k-mer LUT keys are int32: k <= 15")
    del sa  # ranges are position-independent (docstring)
    text = np.asarray(text, dtype=np.uint8)
    n = len(text)
    from ..native import kmer_hist_native
    counts = kmer_hist_native(text, k)
    if counts is not None:
        # native path: radix-partitioned single-pass histogram (~8x
        # the blocked-NumPy fallback below at hg-shard scale)
        cum = np.cumsum(counts)
        probes = np.arange(1 << (2 * k), dtype=np.int64) * 2
        lo = (cum[probes] + 1).astype(np.int32)
        hi = (cum[probes + 1] + 1).astype(np.int32)
        return lo, hi
    # rolling k-symbol keys over text padded with 'A' (short suffixes
    # get a padded key; the is_full bit orders them first), built in
    # 2M-position cache blocks: the k rounds of shift/cast/or re-touch
    # the SAME in-cache block instead of streaming 3k full passes
    # through RAM, and the histogram accumulates per block (round 4:
    # 2.7x at 200 Mbp, ~440 s -> ~160 s per 1.1 Gbp hg shard)
    padded = np.concatenate([text & 3, np.zeros(k, np.uint8)])
    CH = 1 << 21
    nbin = 2 << (2 * k)
    counts = np.zeros(nbin, np.int64)
    buf = np.zeros(min(CH, n + 1), np.int32)
    tmp = np.empty(min(CH, n + 1), np.int32)
    for s in range(0, n + 1, CH):
        e = min(s + CH, n + 1)
        m = e - s
        b, t = buf[:m], tmp[:m]
        b[:] = 0
        for j in range(k):
            np.left_shift(b, 2, out=b)
            np.copyto(t, padded[s + j : e + j], casting="unsafe")
            np.bitwise_or(b, t, out=b)
        # key2 of suffix i = 2 * key[i] + (i <= n - k)
        np.left_shift(b, 1, out=b)
        b[: min(max(n - k + 1 - s, 0), m)] |= 1
        lim = min(n - s, m)  # histogram over suffixes [0, n) only
        if lim > 0:
            counts += np.bincount(b[:lim], minlength=nbin)
    cum = np.cumsum(counts)
    probes = np.arange(1 << (2 * k), dtype=np.int64) * 2
    lo = (cum[probes] + 1).astype(np.int32)      # #(key2 <= 2q) + 1
    hi = (cum[probes + 1] + 1).astype(np.int32)  # #(key2 <= 2q+1) + 1
    return lo, hi
