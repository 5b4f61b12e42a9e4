"""2-step FM-index (pair-BWT): halved dependent-gather chains.

The mapper's two hot loops — backward search and the SSA locate walk —
are chains of LF gathers; their cost is the *number of dependent
gathered indices*, so the win is
consuming two pattern symbols / two text steps per gather round with
the SAME per-round gather count as the 1-step index.  This is the k=2
case of the n-step FM-index construction (Chacón et al. 2013): a
derived pair-BWT

    pair2[i] = BWT[i] | (BWT[LF(i)] << 2)        (a nibble in [0, 16))

with the same blocked occurrence layout as fmindex.index (absolute
int32 per 128-pair block + int8 per-8-pair-word deltas + packed pair
words), so one rank2 touches exactly three gathered elements — like
rank() — but:

    backward search consumes TWO pattern symbols per round:
        range' = C2[c2 | (c1 << 2)] + rank2(c2 | (c1 << 2), range)
    the locate walk takes TWO text steps per round:
        LF²(i) = C2[pair2[i]] + rank2(pair2[i], i)

where C2[p] = C[p >> 2] + rank(p >> 2, C[p & 3]) is a 16-entry table.

Combined with a *bi-marked* SSA (rows with SA[i] % K in {0, 1} sampled,
see build.build_fm_index(bi_sample=True)), the locate walk needs at
most floor((K-1)/2) double-steps — one for the default K=4 — instead
of up to K-1 single steps.

Everything here is DERIVED from the standard FMIndex at load time
(build_fm2, host NumPy, chunked): no index-format change, ~3 bytes/bp
of extra device memory, opt-out via MapperParams.use_fm2 for
memory-tight hg-scale multi-shard runs.

Ref parity: the reference reaches the same goal with texture-cached
rank4() gathers (rank_dictionary.h); here the win is shortening the
dependent chain, which no cache can do.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .index import FMIndex, SSA, rank, _is_marked, _rank1
from ..basic.packed import popc_2bit_prefix

BLOCK2 = 128  # pairs per occ block (16 words x 8 nibbles)
_M1 = np.uint32(0x11111111)
_M7 = np.uint32(0x77777777)


class FM2(NamedTuple):
    """Derived pair-BWT structures (device pytree)."""

    pair_words: jnp.ndarray  # (n_blocks, 16) uint32 — 8 nibble pairs/word
    occ_abs: jnp.ndarray  # (n_blocks, 16) int32 — pair counts before block
    occ_sub: jnp.ndarray  # (n_blocks, 16, 16) int8 — within-block deltas
    C2: jnp.ndarray  # (16,) int32 — C2[c2 | (c1 << 2)]
    row_a: jnp.ndarray  # () int32 — row of SA=0 (primary): pair invalid
    row_b: jnp.ndarray  # () int32 — row of SA=1: second symbol is '$'


def _popc_nibble_prefix(word, p, rn):
    """# of nibbles equal to p among the first rn nibbles of word
    (SWAR zero-nibble detect; one bit set per matching nibble)."""
    y = word ^ (p.astype(jnp.uint32) * _M1)
    z = ~((((y & _M7) + _M7) | y) | _M7)
    mask = (jnp.uint32(1) << (4 * rn).astype(jnp.uint32)) - jnp.uint32(1)
    return jax.lax.population_count(z & mask).astype(jnp.int32)


def rank2(fm2: FM2, p, i):
    """#{j < i : pair2[j] == p}.  p, i broadcastable int32 arrays; the
    two sentinel-adjacent rows (pairs stored as 0) are excluded.
    Exactly three gathered elements per query — the same as the
    1-step rank()."""
    b = i >> 7
    w = (i >> 3) & 15
    rn = i & 7
    word = fm2.pair_words[b, w]
    cnt = (
        fm2.occ_abs[b, p]
        + fm2.occ_sub[b, w, p].astype(jnp.int32)
        + _popc_nibble_prefix(word, p, rn)
    )
    corr = ((p == 0) & (i > fm2.row_a)).astype(jnp.int32) + (
        (p == 0) & (i > fm2.row_b)
    ).astype(jnp.int32)
    return cnt - corr


def backward_search2(fm: FMIndex, fm2: FM2, seeds, lut=None, lut_k: int = 0):
    """Batched exact backward search taking 2 symbols per rank round.

    Fixed-length seeds only (the uniform-seed path).  Bit-identical
    ranges to index.backward_search; the dependent chain is
    ceil((L - lut_k) / 2) rounds instead of L - lut_k.
    """
    N, L = seeds.shape
    use_lut = lut is not None and 0 < lut_k <= L
    if use_lut:
        tail = seeds[:, L - lut_k :].astype(jnp.int32)
        bad0 = (tail >= 4).any(axis=1)
        key = jnp.zeros((N,), jnp.int32)
        for j in range(lut_k):
            key = (key << 2) | (tail[:, j] & 3)
        lo = jnp.where(bad0, 0, lut[0][key])
        hi = jnp.where(bad0, 0, lut[1][key])
        rem = L - lut_k
    else:
        lo = jnp.zeros((N,), jnp.int32)
        hi = jnp.full((N,), fm.n + 1, jnp.int32)
        rem = L

    if rem % 2:  # leading single step at the rightmost remaining symbol
        c = seeds[:, rem - 1].astype(jnp.int32)
        bad = c >= 4
        c4 = jnp.minimum(c, 3)
        nlo = fm.C[c4] + rank(fm, c4, lo)
        nhi = fm.C[c4] + rank(fm, c4, hi)
        lo = jnp.where(bad, 0, nlo)
        hi = jnp.where(bad, 0, nhi)
        rem -= 1

    def pair_step(carry, pos):
        lo, hi = carry
        c1 = seeds[:, pos - 1].astype(jnp.int32)  # newest (prepended last)
        c2 = seeds[:, pos].astype(jnp.int32)
        bad = (c1 >= 4) | (c2 >= 4)
        p = jnp.minimum(c2, 3) | (jnp.minimum(c1, 3) << 2)
        nlo = fm2.C2[p] + rank2(fm2, p, lo)
        nhi = fm2.C2[p] + rank2(fm2, p, hi)
        lo = jnp.where(bad, 0, nlo)
        hi = jnp.where(bad, 0, nhi)
        return (lo, hi), None

    if rem:
        (lo, hi), _ = jax.lax.scan(
            pair_step, (lo, hi),
            jnp.arange(rem - 1, 0, -2, dtype=jnp.int32),
        )
    return lo, hi


def locate2(fm: FMIndex, fm2: FM2, ssa: SSA, idx, k_sample: int):
    """SSA locate via LF² double-steps.  REQUIRES a bi-marked SSA
    (build_fm_index(bi_sample=True)): every SA value % K in {0, 1} is
    sampled, so any row reaches a mark in <= floor((K-1)/2) double
    steps — parity never strands the walk, and rows with SA < 2 are
    marked so the walk cannot cross the sentinel."""
    n_steps = max((k_sample - 1) // 2, 0)

    def step(carry, _):
        i, steps, done = carry
        done = done | _is_marked(ssa, i)
        # the pair read and the in-word rank share ONE gathered word
        nxt = _lf2(fm2, i)
        i = jnp.where(done, i, nxt)
        steps = steps + jnp.where(done, 0, 2)
        return (i, steps, done), None

    steps0 = jnp.zeros_like(idx)
    done0 = jnp.zeros(idx.shape, bool)
    (i, steps, done), _ = jax.lax.scan(
        step, (idx, steps0, done0), None, length=n_steps
    )
    return ssa.vals[_rank1(ssa, i)] + steps


def _lf2(fm2: FM2, i):
    """One LF² double-step (the locate2 body, shared): returns the
    next row.  Sentinel-adjacent rows (pair stored 0) excluded by the
    corr terms."""
    b = i >> 7
    w = (i >> 3) & 15
    rn = i & 7
    word = fm2.pair_words[b, w]
    p = ((word >> (4 * rn).astype(jnp.uint32)) & 15).astype(jnp.int32)
    cnt = (
        fm2.occ_abs[b, p]
        + fm2.occ_sub[b, w, p].astype(jnp.int32)
        + _popc_nibble_prefix(word, p, rn)
    )
    corr = ((p == 0) & (i > fm2.row_a)).astype(jnp.int32) + (
        (p == 0) & (i > fm2.row_b)
    ).astype(jnp.int32)
    return fm2.C2[p] + cnt - corr


def locate2_mono(fm: FMIndex, fm2: FM2, ssa: SSA, idx, k_sample: int):
    """SSA locate via LF² double-steps over a MONO-marked SSA
    (SA % K == 0 only — the sharded hg-scale default layout).

    The bi-marked SSA fixes the parity problem by doubling the sample
    memory; this walk fixes it with a second *parallel* check inside
    each round instead: from row ``i`` it tests ``marked(i)`` and
    ``marked(LF(i))`` together — ``LF(i)`` comes from one base-index
    rank that gathers alongside the pair-word rank, so the
    **dependent** chain is still floor((K-1)/2) rounds (one LF² per
    round), identical to locate2, at ~2x the per-round gather volume
    and zero extra index memory.

    The single-step LF sources its symbol from the BASE BWT word, not
    the pair word: pair nibbles are stored 0 at the two
    sentinel-adjacent rows, so the pair word would mis-read the row
    with SA == 1 — exactly the row whose parallel check must land on
    the marked SA == 0 row.  Rows with SA in {0, 1} are therefore
    always caught by a check, and the LF² step only ever fires from
    SA >= 2: the walk cannot cross the sentinel, mirroring locate2's
    bi-mark guarantee.
    """
    n_steps = max((k_sample - 1) // 2, 0)

    def check(i, fin, off, done, steps):
        """Resolve offsets (steps, steps+1) in one gather round."""
        m0 = _is_marked(ssa, i)
        b = i >> 7
        w = (i >> 4) & 7
        r = i & 15
        if fm.fused is not None:
            # fused block row (index.FMIndex.fused): the parallel
            # base-index LF costs ONE gather beside the pair-word rank
            from .index import _fused_row, _row_pick
            row, w, r = _fused_row(fm, i)
            word = jax.lax.bitcast_convert_type(
                _row_pick(row, w).astype(jnp.int32), jnp.uint32)
            c = ((word >> (2 * r).astype(jnp.uint32)) & 3).astype(
                jnp.int32)
            cnt = (
                _row_pick(row, 8 + c)
                + ((_row_pick(row, 12 + w) >> (8 * c)) & 0xFF)
                + popc_2bit_prefix(
                    word, c.astype(jnp.uint32), r.astype(jnp.uint32)
                ).astype(jnp.int32)
            )
        else:
            word = fm.bwt_words[b, w]
            c = ((word >> (2 * r).astype(jnp.uint32)) & 3).astype(
                jnp.int32)
            cnt = (
                fm.occ_abs[b, c]
                + fm.occ_sub[b, w, c].astype(jnp.int32)
                + popc_2bit_prefix(
                    word, c.astype(jnp.uint32), r.astype(jnp.uint32)
                ).astype(jnp.int32)
            )
        cnt = cnt - ((c == 0) & (i > fm.primary)).astype(jnp.int32)
        lf1 = fm.C[c] + cnt
        m1 = _is_marked(ssa, lf1)
        take0 = ~done & m0
        take1 = ~done & ~m0 & m1
        fin = jnp.where(take0, i, jnp.where(take1, lf1, fin))
        off = jnp.where(take0, steps, jnp.where(take1, steps + 1, off))
        return fin, off, done | m0 | m1

    def step(carry, _):
        i, steps, fin, off, done = carry
        fin, off, done = check(i, fin, off, done, steps)
        nxt = _lf2(fm2, i)
        i = jnp.where(done, i, nxt)
        steps = steps + jnp.where(done, 0, 2)
        return (i, steps, fin, off, done), None

    steps0 = jnp.zeros_like(idx)
    (i, steps, fin, off, done), _ = jax.lax.scan(
        step,
        (idx, steps0, idx, steps0, jnp.zeros(idx.shape, bool)),
        None, length=n_steps,
    )
    fin, off, done = check(i, fin, off, done, steps)  # offsets 2n, 2n+1
    return ssa.vals[_rank1(ssa, fin)] + off


def build_fm2(fm: FMIndex, slab_bytes: int = 1 << 27) -> FM2:
    """Derive FM2 from an FMIndex on the host (chunked NumPy: ~seconds
    per 100 Mbp; nothing is stored on disk — the pair-BWT is a pure
    function of the index)."""
    bwt_words = np.asarray(fm.bwt_words)  # (n_blocks, 8) uint32
    C = np.asarray(fm.C).astype(np.int64)
    primary = int(np.asarray(fm.primary))
    n = int(np.asarray(fm.n))
    m = n + 1
    n_blocks = bwt_words.shape[0]
    total = n_blocks * 128

    # 1) unpack 2-bit BWT symbols (slabbed)
    sym = np.empty(total, np.uint8)
    w = bwt_words.reshape(-1)
    shifts = (2 * np.arange(16)).astype(np.uint32)
    SLAB_W = max(slab_bytes // 64, 1024)
    for s in range(0, w.shape[0], SLAB_W):
        sl = w[s : s + SLAB_W]
        sym[16 * s : 16 * s + 16 * sl.shape[0]] = (
            (sl[:, None] >> shifts[None, :]) & 3
        ).astype(np.uint8).reshape(-1)

    # 2) LF for all rows (counting sort, slabbed; dummy-'A' correction)
    LF = np.empty(m, np.int64)
    nxt = C[:4].copy()  # next LF slot per symbol (sentinel occupies row 0)
    SLAB = max(slab_bytes // 16, 4096)
    for s in range(0, m, SLAB):
        sl = sym[s : min(s + SLAB, m)].astype(np.int64)
        oh = sl[:, None] == np.arange(4)[None, :]
        excl = np.cumsum(oh, axis=0) - oh
        LF[s : s + sl.shape[0]] = nxt[sl] + excl[np.arange(sl.shape[0]), sl]
        nxt += oh.sum(axis=0)
    # stored dummy 'A' at `primary` occupies an LF slot: rows with
    # symbol A after it are off by one; LF[primary] itself is invalid
    a_rows = np.flatnonzero(sym[:m] == 0)
    late = a_rows[a_rows > primary]
    LF[late] -= 1
    LF[primary] = 0
    row_b_arr = np.flatnonzero(LF[:m] == primary)
    row_b = int(row_b_arr[0]) if row_b_arr.size else primary

    # 3) pair nibbles; sentinel-adjacent rows stored as 0 and excluded
    # by rank2's correction terms
    pair = np.zeros(total, np.uint8)
    pair[:m] = sym[:m] | (sym[LF] << 2)
    pair[primary] = 0
    pair[row_b] = 0

    # 4) pack nibbles LSB-first into (n_blocks, 16) uint32 words
    nib = pair.reshape(-1, 8).astype(np.uint32)
    pair_words = np.zeros(nib.shape[0], np.uint32)
    for j in range(8):
        pair_words |= nib[:, j] << np.uint32(4 * j)
    pair_words = pair_words.reshape(n_blocks, 16)

    # 5) blocked occurrence tables over the 16-pair alphabet, STORED
    # counts (the two stored-0 sentinel rows included — rank2's
    # correction terms subtract them uniformly): absolute exclusive
    # int32 per block + exclusive int8 per-word deltas (<= 120)
    occ_abs = np.zeros((n_blocks, 16), np.int64)
    occ_sub = np.empty((n_blocks, 16, 16), np.int8)
    blocks = pair.reshape(n_blocks, 16, 8)
    SLAB_B = max(slab_bytes // (128 * 16), 256)
    for s in range(0, n_blocks, SLAB_B):
        sl = blocks[s : s + SLAB_B]  # (S, 16, 8)
        wc = (sl[:, :, :, None] == np.arange(16)[None, None, None, :]).sum(
            axis=2
        )  # (S, 16 words, 16 pairs)
        wcum = np.cumsum(wc, axis=1)
        occ_sub[s : s + sl.shape[0]] = (wcum - wc).astype(np.int8)
        occ_abs[s : s + sl.shape[0]] = wcum[:, -1]
    occ_abs = np.cumsum(occ_abs, axis=0) - occ_abs

    # 6) C2[p] = C[c1] + rank(c1, C[c2]) via the (tested) device rank
    p_all = np.arange(16)
    c1 = jnp.asarray(p_all >> 2, jnp.int32)
    pos = jnp.asarray(C[p_all & 3], jnp.int32)
    C2 = np.asarray(C[p_all >> 2] + np.asarray(rank(fm, c1, pos)))

    return FM2(
        pair_words=jnp.asarray(pair_words),
        occ_abs=jnp.asarray(occ_abs.astype(np.int32)),
        occ_sub=jnp.asarray(occ_sub),
        C2=jnp.asarray(C2.astype(np.int32)),
        row_a=jnp.asarray(primary, jnp.int32),
        row_b=jnp.asarray(row_b, jnp.int32),
    )

def _fm2_chunk(fm, b0, CB: int):
    """Derive one CB-block chunk of the pair-BWT on device (pure
    function of the chunk position — overlapping tail recompute is
    safe).  Returns (pair_words (CB, 16) u32, occ_sub (CB, 16, 16) i8,
    block_tot (CB, 16) i32, row_b_cand () i32)."""
    m = fm.n + 1
    words = jax.lax.dynamic_slice(fm.bwt_words, (b0, 0),
                                  (CB, 8))  # (CB, 8) u32
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    syms = ((words[:, :, None] >> shifts) & 3).astype(
        jnp.int8).reshape(CB, 128)  # stored symbols (dummy 'A' incl.)
    i_all = (b0 * 128 + jnp.arange(CB * 128, dtype=jnp.int32)).reshape(
        CB, 128)

    # LF(i) = C[s] + stored_rank(s, i) - dummy-A correction; the
    # stored rank is the block's occ_abs base + an in-chunk exclusive
    # one-hot cumsum (no gathers — the whole point of chunking)
    oh = (syms[:, :, None] == jnp.arange(4, dtype=jnp.int8)).astype(
        jnp.int32)  # (CB, 128, 4)
    excl = jnp.cumsum(oh, axis=1) - oh
    base = jax.lax.dynamic_slice(fm.occ_abs, (b0, 0), (CB, 4))
    srank = jnp.take_along_axis(
        base[:, None, :] + excl, syms[:, :, None].astype(jnp.int32),
        axis=2)[:, :, 0]
    s32 = syms.astype(jnp.int32)
    corr = ((s32 == 0) & (i_all > fm.primary)).astype(jnp.int32)
    LF = fm.C[s32] + srank - corr
    LF = jnp.where(i_all == fm.primary, 0, LF)

    # second symbol: one global BWT-word gather per row
    wflat = fm.bwt_words.reshape(-1)
    w2 = wflat[LF >> 4]
    s2 = ((w2 >> (2 * (LF & 15)).astype(jnp.uint32)) & 3).astype(
        jnp.int32)

    is_row_b = (LF == fm.primary) & (i_all < m)
    pair = jnp.where(
        (i_all == fm.primary) | is_row_b | (i_all >= m),
        0, s32 | (s2 << 2)).astype(jnp.uint32)  # (CB, 128) nibbles
    row_b_cand = jnp.min(jnp.where(is_row_b, i_all, jnp.int32(2**31 - 1)))

    # pack nibbles LSB-first into 16 u32 words per 128-pair block
    nib = pair.reshape(CB * 16, 8)
    sh4 = (4 * jnp.arange(8, dtype=jnp.uint32))[None, :]
    pair_words = (nib << sh4).sum(axis=1, dtype=jnp.uint32).reshape(
        CB, 16)

    # blocked occurrence tables over the 16-pair alphabet (STORED
    # counts, sentinel-adjacent zeros included — same as the host)
    oh16 = (pair.reshape(CB, 16, 8)[:, :, :, None]
            == jnp.arange(16, dtype=jnp.uint32)).astype(jnp.int32)
    wc = oh16.sum(axis=2)  # (CB, 16 words, 16 pairs)
    wcum = jnp.cumsum(wc, axis=1)
    occ_sub = (wcum - wc).astype(jnp.int8)
    block_tot = wcum[:, -1]
    return pair_words, occ_sub, block_tot, row_b_cand


@functools.partial(jax.jit, static_argnames=("CB",))
def _fm2_derive_jit(fm, CB: int):
    n_blocks = fm.bwt_words.shape[0]
    n_chunks = (n_blocks + CB - 1) // CB
    pair_words = jnp.zeros((n_blocks, 16), jnp.uint32)
    occ_sub = jnp.zeros((n_blocks, 16, 16), jnp.int8)
    block_tot = jnp.zeros((n_blocks, 16), jnp.int32)

    def body(c, carry):
        pw, os_, bt, rb = carry
        b0 = jnp.minimum(c * CB, n_blocks - CB)  # tail overlap is safe
        cpw, cos, cbt, crb = _fm2_chunk(fm, b0, CB)
        pw = jax.lax.dynamic_update_slice(pw, cpw, (b0, 0))
        os_ = jax.lax.dynamic_update_slice(os_, cos, (b0, 0, 0))
        bt = jax.lax.dynamic_update_slice(bt, cbt, (b0, 0))
        return pw, os_, bt, jnp.minimum(rb, crb)

    pair_words, occ_sub, block_tot, row_b = jax.lax.fori_loop(
        0, n_chunks, body,
        (pair_words, occ_sub, block_tot, jnp.int32(2**31 - 1)))
    occ_abs = jnp.cumsum(block_tot, axis=0) - block_tot
    row_b = jnp.where(row_b == 2**31 - 1, fm.primary, row_b)

    p_all = jnp.arange(16, dtype=jnp.int32)
    C2 = fm.C[p_all >> 2] + rank(fm, p_all >> 2, fm.C[p_all & 3])
    return pair_words, occ_abs, occ_sub, C2, row_b


def build_fm2_device(fm: FMIndex, chunk_blocks: int = 1 << 15) -> FM2:
    """Derive FM2 from a device-resident FMIndex ON DEVICE: one jit
    dispatch, chunked fori_loop (in-place dynamic_update_slice
    outputs), ~1.5 bytes/row of transient state beyond the 3 bytes/row
    result.  For hg-scale shards this replaces minutes of host NumPy +
    a multi-GB H2D upload with seconds of on-chip work — the base
    index is already resident (SURVEY.md §3.3; the n-step FM-index of
    Chacón et al. derived where it is consumed).

    Bit-identical to build_fm2 (tested): same stored-count layout,
    same sentinel-adjacent zeroing, same C2.
    """
    n_blocks = int(fm.bwt_words.shape[0])
    CB = max(min(chunk_blocks, n_blocks), 1)
    pair_words, occ_abs, occ_sub, C2, row_b = _fm2_derive_jit(fm, CB)
    return FM2(pair_words=pair_words, occ_abs=occ_abs, occ_sub=occ_sub,
               C2=C2, row_a=jnp.asarray(fm.primary, jnp.int32),
               row_b=row_b.astype(jnp.int32))
