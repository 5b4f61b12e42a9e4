"""On-device suffix sorting (``lax.sort``-based).

Two device paths mirroring the reference's GPU sufsort module
(ref: nvbio/sufsort/sufsort.h — ``cuda::suffix_sort``,
``prefix_doubling_sufsort.h`` — ``PrefixDoublingSufSort``, and
``bwte.h`` — set-BWT of large read collections, the algorithm of
arXiv:1410.0562):

- ``suffix_array_device``: prefix-doubling over ``lax.sort`` — the
  whole-genome suffix array for references that fit HBM (chr-scale:
  ~256 Mbp in 16 GB).  Each round is one stable 3-operand device sort;
  O(log n) rounds with early exit.
- ``set_bwt_device``: BWT of a *set* of short reads.  Because read
  suffixes are bounded by the read length, the sort is a fixed number
  of LSD radix rounds over packed symbol words — fully static shapes,
  no comparator needed.  This is the XLA-idiomatic replacement for the
  reference's incremental BWTE merge.

Larger-than-HBM references use the native host SA-IS path
(native/sais.cpp); see sufsort/sa.py for the design rationale.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


@functools.partial(jax.jit, donate_argnums=(0,))
def _pd_round(rank, k):
    """One prefix-doubling round: re-rank by (rank[i], rank[i+k])."""
    n = rank.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    second = jnp.where(idx + k < n, jnp.roll(rank, -k), jnp.int32(-1))
    key1, key2, sa = lax.sort((rank, second, idx), dimension=0,
                              is_stable=True, num_keys=2)
    diff = jnp.concatenate([
        jnp.zeros(1, jnp.int32),
        ((key1[1:] != key1[:-1]) | (key2[1:] != key2[:-1])).astype(jnp.int32),
    ])
    new_rank_sorted = jnp.cumsum(diff, dtype=jnp.int32)
    new_rank = jnp.zeros_like(rank).at[sa].set(new_rank_sorted)
    done = new_rank_sorted[-1] == n - 1
    return new_rank, sa, done


def suffix_array_device(text: np.ndarray) -> np.ndarray:
    """Suffix array of `text` (symbols, n < 2^31) computed on device.

    Sentinel-smallest convention, identical output to
    ``sufsort.suffix_array``.
    """
    t = np.asarray(text)
    n = int(t.shape[0])
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = jnp.asarray(t, dtype=jnp.int32)
    k = 1
    while True:
        rank, sa, done = _pd_round(rank, jnp.int32(k))
        k *= 2
        if bool(done) or k >= n:
            return np.asarray(sa).astype(np.int64)


def _pack_words(symp_flat, offs, w, stride_mask):
    """Pack 8 symbols starting at offs+8w into one uint32 (4 bits each)."""
    word = jnp.zeros(offs.shape, jnp.uint32)
    base = offs + 8 * w
    for j in range(8):
        s = symp_flat[base + j]
        word = (word << 4) | s.astype(jnp.uint32)
    return jnp.where(stride_mask, jnp.uint32(0xFFFFFFFF), word)


def set_bwt_device(reads: np.ndarray, lens: np.ndarray):
    """BWT of a read set (BCR/bwte-style) computed on device.

    `reads`: (R, Lmax) symbols 0..3; `lens`: (R,).  Returns the BWT
    symbol array (length sum(lens)+R) over alphabet {0..3, 4='$'}:
    suffixes of every read (each read followed by its own sentinel,
    sentinels ordered by read id) sorted; entry = preceding symbol,
    with 4 marking read starts.

    Ref parity: nvbio/sufsort/bwte.h (BWTEContext) — the incremental
    merge is replaced by one bounded-depth LSD radix sort, which is the
    natural formulation when every suffix fits a fixed number of packed
    words (static shapes for XLA).
    """
    reads = np.asarray(reads, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int32)
    R, Lmax = reads.shape
    L1 = Lmax + 1
    n_words = (L1 + 7) // 8

    # shifted symbols (+1), 0 = sentinel/pad, laid out with 8-word slack
    stride = L1 + 8 * n_words
    symp = np.zeros((R, stride), dtype=np.uint8)
    for r_chunk in range(0, R, 1 << 16):
        sl = slice(r_chunk, min(R, r_chunk + (1 << 16)))
        block = reads[sl].astype(np.uint8) + 1
        mask = np.arange(Lmax)[None, :] < lens[sl, None]
        symp[sl, :Lmax] = np.where(mask, block, 0)

    N = R * L1
    suf_r = np.repeat(np.arange(R, dtype=np.int32), L1)
    suf_o = np.tile(np.arange(L1, dtype=np.int32), R)
    valid = suf_o <= lens[suf_r]

    symp_d = jnp.asarray(symp.reshape(-1))
    offs_d = jnp.asarray((suf_r.astype(np.int64) * stride
                          + suf_o).astype(np.int32))
    invalid_d = jnp.asarray(~valid)

    @jax.jit
    def radix(offs, invalid):
        # least-significant key first: suffix id order (already iota =
        # read id then offset — the sentinel tie-break), then words
        # w = n_words-1 .. 0
        perm = jnp.arange(N, dtype=jnp.int32)
        for w in range(n_words - 1, -1, -1):
            cur_offs = offs[perm]
            keys = _pack_words(symp, cur_offs, w, invalid[perm])
            _, perm = lax.sort((keys, perm), dimension=0,
                               is_stable=True, num_keys=1)
        return perm

    @jax.jit
    def emit(perm, offs, invalid):
        # BWT symbol = preceding symbol; read start (o==0) → 4 ('$')
        o = offs[perm]
        prev = symp[o - 1].astype(jnp.int32) - 1  # -1 undoes the shift
        is_start = o % jnp.int32(stride) == 0
        return jnp.where(is_start, jnp.int32(4), prev), invalid[perm]

    symp = symp_d  # close over device array
    perm = radix(offs_d, invalid_d)
    bwt, inv = emit(perm, offs_d, invalid_d)
    bwt = np.asarray(bwt)
    inv = np.asarray(inv)
    return bwt[~inv].astype(np.uint8)


def set_bwt_oracle(reads: np.ndarray, lens: np.ndarray):
    """Naive host set-BWT (sorted-suffix oracle) for tests."""
    reads = np.asarray(reads, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int64)
    sufs = []
    for r in range(reads.shape[0]):
        seq = [int(c) + 1 for c in reads[r, : lens[r]]] + [0]
        for o in range(len(seq)):
            sufs.append((seq[o:], r, o))
    sufs.sort(key=lambda x: (x[0], x[1]))
    out = []
    for seq_suffix, r, o in sufs:
        if o == 0:
            out.append(4)
        else:
            full = [int(c) + 1 for c in reads[r, : lens[r]]] + [0]
            out.append(full[o - 1] - 1)
    return np.asarray(out, dtype=np.uint8)
