"""Bucketed device suffix sort — HBM-bounded, shard-scale.

The round-3 ``suffix_array_device`` (device.py) prefix-doubles over the
FULL text every round: 3 resident (n,) int32 operands per ``lax.sort``
plus sort workspace, so device memory grows ~5x faster than the text,
and every one of the ~30 rounds pays a full-n sort even
though most suffixes resolve in the first couple of rounds.

This module is the scalable design SURVEY.md §3.4 calls for (the
capability of the reference's blockwise difference-cover sort —
nvbio/sufsort/dcs.h + compression_sort.h — re-thought for XLA, which
has key-based ``lax.sort`` but no comparator-based segmented sort):

1. **Host bucketing** (one linear pass): every suffix keyed by its
   first 8 symbols (base-5, end-of-string = 0 so the sentinel sorts
   smallest); a stable integer argsort groups suffixes into at most
   5^8 contiguous buckets.  A suffix's global rank is its bucket's
   start index — ranks never cross buckets again, so all later work
   is bucket-local and embarrassingly parallel (chunks of whole
   buckets ride to the device independently; on a mesh, chunks are
   the natural shard axis).

2. **Device radix refinement** (per chunk of <= chunk_cap suffixes,
   padded to pow2 so a handful of executables serve every chunk):
   rounds of one stable 2-key ``lax.sort`` over
   ``(rank, next-8-symbols)``.  The 8-symbol window at any offset is
   two u32 gathers + a funnel shift from the nibble-packed text
   (symbol+1 per nibble, 0 = past-end, big-end-first so u32 numeric
   order == lexicographic order) — the packed text is the only
   full-length device array (n/8 u32 = 0.5 B/bp).  Relabel keeps
   ranks globally consistent: new rank = old rank (its group's
   global start) + index-within-group of the segment head, all
   cumulative ops.  Chunks early-exit as soon as they have no ties
   (random text: ~2 rounds); repeat-dense buckets continue to
   ``v`` symbols.

3. **Compacted global doubling** for whatever still ties after ``v``
   symbols (high-copy repeats): classic Larsson–Sadakane rounds
   ``key = (rank[p], rank[p+k])``, k = v, 2v, ..., but run ONLY over
   the surviving groups (compacted + pow2-padded), with ``rank[p+k]``
   gathered on the host from the global rank array.  Any two suffixes
   still tied at ``v`` symbols contain no end-of-string marker in
   their first ``v`` symbols (the 0 nibble would have split them), so
   the doubling invariant holds; ``p+k`` past the end ranks -1
   (sentinel-smallest).

Peak HBM: packed text + ~6 chunk-sized i32/u32 operands — independent
of n.  Peak host: the 8-symbol key + argsort arrays (~12 B/bp).

Oracle equality vs host SA-IS: tests/test_sufsort.py (random, tandem /
homopolymer adversarial, forced multi-chunk, 1 Mbp repeat-structured
at CI scale) and benchsuite/sa100_bench.py (100 Mbp repeat-structured,
on the GPU).  Each chunk ships ~100 MB of rank/suffix operands plus
per-round host syncs, so whether this beats host SA-IS depends on the
host link; host SA-IS stays the build default until that is measured.
The memory-bounded design (never more than packed text + 6 chunk
operands resident) is what this module establishes.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

# default refinement depth before switching to doubling: 8 host + 7
# device rounds x 8 symbols; repeats with period <= 64 are the common
# genomic case (ALU ~300 bp handled by doubling in 5 more rounds)
V_SYMBOLS = 64
CHUNK_CAP = 1 << 23  # suffixes per device chunk (6 ops -> ~200 MB)


def _pack_nibbles(text: np.ndarray, pad_words: int) -> np.ndarray:
    """(sym+1) 4-bit nibbles, 8 per u32, first symbol in the top
    nibble (numeric u32 order == lexicographic symbol order), plus
    `pad_words` zero words so windows may read past the end."""
    n = len(text)
    n_words = (n + 7) // 8
    nib = np.zeros(n_words * 8, dtype=np.uint32)
    nib[:n] = text.astype(np.uint32) + 1
    w = nib.reshape(n_words, 8)
    packed = np.zeros(n_words + pad_words, dtype=np.uint32)
    for j in range(8):
        packed[:n_words] |= w[:, j] << (28 - 4 * j)
    return packed


def _host_bucket_keys(text: np.ndarray) -> np.ndarray:
    """Base-5 key of the first 8 (sym+1)-biased symbols, 0 past end."""
    n = len(text)
    padded = np.zeros(n + 8, dtype=np.int32)
    padded[:n] = text.astype(np.int32) + 1
    key = np.zeros(n, dtype=np.int32)
    for j in range(8):
        key *= 5
        key += padded[j : j + n]
    return key


@functools.partial(jax.jit, static_argnames=("off_words",),
                   donate_argnums=(1, 2))
def _refine_round(packed, rank, pos, off_words):
    """One symbol-refinement round: sort by (rank, next 8 symbols at
    symbol offset off_words*8 + nib_off... see caller), relabel.

    `pos` carries suffix positions; pad entries have rank INT32_MAX
    and pos beyond n (reads land in the zero pad words).
    Returns (new_rank, new_pos, n_tied) with ranks globally
    consistent (rank + index-in-group of segment head).
    """
    # symbol index of the window start = pos + 8*off_words
    q = pos + jnp.int32(8 * off_words)
    a = q >> 3
    r4 = (q & 7) << 2  # nibble shift in bits
    hi = packed[a] << r4
    lo = (packed[a + 1] >> (31 - r4)) >> 1
    w = hi | lo

    rank_s, w_s, pos_s = lax.sort((rank, w, pos), dimension=0,
                                  is_stable=True, num_keys=2)
    m = rank.shape[0]
    idx = jnp.arange(m, dtype=jnp.int32)
    grp_new = jnp.concatenate(
        [jnp.ones(1, jnp.bool_), rank_s[1:] != rank_s[:-1]])
    seg_new = grp_new | jnp.concatenate(
        [jnp.ones(1, jnp.bool_), w_s[1:] != w_s[:-1]])
    # index within the (old) group
    grp_head = jnp.where(grp_new, idx, 0)
    in_grp = idx - lax.cummax(grp_head, axis=0)
    # every element takes its segment head's (rank + in-group index);
    # that value is strictly increasing over segment heads (group
    # slots are globally disjoint), so one cummax broadcasts it
    new_rank = lax.cummax(
        jnp.where(seg_new, rank_s + in_grp, jnp.int32(-1)), axis=0)
    # tied = element shares its segment with a neighbour (pads all
    # carry rank INT32_MAX + pos>n -> equal keys, excluded by caller)
    seg_sz_gt1 = (~seg_new) | jnp.concatenate(
        [~seg_new[1:], jnp.zeros(1, jnp.bool_)])
    n_tied = jnp.sum((seg_sz_gt1 & (rank_s != jnp.int32(2**31 - 1)))
                     .astype(jnp.int32))
    return new_rank, pos_s, n_tied


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _double_round(rank, second, pos):
    """One compacted Larsson–Sadakane round over surviving groups:
    sort by (rank, rank[p+k]) (second gathered on host), relabel."""
    rank_s, sec_s, pos_s = lax.sort((rank, second, pos), dimension=0,
                                    is_stable=True, num_keys=2)
    m = rank.shape[0]
    idx = jnp.arange(m, dtype=jnp.int32)
    grp_new = jnp.concatenate(
        [jnp.ones(1, jnp.bool_), rank_s[1:] != rank_s[:-1]])
    seg_new = grp_new | jnp.concatenate(
        [jnp.ones(1, jnp.bool_), sec_s[1:] != sec_s[:-1]])
    grp_head = jnp.where(grp_new, idx, 0)
    in_grp = idx - lax.cummax(grp_head, axis=0)
    new_rank = lax.cummax(
        jnp.where(seg_new, rank_s + in_grp, jnp.int32(-1)), axis=0)
    seg_sz_gt1 = (~seg_new) | jnp.concatenate(
        [~seg_new[1:], jnp.zeros(1, jnp.bool_)])
    tied = seg_sz_gt1 & (rank_s != jnp.int32(2**31 - 1))
    return new_rank, pos_s, tied


def suffix_array_bucketed(text: np.ndarray, v: int = V_SYMBOLS,
                          chunk_cap: int = CHUNK_CAP,
                          verbose: bool = False) -> np.ndarray:
    """Suffix array of `text` (uint8 symbols 0..3), device-sorted in
    HBM-bounded chunks; identical output to ``sufsort.suffix_array``
    (sentinel-smallest convention).
    """
    text = np.asarray(text, dtype=np.uint8)
    n = len(text)
    if n < 4096:  # not worth a device round trip
        from .sa import suffix_array_pd
        return suffix_array_pd(text)
    assert v % 8 == 0 and v >= 16
    INT_MAX = np.int32(2**31 - 1)

    # ---- phase 1: host bucketing by the first 8 symbols ----
    key8 = _host_bucket_keys(text)
    order = np.argsort(key8, kind="stable").astype(np.int32)
    key_sorted = key8[order]
    del key8
    grp_start_mask = np.empty(n, dtype=bool)
    grp_start_mask[0] = True
    np.not_equal(key_sorted[1:], key_sorted[:-1], out=grp_start_mask[1:])
    del key_sorted
    # global rank of each position in `order`-order = its group start
    starts_idx = np.flatnonzero(grp_start_mask).astype(np.int32)
    grp_id = np.cumsum(grp_start_mask) - 1
    rank_in_order = starts_idx[grp_id].astype(np.int32)
    del grp_id

    rank_final = np.empty(n, dtype=np.int32)  # rank by position
    rank_final[order] = rank_in_order

    pad_words = (v + 80) // 8 + 2
    packed = jnp.asarray(_pack_nibbles(text, pad_words))

    # chunks = runs of whole buckets, <= chunk_cap suffixes each (a
    # single bucket larger than chunk_cap gets its own chunk: the
    # sort is in-chunk, so it still fits as long as HBM allows)
    bucket_bounds = np.append(starts_idx, n)
    chunks = []
    c0 = 0
    for b in range(len(starts_idx)):
        if bucket_bounds[b + 1] - c0 > chunk_cap and bucket_bounds[b] > c0:
            chunks.append((c0, int(bucket_bounds[b])))
            c0 = int(bucket_bounds[b])
    chunks.append((c0, n))

    # ---- phase 2: device radix refinement to v symbols ----
    rounds_sym = (v - 8) // 8
    for ci, (s, e) in enumerate(chunks):
        m = e - s
        # singleton-only chunk: already resolved by the host key
        if m == np.sum(grp_start_mask[s:e]):
            continue
        cap = 1 << max(12, (m - 1).bit_length())
        rank_c = np.full(cap, INT_MAX, np.int32)
        pos_c = np.full(cap, n + 8, np.int32)
        rank_c[:m] = rank_in_order[s:e]
        pos_c[:m] = order[s:e]
        jr, jp = jnp.asarray(rank_c), jnp.asarray(pos_c)
        for r in range(1, rounds_sym + 1):
            jr, jp, n_tied = _refine_round(packed, jr, jp, r)
            if int(n_tied) == 0:
                break
        rank_in_order[s:e] = np.asarray(jr)[:m]
        order[s:e] = np.asarray(jp)[:m]
        if verbose:
            print(f"[sufsort] chunk {ci}: {m} suffixes, "
                  f"{int(n_tied)} tied after {r * 8 + 8} symbols",
                  flush=True)
    rank_final[order] = rank_in_order

    # ---- phase 3: compacted doubling over surviving ties ----
    seg_new = np.empty(n, dtype=bool)
    seg_new[0] = True
    np.not_equal(rank_in_order[1:], rank_in_order[:-1], out=seg_new[1:])
    tied_mask = ~seg_new | np.append(~seg_new[1:], False)
    k = v
    while tied_mask.any() and k < n:
        act = np.flatnonzero(tied_mask)
        m = len(act)
        cap = 1 << max(12, (m - 1).bit_length())
        rank_c = np.full(cap, INT_MAX, np.int32)
        sec_c = np.full(cap, INT_MAX, np.int32)
        pos_c = np.full(cap, n + 8, np.int32)
        pos_act = order[act]
        rank_c[:m] = rank_in_order[act]
        pk = pos_act.astype(np.int64) + k
        sec_c[:m] = np.where(pk < n, rank_final[np.minimum(pk, n - 1)],
                             np.int32(-1))
        pos_c[:m] = pos_act
        jr, jp, jt = _double_round(jnp.asarray(rank_c),
                                   jnp.asarray(sec_c),
                                   jnp.asarray(pos_c))
        new_rank = np.asarray(jr)[:m]
        new_pos = np.asarray(jp)[:m]
        still = np.asarray(jt)[:m]
        # `act` indexes stay the sorted slots of these suffixes (the
        # sort permutes within equal-rank groups, which occupy
        # contiguous `act` runs — each group is whole in the active
        # set by construction)
        rank_in_order[act] = new_rank
        order[act] = new_pos
        rank_final[new_pos] = new_rank
        tied_mask[:] = False
        tied_mask[act[still]] = True
        if verbose:
            print(f"[sufsort] doubling k={k}: {m} active, "
                  f"{int(still.sum())} still tied", flush=True)
        k *= 2
    assert not tied_mask.any(), "doubling did not converge"

    sa = np.empty(n, dtype=np.int64)
    sa[:] = order
    return sa
