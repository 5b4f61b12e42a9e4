"""K-mer-spectrum read error correction (nvLighter equivalent).

Ref parity: nvLighter/ (SURVEY.md §3.9, §4.5) — a GPU re-build of the
Lighter corrector: pass 1 subsamples read k-mers (rate alpha) into a
Bloom filter; pass 2 tests k-mer trust and greedily corrects bases.

Batched re-design, fixed shapes throughout:

- pass 1: one batched count-min-sketch pass over all read k-mers
  (replacing Lighter's alpha-sampled filter A + trust-derivation pass
  with an equivalent single structure: a k-mer is *trusted* when its
  min-count reaches ``min_count``, i.e. enough read coverage supports
  it);
- pass 2: per read, all covering k-mers are queried at once; a base is
  suspect when no trusted k-mer covers it; every (position,
  alternative-base) pair is evaluated in one vectorized sweep counting
  how many covering k-mers become trusted, and the best substitution
  per position is applied where it beats a threshold.  One round
  (Lighter's greedy loop unrolls to one dominant round on typical
  error rates).

K-mer keys are 2-bit packed into int32 (k <= 15).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..basic.bloom import (
    BloomFilter,
    make_bloom,
    counting_insert,
    counting_query,
)


def _kmer_keys(reads, k: int):
    """(R, L) symbols -> (R, L-k+1) int32 keys; invalid (contains N/pad)
    keys return -1."""
    R, L = reads.shape
    n = L - k + 1
    keys = jnp.zeros((R, n), jnp.int32)
    bad = jnp.zeros((R, n), bool)
    for j in range(k):
        sym = reads[:, j : j + n].astype(jnp.int32)
        bad = bad | (sym >= 4)
        keys = (keys << 2) | (sym & 3)
    return jnp.where(bad, -1, keys), ~bad


@functools.partial(jax.jit, static_argnames=("k",))
def sample_kmers(bf: BloomFilter, reads, lens, *, k: int):
    """Pass 1: count every read k-mer into the sketch (ref: nvLighter
    sample_kmers.cu; see module docstring for the design delta)."""
    keys, ok = _kmer_keys(reads, k)
    n = keys.shape[1]
    in_read = jnp.arange(n)[None, :] + k <= lens[:, None]
    use = ok & in_read
    return counting_insert(bf, keys, use)


@functools.partial(jax.jit,
                   static_argnames=("k", "min_support", "min_count"))
def error_correct(bf: BloomFilter, reads, lens, *, k: int,
                  min_support: int = 2, min_count: int = 3):
    """Pass 2 (ref: nvLighter error_correct.cu): returns (corrected
    reads, n_corrections per read).  A k-mer is trusted when its
    count-min estimate reaches `min_count`."""
    R, L = reads.shape
    n = L - k + 1
    keys, okk = _kmer_keys(reads, k)
    in_read = jnp.arange(n)[None, :] + k <= lens[:, None]
    trusted = (counting_query(bf, keys) >= min_count) & okk & in_read

    # coverage of each base by trusted k-mers
    cov = jnp.zeros((R, L), jnp.int32)
    for s in range(k):  # shift-add the trusted windows
        cov = cov.at[:, s : s + n].add(trusted.astype(jnp.int32))
    suspect = (cov == 0) & (jnp.arange(L)[None, :] < lens[:, None]) & (
        reads < 4
    )

    # evaluate every (position, alt base): how many covering k-mers
    # become trusted if reads[:, p] -> b
    gain = jnp.zeros((R, L, 4), jnp.int32)
    for d in range(k):  # k-mer starting at p - d covers p at offset d
        shift = 2 * (k - 1 - d)
        base_keys = jnp.full((R, L), -1, jnp.int32)
        valid_s = jnp.zeros((R, L), bool)
        # k-mer start s = p - d exists when 0 <= p - d <= n - 1
        p_lo, p_hi = d, d + n  # p range with a valid covering k-mer
        base_keys = base_keys.at[:, p_lo:p_hi].set(keys)
        valid_s = valid_s.at[:, p_lo:p_hi].set(okk & in_read)
        cleared = base_keys & ~(3 << shift)
        for b in range(4):
            cand = cleared | (b << shift)
            hit = (counting_query(bf, cand) >= min_count) & valid_s & (
                base_keys >= 0)
            gain = gain.at[:, :, b].add(hit.astype(jnp.int32))

    best_b = jnp.argmax(gain, axis=2).astype(jnp.int8)
    best_gain = jnp.max(gain, axis=2)
    do = suspect & (best_gain >= min_support)
    corrected = jnp.where(do, best_b, reads.astype(jnp.int8))
    return corrected, do.sum(axis=1).astype(jnp.int32)


class Corrector(NamedTuple):
    bf: BloomFilter
    k: int

    @staticmethod
    def build(reads_iter, lens_iter, k: int = 15, log2_slots: int = 24):
        """Pass 1 over all batches."""
        bf = make_bloom(log2_slots)
        for reads, lens in zip(reads_iter, lens_iter):
            bf = sample_kmers(bf, jnp.asarray(reads),
                              jnp.asarray(lens.astype(np.int32)), k=k)
        return Corrector(bf=bf, k=k)

    def correct(self, reads, lens, min_support: int = 2,
                min_count: int = 3, rounds: int = 1):
        """`rounds` > 1 re-runs the vectorized sweep on the corrected
        output — the fixed-shape analog of Lighter's greedy loop
        continuing along the read: each round can fix one more error
        per k-window (a 2nd error inside the same window leaves no
        trusted covering k-mer for round 1 to gain from)."""
        out = jnp.asarray(reads)
        jl = jnp.asarray(np.asarray(lens).astype(np.int32))
        ncorr = np.zeros(out.shape[0], np.int32)
        for _ in range(max(rounds, 1)):
            out, nc = error_correct(
                self.bf, out, jl, k=self.k,
                min_support=min_support, min_count=min_count,
            )
            nc = np.asarray(nc)
            ncorr += nc
            if not nc.any():
                break
        return np.asarray(out), ncorr
