"""Bloom filters (device-side, JAX).

Ref parity: nvbio/basic/bloom_filter.h (``bloom_filter``,
``blocked_bloom_filter``) — the backing store of nvLighter.  Fixed-shape
design: one byte per slot (scatter-max inserts, gather queries — XLA
has no atomic-OR scatter on packed bits, and HBM capacity at our
scales makes the 8x trade worthwhile; a packed uint32 variant can come
with a Pallas kernel later).  Slot count is a power of two.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax

import jax.numpy as jnp

# NumPy, not jnp: importing a module must not initialize a JAX backend
_SALTS = np.array(
    [0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
     0x165667B1, 0xD3A2646C, 0xFD7046C5, 0xB55A4F09],
    dtype=np.uint32,
)


def _mix(x, salt):
    """xorshift-multiply finalizer (splitmix-style) on uint32."""
    x = x.astype(jnp.uint32) ^ salt
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


@jax.tree_util.register_pytree_node_class
class BloomFilter(NamedTuple):
    slots: jnp.ndarray  # (n_slots,) uint8, n_slots = 2**log2_slots
    n_hashes: int  # static (pytree aux data, not a traced leaf)

    def tree_flatten(self):
        return (self.slots,), self.n_hashes

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(slots=children[0], n_hashes=aux)


def make_bloom(log2_slots: int, n_hashes: int = 4) -> BloomFilter:
    return BloomFilter(
        slots=jnp.zeros(1 << log2_slots, jnp.uint8), n_hashes=n_hashes
    )


def bloom_insert(bf: BloomFilter, keys) -> BloomFilter:
    """Insert int32/uint32 keys (any shape); returns the updated filter."""
    mask = jnp.uint32(bf.slots.shape[0] - 1)
    slots = bf.slots
    flat = keys.reshape(-1)
    for h in range(bf.n_hashes):
        idx = (_mix(flat, _SALTS[h]) & mask).astype(jnp.int32)
        slots = slots.at[idx].max(jnp.uint8(1))
    return BloomFilter(slots=slots, n_hashes=bf.n_hashes)


def bloom_query(bf: BloomFilter, keys):
    """Membership test; returns bool array shaped like keys."""
    mask = jnp.uint32(bf.slots.shape[0] - 1)
    flat = keys.reshape(-1)
    ok = jnp.ones(flat.shape, bool)
    for h in range(bf.n_hashes):
        idx = (_mix(flat, _SALTS[h]) & mask).astype(jnp.int32)
        ok = ok & (bf.slots[idx] > 0)
    return ok.reshape(keys.shape)


def counting_insert(bf: BloomFilter, keys, weights=None) -> BloomFilter:
    """Count-min-sketch insert: each hash slot accumulates occurrence
    counts (uint8, callers keep coverage < 255).  `weights` masks out
    invalid keys (0 = skip)."""
    mask = jnp.uint32(bf.slots.shape[0] - 1)
    flat = keys.reshape(-1)
    w = (jnp.ones(flat.shape, jnp.uint8) if weights is None
         else weights.reshape(-1).astype(jnp.uint8))
    slots = bf.slots
    for h in range(bf.n_hashes):
        idx = (_mix(flat, _SALTS[h]) & mask).astype(jnp.int32)
        slots = slots.at[idx].add(w)
    return BloomFilter(slots=slots, n_hashes=bf.n_hashes)


def counting_query(bf: BloomFilter, keys):
    """Count-min estimate: min slot count over the hash functions."""
    mask = jnp.uint32(bf.slots.shape[0] - 1)
    flat = keys.reshape(-1)
    cnt = jnp.full(flat.shape, 255, jnp.uint8)
    for h in range(bf.n_hashes):
        idx = (_mix(flat, _SALTS[h]) & mask).astype(jnp.int32)
        cnt = jnp.minimum(cnt, bf.slots[idx])
    return cnt.reshape(keys.shape)
