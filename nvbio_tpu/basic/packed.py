"""2-bit packed symbol streams.

JAX replacement for the reference's ``PackedStream`` /
``PackedVector`` (ref: nvbio/basic/packedstream.h, packed_vector.h) and
its 2-bit popcount primitives (ref: nvbio/basic/popcount.h —
``popc_2bit``).  Rather than an iterator abstraction we store flat
``uint32`` word arrays (16 symbols/word, LSB-first within the word) and
provide vectorized pack/unpack plus masked 2-bit-symbol popcounts — the
inner primitive of FM-index rank.

All functions take/return NumPy arrays when given NumPy inputs and work
under `jax.numpy` when given JAX arrays (pure elementwise/bit ops), so
the same code serves host oracles and jitted device paths.
"""

from __future__ import annotations

import numpy as np

#: symbols per 32-bit word at 2 bits/symbol
SYMBOLS_PER_WORD = 16
LOG2_SYMBOLS_PER_WORD = 4


def _xp(a):
    """Return the array namespace (numpy or jax.numpy) of `a`."""
    if type(a).__module__.startswith("jax"):
        import jax.numpy as jnp

        return jnp
    return np


def pack_2bit(symbols: np.ndarray) -> np.ndarray:
    """Pack an array of 2-bit symbols (values 0..3) into uint32 words.

    Symbol i lands in word i//16 at bit offset 2*(i%16) (LSB-first).
    The tail word is zero-padded (pad symbol = 0 = 'A'); callers that
    care must track the true length separately.
    """
    symbols = np.asarray(symbols, dtype=np.uint32)
    n = symbols.shape[0]
    n_words = (n + SYMBOLS_PER_WORD - 1) // SYMBOLS_PER_WORD
    padded = np.zeros(n_words * SYMBOLS_PER_WORD, dtype=np.uint32)
    padded[:n] = symbols & 3
    lanes = padded.reshape(n_words, SYMBOLS_PER_WORD)
    shifts = (2 * np.arange(SYMBOLS_PER_WORD, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(lanes << shifts, axis=1).astype(np.uint32)


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    """Unpack uint32 words back to `n` 2-bit symbols (uint8/int32)."""
    xp = _xp(words)
    words = words.astype(xp.uint32)
    shifts = (2 * xp.arange(SYMBOLS_PER_WORD, dtype=xp.uint32))[None, :]
    syms = (words[:, None] >> shifts) & 3
    return syms.reshape(-1)[:n].astype(xp.uint8)


def get_symbol(words, i):
    """Extract symbol(s) at flat index/indices `i` from packed words."""
    xp = _xp(words)
    w = words[i >> LOG2_SYMBOLS_PER_WORD]
    return (w >> (2 * (i & (SYMBOLS_PER_WORD - 1)).astype(xp.uint32))) & 3


def popc_2bit_word(words, c):
    """Count occurrences of 2-bit symbol `c` in each full uint32 word.

    Vectorized equivalent of the reference's ``popc_2bit`` (ref:
    nvbio/basic/popcount.h): XOR against the symbol replicated 16x, then
    mark symbol slots whose both bits are zero.
    """
    xp = _xp(words)
    words = words.astype(xp.uint32)
    pattern = (xp.uint32(0x55555555) * xp.uint32(c)) & xp.uint32(0xFFFFFFFF)
    x = words ^ pattern
    # slot matches c iff both bits of (word ^ pattern) are 0
    y = (~x) & ((~x) >> xp.uint32(1)) & xp.uint32(0x55555555)
    return _popcount32(y, xp)


def popc_2bit_prefix(words, c, k):
    """Count occurrences of symbol `c` among the first `k` (0..16)
    symbols of each word."""
    xp = _xp(words)
    words = words.astype(xp.uint32)
    k = xp.asarray(k, dtype=xp.uint32)
    # keep only the low 2k bits; k==16 keeps everything
    full = xp.uint32(0xFFFFFFFF)
    mask = xp.where(k >= 16, full, ~(full << (2 * k)) & full)
    pattern = (xp.uint32(0x55555555) * xp.uint32(c)) & full
    x = words ^ pattern
    y = (~x) & ((~x) >> xp.uint32(1)) & xp.uint32(0x55555555) & mask
    return _popcount32(y, xp)


def _popcount32(v, xp):
    if xp is np:
        v = v - ((v >> np.uint32(1)) & np.uint32(0x55555555))
        v = (v & np.uint32(0x33333333)) + ((v >> np.uint32(2)) & np.uint32(0x33333333))
        v = (v + (v >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
        return ((v * np.uint32(0x01010101)) & np.uint32(0xFFFFFFFF)) >> np.uint32(24)
    import jax.lax

    return jax.lax.population_count(v)
