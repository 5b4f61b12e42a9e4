"""Core runtime: packed symbol streams, alphabets, bit primitives.

JAX re-design of the reference's ``nvbio/basic/`` layer
(packedstream.h, dna.h, popcount.h — symbols ``PackedStream``,
``char_to_dna``, ``popc_2bit``). Instead of a templated iterator zoo we
expose flat ``uint32`` word arrays + vectorized pack/unpack/popcount
helpers that work identically in NumPy (host oracles) and JAX (device).
"""

from .alphabet import (  # noqa: F401
    DNA_SYMBOLS,
    char_to_dna,
    dna_to_char,
    complement,
    reverse_complement,
    encode_dna,
    decode_dna,
)
from .packed import (  # noqa: F401
    SYMBOLS_PER_WORD,
    pack_2bit,
    unpack_2bit,
    popc_2bit_word,
    popc_2bit_prefix,
)
