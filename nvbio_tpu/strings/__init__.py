"""String sets and seed extraction.

Covers the reference's ``nvbio/strings/`` layer (ref: string_set.h —
``ConcatenatedStringSet``; seeds.h — ``enumerate_string_seeds``,
``uniform_seeds_functor``; infix.h — ``InfixSet``).  On the device the only
layout that matters is the padded batch matrix (reads, max_len) +
length vector — the moral equivalent of the reference's strided layout,
giving coalesced lane access.
"""

from .seeds import extract_uniform_seeds, num_uniform_seeds  # noqa: F401
from .string_set import pack_reads  # noqa: F401
