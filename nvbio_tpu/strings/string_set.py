"""Padded read-batch packing (host NumPy → device-ready arrays).

The fixed-shape analog of the reference's string-set layouts (ref:
nvbio/strings/string_set.h): variable-length reads become a fixed
(R, max_len) matrix + length vector, padded with symbol 7 (never
matches) and quality 0.
"""

from __future__ import annotations

import numpy as np

PAD_SYMBOL = 7


def pack_reads(
    seqs: list[np.ndarray],
    quals: list[np.ndarray] | None = None,
    max_len: int | None = None,
):
    """Pack a list of symbol arrays into (reads, lens, quals) matrices.

    Reads longer than max_len are truncated (with a count returned in
    the stats dict); pads use PAD_SYMBOL / qual 0.
    """
    R = len(seqs)
    L = max_len or (max((len(s) for s in seqs), default=0) or 1)
    reads = np.full((R, L), PAD_SYMBOL, dtype=np.int8)
    qmat = np.zeros((R, L), dtype=np.uint8)
    lens = np.zeros(R, dtype=np.int32)
    truncated = 0
    for i, s in enumerate(seqs):
        m = len(s)
        if m > L:
            m = L
            truncated += 1
        reads[i, :m] = s[:m]
        lens[i] = m
        if quals is not None:
            qmat[i, :m] = quals[i][:m]
        else:
            qmat[i, :m] = 40
    return reads, lens, qmat, {"truncated": truncated}
