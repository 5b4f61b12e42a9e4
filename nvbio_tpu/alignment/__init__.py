"""Batched dynamic-programming alignment engine.

JAX re-design of the reference's ``nvbio/alignment/`` layer
(alignment.h — ``make_gotoh_aligner``/``make_smith_waterman_aligner``/
``make_edit_distance_aligner``; batched.h — ``BatchedAlignmentScore``;
banded_inl.h — ``banded_alignment_score``).

One affine-gap (Gotoh) engine covers the whole aligner taxonomy:
Smith-Waterman with linear gaps is Gotoh with ``gap_open=0``; edit
distance is Gotoh with unit mismatch/gap costs.  Alignment types GLOBAL /
SEMI_GLOBAL (pattern-global, free text ends) / LOCAL match the
reference's tags.

Batching strategy (replaces the reference's CUDA thread/warp/persistent
schedulers, SURVEY.md §3.12): alignments ride the *batch* axis, fully
vectorized; each DP row advances with a `lax.scan` step, and the
within-row horizontal-gap recurrence is solved exactly with a weighted
cumulative max (max-plus scan).  The GPU kernel in
``nvbio_tpu.ops.banded_dp`` uses the same math with one alignment per
thread.
"""

from .types import (  # noqa: F401
    AlignmentType,
    GotohScheme,
    EDIT_DISTANCE_SCHEME,
    NEG_INF,
)
from .oracle import align_oracle  # noqa: F401
from .batched import banded_score_batch, banded_directions_batch  # noqa: F401
from .myers import myers_edit_distance_batch  # noqa: F401
from .cigar import traceback_banded, cigar_to_string, make_md_string  # noqa: F401
