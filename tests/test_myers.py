"""Myers bit-vector edit distance vs scalar Levenshtein oracle."""

import numpy as np
import pytest

from nvbio_tpu.alignment.myers import (
    myers_edit_distance_batch,
    edit_distance_oracle,
)
from nvbio_tpu.alignment.types import AlignmentType


@pytest.mark.parametrize("LP,LT", [(20, 40), (32, 50), (33, 60), (128, 150)])
@pytest.mark.parametrize(
    "atype", [AlignmentType.SEMI_GLOBAL, AlignmentType.GLOBAL]
)
def test_myers_matches_oracle(LP, LT, atype):
    rng = np.random.default_rng(LP * 1000 + LT)
    N = 24
    plens = rng.integers(1, LP + 1, N).astype(np.int32)
    tlens = rng.integers(1, LT + 1, N).astype(np.int32)
    pats = rng.integers(0, 4, (N, LP)).astype(np.int32)
    texts = rng.integers(0, 4, (N, LT)).astype(np.int32)
    for i in range(0, N, 2):  # plant near-matches
        pl = plens[i]
        tl = max(tlens[i], pl)
        tlens[i] = tl
        s = rng.integers(0, tl - pl + 1)
        texts[i, s : s + pl] = pats[i, :pl]
    d, _ = myers_edit_distance_batch(pats, plens, texts, tlens, atype=atype)
    d = np.asarray(d)
    for i in range(N):
        want = edit_distance_oracle(
            pats[i, : plens[i]], texts[i, : tlens[i]], atype
        )
        assert d[i] == want


def test_myers_semi_global_end_position():
    # exact planted match: distance 0 and end at the plant position
    pat = np.array([[0, 1, 2, 3, 0, 1, 2, 3]], np.int32)
    text = np.full((1, 30), 3, np.int32)
    text[0, 10:18] = pat[0]
    d, tj = myers_edit_distance_batch(
        pat, np.array([8], np.int32), text, np.array([30], np.int32),
        atype=AlignmentType.SEMI_GLOBAL,
    )
    assert int(d[0]) == 0
    assert int(tj[0]) == 18


def test_myers_n_symbols_never_match():
    pat = np.array([[4, 4, 4, 4]], np.int32)  # all N
    text = np.zeros((1, 10), np.int32)
    d, _ = myers_edit_distance_batch(
        pat, np.array([4], np.int32), text, np.array([10], np.int32),
        atype=AlignmentType.SEMI_GLOBAL,
    )
    assert int(d[0]) == 4


def test_myers_local_rejected():
    with pytest.raises(ValueError):
        myers_edit_distance_batch(
            np.zeros((1, 4), np.int32), np.array([4], np.int32),
            np.zeros((1, 4), np.int32), np.array([4], np.int32),
            atype=AlignmentType.LOCAL,
        )
