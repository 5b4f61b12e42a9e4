"""Wide-band banded Gotoh on the XLA twin vs the scalar oracle.

Covers the reference's warp-per-alignment wavefront capability for wide
bands (SURVEY.md §3.5 warp scheduler, §5.8(b)): the twin is the engine
there on every backend, so it is checked against the scalar oracle
directly — score, p_end and t_end for all alignment types, including N
symbols, quality-scaled mismatches and ragged lengths — and the
full-band flags that pass 3 of the two-pass CIGAR (alignment/wide.py)
walks are checked against the oracle's CIGAR.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nvbio_tpu.alignment import AlignmentType, GotohScheme, align_oracle
from nvbio_tpu.alignment.batched import banded_score_batch
from nvbio_tpu.alignment.wide import wide_band_cigar_batch


def _assert_oracle(pats, plens, texts, tlens, quals, *, scheme, atype,
                   band_w):
    """Twin sinks == oracle sinks on every lane the oracle defines the
    same way: non-empty patterns, and for GLOBAL an end cell inside the
    band."""
    jp = jnp.asarray
    got = banded_score_batch(jp(pats), jp(plens), jp(texts), jp(tlens),
                             None if quals is None else jp(quals),
                             scheme=scheme, atype=atype, band_w=band_w)
    n_checked = 0
    for b in range(len(pats)):
        if plens[b] == 0 or (atype == AlignmentType.GLOBAL
                             and abs(int(tlens[b]) - int(plens[b]))
                             > band_w):
            continue
        o = align_oracle(pats[b, : plens[b]], texts[b, : tlens[b]],
                         scheme, atype, band=band_w,
                         quals=None if quals is None
                         else quals[b, : plens[b]], traceback=False)
        assert int(got["score"][b]) == o.score, (atype, b)
        if o.score > -(1 << 29):  # sinks defined when a path exists
            assert int(got["p_end"][b]) == o.p_end, (atype, b)
            assert int(got["t_end"][b]) == o.t_end, (atype, b)
        n_checked += 1
    assert n_checked


@pytest.mark.parametrize("atype", list(AlignmentType))
def test_twin_matches_oracle_random_small(atype):
    """Randomized parity incl. N symbols and ragged lengths."""
    rng = np.random.default_rng(1234)
    for trial in range(4):
        nb = 3
        lp = int(rng.integers(5, 90))
        lt = int(rng.integers(5, 120))
        bw = int(rng.integers(3, 40))
        pats = rng.integers(0, 5, (nb, lp)).astype(np.int32)
        texts = rng.integers(0, 5, (nb, lt)).astype(np.int32)
        plens = rng.integers(1, lp + 1, nb).astype(np.int32)
        tlens = rng.integers(0, lt + 1, nb).astype(np.int32)
        if atype == AlignmentType.GLOBAL:
            tlens = np.clip(plens + rng.integers(-bw, bw + 1, nb), 0,
                            lt).astype(np.int32)
        quals = rng.integers(0, 41, (nb, lp)).astype(np.int32)
        _assert_oracle(pats, plens, texts, tlens, quals,
                       scheme=GotohScheme(), atype=atype, band_w=bw)


@pytest.mark.parametrize("atype", list(AlignmentType))
def test_twin_wide_band_rebase_matches_oracle(atype):
    """Wide band on mutated-copy texts (1.2 kb patterns, band_w 520)."""
    rng = np.random.default_rng(7)
    nb, lp, bw = 2, 1200, 520
    lt = lp + 180
    pats = rng.integers(0, 4, (nb, lp)).astype(np.int32)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int32)
    texts[:, 90:90 + lp] = pats
    for b in range(nb):
        mut = rng.integers(0, lt, 90)
        texts[b, mut] = rng.integers(0, 4, 90)
    plens = np.array([lp, lp - 37], np.int32)
    tlens = np.array([lt, lt - 11], np.int32)
    _assert_oracle(pats, plens, texts, tlens, None,
                   scheme=GotohScheme(), atype=atype, band_w=bw)


def test_twin_nondefault_scheme_matches_oracle():
    """Scoring-scheme plumbing: a non-default scheme (the CLI's
    --ma/--mp/--np/--rdg analog), local and semi-global."""
    rng = np.random.default_rng(11)
    nb, lp, lt, bw = 3, 200, 260, 48
    pats = rng.integers(0, 4, (nb, lp)).astype(np.int32)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int32)
    texts[:, 20:20 + lp] = pats
    texts[:, 20 + rng.integers(0, lp, 12)] = rng.integers(0, 4, 12)
    plens = np.full(nb, lp, np.int32)
    tlens = np.full(nb, lt, np.int32)
    quals = rng.integers(0, 41, (nb, lp)).astype(np.int32)
    scheme = GotohScheme(match=2, mismatch_min=3, mismatch_max=9,
                         n_penalty=2, gap_open=7, gap_extend=2)
    for atype in (AlignmentType.LOCAL, AlignmentType.SEMI_GLOBAL):
        _assert_oracle(pats, plens, texts, tlens, quals,
                       scheme=scheme, atype=atype, band_w=bw)


def test_pass3_full_band_walk_matches_oracle():
    """Pass 3 (every lane past a one-rung ladder): the twin's full-band
    flags, walked on the device, give the oracle's CIGAR — a big
    deletion, a big insertion and substitutions only."""
    rng = np.random.default_rng(88)
    W, LP = 96, 256
    nb = 3
    lt = LP + 2 * W
    pats = rng.integers(0, 4, (nb, LP)).astype(np.int8)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
    # lane 0: big deletion; lane 1: big insertion; lane 2: subs only
    texts[0, W:W + 120] = pats[0, :120]
    texts[0, W + 120 + 60:W + LP + 60] = pats[0, 120:]
    ins = np.concatenate([pats[1][:100], rng.integers(0, 4, 40),
                          pats[1][100:]])
    texts[1, W:W + len(ins[:LP + 40])] = ins[:min(len(ins), lt - W)]
    t2 = pats[2].copy()
    t2[::17] = (t2[::17] + 1) % 4
    texts[2, W:W + LP] = t2
    plens = np.full(nb, LP, np.int32)
    tlens = np.full(nb, lt, np.int32)
    scheme = GotohScheme()
    # max_tb_band=0: no certificate fits, every lane takes pass 3
    out = wide_band_cigar_batch(pats, plens, texts, tlens,
                                scheme=scheme,
                                atype=AlignmentType.SEMI_GLOBAL,
                                band_w=W, max_tb_band=0)
    assert (out["tb_band"] == W).all() and out["tb_ok"].all()
    ops = "?MDI"
    cigars = []
    for b in range(nb):
        o = align_oracle(pats[b], texts[b], scheme,
                         AlignmentType.SEMI_GLOBAL, band=W)
        runs = [(ops[int(op)], int(ln)) for op, ln in
                zip(out["run_ops"][b], out["run_lens"][b]) if ln > 0]
        assert runs[::-1] == o.cigar, b  # runs are end->start
        cigars.append("".join(op for op, _l in o.cigar))
        assert int(out["score"][b]) == o.score
        assert int(out["p_start"][b]) == o.p_start
        assert int(out["t_start"][b]) == o.t_start
    # the planted indels really appear in the walked CIGARs
    assert "D" in cigars[0] and "I" in cigars[1]
