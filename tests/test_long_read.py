"""Long-read DP on the XLA twin + mapper long-read path.

Covers the reference's long-alignment capability (SURVEY.md §3.5 warp
scheduler, §5.8(a-c)): oracle-exact score+CIGAR at kb scale (the twin
is the long-read engine on every backend) and the seed-and-extend
mapper accepting reads far beyond 512 bp.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nvbio_tpu.alignment import (
    AlignmentType,
    GotohScheme,
    align_oracle,
    banded_score_batch,
    banded_directions_batch,
)
from nvbio_tpu.alignment.types import NEG_INF, gap_penalties
from nvbio_tpu.models.mapper import _runjump_walk


def _long_batch(nb, lp, band_w, seed, n_mut=20, n_indel=4):
    rng = np.random.default_rng(seed)
    plens = rng.integers(lp - lp // 10, lp + 1, nb).astype(np.int32)
    pats = rng.integers(0, 4, (nb, lp)).astype(np.int8)
    quals = rng.integers(0, 42, (nb, lp)).astype(np.int32)
    lt = lp + 2 * band_w
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
    for b in range(nb):
        t = pats[b, : plens[b]].copy()
        for _ in range(n_mut):
            t[rng.integers(0, len(t))] = rng.integers(0, 4)
        for _ in range(n_indel):
            p = rng.integers(1, len(t) - 2)
            if rng.random() < 0.5:
                t = np.concatenate([t[:p], t[p + 1:]])
            else:
                t = np.concatenate([t[:p], [rng.integers(0, 4)], t[p:]])
        texts[b, : min(len(t), lt)] = t[:lt]
    tlens = np.full(nb, lt, np.int32)
    return pats, plens, quals, texts, tlens


def _walk_runs(rops, rlens, r):
    return [(int(o), int(l))
            for o, l in zip(np.asarray(rops[r]), np.asarray(rlens[r]))
            if l > 0]


def _oracle_check(pats, plens, quals, texts, tlens, band_w, lanes):
    """Twin score, sinks and run-jump-walk CIGAR == the scalar oracle's
    on the given lanes (SEMI_GLOBAL, default scheme)."""
    scheme = GotohScheme()
    kw = dict(scheme=scheme, atype=AlignmentType.SEMI_GLOBAL,
              band_w=band_w)
    jp = jnp.asarray
    res, dirs = banded_directions_batch(jp(pats), jp(plens), jp(texts),
                                        jp(tlens), jp(quals), **kw)
    nb = len(pats)
    i0 = res["p_end"].astype(jnp.int32)
    k0 = res["t_end"].astype(jnp.int32) - i0 + band_w
    w = _runjump_walk(jp(np.asarray(dirs).reshape(nb, -1)),
                      2 * band_w + 1, i0, k0)
    for r in lanes:
        o = align_oracle(pats[r, : plens[r]], texts[r, : tlens[r]],
                         scheme, AlignmentType.SEMI_GLOBAL, band=band_w,
                         quals=quals[r])
        assert int(res["score"][r]) == o.score
        assert int(res["p_end"][r]) == o.p_end
        assert int(res["t_end"][r]) == o.t_end
        runs = _walk_runs(w[2], w[3], r)[::-1]  # walk is end->start
        assert [("M", "M", "D", "I")[op] for op, _l in runs] == [
            op for op, _l in o.cigar]
        assert [l for _op, l in runs] == [l for _op, l in o.cigar]
        assert int(w[0][r]) == o.p_start


@pytest.mark.parametrize("lp,band_w", [(640, 31), (1300, 15)])
def test_long_twin_matches_oracle_and_walk(lp, band_w):
    """The twin at long-read shapes: scores, sinks AND the traceback
    walk equal the scalar oracle's."""
    batch = _long_batch(6, lp, band_w, lp)
    _oracle_check(*batch, band_w, lanes=range(3))


def test_long_walk_matches_oracle_cigar():
    """Twin + run-jump walk reproduce the scalar oracle's score AND
    CIGAR at kb scale (banded)."""
    lp, band_w = 1200, 15
    pats, plens, quals, texts, tlens = _long_batch(
        4, lp, band_w, 99, n_mut=30, n_indel=6)
    scheme = GotohScheme()
    kw = dict(scheme=scheme, atype=AlignmentType.SEMI_GLOBAL,
              band_w=band_w)
    jp = jnp.asarray
    res, dirs = banded_directions_batch(jp(pats), jp(plens), jp(texts),
                                        jp(tlens), jp(quals), **kw)
    BAND = 2 * band_w + 1
    i0 = res["p_end"].astype(jnp.int32)
    k0 = res["t_end"].astype(jnp.int32) - i0 + band_w
    w = _runjump_walk(jp(np.asarray(dirs).reshape(4, -1)), BAND, i0, k0)
    for r in range(4):
        o = align_oracle(pats[r, : plens[r]], texts[r, : tlens[r]],
                         scheme, AlignmentType.SEMI_GLOBAL, band=band_w,
                         quals=quals[r])
        assert int(res["score"][r]) == o.score
        # walk runs are end->start; oracle CIGAR is start->end
        runs = _walk_runs(w[2], w[3], r)[::-1]
        ops = [("M", "M", "D", "I")[op] for op, _l in runs]
        lens_ = [l for _op, l in runs]
        assert list(zip(ops, lens_)) == o.cigar
        assert int(w[0][r]) == o.p_start


def _banded_semi_global_ref(p, t, q, scheme, w):
    """Scalar banded SEMI_GLOBAL Gotoh with one band row in memory: the
    oracle's recurrences (oracle.py) for patterns where its full
    matrices do not fit.  Returns (score, t_end)."""
    eo, ee, fo, fe = gap_penalties(scheme)
    M, N = len(p), len(t)
    Hp = {j: 0 for j in range(0, min(N, w) + 1)}  # row 0: free text
    Fp = {}
    for i in range(1, M + 1):
        H, F, Hh = {}, {}, {}
        e = NEG_INF
        for j in range(max(0, i - w), min(N, i + w) + 1):
            if j == 0:  # leading pattern symbols = costed insertions
                H[0] = Hh[0] = F[0] = -(fo + i * fe)
                e = NEG_INF
                continue
            s = scheme.substitution(int(p[i - 1]), int(t[j - 1]),
                                    int(q[i - 1]))
            diag = Hp.get(j - 1, NEG_INF) + s
            F[j] = (max(Hp[j] - fo - fe, Fp.get(j, NEG_INF) - fe)
                    if j in Hp else NEG_INF)
            Hh[j] = max(diag, F[j])
            e = (max(Hh[j - 1] - eo - ee, e - ee) if (j - 1) in Hh
                 else NEG_INF)
            H[j] = max(Hh[j], e)
        Hp, Fp = H, F
    j_best = min(j for j, v in Hp.items() if v == max(Hp.values()))
    return Hp[j_best], j_best


@pytest.mark.parametrize("lp", [10_000])
def test_very_long_twin_score_matches_reference(lp):
    """10 kb patterns: twin scores and sinks == a scalar banded
    reference of the oracle's recurrences."""
    band_w = 15
    pats, plens, quals, texts, tlens = _long_batch(
        2, lp, band_w, 7, n_mut=100, n_indel=8)
    kw = dict(scheme=GotohScheme(), atype=AlignmentType.SEMI_GLOBAL,
              band_w=band_w)
    jp = jnp.asarray
    a = banded_score_batch(jp(pats), jp(plens), jp(texts), jp(tlens),
                           jp(quals), **kw)
    for r in range(2):
        score, t_end = _banded_semi_global_ref(
            pats[r, : plens[r]], texts[r, : tlens[r]], quals[r],
            GotohScheme(), band_w)
        assert int(a["score"][r]) == score
        assert int(a["p_end"][r]) == plens[r]
        assert int(a["t_end"][r]) == t_end


def test_mapper_long_reads_end_to_end():
    """Seed-and-extend mapper on 2 kb reads (> the old 512 bp cap):
    correct loci and CIGARs spanning indels."""
    from nvbio_tpu.fmindex import build_fm_index
    from nvbio_tpu.models import Mapper, MapperParams
    from nvbio_tpu.strings import pack_reads
    from nvbio_tpu.utils.simulate import random_genome

    rng = np.random.default_rng(17)
    genome = random_genome(300_000, seed=18)
    R, L = 8, 2000
    params = MapperParams(batch_size=R, sa_sample=8, max_candidates=8,
                          band_w=31, max_read_len=2048)
    fm, ssa = build_fm_index(genome, sa_sample=8, bi_sample=True)
    seqs, quals, true_pos = [], [], []
    for i in range(R):
        p = int(rng.integers(0, len(genome) - L - 50))
        true_pos.append(p)
        t = genome[p : p + L].copy()
        for _ in range(20):  # 1% mismatches
            t[rng.integers(0, L)] = rng.integers(0, 4)
        for _ in range(3):  # a few short indels
            q = int(rng.integers(100, L - 100))
            if rng.random() < 0.5:
                t = np.concatenate([t[:q], t[q + 2:]])
            else:
                t = np.concatenate(
                    [t[:q], rng.integers(0, 4, 2).astype(t.dtype), t[q:]])
        seqs.append(t[:L].astype(np.uint8))
        quals.append(np.full(len(seqs[-1]), 35, np.uint8))
    reads, lens, qmat, _ = pack_reads(seqs, quals, max_len=2048)
    m = Mapper(fm, ssa, genome, params=params)
    res = m.map_reads(reads, lens, qmat)
    n_ok = 0
    for i, r in enumerate(res):
        if r.aligned and abs(r.pos - true_pos[i]) <= 40:
            n_ok += 1
            assert sum(l for l, op in _parse_cigar(r.cigar)
                       if op in "MI") == int(lens[i])
    assert n_ok >= R - 1


def _parse_cigar(c):
    import re
    return [(int(l), op) for l, op in re.findall(r"(\d+)([MIDNSHP=X])", c)]


def test_wide_band_twin_walk_matches_oracle():
    """Wide bands (band_w 300, 800 bp): the twin's flags walk to the
    oracle's CIGAR."""
    band_w, lp = 300, 800
    batch = _long_batch(2, lp, band_w, 17, n_mut=40, n_indel=10)
    _oracle_check(*batch, band_w, lanes=range(2))
