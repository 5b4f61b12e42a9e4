"""The GPU banded-DP kernel (Pallas, Triton route) vs the XLA twin —
exact equality, in interpret mode on the CPU; the same kernel is
compiled for the card by chip_smoke.py and the ``gpu``-marked test."""

import numpy as np
import jax.numpy as jnp
import pytest

from nvbio_tpu.alignment import AlignmentType, GotohScheme
from nvbio_tpu.alignment.batched import (banded_directions_batch,
                                         banded_score_batch)
from nvbio_tpu.alignment.blosum import BLOSUM62
from nvbio_tpu.alignment.types import BOWTIE2_LOCAL_SCHEME
from nvbio_tpu.ops import banded_dp
from nvbio_tpu.ops.banded_dp import (TRITON_MAX_BAND_W, banded_directions,
                                     banded_directions_triton, banded_score,
                                     banded_score_triton, select_banded_dp)

BAND_W = 7
LP, LT = 20, 28
NB = 130  # deliberately not a multiple of the 128-lane block
FIELDS = ("score", "p_end", "t_end")


def _random_batch(seed, nb=NB, lp=LP, lt=LT):
    rng = np.random.default_rng(seed)
    plens = rng.integers(5, lp + 1, nb).astype(np.int32)
    tlens = rng.integers(10, lt + 1, nb).astype(np.int32)
    pats = rng.integers(0, 4, (nb, lp)).astype(np.int8)
    quals = rng.integers(0, 42, (nb, lp)).astype(np.int32)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
    for b in range(nb):
        n = min(plens[b], tlens[b])
        texts[b, :n] = pats[b, :n]
        for _ in range(rng.integers(0, 4)):
            texts[b, rng.integers(0, tlens[b])] = rng.integers(0, 4)
    # N symbols (4) in both operands score -n_penalty, distinct from
    # the PAD symbol (7) the staging pads with
    pats[rng.random((nb, lp)) < 0.02] = 4
    texts[rng.random((nb, lt)) < 0.02] = 4
    return pats, plens, quals, texts, tlens


def _args(pats, plens, quals, texts, tlens):
    return (jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(texts),
            jnp.asarray(tlens), jnp.asarray(quals))


def _assert_same(got, ref):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(got[f]),
                                      np.asarray(ref[f]), err_msg=f)


@pytest.mark.parametrize(
    "scheme,atype",
    [
        (GotohScheme(), AlignmentType.SEMI_GLOBAL),
        (BOWTIE2_LOCAL_SCHEME, AlignmentType.LOCAL),
        (GotohScheme(), AlignmentType.GLOBAL),
        # asymmetric --rdg/--rfg penalties (read gaps != ref gaps)
        (GotohScheme(gap_open=3, gap_extend=1,
                     ref_gap_open=8, ref_gap_extend=4),
         AlignmentType.SEMI_GLOBAL),
    ],
)
def test_pallas_matches_xla(scheme, atype):
    pats, plens, quals, texts, tlens = _random_batch(atype.value + 11)
    if atype == AlignmentType.GLOBAL:
        tlens = np.clip(tlens, plens - BAND_W // 2, plens + BAND_W // 2)
        tlens = np.minimum(tlens, LT).astype(np.int32)
    args = _args(pats, plens, quals, texts, tlens)
    kw = dict(scheme=scheme, atype=atype, band_w=BAND_W)
    # sinks agree on every lane, including lanes with no path
    _assert_same(banded_score_triton(*args, interpret=True, **kw),
                 banded_score_batch(*args, **kw))


def test_pallas_wide_band_matches_xla():
    """The widest band the register-resident kernel takes (the
    selector sends wider ones to the twin); exact equality vs the
    twin."""
    scheme, atype = GotohScheme(), AlignmentType.SEMI_GLOBAL
    band_w = TRITON_MAX_BAND_W
    lp = 24
    rng = np.random.default_rng(5)
    pats, plens, quals, texts, tlens = _random_batch(
        5, nb=96, lp=lp, lt=lp + 2 * band_w)
    for b in range(96):  # plant the pattern somewhere in the window
        off = rng.integers(0, tlens[b] - min(plens[b], tlens[b]) + 1)
        n = min(plens[b], tlens[b] - off)
        texts[b, off:off + n] = pats[b, :n]
    args = _args(pats, plens, quals, texts, tlens)
    kw = dict(scheme=scheme, atype=atype, band_w=band_w)
    _assert_same(banded_score_triton(*args, interpret=True, **kw),
                 banded_score_batch(*args, **kw))


@pytest.mark.parametrize("lp", [100, 150])
def test_pallas_mapper_widths_match_xla(lp):
    """The mapper's widths (100 and 150 bp, band half-width 15): the
    score pass and the directions pass (flags included) equal the
    twin's."""
    w = 15
    pats, plens, quals, texts, tlens = _random_batch(
        lp, nb=130, lp=lp, lt=lp + 2 * w)
    args = _args(pats, plens, quals, texts, tlens)
    for scheme, atype in ((GotohScheme(), AlignmentType.SEMI_GLOBAL),
                          (BOWTIE2_LOCAL_SCHEME, AlignmentType.LOCAL)):
        kw = dict(scheme=scheme, atype=atype, band_w=w)
        _assert_same(banded_score_triton(*args, interpret=True, **kw),
                     banded_score_batch(*args, **kw))
        rk, dk = banded_directions_triton(*args, interpret=True, **kw)
        rt, dt = banded_directions_batch(*args, **kw)
        _assert_same(rk, rt)
        np.testing.assert_array_equal(np.asarray(dk), np.asarray(dt))


def test_pallas_padding_and_empty_lanes():
    """Batches of 1 and 129 lanes pad to whole 128-lane programs;
    empty patterns and empty texts give the twin's no-path sinks."""
    for nb in (1, 129):
        pats, plens, quals, texts, tlens = _random_batch(nb, nb=nb)
        plens[: nb // 3] = 0
        tlens[nb // 3 : 2 * nb // 3] = 0
        args = _args(pats, plens, quals, texts, tlens)
        for atype in AlignmentType:
            kw = dict(scheme=GotohScheme(), atype=atype, band_w=BAND_W)
            got = banded_score_triton(*args, interpret=True, **kw)
            assert got["score"].shape == (nb,)
            _assert_same(got, banded_score_batch(*args, **kw))


def _np_walk(dirs_flat, stride, p_end, t_end, w, max_steps=600):
    """Reference traceback walk (mirrors traceback_walk_windows.step)."""
    i, k, st = int(p_end), int(t_end) - int(p_end) + w, 0
    ops = []
    for _ in range(max_steps):
        if st == 0 and i == 0:
            break
        flag = int(dirs_flat[(i - 1) * stride + k])
        f = flag & 3
        if st == 0:
            if f == 3:
                break
            if f == 0:
                ops.append("M"); i -= 1
            elif f == 1:
                st = 1
            else:
                st = 2
        elif st == 1:
            ops.append("I"); k -= 1
            if (flag >> 2) & 1:
                st = 0
        else:
            ops.append("D"); i -= 1; k += 1
            if (flag >> 3) & 1:
                st = 0
    return "".join(ops), i, k


def test_pallas_directions_match_xla_walk():
    """The one-pass directions kernel must produce the twin's flags and
    therefore the same traceback walks (op streams + start cells)."""
    scheme, atype = GotohScheme(), AlignmentType.SEMI_GLOBAL
    w = 7
    lp, lt, nb = 24, 38, 96
    rng = np.random.default_rng(21)
    plens = rng.integers(8, lp + 1, nb).astype(np.int32)
    tlens = rng.integers(16, lt + 1, nb).astype(np.int32)
    pats = rng.integers(0, 4, (nb, lp)).astype(np.int8)
    quals = rng.integers(0, 42, (nb, lp)).astype(np.int32)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
    for b in range(nb):  # plant with 0-2 indels + mismatches
        p = list(pats[b][:plens[b]])
        for _ in range(rng.integers(0, 3)):
            if rng.random() < 0.5 and len(p) > 4:
                del p[rng.integers(0, len(p))]
            else:
                p.insert(rng.integers(0, len(p)), rng.integers(0, 4))
        texts[b, :min(len(p), tlens[b])] = p[:tlens[b]]
        for _ in range(rng.integers(0, 3)):
            texts[b, rng.integers(0, tlens[b])] = rng.integers(0, 4)
    args = (jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(texts),
            jnp.asarray(tlens), jnp.asarray(quals))
    kw = dict(scheme=scheme, atype=atype, band_w=w)
    res_x, dirs_x = banded_directions_batch(*args, **kw)
    res_p, dirs_p = banded_directions_triton(*args, interpret=True, **kw)
    _assert_same(res_p, res_x)
    np.testing.assert_array_equal(np.asarray(dirs_p), np.asarray(dirs_x))
    BAND = 2 * w + 1
    dx = np.asarray(dirs_x).reshape(nb, -1)
    dp = np.asarray(dirs_p).reshape(nb, -1)
    smin = -0.6 - 0.6 * plens
    n_checked = 0
    for b in range(nb):
        if int(np.asarray(res_x["score"])[b]) < smin[b]:
            continue
        wx = _np_walk(dx[b], BAND, np.asarray(res_x["p_end"])[b],
                      np.asarray(res_x["t_end"])[b], w)
        wp = _np_walk(dp[b], BAND, np.asarray(res_p["p_end"])[b],
                      np.asarray(res_p["t_end"])[b], w)
        assert wx == wp, f"lane {b}: {wx} != {wp}"
        n_checked += 1
    assert n_checked >= nb // 2


@pytest.mark.parametrize("backend,band_w,scheme,want", [
    ("gpu", 15, GotohScheme(), "triton"),
    ("gpu", TRITON_MAX_BAND_W, GotohScheme(), "triton"),
    ("gpu", TRITON_MAX_BAND_W + 1, GotohScheme(), "xla"),
    ("gpu", 63, GotohScheme(), "xla"),  # PE rescue chunk band
    ("gpu", 15, BLOSUM62, "xla"),  # substitution matrix
    ("cpu", 15, GotohScheme(), "xla"),
])
def test_select_banded_dp(backend, band_w, scheme, want):
    assert select_banded_dp(backend, band_w, scheme) == want


def test_dispatch_follows_the_selector(monkeypatch):
    """banded_score/banded_directions run the engine the selector names
    for the current backend: the twin on the CPU, the kernel when the
    selector says so (interpret mode stands in for the card here)."""
    pats, plens, quals, texts, tlens = _random_batch(3)
    args = _args(pats, plens, quals, texts, tlens)
    kw = dict(scheme=GotohScheme(), atype=AlignmentType.SEMI_GLOBAL,
              band_w=BAND_W)
    ref, ref_dirs = banded_directions_batch(*args, **kw)
    _assert_same(banded_score(*args, **kw), ref)
    calls = []
    monkeypatch.setattr(banded_dp, "_engine",
                        lambda band_w, scheme: calls.append(band_w)
                        or "triton")
    for name in ("banded_score_triton", "banded_directions_triton"):
        fn = getattr(banded_dp, name)
        monkeypatch.setattr(
            banded_dp, name,
            lambda *a, fn=fn, **k: fn(*a, interpret=True, **k))
    _assert_same(banded_score(*args, **kw), ref)
    res, dirs = banded_directions(*args, **kw)
    _assert_same(res, ref)
    np.testing.assert_array_equal(np.asarray(dirs), np.asarray(ref_dirs))
    assert calls == [BAND_W, BAND_W]


@pytest.mark.gpu
def test_kernel_on_the_card_matches_xla(gpu_device):
    """The kernel as compiled for the card (no interpret mode) against
    the twin at the mapper's width."""
    pats, plens, quals, texts, tlens = _random_batch(
        7, nb=4096, lp=100, lt=130)
    args = _args(pats, plens, quals, texts, tlens)
    for atype in AlignmentType:
        kw = dict(scheme=GotohScheme(), atype=atype, band_w=15)
        rk, dk = banded_directions_triton(*args, **kw)
        rt, dt = banded_directions_batch(*args, **kw)
        _assert_same(rk, rt)
        np.testing.assert_array_equal(np.asarray(dk), np.asarray(dt))
