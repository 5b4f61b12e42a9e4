"""Two-pass wide-band alignment WITH traceback (score-derived band).

Completes the long-alignment tier (ref: nvbio/alignment/batched.h
warp-per-alignment wavefront scheduler + checkpointed traceback,
SURVEY.md §3.5/§5.8(b-c)) for wide bands (band_w in the hundreds to
thousands): ONT-class long reads where the alignment diagonal is
unknown up front.

Score first, then trace a narrow certified band, instead of
checkpoint-recompute traceback:

1. **Score pass** at the requested wide band on the XLA twin
   (``banded_score_batch``).  O(band) memory per alignment, no flags.
2. **Band derivation** (host, exact): any path scoring ``s`` has at
   most ``g = (perfect(Lp) - s - min(open)) // min(extend)`` indels
   — each E/D or F/I step costs at least ``min(ee, fe)`` on top of
   one ``min(eo, fo)`` — and every indel moves the path's diagonal
   by one, so the whole optimal path stays within ``g`` diagonals of
   the end cell's diagonal ``d_end = t_end - p_end`` (and its
   leftmost text column is ``>= d_end - g``, see derive_tb_band).
3. **Traceback pass** on a window starting at text column
   ``max(d_end - g, 0)`` with the derived (quantized, <= ~2g) narrow
   band — ``ops.banded_directions`` + the run-jump walk, both existing
   machinery.

The derived band is a *certificate*, not a heuristic: pass 2's window
contains an optimal pass-1 path entirely, so its score matches pass 1
exactly (asserted in tests) and the emitted CIGAR attains it.  When
several optimal paths exist the traced one follows pass 2's in-window
tie-break, which can differ from a full-band twin's choice — the
score and validity are identical.

Alignments whose certificate exceeds ``max_tb_band`` (score gap
> ~2300 at default penalties) take **pass 3** instead: the twin's
direction pass re-runs on just those lanes at the full band and the
run-jump walk traces its flags on the device — no band cap, so every
valid lane gets a CIGAR regardless of score gap.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .batched import banded_directions_batch, banded_score_batch
from .types import AlignmentType, GotohScheme, NEG_INF, gap_penalties
from .walk import runjump_walk

#: static band ladder for the traceback pass: one compile variant per
#: rung; lanes past the last rung (flags of Lp * 1535 bytes each) take
#: pass 3 a few lanes at a time
TB_BANDS = (31, 63, 127, 255, 511, 767)
PAD_SYMBOL = 7


def derive_tb_band(plens, scores, p_end, t_end, scheme, band_w):
    """Per-alignment exact traceback certificate (host NumPy).

    Indel budget ``g`` from the score gap bounds the optimal path's
    diagonal span to ``[d_end - g, d_end + g]`` — AND its leftmost
    text column to ``>= d_end - g`` (reached only at pattern row 0).
    A pass-2 window ``(off, B2)`` covers text cols ``[off, ...)`` and
    diagonals ``[off - B2, off + B2]``; the left text edge therefore
    forces ``off <= d_end - g`` (clipped at 0), and covering the
    diagonal span from there costs ``B2 >= (d_end + g) - off``.

    The indel-budget certificate needs ``min(ee, fe) >= 1`` (a
    zero-cost gap extension unbinds run lengths from the score); the
    fallback certificate — always valid — is the ORIGINAL window
    itself: with ``off = 0`` and ``B2 = band_w`` pass 2's geometry
    equals pass 1's, so ``need`` is capped at ``band_w`` per lane.

    Returns ``(need, off)``: the minimal band and the window start.
    """
    plens = np.asarray(plens, np.int64)
    scores = np.asarray(scores, np.int64)
    d_end = np.asarray(t_end, np.int64) - np.asarray(p_end, np.int64)
    eo, ee, fo, fe = gap_penalties(scheme)
    min_ext = min(ee, fe)
    if min_ext < 1:  # score does not bound indel runs: original band
        n = len(plens)
        return (np.full(n, band_w, np.int64), np.zeros(n, np.int64))
    perfect = plens * scheme.match
    gap = np.maximum(perfect - scores - min(eo, fo), 0)
    g = gap // min_ext
    off = np.maximum(d_end - g, 0)
    need = np.maximum(d_end + g - off, off - (d_end - g))
    cert_wins = need < band_w
    need = np.where(cert_wins, need, band_w)
    off = np.where(cert_wins, off, 0)
    return need.astype(np.int64), off.astype(np.int64)


def _quantize_band(need: int) -> int | None:
    for b in TB_BANDS:
        if need <= b:
            return b
    return None


def wide_band_cigar_batch(
    patterns,  # (NB, Lp) int8 symbols (0..3; >=4 N)
    plens,  # (NB,) int32
    texts,  # (NB, Lt)
    tlens,  # (NB,) int32
    quals=None,  # (NB, Lp) or None
    *,
    scheme: GotohScheme,
    atype: AlignmentType,
    band_w: int,
    max_tb_band: int = TB_BANDS[-1],
):
    """Wide-band banded Gotoh with CIGAR via the two-pass schedule.

    Host-level function (two jit dispatches + one scalar sync).
    Returns a dict of host arrays: ``score``, ``p_end``, ``t_end``
    (coordinates in the ORIGINAL text), ``p_start``, ``t_start``,
    ``run_ops``/``run_lens`` (CIGAR runs in end->start walk order,
    codes {0 none, 1 M, 2 D, 3 I}), ``tb_ok`` (bool: CIGAR present),
    ``tb_band`` (the band certificate used).
    """
    from ..ops.banded_dp import banded_directions

    NB, Lp = patterns.shape
    # bands past the ladder take pass 3 instead of a new compile variant
    max_tb_band = min(max_tb_band, TB_BANDS[-1])
    patterns = jnp.asarray(patterns)
    texts = jnp.asarray(texts)
    plens_j = jnp.asarray(plens, jnp.int32)
    tlens_j = jnp.asarray(tlens, jnp.int32)
    quals_j = None if quals is None else jnp.asarray(quals)

    # ---- pass 1: wide-band score ----
    res1 = banded_score_batch(
        patterns, plens_j, texts, tlens_j, quals_j,
        scheme=scheme, atype=atype, band_w=band_w)
    score = np.asarray(res1["score"]).astype(np.int64)
    p_end = np.asarray(res1["p_end"]).astype(np.int64)
    t_end = np.asarray(res1["t_end"]).astype(np.int64)

    # ---- derive + quantize the traceback band ----
    valid = score > NEG_INF // 2
    need, off = derive_tb_band(plens, score, p_end, t_end, scheme,
                                band_w)
    tb_ok = valid & (need <= max_tb_band)
    need_max = int(need[tb_ok].max()) if tb_ok.any() else TB_BANDS[0]
    B2 = _quantize_band(min(need_max, max_tb_band)) or max_tb_band

    out = {
        "score": score, "p_end": p_end, "t_end": t_end,
        "tb_ok": tb_ok, "tb_band": np.full(NB, B2, np.int32),
        "p_start": np.zeros(NB, np.int64),
        "t_start": np.zeros(NB, np.int64),
        "run_ops": np.zeros((NB, 1), np.uint8),
        "run_lens": np.zeros((NB, 1), np.int32),
    }
    # lanes whose certificate exceeds the banded ladder are traced at
    # the full band instead (pass 3 below) — no band cap, so every
    # valid lane gets a CIGAR
    hard = valid & (need > max_tb_band)
    if not tb_ok.any():
        if hard.any():
            _full_band_tb(out, hard, patterns, plens, texts, tlens,
                          quals, scheme, atype, band_w)
        return out

    # ---- pass 2: re-positioned window, narrow-band directions DP ----
    # cell (i, k) of the banded DP over the window maps to text col
    # j = off + i + k - B2; derive_tb_band picked (need, off) so the
    # window's diagonal AND text-column reach contain every optimal
    # path end-to-end (see its docstring).
    off = np.where(tb_ok, off, 0)
    LT2 = Lp + 2 * B2
    Lt = texts.shape[1]
    off_j = jnp.asarray(off, jnp.int32)
    # one slice per lane, not LT2 gather indices per lane (the same
    # slice-level fetch as batched.window_slices); the PAD tail keeps
    # beyond-tlen symbols inert
    texts_p = jnp.pad(texts, ((0, 0), (0, LT2)),
                      constant_values=PAD_SYMBOL)
    texts2 = jax.vmap(
        lambda t, s: jax.lax.dynamic_slice(t, (s,), (LT2,)))(
            texts_p, off_j)
    tlens2 = jnp.clip(tlens_j - off_j, 0, LT2)

    res2, dirs = banded_directions(
        patterns, plens_j, texts2, tlens2, quals_j,
        scheme=scheme, atype=atype, band_w=B2)
    stride = 2 * B2 + 1
    dirs_flat = dirs.reshape(NB, Lp * stride)

    i0 = res2["p_end"].astype(jnp.int32)
    k0 = res2["t_end"].astype(jnp.int32) - i0 + B2
    fi, fk, run_ops, run_lens = runjump_walk(
        dirs_flat, stride, i0, k0,
        active=jnp.asarray(tb_ok))

    score2 = np.asarray(res2["score"]).astype(np.int64)
    # the band certificate guarantees pass 2 recovers pass 1's optimum
    # (its window contains an optimal path end-to-end); a higher pass-2
    # score is equally legitimate (a better path within the
    # re-positioned band) and is what the emitted CIGAR attains.  A
    # LOWER pass-2 score would mean the certificate was violated — the
    # guard demotes such lanes to the tb_ok=False contract (score/ends
    # from pass 1, no CIGAR) instead of reporting a score the CIGAR
    # cannot attain.
    tb_ok = out["tb_ok"] = tb_ok & (score2 >= score)
    out["score"] = np.where(tb_ok, score2, score)
    p_end2 = np.asarray(res2["p_end"]).astype(np.int64)
    t_end2 = np.asarray(res2["t_end"]).astype(np.int64) + off
    out["p_end"] = np.where(tb_ok, p_end2, p_end)
    out["t_end"] = np.where(tb_ok, t_end2, t_end)
    fi = np.asarray(fi).astype(np.int64)
    fk = np.asarray(fk).astype(np.int64)
    out["p_start"] = np.where(tb_ok, fi, 0)
    out["t_start"] = np.where(tb_ok, off + fi + fk - B2, 0)
    out["run_ops"] = np.asarray(run_ops)
    out["run_lens"] = np.asarray(run_lens)
    if hard.any():
        _full_band_tb(out, hard, patterns, plens, texts, tlens, quals,
                      scheme, atype, band_w)
    return out


def _full_band_tb(out, hard, patterns, plens, texts, tlens, quals,
                  scheme, atype, band_w):
    """Pass 3: CIGARs for lanes beyond the certificate ladder.

    Re-runs the twin's direction pass on just the hard lanes at the
    full band and walks its flags on the device (``runjump_walk``).
    It is the same recurrence as pass 1, so scores and ends are
    unchanged; only the CIGAR is new.  Flags take Lp * (2 * band_w + 1)
    bytes per lane (tens of MB at 10 kb / band 2000), so hard lanes go
    in small slices and the working set stays bounded.
    """
    idx = np.flatnonzero(np.asarray(hard))
    patterns = np.asarray(patterns)
    texts = np.asarray(texts)
    plens = np.asarray(plens)
    tlens = np.asarray(tlens)
    quals = None if quals is None else np.asarray(quals)
    Lp = patterns.shape[1]
    stride = 2 * band_w + 1
    runs_all = {}
    SLICE = 8  # lanes per call (flag memory bound)
    for s0 in range(0, idx.size, SLICE):
        sl = idx[s0:s0 + SLICE]
        res, dirs = banded_directions_batch(
            jnp.asarray(patterns[sl]), jnp.asarray(plens[sl], jnp.int32),
            jnp.asarray(texts[sl]), jnp.asarray(tlens[sl], jnp.int32),
            None if quals is None else jnp.asarray(quals[sl]),
            scheme=scheme, atype=atype, band_w=band_w)
        i0 = res["p_end"].astype(jnp.int32)
        k0 = res["t_end"].astype(jnp.int32) - i0 + band_w
        fi, fk, run_ops, run_lens = runjump_walk(
            dirs.reshape(len(sl), Lp * stride), stride, i0, k0)
        sc = np.asarray(res["score"])
        fi, fk = np.asarray(fi), np.asarray(fk)
        run_ops, run_lens = np.asarray(run_ops), np.asarray(run_lens)
        for li, b in enumerate(sl):
            # pass 1 and pass 3 run the same recurrence: ends agree
            assert sc[li] == out["score"][b], (b, sc[li],
                                               out["score"][b])
            keep = run_ops[li] != 0
            runs_all[b] = (run_ops[li][keep], run_lens[li][keep],
                           int(fi[li]), int(fi[li] + fk[li] - band_w))
    if not runs_all:
        return
    # device-derived arrays are read-only views; mutation needs copies
    for k in ("run_ops", "run_lens", "p_start", "t_start", "tb_ok",
              "tb_band"):
        out[k] = np.array(out[k])
    width = max(out["run_ops"].shape[1],
                max(len(r[0]) for r in runs_all.values()))
    if width > out["run_ops"].shape[1]:
        pad = width - out["run_ops"].shape[1]
        out["run_ops"] = np.pad(out["run_ops"], ((0, 0), (0, pad)))
        out["run_lens"] = np.pad(out["run_lens"], ((0, 0), (0, pad)))
    for b, (ro, rl, ps, ts) in runs_all.items():
        out["run_ops"][b, :len(ro)] = ro
        out["run_ops"][b, len(ro):] = 0
        out["run_lens"][b, :len(rl)] = rl
        out["run_lens"][b, len(rl):] = 0
        out["p_start"][b] = ps
        out["t_start"][b] = ts
        out["tb_ok"][b] = True
        out["tb_band"][b] = band_w
