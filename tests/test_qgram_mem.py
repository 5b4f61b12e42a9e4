"""Q-gram index/filter and MEM search vs brute force."""

import numpy as np
import jax.numpy as jnp

from nvbio_tpu.qgram import build_qgram_index, qgram_filter
from nvbio_tpu.qgram.index import qgram_keys
from nvbio_tpu.fmindex import build_fm_index
from nvbio_tpu.fmindex.mem import find_mems
from nvbio_tpu.alignment.extra import hamming_score_batch, full_score_batch
from nvbio_tpu.alignment import GotohScheme, AlignmentType, align_oracle
from nvbio_tpu.utils.simulate import random_genome


def test_qgram_filter_finds_all_hits():
    rng = np.random.default_rng(0)
    text = random_genome(5000, seed=1)
    Q = 8
    idx = build_qgram_index(text, q=Q)
    # query q-grams sampled from the text + randoms
    starts = rng.integers(0, 5000 - Q, 30)
    queries = qgram_keys(text, Q)[starts]
    offsets = rng.integers(0, 50, 30).astype(np.int32)
    diag, valid = qgram_filter(idx, jnp.asarray(queries),
                               jnp.asarray(offsets), max_hits=16)
    diag, valid = np.asarray(diag), np.asarray(valid)
    all_keys = qgram_keys(text, Q)
    for i, s in enumerate(starts):
        expect = np.nonzero(all_keys == all_keys[s])[0] - offsets[i]
        got = np.sort(diag[i][valid[i]])
        if len(expect) <= 16:
            np.testing.assert_array_equal(got, np.sort(expect))
        else:
            assert valid[i].all()


def _brute_mems(text, read, min_len):
    """All maximal exact matches (start, end) of read in text."""
    tb = text.tobytes()
    out = []
    L = len(read)
    for e in range(1, L + 1):
        # longest match ending at e
        best = 0
        for s in range(e - 1, -1, -1):
            if read[s:e].tobytes() in tb:
                best = e - s
            else:
                break
        if best:
            out.append((e - best, e))
    # right-maximality: drop (s,e) contained in (s', e+1)
    keep = []
    for s, e in out:
        contained = any(s2 <= s and e2 >= e and (s2, e2) != (s, e)
                        for s2, e2 in out)
        if not contained and e - s >= min_len:
            keep.append((s, e))
    return sorted(set(keep))


def test_find_mems_vs_brute():
    rng = np.random.default_rng(3)
    text = random_genome(3000, seed=5)
    R, L = 8, 40
    reads = np.zeros((R, L), np.int8)
    for r in range(R):
        # stitch two text chunks so MEM boundaries exist mid-read
        a = rng.integers(0, 2900)
        b = rng.integers(0, 2900)
        cut = rng.integers(10, 30)
        reads[r, :cut] = text[a : a + cut]
        reads[r, cut:] = text[b : b + L - cut]
    lens = np.full(R, L, np.int32)
    fm, _ = build_fm_index(text)
    res = find_mems(fm, jnp.asarray(reads), jnp.asarray(lens),
                    max_len=40, min_len=8)
    blen = np.asarray(res["len"])
    smem = np.asarray(res["smem"])
    lo, hi = np.asarray(res["lo"]), np.asarray(res["hi"])
    tb = text.tobytes()
    for r in range(R):
        got = sorted(
            (int(e - blen[r, e - 1]), int(e))
            for e in range(1, L + 1) if smem[r, e - 1]
        )
        expect = _brute_mems(text, reads[r].astype(np.uint8), 8)
        assert got == expect, f"read {r}: {got} != {expect}"
        # SA range size == occurrence count
        for s, e in got:
            cnt = 0
            start = 0
            pb = reads[r, s:e].astype(np.uint8).tobytes()
            while True:
                p = tb.find(pb, start)
                if p < 0:
                    break
                cnt += 1
                start = p + 1
            j = e - 1
            assert hi[r, j] - lo[r, j] == cnt


def test_hamming_and_full():
    rng = np.random.default_rng(7)
    R, L = 8, 20
    pats = rng.integers(0, 4, (R, L)).astype(np.int8)
    texts = pats.copy()
    texts[:, 5] = (texts[:, 5] + 1) % 4  # one mismatch at qual 40 -> -6
    plens = np.full(R, L, np.int32)
    h = np.asarray(hamming_score_batch(jnp.asarray(pats), jnp.asarray(plens),
                                       jnp.asarray(texts)))
    np.testing.assert_array_equal(h, np.full(R, -6))

    res = full_score_batch(
        jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(texts),
        jnp.asarray(plens), scheme=GotohScheme(),
        atype=AlignmentType.GLOBAL,
    )
    for r in range(R):
        ref = align_oracle(pats[r], texts[r], GotohScheme(),
                           AlignmentType.GLOBAL)
        assert int(res["score"][r]) == ref.score


def test_qgram_mapper_end_to_end():
    from nvbio_tpu.fmindex import build_fm_index
    from nvbio_tpu.models import MapperParams
    from nvbio_tpu.models.qgram_mapper import QGramMapper
    from nvbio_tpu.strings import pack_reads
    from nvbio_tpu.utils.simulate import random_genome, simulate_reads

    genome = random_genome(60_000, seed=41)
    params = MapperParams(batch_size=48, sa_sample=16, max_candidates=8)
    fm, ssa = build_fm_index(genome, sa_sample=params.sa_sample)
    m = QGramMapper(fm, ssa, genome, q=14, stride=7, params=params)
    sim = simulate_reads(genome, 48, 100, seed=42, error_rate=0.02)
    reads, lens, quals, _ = pack_reads(
        list(sim["seqs"].astype(np.uint8)), list(sim["quals"])
    )
    results = m.map_reads(reads, lens, quals.astype(np.int32))
    n_ok = sum(
        1 for i, r in enumerate(results)
        if r.aligned and abs(r.pos - sim["true_pos"][i]) <= 2
        and r.strand == sim["true_strand"][i]
    )
    assert n_ok >= 44
