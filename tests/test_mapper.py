"""End-to-end mapper test on a synthetic genome (ground-truth oracle).

Plays the role of the reference's nvbio-aln-diff output validation
(SURVEY.md §5.1) with a stronger oracle: simulated reads carry their
true positions, so we check mapping accuracy, CIGAR consistency, and
score reproducibility directly.
"""

import numpy as np
import pytest

from nvbio_tpu.fmindex import build_fm_index
from nvbio_tpu.models import Mapper, MapperParams
from nvbio_tpu.strings import pack_reads
from nvbio_tpu.utils.simulate import random_genome, simulate_reads
from nvbio_tpu.io.sam import SamRecord

GENOME_N = 100_000
N_READS = 64
READ_LEN = 100


@pytest.fixture(scope="module")
def mapper():
    genome = random_genome(GENOME_N, seed=7)
    params = MapperParams(batch_size=N_READS, sa_sample=16,
                          max_candidates=8)
    fm, ssa = build_fm_index(genome, sa_sample=params.sa_sample)
    return Mapper(fm, ssa, genome, params=params), genome


def _score_from_path(scheme, pat, quals, window, t_start, cigar_ops):
    s, i, j = 0, 0, t_start
    for op, length in cigar_ops:
        if op == "M":
            for _ in range(length):
                s += scheme.substitution(int(pat[i]), int(window[j]),
                                         int(quals[i]))
                i += 1
                j += 1
        else:
            s -= scheme.gap_open + length * scheme.gap_extend
            if op == "I":
                i += length
            else:
                j += length
    return s


def test_mapper_end_to_end(mapper):
    m, genome = mapper
    sim = simulate_reads(genome, N_READS, READ_LEN, error_rate=0.01,
                         indel_rate=0.002, seed=3)
    reads, lens, quals, _ = pack_reads(list(sim["seqs"].astype(np.uint8)),
                                       list(sim["quals"]))
    results = m.map_reads(reads, lens, quals)

    n_aligned = sum(r.aligned for r in results)
    assert n_aligned >= int(0.95 * N_READS), f"only {n_aligned} aligned"

    correct = 0
    for r, mr in enumerate(results):
        if not mr.aligned:
            continue
        if (
            mr.strand == int(sim["true_strand"][r])
            and abs(mr.pos - int(sim["true_pos"][r])) <= 8
        ):
            correct += 1
        # CIGAR must consume the whole read (end-to-end mode)
        consumed = 0
        num = ""
        for ch in mr.cigar:
            if ch.isdigit():
                num += ch
            else:
                if ch in "MIS":
                    consumed += int(num)
                num = ""
        assert consumed == lens[r], f"read {r}: cigar {mr.cigar}"
    assert correct >= int(0.9 * n_aligned), f"{correct}/{n_aligned} correct"


def test_scores_reproducible_from_cigar(mapper):
    m, genome = mapper
    sim = simulate_reads(genome, N_READS, READ_LEN, error_rate=0.02,
                         indel_rate=0.004, seed=9)
    reads, lens, quals, _ = pack_reads(list(sim["seqs"].astype(np.uint8)),
                                       list(sim["quals"]))
    results = m.map_reads(reads, lens, quals)
    scheme = m.params.scheme
    W = m.params.band_w
    checked = 0
    for r, mr in enumerate(results):
        if not mr.aligned:
            continue
        pat = reads[r, : lens[r]].astype(np.uint8)
        q = quals[r, : lens[r]]
        if mr.strand:
            pat = np.where(pat < 4, 3 - pat, pat)[::-1].astype(np.uint8)
            q = q[::-1]
        # reconstruct the path from the CIGAR against the genome
        ops = []
        num = ""
        for ch in mr.cigar:
            if ch.isdigit():
                num += ch
            else:
                if ch != "S":
                    ops.append((ch, int(num)))
                num = ""
        window = genome[max(0, mr.pos - W) : mr.pos + lens[r] + W]
        t_start = mr.pos - max(0, mr.pos - W)
        got = _score_from_path(scheme, pat, q, window, t_start, ops)
        assert got == mr.score, f"read {r}: path {got} != score {mr.score}"
        checked += 1
    assert checked > 0


def test_sam_records(mapper):
    m, genome = mapper
    sim = simulate_reads(genome, N_READS, READ_LEN, seed=5)
    reads, lens, quals, _ = pack_reads(list(sim["seqs"].astype(np.uint8)),
                                       list(sim["quals"]))
    results = m.map_reads(reads, lens, quals)
    names = [f"r{i}" for i in range(N_READS)]
    recs = m.to_sam_records(names, reads, lens, quals, results)
    assert len(recs) == N_READS
    for rec in recs:
        line = rec.to_line()
        cols = line.split("\t")
        assert len(cols) >= 11
        assert 0 <= int(cols[4]) <= 42
        if not (rec.flag & 0x4):
            assert cols[2] == "ref"
            assert int(cols[3]) >= 1
            assert "M" in cols[5]


def test_one_mismatch_seeding_rescues_unseedable_reads():
    """Reads where EVERY seed contains exactly one substitution: exact
    (-N 0) seeding finds nothing, -N 1 maps them (ref: mapping_inl.h
    map_approx / fmindex/backtrack.h)."""
    from nvbio_tpu.fmindex import build_fm_index
    from nvbio_tpu.models import MapperParams
    from nvbio_tpu.models.mapper import Mapper
    from nvbio_tpu.strings import pack_reads
    from nvbio_tpu.utils.simulate import random_genome

    genome = random_genome(50_000, seed=77)
    rng = np.random.default_rng(78)
    R, L, SL = 24, 32, 16
    seqs, starts = [], []
    for _ in range(R):
        s = int(rng.integers(0, len(genome) - L))
        frag = genome[s : s + L].copy()
        for p in (8, 24):  # one substitution inside each 16bp seed
            frag[p] = (frag[p] + 1 + rng.integers(0, 3)) % 4
        seqs.append(frag)
        starts.append(s)
    reads, lens, quals, _ = pack_reads(
        seqs, [np.full(L, 35, np.uint8)] * R
    )
    quals = quals.astype(np.int32)

    common = dict(batch_size=R, sa_sample=16, max_candidates=8,
                  seed_len=SL, seed_interval=SL)
    fm, ssa = build_fm_index(genome, sa_sample=16)
    m0 = Mapper(fm, ssa, genome, params=MapperParams(**common))
    m1 = Mapper(fm, ssa, genome,
                params=MapperParams(seed_mismatches=1, **common))
    r0 = m0.map_reads(reads, lens, quals)
    r1 = m1.map_reads(reads, lens, quals)
    assert sum(r.aligned for r in r0) == 0
    ok = sum(
        1 for i, r in enumerate(r1) if r.aligned and r.pos == starts[i]
    )
    assert ok >= R - 2


def test_all_mappings_mode_finds_planted_duplicates():
    """--all mode (ref: nvBowtie all_inl.h): a read whose origin was
    copied to a second locus must report both as alignments."""
    from nvbio_tpu.fmindex import build_fm_index
    from nvbio_tpu.models import MapperParams
    from nvbio_tpu.models.mapper import Mapper
    from nvbio_tpu.strings import pack_reads
    from nvbio_tpu.utils.simulate import random_genome

    genome = random_genome(40_000, seed=55)
    genome[30_000:30_200] = genome[5_000:5_200]  # duplicate a segment
    rng = np.random.default_rng(56)
    R, L = 16, 80
    seqs, starts = [], []
    for _ in range(R):
        off = int(rng.integers(0, 120))
        seqs.append(genome[5_000 + off : 5_000 + off + L].copy())
        starts.append(5_000 + off)
    reads, lens, quals, _ = pack_reads(
        seqs, [np.full(L, 35, np.uint8)] * R
    )
    params = MapperParams(batch_size=R, sa_sample=16, max_candidates=8)
    fm, ssa = build_fm_index(genome, sa_sample=16)
    m = Mapper(fm, ssa, genome, params=params)
    all_res = m.map_reads_all(reads, lens, quals.astype(np.int32))
    for i, alns in enumerate(all_res):
        poss = sorted(a.pos for a in alns)
        assert len(alns) >= 2, (i, poss)
        assert starts[i] in poss
        assert starts[i] + 25_000 in poss
    # SAM emit: one primary + secondaries with FLAG 0x100
    recs = m.to_sam_records_all(
        [f"r{i}" for i in range(R)], reads, lens, quals, all_res
    )
    n_secondary = sum(1 for r in recs if r.flag & 0x100)
    n_primary = sum(1 for r in recs if not (r.flag & 0x104))
    assert n_primary == R
    assert n_secondary >= R


def test_native_finish_matches_python_walk(mapper):
    """The C++ traceback/CIGAR/MD batch path must be byte-identical to
    the Python oracle walk on reads with substitutions and indels."""
    import pytest
    from nvbio_tpu.native import tb_lib
    from nvbio_tpu.utils.simulate import simulate_reads
    from nvbio_tpu.strings import pack_reads

    if tb_lib() is None:
        pytest.skip("no C++ toolchain")
    m, genome = mapper
    sim = simulate_reads(genome, 48, 100, seed=71, error_rate=0.03,
                         indel_rate=0.01)
    reads, lens, quals, _ = pack_reads(
        list(sim["seqs"].astype(np.uint8)), list(sim["quals"])
    )
    quals = quals.astype(np.int32)
    res_native = m.map_reads(reads, lens, quals)
    # force the Python fallback by monkeypatching the native entry
    orig = m._finish_native
    m._finish_native = lambda *a, **k: None
    try:
        res_python = m.map_reads(reads, lens, quals)
    finally:
        m._finish_native = orig
    for a, b in zip(res_native, res_python):
        assert (a.aligned, a.pos, a.strand, a.cigar, a.md, a.nm,
                a.ref_span, a.score, a.mapq) == \
               (b.aligned, b.pos, b.strand, b.cigar, b.md, b.nm,
                b.ref_span, b.score, b.mapq)


def test_pallas_interpret_traceback_walk_matches_xla(mapper, monkeypatch):
    """The nested walk path with the GPU directions kernel (interpret
    mode) inside the jitted traceback_walk_windows must produce the same
    CIGAR runs as the XLA twin."""
    import functools
    import jax
    import jax.numpy as jnp
    from nvbio_tpu.models import mapper as mapper_mod
    from nvbio_tpu.models.mapper import traceback_walk_batch
    from nvbio_tpu.ops.banded_dp import banded_directions_triton

    m, genome = mapper
    sim = simulate_reads(genome, N_READS, READ_LEN, error_rate=0.02,
                         seed=33)
    reads, lens, quals, _ = pack_reads(
        list(sim["seqs"].astype(np.uint8)), list(sim["quals"]))
    jr = jnp.asarray(reads)
    jl = jnp.asarray(lens.astype(np.int32))
    jq32 = jnp.asarray(quals.astype(np.int32))
    jq8 = jnp.asarray(quals.astype(np.uint8))
    fwd = m._forward(jr, jl, jq32)
    args = (m.genome, jnp.asarray(m.n, jnp.int32), jr, jl, jq8,
            fwd["win_start"], fwd["strand"])
    _, wx = traceback_walk_batch(*args, params=m.params,
                                 active=fwd["aligned"])
    # route the walk's DP to the kernel (the selector's GPU choice)
    monkeypatch.setattr(mapper_mod, "banded_directions", functools.partial(
        banded_directions_triton, interpret=True))
    jax.clear_caches()  # the twin's trace of the walk is cached
    _, wp = traceback_walk_batch(*args, params=m.params,
                                 active=fwd["aligned"])
    monkeypatch.undo()
    jax.clear_caches()
    aligned = np.asarray(fwd["aligned"])
    assert aligned.sum() > N_READS // 2

    def runs(walk, r):
        ro = np.asarray(walk["run_ops"][r])
        rl = np.asarray(walk["run_lens"][r])
        return [(int(o), int(l)) for o, l in zip(ro, rl) if l > 0]

    for r in range(N_READS):
        if not aligned[r]:
            continue
        assert runs(wx, r) == runs(wp, r), r
        assert int(wx["p_start"][r]) == int(wp["p_start"][r])
        assert int(wx["t_start"][r]) == int(wp["t_start"][r])


def test_uniform_shift_revcomp_path_identical(mapper):
    """The static-flip revcomp fast path (uniform-length batches) is
    bit-identical to the per-row gather path."""
    import jax.numpy as jnp
    from nvbio_tpu.models.mapper import map_batch

    m, genome = mapper
    sim = simulate_reads(genome, N_READS, READ_LEN, error_rate=0.02,
                         seed=77)
    reads, lens, quals, _ = pack_reads(
        list(sim["seqs"].astype(np.uint8)), list(sim["quals"]),
        max_len=128)
    jr = jnp.asarray(reads)
    jl = jnp.asarray(lens.astype(np.int32))
    jq = jnp.asarray(quals.astype(np.int32))
    kw = dict(params=m.params, lut=m.lut,
              fm2=m.fm2, bi=m.bi)
    a = map_batch(m.fm, m.ssa, m.genome, jr, jl, jq,
                  uniform_shift=-1, **kw)
    b = map_batch(m.fm, m.ssa, m.genome, jr, jl, jq,
                  uniform_shift=128 - READ_LEN, **kw)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]),
                                      np.asarray(b[k]), err_msg=k)


def test_per_read_seed_interval_mixed_lengths():
    """TRUE per-read -i (params.cpp SimpleFunc per read): a
    mixed-length chunk must seed every read at ITS OWN interval —
    verified against mapping each length group separately, where the
    per-chunk static path is exact."""
    genome = random_genome(200_000, seed=21)
    rng = np.random.default_rng(3)
    lens_mix = np.array([60, 100, 150, 60, 100, 150, 75, 125] * 8,
                        np.int32)
    Lp = 160
    seqs = np.full((len(lens_mix), Lp), 7, np.uint8)
    quals = np.zeros((len(lens_mix), Lp), np.uint8)
    starts = rng.integers(0, 200_000 - Lp, len(lens_mix))
    for i, (s, ln) in enumerate(zip(starts, lens_mix)):
        frag = genome[s:s + ln].copy()
        err = rng.random(ln) < 0.01
        frag[err] = (frag[err] + 1 + rng.integers(0, 3, err.sum())) % 4
        seqs[i, :ln] = frag
        quals[i, :ln] = 35

    fn = dict(seed_interval_fn="S", seed_interval_a=1.0,
              seed_interval_b=1.15, sa_sample=16)
    fm, ssa = build_fm_index(genome, sa_sample=16)
    m = Mapper(fm, ssa, genome, params=MapperParams(
        batch_size=len(lens_mix), **fn))
    # force ONE mixed chunk (bypass length bucketing) to exercise the
    # dynamic path: dispatch directly with the mixed batch
    p = m._chunk_params(int(lens_mix.max()), int(lens_mix.min()))
    assert p.seed_slots > 0  # the per-read path engaged
    res = m.map_reads(seqs, lens_mix, quals)

    # reference: each uniform length group mapped alone (static path,
    # exact per-read interval by construction)
    for ln in np.unique(lens_mix):
        i = np.flatnonzero(lens_mix == ln)
        mg = Mapper(fm, ssa, genome, params=MapperParams(
            batch_size=len(i), **fn))
        ref = mg.map_reads(seqs[i][:, :ln], lens_mix[i], quals[i][:, :ln])
        for j, r in zip(i, ref):
            got = res[j]
            assert got.aligned == r.aligned
            if r.aligned:
                assert (got.pos, got.strand, got.score) == \
                    (r.pos, r.strand, r.score), (ln, j)
