"""Worker for the 2-process jax.distributed CPU test.

Each process owns one CPU device; together they form a 2-device global
mesh.  The worker shards a read batch over the global ``dp`` axis, runs
the jitted mapping step, and prints the per-process aligned count —
exercising the real multi-host code path (global mesh + process-local
data) that config 5 uses on a pod slice.
"""

import os
import sys


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from nvbio_tpu.fmindex import build_fm_index
    from nvbio_tpu.models import MapperParams
    from nvbio_tpu.models.mapper import map_batch, PAD
    from nvbio_tpu.strings import pack_reads
    from nvbio_tpu.utils.simulate import random_genome, simulate_reads

    assert jax.process_count() == nproc
    devs = jax.devices()
    assert len(devs) == nproc, devs
    mesh = Mesh(np.array(devs), ("dp",))

    # identical index on every host (replicated, as on a real slice)
    n_genome, R, L = 20_000, 16 * nproc, 64
    params = MapperParams(batch_size=R, sa_sample=16, max_candidates=8)
    genome = random_genome(n_genome, seed=11)
    fm, ssa = build_fm_index(genome, sa_sample=params.sa_sample)
    sim = simulate_reads(genome, R, L, seed=12)
    reads, lens, quals, _ = pack_reads(
        list(sim["seqs"].astype(np.uint8)), list(sim["quals"])
    )
    lt_pad = params.max_read_len + 2 * params.band_w + 8
    gp = np.full(n_genome + lt_pad, PAD, dtype=np.int8)
    gp[:n_genome] = genome

    sh = NamedSharding(mesh, P("dp"))
    rep = NamedSharding(mesh, P())
    # each process contributes its local rows of the global batch
    local = slice(pid * R // nproc, (pid + 1) * R // nproc)

    def put(a, s):
        a = jnp.asarray(a)
        if s is sh:
            return jax.make_array_from_process_local_data(s, np.asarray(a)[local])
        return jax.device_put(a, s)

    fm = jax.tree_util.tree_map(lambda a: put(a, rep), fm)
    ssa = jax.tree_util.tree_map(lambda a: put(a, rep), ssa)
    gp = put(gp, rep)
    jr = put(reads, sh)
    jl = put(lens.astype(np.int32), sh)
    jq = put(quals.astype(np.int32), sh)

    fn = jax.jit(
        lambda r, l, q: map_batch(fm, ssa, gp, r, l, q,
                                  params=params),
        in_shardings=(sh, sh, sh),
    )
    out = fn(jr, jl, jq)
    jax.block_until_ready(out)
    n_aligned = int(jnp.sum(out["aligned"]))  # global reduce
    print(f"DIST_OK pid={pid} aligned={n_aligned}/{R}", flush=True)


if __name__ == "__main__":
    main()
