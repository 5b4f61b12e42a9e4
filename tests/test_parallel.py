"""Multi-device sharding: the mapping step must produce identical
results on a 1-device and an 8-device mesh (virtual CPU devices)."""

import numpy as np
import jax

from __graft_entry__ import dryrun_multichip, _tiny_problem


def test_dryrun_multichip_8():
    assert len(jax.devices()) >= 8
    dryrun_multichip(8)


def test_sharded_matches_single():
    from jax.sharding import NamedSharding, PartitionSpec as P
    from nvbio_tpu.models.mapper import map_batch
    from nvbio_tpu.parallel import make_mesh, shard_reads, replicate

    params, fm, ssa, genome, (reads, lens, quals) = _tiny_problem(
        n_genome=20_000, n_reads=32, read_len=64, batch_size=32
    )
    ref = map_batch(fm, ssa, genome, reads, lens, quals,
                    params=params)

    mesh = make_mesh(8)
    fmr, ssar, gr = replicate(mesh, (fm, ssa, genome))
    r, l, q = shard_reads(mesh, reads, lens, quals)
    out = jax.jit(
        lambda r, l, q: map_batch(fmr, ssar, gr, r, l, q,
                                  params=params),
        in_shardings=(NamedSharding(mesh, P("dp")),) * 3,
    )(r, l, q)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k]), np.asarray(out[k]),
                                      err_msg=k)
