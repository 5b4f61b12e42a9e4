"""Persistent index server (nvFM-server equivalent, device-resident).

Ref parity: nvFM-server/nvFM-server.cpp + basic/mmap.h
(``ServerMappedFile``): the reference loads an FM-index once and
serves it to client processes through POSIX shared memory.  On an
accelerator the expensive copies are BOTH the host parse and the host->device
upload (an hg-scale index costs minutes of device_put), and device
memory is process-private — so the capability-equivalent design is a
resident *mapping daemon*: one process loads the index, uploads it,
keeps the jitted pipelines warm, and serves mapping jobs over a unix
socket.  Each `map` request pays only the per-batch work; the
load+upload+compile cost is amortized across every job.

    # daemon (holds the index on device until `stop`):
    python -m nvbio_tpu.tools.fm_server serve -x idx.npz \\
        --socket /tmp/fm.sock [--cpu]

    # clients (return when the SAM is written; stats include the
    # server's index-attach time for the first/steady-state contrast):
    python -m nvbio_tpu.tools.fm_server map --socket /tmp/fm.sock \\
        -U reads.fq -S out.sam
    python -m nvbio_tpu.tools.fm_server map --socket /tmp/fm.sock \\
        -1 r1.fq -2 r2.fq -S out.sam
    python -m nvbio_tpu.tools.fm_server ping --socket /tmp/fm.sock
    python -m nvbio_tpu.tools.fm_server stop --socket /tmp/fm.sock

The host-side page-cache sharing of round 1 is kept as `publish`
(clients `load_index(mmap=True)` a /dev/shm copy).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import sys
import time

SHM_DIR = "/dev/shm/nvbio_tpu"


def publish(path):
    os.makedirs(SHM_DIR, exist_ok=True)
    dst = os.path.join(SHM_DIR, os.path.basename(path))
    shutil.copyfile(path, dst)
    print(dst)
    return 0


# ---------------------------------------------------------------- daemon

def _recv_json(conn):
    buf = b""
    while not buf.endswith(b"\n"):
        chunk = conn.recv(1 << 16)
        if not chunk:
            return None
        buf += chunk
    return json.loads(buf.decode())


def _send_json(conn, obj):
    conn.sendall((json.dumps(obj) + "\n").encode())


def _handle_map(state, req):
    """Run one mapping job with the resident mapper."""
    import numpy as np
    from ..io.sam import SamWriter
    from ..io.sequence import ReadBatchIterator
    from ..io.fastq import FastqBatchReader
    from ..strings import pack_reads

    mapper = state["pe_mapper" if req.get("m1") else "se_mapper"]()
    meta = state["meta"]
    batch = int(req.get("batch", state["batch"]))
    max_len = int(req.get("max_read_len", state["max_read_len"]))
    sam = req["sam"]
    writer_cls = SamWriter
    if sam.endswith(".bam"):
        from ..io.bam import BamWriter as writer_cls
    writer = writer_cls(sam, meta["contig_names"], meta["contig_lens"],
                        cmdline=f"fm_server map {req}")
    t0 = time.time()
    n = n_aligned = 0
    if req.get("m1"):
        def pairs():
            it1 = FastqBatchReader(req["m1"], batch)
            it2 = FastqBatchReader(req["m2"], batch)
            for (n1, s1, q1), (n2, s2, q2) in zip(it1, it2):
                r1, l1, qm1, _ = pack_reads(s1, q1, max_len=max_len)
                r2, l2, qm2, _ = pack_reads(s2, q2, max_len=max_len)
                yield n1, r1, l1, qm1, r2, l2, qm2

        for (n1, r1, l1, qm1, r2, l2, qm2, res1, res2,
             info) in mapper.map_pairs_stream(pairs()):
            n += len(res1) + len(res2)
            n_aligned += sum(r.aligned for r in res1)
            n_aligned += sum(r.aligned for r in res2)
            for rec in mapper.to_sam_records_pe(
                    n1, r1, l1, qm1, r2, l2, qm2, res1, res2, info):
                writer.write(rec)
    else:
        def batches():
            for names, seqs, quals in ReadBatchIterator(req["u"], batch):
                reads, lens, qmat, _ = pack_reads(seqs, quals,
                                                  max_len=max_len)
                yield names, reads, lens, qmat

        for names, reads, lens, qmat, results in \
                mapper.map_stream(batches()):
            n += len(results)
            n_aligned += sum(r.aligned for r in results)
            for rec in mapper.to_sam_records(names, reads, lens, qmat,
                                             results):
                writer.write(rec)
    writer.close()
    dt = time.time() - t0
    return {"status": "ok", "reads": n, "aligned": n_aligned,
            "seconds": round(dt, 3),
            "reads_per_sec": round(n / max(dt, 1e-9), 1),
            "attach_seconds": state["attach_seconds"]}


def serve(index_path, sock_path, batch=4096, max_read_len=320,
          cpu=False, once=False):
    if cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from ..utils.jax_cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import numpy as np
    from ..io.index_file import load_index
    from ..models import Mapper, MapperParams
    from ..models.paired import PairedMapper

    t0 = time.time()
    prefix = index_path
    for suf in (".npz", ".manifest.json"):
        if prefix.endswith(suf):
            prefix = prefix[: -len(suf)]
    sharded = os.path.exists(prefix + ".manifest.json") and not (
        index_path.endswith(".npz") and os.path.exists(index_path))
    if sharded:
        from ..fmindex.sharded import load_sharded_index

        sidx, genome, man = load_sharded_index(prefix)
        meta = {"sa_sample": man["sa_sample"], "lut_k": man["lut_k"],
                "contig_names": man["contig_names"],
                "contig_lens": man["contig_lens"]}
        fm = ssa = None
    else:
        fm, ssa, genome, meta = load_index(index_path)
        # force the upload NOW (load_index produces device arrays
        # lazily materialized; block so attach time is honest and
        # requests are hot)
        jax.block_until_ready(jax.tree.map(
            lambda x: x, (fm, ssa, meta.get("lut"))))
    params = MapperParams(batch_size=batch, sa_sample=meta["sa_sample"],
                          lut_k=meta.get("lut_k", 0),
                          max_read_len=max_read_len)
    contigs = {
        "names": meta["contig_names"],
        "starts": np.concatenate(
            [[0], np.cumsum(meta["contig_lens"][:-1])]).astype(np.int64),
        "lens": np.array(meta["contig_lens"], dtype=np.int64),
    }
    genome = genome.astype(np.uint8)
    state = {
        "meta": meta, "batch": batch, "max_read_len": max_read_len,
        "attach_seconds": None,
    }
    mappers = {}

    def get_mapper(cls):
        if cls not in mappers:
            mappers[cls] = cls(fm, ssa, genome, params=params,
                               contigs=contigs, lut=meta.get("lut"))
        return mappers[cls]

    if sharded:
        # sharded (hg-scale) indexes: the daemon is where the
        # device-resident shards + fm2 + warm jits pay off most
        from ..models.sharded_mapper import (ShardedMapper,
                                             PairedShardedMapper)

        def get_mapper(cls):  # noqa: F811
            scls = (PairedShardedMapper if cls is PairedMapper
                    else ShardedMapper)
            if scls not in mappers:
                mappers[scls] = scls(sidx, genome, params=params,
                                     contigs=contigs)
            return mappers[scls]

        # warm the SE mapper NOW: shard upload + resident pair-BWT
        # derivation are exactly the cold start the daemon exists to
        # hide (same contract as the monolithic block_until_ready)
        m = get_mapper(Mapper)
        jax.block_until_ready([
            (st["fm"], st["ssa"], st["g"], st["fm2"])
            for st in m.shard_state])

    state["se_mapper"] = lambda: get_mapper(Mapper)
    state["pe_mapper"] = lambda: get_mapper(PairedMapper)
    state["attach_seconds"] = round(time.time() - t0, 3)

    if os.path.exists(sock_path):
        os.remove(sock_path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(4)
    print(f"[fm_server] serving {index_path} on {sock_path} "
          f"(attach {state['attach_seconds']}s)", file=sys.stderr,
          flush=True)
    try:
        while True:
            conn, _ = srv.accept()
            try:
                req = _recv_json(conn)
                if req is None:
                    continue
                if req.get("cmd") == "stop":
                    _send_json(conn, {"status": "stopped"})
                    break
                if req.get("cmd") == "ping":
                    _send_json(conn, {
                        "status": "ok",
                        "attach_seconds": state["attach_seconds"],
                        "index": index_path})
                    continue
                if req.get("cmd") == "map":
                    try:
                        _send_json(conn, _handle_map(state, req))
                    except Exception as e:  # job error: keep serving
                        _send_json(conn, {"status": "error",
                                          "error": repr(e)})
                    if once:
                        break
                    continue
                _send_json(conn, {"status": "error",
                                  "error": "unknown cmd"})
            finally:
                conn.close()
    finally:
        srv.close()
        if os.path.exists(sock_path):
            os.remove(sock_path)
    return 0


def request(sock_path, obj, timeout=3600):
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(timeout)
    c.connect(sock_path)
    _send_json(c, obj)
    resp = _recv_json(c)
    c.close()
    return resp


def main(argv=None):
    p = argparse.ArgumentParser(prog="fm_server", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("serve")
    ps.add_argument("-x", "--index", required=True)
    ps.add_argument("--socket", default="/tmp/nvbio_fm.sock")
    ps.add_argument("--batch", type=int, default=4096)
    ps.add_argument("--max-read-len", type=int, default=320)
    ps.add_argument("--cpu", action="store_true")
    pm = sub.add_parser("map")
    pm.add_argument("--socket", default="/tmp/nvbio_fm.sock")
    pm.add_argument("-U", dest="u")
    pm.add_argument("-1", dest="m1")
    pm.add_argument("-2", dest="m2")
    pm.add_argument("-S", dest="sam", required=True)
    pm.add_argument("--batch", type=int)
    for name in ("ping", "stop"):
        px = sub.add_parser(name)
        px.add_argument("--socket", default="/tmp/nvbio_fm.sock")
    pp = sub.add_parser("publish")
    pp.add_argument("index")
    sub.add_parser("list")
    pr = sub.add_parser("remove")
    pr.add_argument("name")
    args = p.parse_args(argv)

    if args.cmd == "serve":
        return serve(args.index, args.socket, batch=args.batch,
                     max_read_len=args.max_read_len, cpu=args.cpu)
    if args.cmd == "map":
        req = {"cmd": "map", "sam": args.sam}
        if args.u:
            req["u"] = args.u
        if args.m1:
            req["m1"], req["m2"] = args.m1, args.m2
        if args.batch:
            req["batch"] = args.batch
        resp = request(args.socket, req)
        print(json.dumps(resp))
        return 0 if resp and resp.get("status") == "ok" else 1
    if args.cmd in ("ping", "stop"):
        resp = request(args.socket, {"cmd": args.cmd}, timeout=60)
        print(json.dumps(resp))
        return 0
    if args.cmd == "publish":
        return publish(args.index)
    if args.cmd == "list":
        if os.path.isdir(SHM_DIR):
            for f in sorted(os.listdir(SHM_DIR)):
                print(os.path.join(SHM_DIR, f))
        return 0
    if args.cmd == "remove":
        os.remove(os.path.join(SHM_DIR, args.name))
        return 0


if __name__ == "__main__":
    sys.exit(main())
