"""Two-process distributed aln run (DCN-sim): the closest executable
proxy to multi-host operation available in this environment.

Spawns 2 `jax.distributed.initialize` CPU processes (4 virtual devices
each -> one 8-device global dp mesh over gRPC), feeds each process its
read shard, runs the SAME sharded persistent search the production path
uses (parallel/mesh.py::_persistent_sharded_fn), and byte-compares the
merged hit set against a single-process run of the identical workload.

Writes MULTICHIP-style JSON to stdout.  Note: this host has ONE physical
core, so the two processes timeshare it — the wall-clock "efficiency"
recorded here validates the mechanism (global mesh, cross-process
collectives, shard feeding, result merge), not ICI/DCN scaling.

Usage: python scripts/dist_2proc.py            # parent: spawns workers
       (workers are re-invoked with --worker I)
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = 29817
N_READS = 256
READ_LEN = 36
GLEN = 8192
N_PROC = 2
DEV_PER_PROC = 4


def worker(pid: int) -> None:
    import jax

    jax.distributed.initialize(coordinator_address=f"localhost:{PORT}",
                               num_processes=N_PROC, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, str(REPO))
    from ibwa_tpu.align import engine_jax
    from ibwa_tpu.parallel import mesh as pmesh

    sys.path.insert(0, str(REPO))
    import __graft_entry__ as ge

    n_total = N_READS
    _, opt, (sq, lens, md, has_seed, seed_seqs, bad) = ge._tiny_problem(
        n_reads=n_total, read_len=READ_LEN, glen=GLEN)
    fms = ge._tiny_problem.fms
    from ibwa_tpu.fm.device import build_device_pair
    dfm = build_device_pair(fms[0], fms[1], put=np.asarray)

    devs = jax.devices()
    assert len(devs) == N_PROC * DEV_PER_PROC, devs
    mesh = pmesh.make_mesh(devices=devs)
    cfg = engine_jax.make_config(sq.shape[-1], int(md.max()), opt)

    shard = NamedSharding(mesh, P("dp"))
    repl = NamedSharding(mesh, P())
    lo = pid * (n_total // N_PROC)
    hi = lo + n_total // N_PROC

    def mk(arr):
        return jax.make_array_from_process_local_data(shard, arr[lo:hi])

    fm_args = tuple(jax.device_put(np.asarray(a), repl)
                    for a in (dfm.blocks, dfm.L2, dfm.l2diff, dfm.primary))
    batch = tuple(mk(np.asarray(a))
                  for a in (sq, lens, md, has_seed, seed_seqs, bad))
    fn = pmesh._persistent_sharded_fn(cfg, mesh, dfm.seq_len, dfm.n_blk, 8)
    t0 = time.perf_counter()
    harr, n_hits, fb, it = fn(*fm_args, *batch)
    # collect THIS process's addressable output shard
    local = {}
    for s in harr.addressable_shards:
        local[s.index[0].start or 0] = np.asarray(s.data)
    nh_local = {}
    for s in n_hits.addressable_shards:
        nh_local[s.index[0].start or 0] = np.asarray(s.data)
    dt = time.perf_counter() - t0
    outdir = REPO / ".bench" / "dist2"
    outdir.mkdir(parents=True, exist_ok=True)
    np.savez(outdir / f"shard{pid}.npz",
             starts=np.array(sorted(local)),
             **{f"h{k}": v for k, v in local.items()},
             **{f"n{k}": v for k, v in nh_local.items()})
    (outdir / f"time{pid}.json").write_text(json.dumps({"wall_s": dt}))
    # keep process 0 alive until all shards written happens naturally
    print(f"[worker {pid}] done in {dt:.2f}s", file=sys.stderr)


def main() -> None:
    if "--worker" in sys.argv:
        worker(int(sys.argv[sys.argv.index("--worker") + 1]))
        return

    env = dict(os.environ)
    # workers import this checkout and run on virtual CPU devices
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        f" --xla_force_host_platform_device_count="
                        f"{DEV_PER_PROC}").strip()
    outdir = REPO / ".bench" / "dist2"
    if outdir.exists():
        for f in outdir.glob("*"):
            f.unlink()

    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(i)], env=env)
        for i in range(N_PROC)]
    for p in procs:
        rc = p.wait(timeout=900)
        if rc != 0:
            raise SystemExit(f"worker failed rc={rc}")
    t2 = time.perf_counter() - t0

    # single-process reference of the same workload on an 8-device mesh
    env1 = dict(env)
    env1["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                         " --xla_force_host_platform_device_count=8").strip()
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", f"""
import sys, time, json, pathlib
sys.path.insert(0, {str(REPO)!r})
import numpy as np, jax
from ibwa_tpu.align import engine_jax
from ibwa_tpu.parallel import mesh as pmesh
from ibwa_tpu.fm.device import build_device_pair
import __graft_entry__ as ge
_, opt, (sq, lens, md, has_seed, seed_seqs, bad) = ge._tiny_problem(
    n_reads={N_READS}, read_len={READ_LEN}, glen={GLEN})
fms = ge._tiny_problem.fms
dfm = build_device_pair(fms[0], fms[1], put=np.asarray)
mesh = pmesh.make_mesh(devices=jax.devices())
cfg = engine_jax.make_config(sq.shape[-1], int(md.max()), opt)
t0 = time.perf_counter()
harr, n_hits, fb, it = pmesh.run_sharded_search_persistent(
    cfg, mesh, dfm, sq, lens, md, has_seed, seed_seqs, bad, n_lanes=8)
harr = np.asarray(harr); n_hits = np.asarray(n_hits)
dt = time.perf_counter() - t0
out = pathlib.Path({str(REPO)!r}) / ".bench" / "dist2"
np.savez(out / "single.npz", h=harr, n=n_hits)
(out / "time_single.json").write_text(json.dumps(dict(wall_s=dt)))
"""], env=env1, check=True)
    t1 = time.perf_counter() - t0

    # merge + byte-compare
    import numpy as np
    single = np.load(outdir / "single.npz")
    h_ref, n_ref = single["h"], single["n"]
    ok = True
    for pid in range(N_PROC):
        z = np.load(outdir / f"shard{pid}.npz")
        for st in z["starts"]:
            h = z[f"h{st}"]
            nh = z[f"n{st}"]
            sl = slice(int(st), int(st) + h.shape[0])
            if not (np.array_equal(h, h_ref[sl])
                    and np.array_equal(nh, n_ref[sl])):
                ok = False
    w2 = max(json.loads((outdir / f"time{p}.json").read_text())["wall_s"]
             for p in range(N_PROC))
    w1 = json.loads((outdir / "time_single.json").read_text())["wall_s"]
    result = {
        "mode": "2-process DCN-sim (gRPC coordinator, 4+4 CPU devices)",
        "identical_hits": ok,
        "wall_1proc_s": round(w1, 3),
        "wall_2proc_s": round(w2, 3),
        "wall_efficiency": round(w1 / (w2 or 1e-9), 3),
        "note": ("single physical core: efficiency validates mechanism, "
                 "not DCN scaling"),
        "proc_spawn_total_s": round(t2, 1),
        "single_total_s": round(t1, 1),
    }
    print(json.dumps(result))
    if not ok:
        raise SystemExit("hit mismatch between 2-proc and 1-proc runs")


if __name__ == "__main__":
    main()
