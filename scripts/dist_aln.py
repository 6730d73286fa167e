"""Distributed `aln` over the PRODUCTION pipeline: per-process read
shards feeding one global jax.distributed mesh, merged `.sai` output.

This is the executable 2-host proxy for the multi-host north star
(BASELINE.json): the unit of distribution is a
per-process FASTQ shard — exactly the reference's file-based contract
(bwtaln.c:192, saiset.c:28) lifted to processes — while the search
itself runs as ONE SPMD program over the global `dp` mesh
(parallel/mesh.py::run_sharded_search_persistent via
engine_jax.JaxAlnEngine.align_batch, the same path the CLI takes).

Each worker:
  * `jax.distributed.initialize` (2 processes x 4 virtual CPU devices
    -> one 8-device global mesh),
  * reads its contiguous shard of the parity_scale E. coli corpus,
  * runs `align/pipeline.py::aln_to_stream` (production CLI path) with
    the hybrid host share pinned to 0 (IBWA_HOST_FRAC=0: the adaptive
    split is timing-dependent and would desync the SPMD dispatch
    counts between processes),
  * writes its own `.sai` shard (files as the IPC contract).

The parent byte-compares header+records of the concatenated shards
against a single-process run of the identical pipeline, and emits a
DIST JSON. NOTE on timing: this host has ONE physical core; the wall
clock validates the mechanism, not scaling.

Usage: python scripts/dist_aln.py [--reads N] (default: the 40k-read
parity_scale corpus; shards are N/2 each)
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
WORK = REPO / ".bench" / "parity_scale"
OUT = REPO / ".bench" / "dist_aln"
PORT = 29843
N_PROC = 2
DEV_PER_PROC = 4


def log(msg: str) -> None:
    print(f"[dist_aln] {msg}", file=sys.stderr, flush=True)


def split_fastq(src: pathlib.Path, n_shards: int) -> list[pathlib.Path]:
    """Contiguous equal shards (pad requirement: equal read counts so
    every process makes the same number of SPMD dispatches)."""
    lines = src.read_bytes().split(b"\n")
    if lines and not lines[-1]:
        lines.pop()
    assert len(lines) % 4 == 0
    n = len(lines) // 4
    per = n // n_shards
    assert per * n_shards == n, "read count must divide evenly"
    outs = []
    for s in range(n_shards):
        p = OUT / f"shard{s}.fq"
        with open(p, "wb") as f:
            f.write(b"\n".join(lines[s * per * 4:(s + 1) * per * 4]))
            f.write(b"\n")
        outs.append(p)
    return outs


def worker(pid: int, fq: str, out_sai: str) -> None:
    import jax

    jax.distributed.initialize(coordinator_address=f"localhost:{PORT}",
                               num_processes=N_PROC, process_id=pid)
    sys.path.insert(0, str(REPO))
    from ibwa_tpu.align import engine_jax
    from ibwa_tpu.align.opts import GapOpt
    from ibwa_tpu.align.pipeline import aln_to_stream

    engine_jax.DEV_BATCH = 64                # lanes per device
    engine_jax.PERSIST_N = 640               # reads per device per chunk
    assert len(jax.devices()) == N_PROC * DEV_PER_PROC

    prefix = str(WORK / "ecoli.fa")
    t0 = time.perf_counter()
    with open(out_sai, "wb") as f:
        n = aln_to_stream(prefix, fq, GapOpt(), f, engine="jax")
    dt = time.perf_counter() - t0
    print(json.dumps({"pid": pid, "reads": n, "seconds": round(dt, 2),
                      "reads_per_s": round(n / dt, 1)}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--fq", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--reads", type=int, default=40_000)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.fq, args.out)
        return

    OUT.mkdir(parents=True, exist_ok=True)
    src = WORK / f"ecoli_se{args.reads}.fq"
    if not src.exists():
        log(f"missing corpus {src}; run scripts/parity_scale.py first")
        sys.exit(1)
    shards = split_fastq(src, N_PROC)

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)            # workers import this checkout
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                        f"{DEV_PER_PROC}")
    env["IBWA_HOST_FRAC"] = "0"

    log(f"spawning {N_PROC} jax.distributed workers over "
        f"{N_PROC * DEV_PER_PROC} virtual devices")
    t0 = time.perf_counter()
    procs = []
    for pid in range(N_PROC):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--worker", str(pid),
             "--fq", str(shards[pid]),
             "--out", str(OUT / f"shard{pid}.sai")],
            env=env, stdout=subprocess.PIPE, text=True))
    stats = []
    for p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            log(f"worker failed rc={p.returncode}")
            sys.exit(1)
        stats.append(json.loads(out.strip().splitlines()[-1]))
    wall = time.perf_counter() - t0

    # single-process run of the SAME pipeline for the byte-compare
    log("single-process reference run (same pipeline, same engine)")
    env1 = dict(env)
    env1["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    t1 = time.perf_counter()
    single = subprocess.run(
        [sys.executable, "-c",
         f"""
import sys, time
sys.path.insert(0, {str(REPO)!r})
from ibwa_tpu.align import engine_jax
from ibwa_tpu.align.opts import GapOpt
from ibwa_tpu.align.pipeline import aln_to_stream
engine_jax.DEV_BATCH = 64
engine_jax.PERSIST_N = 640
with open({str(OUT / 'single.sai')!r}, 'wb') as f:
    aln_to_stream({str(WORK / 'ecoli.fa')!r}, {str(src)!r}, GapOpt(), f,
                  engine='jax')
"""],
        env=env1)
    if single.returncode != 0:
        sys.exit(1)
    t_single = time.perf_counter() - t1

    # merge: shard0 (with header) + shard1 records (header stripped)
    hdr_len = None
    sys.path.insert(0, str(REPO))
    from ibwa_tpu.io import sai as sai_mod
    import io as io_mod
    b0 = (OUT / "shard0.sai").read_bytes()
    fp = io_mod.BytesIO(b0)
    sai_mod.read_header(fp)
    hdr_len = fp.tell()
    merged = b0 + (OUT / "shard1.sai").read_bytes()[hdr_len:]
    ok = merged == (OUT / "single.sai").read_bytes()
    result = {
        "ok": bool(ok),
        "reads": args.reads,
        "n_processes": N_PROC,
        "devices": N_PROC * DEV_PER_PROC,
        "merged_sai_identical": bool(ok),
        "wall_s_2proc": round(wall, 2),
        "wall_s_1proc": round(t_single, 2),
        "per_process": stats,
        "note": "1 physical core: wall validates mechanism, not scaling",
    }
    print(json.dumps(result))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
