"""Stage A/Bs on the GPU + engine step-cost capture.

Modes (each arm runs in a FRESH process — env flags are read at import,
and one process per arm keeps the device to one JAX client):

  bwasw   IBWA_BSW_DEVICE=0 vs 1 on the bench long reads (device seed
          extensions, ops/dp.py via bsw2's staged driver)
  sampe   IBWA_PE_DEVICE=0 vs 1 on the bench pairs (device SA-walk
          prefill, fm/walk.py -> pe_stage walk cache)
  stats   device-only align_batch at the current defaults: wall,
          engine iterations, per-step cost, lane-steps/read

Timing: perf_counter around the whole stage call, best of --reps after
one warm-up (stage paths are host-driven; device dispatches inside
force their own readbacks).  Appends one JSON line per arm to
.bench/ab_stage.json.
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
WORK = REPO / ".bench"
FA = str(WORK / "genome_rep1.fa")
OUT = WORK / "ab_stage.json"


def _append(rec: dict) -> None:
    rows = []
    if OUT.exists():
        try:
            rows = json.loads(OUT.read_text())
        except json.JSONDecodeError:
            rows = []
    rows.append(rec)
    OUT.write_text(json.dumps(rows, indent=1))


def child_bwasw(reps: int) -> dict:
    sys.path.insert(0, str(REPO))
    import io
    from ibwa_tpu.bwasw.aux import Bsw2Opt, bsw2_aln
    fql = str(WORK / "long_rep1.fq")
    n = sum(1 for line in open(fql) if line.startswith("@L"))
    best = 1e18
    out0 = None
    for r in range(reps + 1):          # first pass warms compiles
        buf = io.StringIO()
        t0 = time.perf_counter()
        bsw2_aln(Bsw2Opt(), FA, fql, out=buf)
        dt = time.perf_counter() - t0
        if r == 0:
            out0 = buf.getvalue()
        else:
            assert buf.getvalue() == out0, "nondeterministic bwasw output"
            best = min(best, dt)
    import hashlib
    return {"mode": "bwasw", "device": os.environ.get("IBWA_BSW_DEVICE", "0"),
            "n_reads": n, "seconds": round(best, 3),
            "reads_per_s": round(n / best, 1),
            "sam_sha": hashlib.sha256(out0.encode()).hexdigest()[:16]}


def child_sampe(reps: int) -> dict:
    sys.path.insert(0, str(REPO))
    import io
    from ibwa_tpu.sam.sampe import PeOpt, sai2sam_pe
    fq1 = str(WORK / "pairs_rep1_50000_1.fq")
    fq2 = str(WORK / "pairs_rep1_50000_2.fq")
    s1 = fq1.removesuffix(".fq") + ".sai"
    s2 = fq2.removesuffix(".fq") + ".sai"
    if not (pathlib.Path(s1).exists() and pathlib.Path(s2).exists()):
        from ibwa_tpu.align.opts import GapOpt
        from ibwa_tpu.align.pipeline import aln_to_stream
        for fqx, sx in ((fq1, s1), (fq2, s2)):
            with open(sx, "wb") as f:
                aln_to_stream(FA, fqx, GapOpt(), f)
    best = 1e18
    sha0 = None
    import hashlib
    for r in range(reps + 1):
        buf = io.StringIO()
        t0 = time.perf_counter()
        sai2sam_pe([FA], [(s1, s2)], fq1, fq2, PeOpt(remapping=1), out=buf)
        dt = time.perf_counter() - t0
        h = hashlib.sha256(buf.getvalue().encode()).hexdigest()[:16]
        if r == 0:
            sha0 = h
        else:
            assert h == sha0, "nondeterministic sampe output"
            best = min(best, dt)
    n = 100_000
    return {"mode": "sampe", "device": os.environ.get("IBWA_PE_DEVICE", "0"),
            "n_reads": n, "seconds": round(best, 3),
            "reads_per_s": round(n / best, 1), "sam_sha": sha0}


def child_stats(reps: int) -> dict:
    sys.path.insert(0, str(REPO))
    from ibwa_tpu.align import engine_jax
    from ibwa_tpu.align.opts import GapOpt
    from ibwa_tpu.fm.fmindex import FmIndex
    from ibwa_tpu.index.builder import load_index
    from ibwa_tpu.io.reads import load_reads
    import jax
    fms = (FmIndex(load_index(FA, 0)), FmIndex(load_index(FA, 1)))
    reads = load_reads(str(WORK / "reads_rep1.fq"))
    seqs = [r.seq for r in reads]
    rseqs = [r.rseq for r in reads]
    opt = GapOpt()
    eng = engine_jax.JaxAlnEngine(fms)
    eng.host_frac = 0.0
    eng.align_batch(seqs, rseqs, opt)            # compile + warm
    best, st = 1e18, None
    for _ in range(reps):
        it0 = eng.stats["iterations"]
        dr0 = eng.stats["device_reads"]
        fb0 = eng.stats["fallback_reads"]
        t0 = time.perf_counter()
        eng.align_batch(seqs, rseqs, opt)
        dt = time.perf_counter() - t0
        if dt < best:
            best = dt
            st = {"iterations": eng.stats["iterations"] - it0,
                  "device_reads": eng.stats["device_reads"] - dr0,
                  "fallback_reads": eng.stats["fallback_reads"] - fb0}
    n = len(seqs)
    per_step = best / max(st["iterations"], 1)
    return {"mode": "stats", "backend": jax.default_backend(),
            "intv": int(os.environ.get("IBWA_DEV_INTV", "64")),
            "dev_batch": engine_jax.DEV_BATCH,
            "persist_n": engine_jax.PERSIST_N,
            "iter_cap": engine_jax.ITER_CAP,
            "n_reads": n, "seconds": round(best, 3),
            "reads_per_s": round(n / best, 1), **st,
            "us_per_step": round(per_step * 1e6, 2),
            "ns_per_lane_step": round(
                per_step / engine_jax.DEV_BATCH * 1e9, 2),
            "lane_steps_per_device_read": round(
                st["iterations"] * engine_jax.DEV_BATCH
                / max(st["device_reads"], 1), 1)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["bwasw", "sampe", "stats"])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--arms", nargs="*", default=["0", "1"],
                    help="device-flag values to A/B (child runs one)")
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, str(REPO))
        from ibwa_tpu.compile_cache import enable
        enable()
        rec = {"bwasw": child_bwasw, "sampe": child_sampe,
               "stats": child_stats}[args.mode](args.reps)
        print(json.dumps(rec), flush=True)
        return
    env_flag = {"bwasw": "IBWA_BSW_DEVICE", "sampe": "IBWA_PE_DEVICE",
                "stats": None}[args.mode]
    arms = args.arms if env_flag else ["-"]
    for v in arms:
        env = dict(os.environ)
        if env_flag:
            env[env_flag] = v
        r = subprocess.run(
            [sys.executable, __file__, args.mode, "--child",
             "--reps", str(args.reps)],
            env=env, capture_output=True, text=True, timeout=3600)
        line = (r.stdout.strip().splitlines() or ["{}"])[-1]
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            rec = {"mode": args.mode, "device": v,
                   "error": r.stderr[-400:]}
        print(json.dumps(rec), flush=True)
        _append(rec)


if __name__ == "__main__":
    main()
