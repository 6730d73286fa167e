"""Sweep persistent-lane count (DEV_BATCH) x PERSIST_N for the device
engine, one FRESH PROCESS per config (each config compiles its own
executables, and a fresh process keeps one config's from sharing the
device with the next).

Each child times the end-to-end device-only align_batch
(IBWA_HOST_FRAC=0) on the rep2 bench corpus, best of 3 after a warm-up
pass, and prints one JSON line; the parent collects them into
.bench/sweep_lanes.json.

Usage:  python scripts/sweep_lanes.py                 # default grid
        python scripts/sweep_lanes.py --child 2048 4096   # one config
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
FA = str(REPO / ".bench" / "genome_rep2.fa")
FQ = str(REPO / ".bench" / "reads_rep2.fq")

# (DEV_BATCH, PERSIST_N): more lanes amortize the per-step serial gather
# latency over more reads — the round-2 wall was latency, not bandwidth
GRID = [(1024, 2048), (2048, 4096), (4096, 8192), (8192, 16384)]


def child(dev_batch: int, persist_n: int) -> None:
    sys.path.insert(0, str(REPO))
    from ibwa_tpu.align import engine_jax
    from ibwa_tpu.align.opts import GapOpt
    from ibwa_tpu.fm.fmindex import FmIndex
    from ibwa_tpu.index.builder import load_index
    from ibwa_tpu.io.reads import load_reads

    engine_jax.DEV_BATCH = dev_batch
    engine_jax.PERSIST_N = persist_n
    fms = (FmIndex(load_index(FA, 0)), FmIndex(load_index(FA, 1)))
    reads = load_reads(FQ)
    seqs = [r.seq for r in reads]
    rseqs = [r.rseq for r in reads]
    opt = GapOpt()
    eng = engine_jax.JaxAlnEngine(fms)
    eng.host_frac = 0.0
    eng.align_batch(seqs, rseqs, opt)  # compile + warm
    best = 1e18
    fb = 0
    for _ in range(3):
        f0 = eng.stats["fallback_reads"]
        t0 = time.perf_counter()
        eng.align_batch(seqs, rseqs, opt)
        dt = time.perf_counter() - t0
        if dt < best:
            best, fb = dt, eng.stats["fallback_reads"] - f0
    print(json.dumps({
        "dev_batch": dev_batch, "persist_n": persist_n,
        "reads_per_s": round(len(seqs) / best, 1),
        "seconds": round(best, 3), "fallback_reads": fb,
    }))


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        sys.path.insert(0, str(REPO))
        from ibwa_tpu.compile_cache import enable
        enable()
        child(int(sys.argv[2]), int(sys.argv[3]))
        return
    env = dict(os.environ)
    results = []
    for dev_batch, persist_n in GRID:
        r = subprocess.run(
            [sys.executable, __file__, "--child", str(dev_batch),
             str(persist_n)], env=env, capture_output=True, text=True)
        line = (r.stdout.strip().splitlines() or ["{}"])[-1]
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            rec = {"dev_batch": dev_batch, "persist_n": persist_n,
                   "error": r.stderr[-300:]}
        print(json.dumps(rec), flush=True)
        results.append(rec)
    out = REPO / ".bench" / "sweep_lanes.json"
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
