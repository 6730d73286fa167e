"""Sweep the dimer-engine knobs on the GPU, one FRESH PROCESS per config
(env flags are read at import, and a fresh process keeps one config's
executables from sharing the device with the next).

Configs: DIMER_UNROLL in {0 (occ1 path), 1, 2, 3} x ITER_CAP in
{256, 384}.  Each child times the end-to-end device-only align_batch
(IBWA_HOST_FRAC=0) on the rep2 bench corpus, best of 3 after a warm-up
pass, and prints one JSON line.  The parent collects them into
.bench/sweep_dimer.json.

Usage:  python scripts/sweep_dimer.py            # full sweep
        python scripts/sweep_dimer.py --child 2 384   # one config
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


def child(unroll: int, iter_cap: int) -> None:
    sys.path.insert(0, str(REPO))
    from ibwa_tpu.align import engine_jax
    from ibwa_tpu.align.opts import GapOpt
    from ibwa_tpu.fm.fmindex import FmIndex
    from ibwa_tpu.index.builder import load_index
    from ibwa_tpu.io.reads import load_reads

    engine_jax.DIMER_UNROLL = unroll
    engine_jax.ITER_CAP = iter_cap
    if unroll == 0:
        os.environ["IBWA_NO_DIMER"] = "1"
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
        "dimer_unroll": unroll, "iter_cap": iter_cap,
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
    for unroll in (2, 3, 1, 0):
        for cap in (384, 256):
            r = subprocess.run(
                [sys.executable, __file__, "--child", str(unroll),
                 str(cap)], env=env, capture_output=True, text=True)
            line = (r.stdout.strip().splitlines() or ["{}"])[-1]
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                rec = {"dimer_unroll": unroll, "iter_cap": cap,
                       "error": r.stderr[-300:]}
            print(json.dumps(rec), flush=True)
            results.append(rec)
    out = REPO / ".bench" / "sweep_dimer.json"
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
