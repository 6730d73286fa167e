"""Per-step cost of the device search engine, on the chip_smoke corpus.

Four modes:

  --mode budget   (default) marginal dwall/dsteps of a fixed-step search
                  harness, full vs each component stubbed out via
                  EngineConfig.profile_skips — the difference is that
                  component's per-step cost (np.asarray readback inside
                  the timed region, marginal over two step counts).
  --mode budget-add  the same, enabling one component at a time.
  --mode lanes    the same full-step marginal cost at several lane
                  counts B (feeds the DEV_BATCH choice).
  --mode trace    jax.profiler traces, reduced to device busy time,
                  idle share and kernels per step: (a) one production
                  dispatch of the persistent search (PERSIST_N reads,
                  DEV_BATCH lanes), (b) the fixed-step harness, full and
                  with the stack update stubbed — the busy-time
                  difference is the stack update's share of a step.
                  Writes .bench/profile_trace.json.

The harness runs `_search_step` in a fori_loop from the real initial
state (no early exit, no lane reloads), in NONSTOP mode with a wide diff
budget so lanes stay active across the whole measured window; iter_cap
is disabled for the same reason.  Stubbed steps are semantically wrong
by design — this never touches production paths (profile_skips
defaults to ()).

Usage: python scripts/profile_step.py [--mode budget|budget-add|lanes|trace]
         [--lanes B ...] [--s1 N] [--s2 N] [--reps R] [--acap N]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import shutil
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke
from ibwa_tpu.align import engine_jax
from ibwa_tpu.align.opts import GapOpt, BWA_MODE_NONSTOP
from ibwa_tpu.fm.device import DeviceFmPair, build_device_pair
from ibwa_tpu.fm.fmindex import FmIndex
from ibwa_tpu.index.builder import load_index
from ibwa_tpu.io.reads import load_reads

SEED = 20
OUT = REPO / ".bench"


def corpus() -> tuple[str, str]:
    """(index prefix, single-end fastq) of the chip_smoke data."""
    paths = chip_smoke.make_data(
        chip_smoke.SMOKE / f"s{SEED}_{chip_smoke.FULL.genome}", SEED,
        chip_smoke.FULL)
    return str(paths["fa"]), str(paths["se"])

# components stubbable via EngineConfig.profile_skips; the remainder
# after subtracting all of them is "children construction + elementwise
# logic + loop/op-launch overhead"
COMPONENTS = ["occ4", "eunroll", "meta", "shadow", "stack", "hits"]


@functools.partial(jax.jit, static_argnums=(0,),
                   static_argnames=("seq_len", "n_blk", "n_steps"))
def run_fixed(cfg, blocks, L2, l2diff, primary, seqs, lens, md, hs, ssq,
              bad, seq_len: int, n_blk: int, n_steps: int):
    fm = DeviceFmPair(blocks, L2, l2diff, primary, None, seq_len, n_blk,
                      None, (blocks.shape[1] - 4) << 4)
    st = engine_jax._init_state(cfg, fm, seqs, lens, md, hs, ssq, bad)

    def body(i, s):
        return engine_jax._search_step(cfg, fm, seqs, s)

    st = jax.lax.fori_loop(0, n_steps, body, st)
    # checksum over every carried leaf so no component is DCE'd
    tot = jnp.zeros((), jnp.uint32)
    for x in jax.tree_util.tree_leaves(st):
        tot = tot + jnp.sum(x.astype(jnp.uint32))
    return tot


def prep(B: int, acap: int):
    """Real reads from the smoke corpus packed for the fixed-step
    harness (same packing as JaxAlnEngine.align_batch)."""
    fa, fq = corpus()
    fms = (FmIndex(load_index(fa, 0)), FmIndex(load_index(fa, 1)))
    dfm = build_device_pair(fms[0], fms[1], dimer=False)
    reads = load_reads(fq)
    # NONSTOP + wide budget: lanes keep popping for the whole window
    opt = GapOpt(mode=GapOpt().mode | BWA_MODE_NONSTOP,
                 max_top2=0x7FFFFFFF)
    n = min(B, len(reads))
    seqs = [reads[i % n].seq for i in range(B)]
    rseqs = [reads[i % n].rseq for i in range(B)]
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    L = int(max(8, (lens.max() + 7) // 8 * 8))
    md = np.full(B, 4, dtype=np.int32)   # wide budget, deep search
    sq = np.full((B, 2, L), 4, dtype=np.uint8)
    for b in range(B):
        sq[b, 0, :lens[b]] = seqs[b]
        sq[b, 1, :lens[b]] = rseqs[b]
    SL = min(opt.seed_len, L)
    hs = lens > opt.seed_len
    ssq = np.full((B, 2, SL), 4, dtype=np.uint8)
    for b in range(B):
        if hs[b]:
            ssq[b, 0] = sq[b, 0, lens[b] - SL:lens[b]]
            ssq[b, 1] = sq[b, 1, lens[b] - SL:lens[b]]
    bad = np.zeros(B, dtype=bool)
    base_cfg = engine_jax.make_config(L, 4, opt, seq_len=dfm.seq_len)
    base_cfg = dataclasses.replace(base_cfg, acap=acap,
                                   iter_cap=0x7FFFFFFF)
    args = (dfm.blocks, dfm.L2, dfm.l2diff, dfm.primary,
            jnp.asarray(sq), jnp.asarray(lens), jnp.asarray(md),
            jnp.asarray(hs), jnp.asarray(ssq), jnp.asarray(bad))
    return base_cfg, dfm, args


def time_readback(fn, reps: int):
    np.asarray(fn())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def marginal(cfg, dfm, args, s1, s2, reps):
    f = lambda s: (lambda: run_fixed(cfg, *args, seq_len=dfm.seq_len,
                                     n_blk=dfm.n_blk, n_steps=s))
    t1 = time_readback(f(s1), reps)
    t2 = time_readback(f(s2), reps)
    return (t2 - t1) / (s2 - s1)


def mode_budget(a):
    B = a.lanes[0]
    cfg, dfm, args = prep(B, a.acap)
    out = {"lanes": B, "acap": a.acap, "s1": a.s1, "s2": a.s2}
    full = marginal(cfg, dfm, args, a.s1, a.s2, a.reps)
    out["full_us"] = round(full * 1e6, 2)
    print(f"B={B} full: {full*1e6:9.2f} us/step", flush=True)
    rows = []
    for comp in COMPONENTS:
        c2 = dataclasses.replace(cfg, profile_skips=(comp,))
        t = marginal(c2, dfm, args, a.s1, a.s2, a.reps)
        d = full - t
        rows.append({"component": comp, "us": round(d * 1e6, 2),
                     "without_us": round(t * 1e6, 2)})
        print(f"B={B} -{comp:8s}: {t*1e6:9.2f} us/step  "
              f"-> {comp} costs {d*1e6:7.2f} us ({100*d/full:5.1f}%)",
              flush=True)
    c_all = dataclasses.replace(cfg, profile_skips=tuple(COMPONENTS))
    t_min = marginal(c_all, dfm, args, a.s1, a.s2, a.reps)
    rows.append({"component": "remainder(children+elementwise+loop)",
                 "us": round(t_min * 1e6, 2)})
    print(f"B={B} -ALL     : {t_min*1e6:9.2f} us/step (children + "
          f"elementwise + loop overhead)", flush=True)
    out["components"] = rows
    _write(out, "profile_budget.json")


def mode_budget_add(a):
    """Additive budget: start from every component stubbed and enable one
    at a time — isolates each component's standalone cost (the
    subtractive mode measures cost-in-context; the difference between
    the two is scheduling/serialization cross-terms)."""
    B = a.lanes[0]
    cfg, dfm, args = prep(B, a.acap)
    out = {"lanes": B, "acap": a.acap, "s1": a.s1, "s2": a.s2}
    base_skips = tuple(COMPONENTS)
    c0 = dataclasses.replace(cfg, profile_skips=base_skips)
    base = marginal(c0, dfm, args, a.s1, a.s2, a.reps)
    out["base_us"] = round(base * 1e6, 2)
    print(f"B={B} base(all stubbed): {base*1e6:9.2f} us/step", flush=True)
    rows = []
    for comp in COMPONENTS:
        skips = tuple(c for c in COMPONENTS if c != comp)
        c2 = dataclasses.replace(cfg, profile_skips=skips)
        t = marginal(c2, dfm, args, a.s1, a.s2, a.reps)
        d = t - base
        rows.append({"component": comp, "us": round(d * 1e6, 2),
                     "with_only_us": round(t * 1e6, 2)})
        print(f"B={B} +{comp:8s}: {t*1e6:9.2f} us/step  "
              f"-> {comp} alone costs {d*1e6:7.2f} us", flush=True)
    full = marginal(cfg, dfm, args, a.s1, a.s2, a.reps)
    out["full_us"] = round(full * 1e6, 2)
    print(f"B={B} full    : {full*1e6:9.2f} us/step", flush=True)
    out["components"] = rows
    _write(out, "profile_budget_add.json")


def mode_lanes(a):
    recs = []
    for B in a.lanes:
        cfg, dfm, args = prep(B, a.acap)
        t = marginal(cfg, dfm, args, a.s1, a.s2, a.reps)
        rec = {"lanes": B, "us_per_step": round(t * 1e6, 2),
               "ns_per_lane_step": round(t / B * 1e9, 2)}
        print(f"B={B:5d}: {t*1e6:9.2f} us/step  "
              f"{t/B*1e9:7.2f} ns/lane-step", flush=True)
        recs.append(rec)
    _write(recs, "profile_lanes.json")


def device_busy(trace_dir: str) -> dict:
    """Reduce one jax.profiler trace to device numbers.

    Kernel events are those on the GPU planes' stream lines.  Busy time
    is the union of their intervals; the window runs from the first
    kernel's start to the last one's end."""
    import glob

    from jax.profiler import ProfileData

    (path,) = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)
    spans, names = [], {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                if ev.duration_ns <= 0 or ev.name.startswith("end:"):
                    continue
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                names[ev.name] = names.get(ev.name, 0) + ev.duration_ns
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s_, e_ in spans:
        if cur_e is None or s_ > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    top = sorted(names.items(), key=lambda kv: -kv[1])[:25]
    return {"kernels": len(spans), "busy_ns": busy, "window_ns": window,
            "idle_share": 1 - busy / window if window else None,
            "top_kernels_ns": top}


def traced(fn, tag: str, reps: int) -> dict:
    """Warm fn, time `reps` untraced calls, then trace one more (each
    call ends in block_until_ready; the profiler's own start and stop
    stay out of the wall times).  wall_s is the median, walls_s all."""
    jax.block_until_ready(fn())
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        walls.append(time.perf_counter() - t0)
    tdir = str(OUT / "traces" / tag)
    shutil.rmtree(tdir, ignore_errors=True)
    with jax.profiler.trace(tdir):
        res = jax.block_until_ready(fn())
    rec = device_busy(tdir)
    rec["walls_s"] = walls
    rec["wall_s"] = float(np.median(walls))
    return rec, res


def mode_trace(a):
    out = {"device": str(jax.devices()[0].device_kind)}
    # (a) one production dispatch: PERSIST_N reads through DEV_BATCH lanes
    fa, fq = corpus()
    fms = (FmIndex(load_index(fa, 0)), FmIndex(load_index(fa, 1)))
    eng = engine_jax.JaxAlnEngine(fms, devices=jax.devices()[:1])
    reads = load_reads(fq)[:engine_jax.PERSIST_N]
    seqs = [r.seq for r in reads]
    cfg, lens, md = eng.batch_config(seqs, GapOpt())
    n, L, SL = len(seqs), cfg.L, cfg.SL
    sq = np.full((n, 2, L), 4, np.uint8)
    ssq = np.full((n, 2, SL), 4, np.uint8)
    for b, r in enumerate(reads):
        sq[b, 0, :lens[b]] = r.seq
        sq[b, 1, :lens[b]] = r.rseq
        ssq[b] = sq[b, :, lens[b] - SL:lens[b]]
    hs = lens > GapOpt().seed_len
    d = eng.dfm
    args = [jnp.asarray(x) for x in (sq, lens, md, hs, ssq,
                                     np.zeros(n, bool))]

    def dispatch():
        return engine_jax._run_search_persistent(
            cfg, d.blocks, d.L2, d.l2diff, d.primary, *args,
            seq_len=d.seq_len, n_blk=d.n_blk, n_lanes=engine_jax.DEV_BATCH,
            dimer=d.dimer)

    rec, res = traced(dispatch, "persistent", a.reps)
    steps = int(res[3])
    per_step = [w / max(steps, 1) * 1e6 for w in rec["walls_s"]]
    rec.update(steps=steps, reads=n, lanes=engine_jax.DEV_BATCH,
               acap=cfg.acap, fallback_reads=int(np.asarray(res[2]).sum()),
               kernels_per_step=rec["kernels"] / max(steps, 1),
               wall_us_per_step=rec["wall_s"] / max(steps, 1) * 1e6,
               walls_us_per_step=per_step,
               busy_us_per_step=rec["busy_ns"] / max(steps, 1) / 1e3)
    out["persistent"] = rec
    print(f"persistent: {steps} steps, {rec['kernels']} kernels "
          f"({rec['kernels_per_step']:.1f}/step), wall "
          f"{', '.join(f'{w:.1f}' for w in per_step)} us/step "
          f"(median {rec['wall_us_per_step']:.1f}), device busy "
          f"{rec['busy_us_per_step']:.1f} us/step, idle share "
          f"{rec['idle_share']:.3f}", flush=True)

    # (b) fixed-step harness, full vs stack update stubbed
    B = a.lanes[0]
    cfg2, dfm, hargs = prep(B, cfg.acap)
    for tag, c in (("full", cfg2), ("no_stack", dataclasses.replace(
            cfg2, profile_skips=("stack",)))):
        rec2, _ = traced(lambda: run_fixed(
            c, *hargs, seq_len=dfm.seq_len, n_blk=dfm.n_blk,
            n_steps=a.s1), f"fixed_{tag}", a.reps)
        rec2["busy_us_per_step"] = rec2["busy_ns"] / a.s1 / 1e3
        out[f"fixed_{tag}"] = rec2
        print(f"fixed {tag}: B={B} acap={cfg.acap}, device busy "
              f"{rec2['busy_us_per_step']:.1f} us/step, "
              f"{rec2['kernels'] / a.s1:.1f} kernels/step", flush=True)
    full = out["fixed_full"]["busy_ns"]
    share = (full - out["fixed_no_stack"]["busy_ns"]) / full
    out["stack_update_share"] = share
    print(f"stack update share of device busy time per step: {share:.3f}",
          flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_trace.json").write_text(json.dumps(out, indent=1))


def _write(obj, name):
    out = OUT / name
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(obj, indent=1))
    print(f"wrote {out}", file=sys.stderr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="budget",
                    choices=["budget", "budget-add", "lanes", "trace"])
    ap.add_argument("--lanes", type=int, nargs="*",
                    default=[1024])
    ap.add_argument("--s1", type=int, default=256)
    ap.add_argument("--s2", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--acap", type=int, default=engine_jax.ACAP)
    a = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"profile_step.py needs a GPU; JAX found only "
                 f"{dev.platform} device(s)")
    from ibwa_tpu.compile_cache import enable
    enable()
    print(f"device: {dev.device_kind}", flush=True)
    {"budget": mode_budget, "budget-add": mode_budget_add,
     "lanes": mode_lanes, "trace": mode_trace}[a.mode](a)


if __name__ == "__main__":
    main()
