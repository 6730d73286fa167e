"""Benchmark: `aln` throughput (reads/s/chip) vs the reference binary.

Prints ONE JSON line (the driver contract):
  {"metric": "aln_reads_per_s_per_chip", "value": N, "unit": "reads/s",
   "vs_baseline": ratio_vs_reference_one_core}

Secondary metrics (samse/sampe/bwasw stage throughput vs the reference
binary, device/host split, device-only rate) go to stderr and to
`.bench/bench_extra.json`.  It needs a GPU and fails without one.

The workload mirrors the reference's headline metric (bwa.1:479-482):
short-read gapped alignment against an indexed genome, default options.
The genome carries repeat structure (dispersed ~300bp elements, a tandem
array, diverged segmental duplications) so wide SA intervals and the
heavy-tail paths fire — a uniform-random genome flatters the aligner.
Baseline = the reference ibwa binary, single thread, same genome/reads on
this host (built from /root/reference on first run, then cached).
"""

from __future__ import annotations

import json
import pathlib
import random
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / ".bench"
GENOME_TAG = "rep2"       # bump when the genome recipe changes
GENOME_LEN = 32_000_000   # chr20-scale (BASELINE.json configs 3-4)
N_READS = 16384
READ_LEN = 100
N_PAIRS = 50_000          # sampe stage benchmark (100k reads: steady-state
                          # throughput, not startup)
N_LONG = 1500             # bwasw stage benchmark


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def make_genome(seed: int) -> str:
    """chip_smoke's repeat-structured genome (~15% repeat content:
    dispersed ~300bp elements, one tandem array, diverged 50kb segmental
    duplications) at GENOME_LEN, as text."""
    import numpy as np

    import chip_smoke
    codes = chip_smoke.make_genome(np.random.default_rng(seed), GENOME_LEN)
    return chip_smoke._ACGT[codes].tobytes().decode()


def _pair_paths() -> tuple[pathlib.Path, pathlib.Path]:
    return (WORK / f"pairs_{GENOME_TAG}_{N_PAIRS}_1.fq",
            WORK / f"pairs_{GENOME_TAG}_{N_PAIRS}_2.fq")


def _read_genome(fa: pathlib.Path) -> str:
    with open(fa) as f:
        return "".join(line.strip() for line in f if not line.startswith(">"))


def ensure_inputs() -> tuple[pathlib.Path, pathlib.Path]:
    WORK.mkdir(exist_ok=True)
    fa = WORK / f"genome_{GENOME_TAG}.fa"
    fq = WORK / f"reads_{GENOME_TAG}.fq"
    fq1, fq2 = _pair_paths()
    fql = WORK / f"long_{GENOME_TAG}.fq"
    have_idx = (fa.exists() and fq.exists()
                and pathlib.Path(str(fa) + ".bwt").exists())
    if have_idx and fq1.exists() and fq2.exists() and fql.exists():
        return fa, fq
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rng = random.Random(20260816)
    if have_idx:
        seq = _read_genome(fa)
    else:
        log(f"generating {GENOME_LEN/1e6:.0f} Mbp repeat-structured genome "
            f"+ {N_READS} reads")
        seq = make_genome(20260816)
        with open(fa, "w") as f:
            f.write(">bench_chr\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")
        with open(fq, "w") as f:
            for i in range(N_READS):
                pos = rng.randrange(0, GENOME_LEN - READ_LEN)
                s = list(seq[pos:pos + READ_LEN])
                for j in range(len(s)):
                    if rng.random() < 0.01:
                        s[j] = rng.choice("ACGT")
                if rng.random() < 0.5:
                    s = [comp[c] for c in reversed(s)]
                f.write(f"@r{i}\n{''.join(s)}\n+\n{'I' * READ_LEN}\n")
    # paired reads for the sampe benchmark (own RNG: genome gen may have
    # been skipped, and the pair count is a bench knob)
    if not (fq1.exists() and fq2.exists()):
        log(f"generating {N_PAIRS} read pairs")
        prng = random.Random(20260817)
        with open(fq1, "w") as f1, open(fq2, "w") as f2:
            for i in range(N_PAIRS):
                isz = max(2 * READ_LEN + 10, int(prng.gauss(320, 40)))
                pos = prng.randrange(0, GENOME_LEN - isz)
                frag = seq[pos:pos + isz]
                a = list(frag[:READ_LEN])
                b = [comp[c] for c in reversed(frag[-READ_LEN:])]
                for arr in (a, b):
                    for j in range(len(arr)):
                        if prng.random() < 0.01:
                            arr[j] = prng.choice("ACGT")
                f1.write(f"@p{i}\n{''.join(a)}\n+\n{'I' * READ_LEN}\n")
                f2.write(f"@p{i}\n{''.join(b)}\n+\n{'I' * READ_LEN}\n")
    # long reads for the bwasw benchmark
    if not fql.exists():
        lrng = random.Random(20260818)
        with open(fql, "w") as f:
            for i in range(N_LONG):
                ln = lrng.randrange(400, 1000)
                pos = lrng.randrange(0, GENOME_LEN - ln)
                s = list(seq[pos:pos + ln])
                for j in range(len(s)):
                    if lrng.random() < 0.02:
                        s[j] = lrng.choice("ACGT")
                if lrng.random() < 0.5:
                    s = [comp[c] for c in reversed(s)]
                f.write(f"@L{i}\n{''.join(s)}\n+\n{'I' * len(s)}\n")
    if not pathlib.Path(str(fa) + ".bwt").exists():
        log("indexing (ours)")
        from ibwa_tpu.index.builder import bwa_index
        bwa_index(str(fa))
    return fa, fq


def build_oracle() -> pathlib.Path | None:
    binary = REPO / ".refsrc" / "ibwa"
    if binary.exists():
        return binary
    ref = pathlib.Path("/root/reference")
    if not ref.exists():
        return None
    dst = REPO / ".refsrc"
    dst.mkdir(exist_ok=True)
    try:
        subprocess.run(f"cp -r {ref}/* {dst}/", shell=True, check=True)
        subprocess.run(["chmod", "-R", "u+w", str(dst)], check=True)
        subprocess.run(
            "sed -e 's/@FULL_VERSION@/0.5.9-ibwa/'"
            " -e 's/@CMAKE_BUILD_TYPE@/Release/' version.h.in > version.h",
            shell=True, cwd=dst, check=True)
        subprocess.run(["make", "CFLAGS=-g -Wall -O2 -fgnu89-inline", "-j8"],
                       cwd=dst, capture_output=True)
        for f in ["bwaremap", "translate_cigar", "filter_alignments"]:
            subprocess.run(["g++", "-c", "-O2", "-DHAVE_PTHREAD", f"{f}.cpp",
                            "-o", f"{f}.o"], cwd=dst, check=True)
        for f in ["bwapair", "bwasw", "byteorder"]:
            subprocess.run(["gcc", "-c", "-O2", "-fgnu89-inline",
                            "-DHAVE_PTHREAD", f"{f}.c", "-o", f"{f}.o"],
                           cwd=dst, check=True)
        subprocess.run(
            "g++ -O2 *.o -o ibwa -lm -lz -lpthread -Lbwt_gen -lbwtgen",
            shell=True, cwd=dst, capture_output=True)
    except Exception as e:  # pragma: no cover
        log(f"oracle build failed: {e}")
        return None
    return binary if binary.exists() else None


def ref_prefix(fa: pathlib.Path, binary) -> pathlib.Path:
    ref_fa = WORK / f"genome_{GENOME_TAG}_ref.fa"
    if not pathlib.Path(str(ref_fa) + ".bwt").exists():
        ref_fa.write_bytes(fa.read_bytes())
        log("indexing (reference)")
        subprocess.run([str(binary), "index", str(ref_fa)], check=True,
                       capture_output=True)
    return ref_fa


def time_reference_aln(fa: pathlib.Path, fq: pathlib.Path) -> float | None:
    """ONE fresh timed run of the reference aln (1 thread).  Called
    interleaved with our timed runs so both sides see the same machine
    conditions (never compare a fresh measurement against a cached
    old one)."""
    binary = build_oracle()
    if binary is None:
        return None
    rfa = ref_prefix(fa, binary)
    t0 = time.perf_counter()
    subprocess.run([str(binary), "aln", "-t", "1", str(rfa), str(fq)],
                   check=True, capture_output=True)
    dt = time.perf_counter() - t0
    cache = WORK / f"baseline_{GENOME_TAG}.json"
    cache.write_text(json.dumps({"reads_per_s": N_READS / dt,
                                 "seconds": dt}))
    return N_READS / dt


def bench_stages(fa: pathlib.Path, extra: dict) -> None:
    """samse / sampe / bwasw stage throughput, ours vs the oracle.

    Both consume the SAME .sai inputs (ours — byte-identical to the
    oracle's by the parity suite), isolating the SAM-stage cost."""
    binary = REPO / ".refsrc" / "ibwa"
    if not binary.exists():
        return
    rfa = ref_prefix(fa, binary)
    fq1, fq2 = _pair_paths()
    fql = WORK / f"long_{GENOME_TAG}.fq"
    s1 = pathlib.Path(str(fq1).removesuffix(".fq") + ".sai")
    s2 = pathlib.Path(str(fq2).removesuffix(".fq") + ".sai")
    from ibwa_tpu.align.opts import GapOpt
    from ibwa_tpu.align.pipeline import aln_to_stream
    if not s1.exists() or not s2.exists():
        log("aln for sampe inputs")
        for fqx, sx in ((fq1, s1), (fq2, s2)):
            with open(sx, "wb") as f:
                aln_to_stream(str(fa), str(fqx), GapOpt(), f)

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    # sampe
    from ibwa_tpu.sam.sampe import PeOpt, sai2sam_pe
    import io
    t_ours = timed(lambda: sai2sam_pe(
        [str(fa)], [(str(s1), str(s2))], str(fq1), str(fq2),
        PeOpt(remapping=1), out=io.StringIO()))
    t_ref = timed(lambda: subprocess.run(
        [str(binary), "sampe", "-R", str(rfa), str(s1), str(s2),
         str(fq1), str(fq2)], check=True, capture_output=True))
    extra["sampe_reads_per_s"] = round(2 * N_PAIRS / t_ours, 1)
    extra["sampe_vs_ref"] = round(t_ref / t_ours, 3)
    log(f"sampe: ours {2*N_PAIRS/t_ours:.0f} reads/s vs ref "
        f"{2*N_PAIRS/t_ref:.0f} -> {t_ref/t_ours:.2f}x")

    # samse
    from ibwa_tpu.sam.bwase import sai2sam_se
    t_ours = timed(lambda: sai2sam_se(str(fa), str(s1), str(fq1),
                                      out=io.StringIO()))
    t_ref = timed(lambda: subprocess.run(
        [str(binary), "samse", str(rfa), str(s1), str(fq1)],
        check=True, capture_output=True))
    extra["samse_reads_per_s"] = round(N_PAIRS / t_ours, 1)
    extra["samse_vs_ref"] = round(t_ref / t_ours, 3)
    log(f"samse: ours {N_PAIRS/t_ours:.0f} reads/s vs ref "
        f"{N_PAIRS/t_ref:.0f} -> {t_ref/t_ours:.2f}x")

    # bwasw
    from ibwa_tpu.bwasw.aux import Bsw2Opt, bsw2_aln
    t_ours = timed(lambda: bsw2_aln(Bsw2Opt(), str(fa), str(fql),
                                    out=io.StringIO()))
    t_ref = timed(lambda: subprocess.run(
        [str(binary), "bwasw", str(rfa), str(fql)], check=True,
        capture_output=True))
    extra["bwasw_reads_per_s"] = round(N_LONG / t_ours, 1)
    extra["bwasw_vs_ref"] = round(t_ref / t_ours, 3)
    log(f"bwasw: ours {N_LONG/t_ours:.0f} reads/s vs ref "
        f"{N_LONG/t_ref:.0f} -> {t_ref/t_ours:.2f}x")


def main() -> None:
    import jax

    from ibwa_tpu.compile_cache import enable
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found only {dev.platform} "
                 f"device(s)")
    enable()
    fa, fq = ensure_inputs()

    from ibwa_tpu.align.engine_jax import JaxAlnEngine
    from ibwa_tpu.align.opts import GapOpt
    from ibwa_tpu.fm.fmindex import FmIndex
    from ibwa_tpu.index.builder import load_index
    from ibwa_tpu.io.reads import load_reads

    opt = GapOpt()
    log("loading index + reads")
    fms = (FmIndex(load_index(str(fa), 0)), FmIndex(load_index(str(fa), 1)))
    reads = load_reads(str(fq))
    seqs = [r.seq for r in reads]
    rseqs = [r.rseq for r in reads]
    eng = JaxAlnEngine(fms)

    log("warmup/compile (persistent compile cache: see "
        "ibwa_tpu/compile_cache.py)")
    # warm the exact dispatch bucket the timed run uses (shapes are
    # static) and let the host/device balance controller converge
    eng.align_batch(seqs, rseqs, opt)
    eng.align_batch(seqs, rseqs, opt)

    # interleaved fresh A/B: ours / reference / ours / reference, best of
    # each — both sides timed this session under the same conditions
    rps_runs, base_runs, steps_runs, dt_runs = [], [], [], []
    for rep in range(2):
        log(f"timing {len(seqs)} reads (run {rep + 1}/2)")
        it0 = eng.stats["iterations"]
        t0 = time.perf_counter()
        eng.align_batch(seqs, rseqs, opt)
        dt = time.perf_counter() - t0
        rps_runs.append(len(seqs) / dt)
        dt_runs.append(dt)
        steps_runs.append(eng.stats["iterations"] - it0)
        log(f"ours: {rps_runs[-1]:.0f} reads/s ({dt:.2f}s), "
            f"stats={eng.stats}")
        log("timing reference aln (1 thread, interleaved)")
        b = time_reference_aln(fa, fq)
        if b:
            base_runs.append(b)
            log(f"reference: {b:.0f} reads/s")
    pick = max(range(2), key=lambda i: rps_runs[i])
    rps, dt, steps = rps_runs[pick], dt_runs[pick], steps_runs[pick]
    base = max(base_runs) if base_runs else None

    extra = {
        "device_reads": eng.stats["device_reads"],
        "fallback_reads": eng.stats["fallback_reads"],
        "host_reads": eng.stats["host_reads"],
        "host_frac": eng.stats.get("host_frac"),
        "hybrid_steps": steps,
    }

    # device-only number: same batch with the host co-processing share
    # forced to zero (capacity-overflow reads still fall back to the
    # host, mirroring production; their count is reported)
    log("timing device-only (host share = 0)")
    saved_frac = eng.host_frac
    eng.host_frac = 0.0
    fb0 = eng.stats["fallback_reads"]
    it0 = eng.stats["iterations"]
    t0 = time.perf_counter()
    eng.align_batch(seqs, rseqs, opt)
    dt_dev = time.perf_counter() - t0
    dev_rps = len(seqs) / dt_dev
    dev_fb = eng.stats["fallback_reads"] - fb0
    dev_steps = eng.stats["iterations"] - it0
    eng.host_frac = saved_frac
    log(f"device-only: {dev_rps:.0f} reads/s ({dt_dev:.2f}s, "
        f"{dev_fb} overflow-fallback reads on host, {dev_steps} steps)")
    extra.update({
        "device_only_reads_per_s": round(dev_rps, 1),
        "device_only_fallback_reads": dev_fb,
        "device_only_steps": dev_steps,
    })
    if base:
        extra["device_only_vs_ref"] = round(dev_rps / base, 3)

    vs = rps / base if base else None
    if base:
        log(f"reference 1-core: {base:.0f} reads/s -> {vs:.2f}x hybrid"
            + (f", {extra['device_only_vs_ref']:.2f}x device-only"
               if "device_only_vs_ref" in extra else ""))

    try:
        bench_stages(fa, extra)
    except Exception as e:  # secondary metrics must not sink the headline
        log(f"stage benchmarks failed: {e}")

    (WORK / "bench_extra.json").write_text(json.dumps(extra, indent=1))
    log(f"extra metrics: {json.dumps(extra)}")
    rec = {
        "metric": "aln_reads_per_s_per_chip",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(vs, 3) if vs is not None else None,
        # the hybrid number is device + host cores; these two say how
        # much is the device
        "host_frac": eng.stats.get("host_frac"),
        "device_only_vs_ref": extra.get("device_only_vs_ref"),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
