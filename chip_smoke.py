"""Run the aligner's main path once on a GPU and check every output.

    python chip_smoke.py [--seed N] [--cards 4]

One process, in-process calls of the CLI (`ibwa_tpu.cli.main`), on a
generated chr20-sized genome (64,444,167 bp, the length of GRCh38 chr20).
At the default 64-base occ blocks its device table is about 64 MB over
both strands, more than the card's L2, so the search's gathers reach
device memory.  Phases, in order:

  device    JAX must find a GPU (no CPU fallback); prints the card's name
            and power limit as nvidia-smi reports them
  data      genome, index and reads from --seed, cached under .smoke/
  compile   lower + compile the persistent search at the shapes `aln`
            dispatches; prints compile seconds and memory_analysis()
  aln       the users' hybrid path and the device-only share
            (IBWA_HOST_FRAC=0); each .sai byte-identical to the native
            host engine's, and the device takes at least half the reads
            in the device-only arm
  sam       samse and sampe -R on the device .sai files equal (without
            @PG) what the same commands write from the native ones
  offpath   sampe with device SA walks (IBWA_PE_DEVICE=1) and bwasw with
            device seed extension (IBWA_BSW_DEVICE=1), each equal to its
            host path

With --cards 4 only the multi-card path runs: the single-end reads
aligned over a `dp` mesh of four cards, byte-compared with the native
engine.  Any failure exits non-zero before the last line; the last line
of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
SMOKE = REPO / ".smoke"


@dataclasses.dataclass(frozen=True)
class Sizes:
    genome: int      # bases
    reads: int       # single-end reads
    pairs: int       # read pairs
    long: int        # bwasw reads of 400-999 bp


FULL = Sizes(genome=64_444_167, reads=32_768, pairs=16_384, long=300)
READ_LEN = 100


class SmokeFailure(Exception):
    """A phase produced a wrong or missing result."""


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ------------------------------------------------------------------ device
def check_device(n_cards: int):
    """The visible devices, or SmokeFailure unless they are n_cards GPUs."""
    import jax

    devs = jax.devices()
    require(devs[0].platform == "gpu",
            f"no GPU: JAX found only {devs[0].platform} device(s)")
    require(len(devs) == n_cards,
            f"needs {n_cards} visible GPU(s), JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    return devs


# -------------------------------------------------------------------- data
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    """Base codes (0-3) with repeat structure: one tandem array of a
    250 bp unit (0.96 Mbp), 13 copies of a 50 kbp segment at 0.1%
    divergence, and a 300 bp element making up one block in ten between
    random blocks of 1500-8999 bp, shuffled and cut to length."""
    rand = lambda n: rng.integers(0, 4, n, dtype=np.uint8)
    alu, unit, seg = rand(300), rand(250), rand(50_000)
    parts = [np.tile(unit, 3840)]
    for _ in range(13):
        s = seg.copy()
        s[rng.integers(0, len(s), 50)] = rand(50)
        parts.append(s)
    made = sum(len(p) for p in parts)
    while made < length:
        p = alu if rng.random() < 0.10 else rand(int(rng.integers(1500, 9000)))
        parts.append(p)
        made += len(p)
    order = rng.permutation(len(parts))
    return np.concatenate([parts[i] for i in order])[:length]


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]


def _mutate(rng, codes: np.ndarray, rate: float) -> np.ndarray:
    out = codes.copy()
    hit = rng.random(len(out)) < rate
    out[hit] = rng.integers(0, 4, int(hit.sum()), dtype=np.uint8)
    return out


def _fastq(f, name: str, codes: np.ndarray) -> None:
    f.write(f"@{name}\n{_ACGT[codes].tobytes().decode()}\n+\n"
            f"{'I' * len(codes)}\n")


def _write_fasta(path: pathlib.Path, genome: np.ndarray) -> None:
    width = 70
    n = len(genome)
    rows = -(-n // width)
    bases = np.full(rows * width, ord("\n"), dtype=np.uint8)
    bases[:n] = _ACGT[genome]
    text = np.full((rows, width + 1), ord("\n"), dtype=np.uint8)
    text[:, :width] = bases.reshape(rows, width)
    body = text.reshape(-1)
    if n % width:   # drop the padding of the last line, keep its newline
        tail = rows * (width + 1) - (width - n % width) - 1
        body = np.concatenate([body[:tail], body[-1:]])
    with open(path, "wb") as f:
        f.write(b">chr20_model\n")
        f.write(body.tobytes())


def make_data(workdir: pathlib.Path, seed: int, sizes: Sizes) -> dict:
    """Genome, its index and all read sets, made once per (seed, sizes).

    Single-end reads: 100 bp, 1% substitutions, a 1-3 bp indel in about
    one read in ten.  Pairs: 100 bp ends of 320 +- 40 bp inserts, 1%
    substitutions.  Long reads: 400-999 bp, 2% substitutions."""
    from ibwa_tpu import cli

    workdir.mkdir(parents=True, exist_ok=True)
    paths = {k: workdir / n for k, n in (
        ("fa", "genome.fa"), ("se", "se.fq"), ("pe1", "pe_1.fq"),
        ("pe2", "pe_2.fq"), ("long", "long.fq"))}
    done = workdir / "done"
    if done.exists():
        return paths
    rng = np.random.default_rng(seed)
    genome = make_genome(rng, sizes.genome)
    _write_fasta(paths["fa"], genome)
    with open(paths["se"], "w") as f:
        for i in range(sizes.reads):
            pos = int(rng.integers(0, sizes.genome - READ_LEN - 3))
            r = genome[pos:pos + READ_LEN + 3]
            if rng.random() < 0.10:
                at = int(rng.integers(20, 80))
                n = int(rng.integers(1, 4))
                if rng.random() < 0.5:
                    r = np.concatenate([r[:at], r[at + n:]])
                else:
                    r = np.concatenate(
                        [r[:at], rng.integers(0, 4, n, dtype=np.uint8),
                         r[at:]])
            r = _mutate(rng, r[:READ_LEN], 0.01)
            _fastq(f, f"r{i}", _revcomp(r) if rng.random() < 0.5 else r)
    with open(paths["pe1"], "w") as f1, open(paths["pe2"], "w") as f2:
        for i in range(sizes.pairs):
            isz = max(2 * READ_LEN + 10, int(round(rng.normal(320, 40))))
            pos = int(rng.integers(0, sizes.genome - isz))
            frag = genome[pos:pos + isz]
            _fastq(f1, f"p{i}", _mutate(rng, frag[:READ_LEN], 0.01))
            _fastq(f2, f"p{i}",
                   _mutate(rng, _revcomp(frag[-READ_LEN:]), 0.01))
    with open(paths["long"], "w") as f:
        for i in range(sizes.long):
            n = int(rng.integers(400, 1000))
            pos = int(rng.integers(0, sizes.genome - n))
            r = _mutate(rng, genome[pos:pos + n], 0.02)
            _fastq(f, f"L{i}", _revcomp(r) if rng.random() < 0.5 else r)
    require(cli.main(["index", str(paths["fa"])]) == 0, "index failed")
    done.write_text("ok\n")
    return paths


# ----------------------------------------------------------------- compile
def compile_search(prefix: str, fq: str) -> tuple[float, object]:
    """Lower + compile the persistent search at the shapes `aln` will
    dispatch for these reads.  Returns (seconds, memory_analysis())."""
    import jax
    import jax.numpy as jnp

    from ibwa_tpu.align import engine_jax
    from ibwa_tpu.align.opts import GapOpt
    from ibwa_tpu.fm.fmindex import FmIndex
    from ibwa_tpu.index.builder import load_index
    from ibwa_tpu.io.reads import load_reads

    fms = (FmIndex(load_index(prefix, 0)), FmIndex(load_index(prefix, 1)))
    eng = engine_jax.JaxAlnEngine(fms, devices=jax.devices()[:1])
    cfg, _, _ = eng.batch_config([r.seq for r in load_reads(fq)], GapOpt())
    pb = engine_jax.PERSIST_N
    spec = lambda *shape, dt=jnp.uint8: jax.ShapeDtypeStruct(shape, dt)
    d = eng.dfm
    t0 = time.perf_counter()
    compiled = engine_jax._run_search_persistent.lower(
        cfg, d.blocks, d.L2, d.l2diff, d.primary,
        spec(pb, 2, cfg.L), spec(pb, dt=jnp.int32), spec(pb, dt=jnp.int32),
        spec(pb, dt=jnp.bool_), spec(pb, 2, cfg.SL), spec(pb, dt=jnp.bool_),
        seq_len=d.seq_len, n_blk=d.n_blk, n_lanes=engine_jax.DEV_BATCH,
        dimer=d.dimer).compile()
    return time.perf_counter() - t0, compiled.memory_analysis()


# --------------------------------------------------------------------- aln
def run_cli(args: list[str]) -> None:
    from ibwa_tpu import cli

    require(cli.main(args) == 0, f"`{args[0]}` failed: {args}")


def aln(prefix: str, fq: str, out: pathlib.Path, engine: str = "jax",
        host_frac: str | None = None) -> dict:
    """One CLI `aln`; returns the device engine's stats (empty for the
    native engine)."""
    from ibwa_tpu.align import engine_jax

    engine_jax._ENGINES.clear()
    kv = {} if host_frac is None else {"IBWA_HOST_FRAC": host_frac}
    with mock.patch.dict(os.environ, kv):
        run_cli(["aln", "--engine", engine, "-f", str(out), prefix, fq])
    if engine != "jax":
        return {}
    (eng,) = engine_jax._ENGINES.values()
    return dict(eng.stats)


def same_bytes(a: pathlib.Path, b: pathlib.Path) -> bool:
    return a.read_bytes() == b.read_bytes()


def sam_body(path: pathlib.Path) -> list[str]:
    """SAM lines without @PG (it names the program version)."""
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith("@PG")]


def aln_arms(prefix: str, fq: str, out: pathlib.Path) -> dict:
    """Native, hybrid and device-only `aln` of one read set.  Each device
    arm's .sai must be byte-identical to the native one."""
    native = out / "se.native.sai"
    aln(prefix, fq, native, engine="native")
    arms = {}
    for arm, frac in (("hybrid", None), ("device_only", "0")):
        sai = out / f"se.{arm}.sai"
        stats = aln(prefix, fq, sai, host_frac=frac)
        require(same_bytes(sai, native),
                f"aln {arm}: .sai differs from the native engine's")
        arms[arm] = stats
    return arms


# --------------------------------------------------------------------- sam
def sam_stage(prefix: str, paths: dict, out: pathlib.Path) -> dict:
    """samse + sampe -R from device .sai files vs from native ones."""
    sai = {}
    for src in ("native", "device"):
        for end in ("pe1", "pe2"):
            sai[src, end] = out / f"{end}.{src}.sai"
            aln(prefix, str(paths[end]), sai[src, end],
                engine="native" if src == "native" else "jax")
    for end in ("pe1", "pe2"):
        require(same_bytes(sai["device", end], sai["native", end]),
                f"aln {end}: .sai differs from the native engine's")
    se_dev = out / "se.device_only.sai"
    se_nat = out / "se.native.sai"
    sams = {}
    for src, se in (("native", se_nat), ("device", se_dev)):
        sams["samse", src] = out / f"samse.{src}.sam"
        run_cli(["samse", "-f", str(sams["samse", src]), prefix, str(se),
                 str(paths["se"])])
        sams["sampe", src] = out / f"sampe.{src}.sam"
        run_cli(["sampe", "-R", "-f", str(sams["sampe", src]), prefix,
                 str(sai[src, "pe1"]), str(sai[src, "pe2"]),
                 str(paths["pe1"]), str(paths["pe2"])])
    for cmd in ("samse", "sampe"):
        require(sam_body(sams[cmd, "device"]) == sam_body(sams[cmd, "native"]),
                f"{cmd}: SAM from device .sai differs from native")
    return {"sai": sai, "sam": sams}


# ----------------------------------------------------------------- offpath
def pe_device_walks(prefix: str, paths: dict, sam: dict,
                    out: pathlib.Path) -> int:
    """sampe -R with SA walks on the device; returns rows walked there.
    The SAM must equal the host-walk SAM of the sam phase."""
    from ibwa_tpu.fm.walk import DeviceWalker

    got = out / "sampe.pe_device.sam"
    with mock.patch.dict(os.environ, IBWA_PE_DEVICE="1"), mock.patch.object(
            DeviceWalker, "resolve", autospec=True,
            side_effect=DeviceWalker.resolve) as resolve:
        run_cli(["sampe", "-R", "-f", str(got), prefix,
                 str(sam["sai"]["device", "pe1"]),
                 str(sam["sai"]["device", "pe2"]),
                 str(paths["pe1"]), str(paths["pe2"])])
    require(sam_body(got) == sam_body(sam["sam"]["sampe", "device"]),
            "sampe with IBWA_PE_DEVICE=1 differs from the host walks")
    return sum(len(c.args[2]) for c in resolve.call_args_list)


def bwasw_device(prefix: str, paths: dict,
                 out: pathlib.Path) -> tuple[int, int]:
    """bwasw with device seed extension vs the host path; returns the
    extension jobs offered to the device and those it computed (the rest
    are empty edges, or jobs `extend_jobs` sends back to the host)."""
    from ibwa_tpu.bwasw import dp_glue
    from ibwa_tpu.ops import dp

    real = dp.extend_jobs
    count = {"offered": 0, "device": 0}

    def counted(targets, queries, *rest):
        res, host_idx = real(targets, queries, *rest)
        empty = sum(not len(t) or not len(q)
                    for t, q in zip(targets, queries))
        count["offered"] += len(targets)
        count["device"] += len(targets) - len(host_idx) - empty
        return res, host_idx

    host = out / "bwasw.host.sam"
    dev = out / "bwasw.device.sam"
    run_cli(["bwasw", "-f", str(host), prefix, str(paths["long"])])
    try:
        with mock.patch.dict(os.environ, IBWA_BSW_DEVICE="1"), \
                mock.patch.object(dp, "extend_jobs", counted):
            run_cli(["bwasw", "-f", str(dev), prefix, str(paths["long"])])
    finally:
        dp_glue.uninstall()
    require(sam_body(dev) == sam_body(host),
            "bwasw with IBWA_BSW_DEVICE=1 differs from the host path")
    return count["offered"], count["device"]


# -------------------------------------------------------------------- main
def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


class Phases:
    """Times each phase and prints its seconds when it ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def done(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - self.t:.1f} s", flush=True)
        self.t = now


def run_one_card(paths: dict, out: pathlib.Path, ph: Phases) -> None:
    prefix, se = str(paths["fa"]), str(paths["se"])
    secs, mem = compile_search(prefix, se)
    print(f"compile _run_search_persistent: {secs:.1f} s", flush=True)
    print(f"memory_analysis: {mem}", flush=True)
    ph.done("compile")

    arms = aln_arms(prefix, se, out)
    for arm, stats in arms.items():
        print(f"aln {arm} stats: {json.dumps(stats)}", flush=True)
    dev = arms["device_only"]
    require(2 * dev["device_reads"] >= dev["device_reads"]
            + dev["fallback_reads"] + dev["host_reads"],
            "device-only arm put fewer than half the reads on the device")
    print("aln: hybrid and device-only .sai byte-identical to native",
          flush=True)
    ph.done("aln")

    sam = sam_stage(prefix, paths, out)
    print("samse, sampe -R: SAM from device .sai equals native", flush=True)
    ph.done("sam")

    rows = pe_device_walks(prefix, paths, sam, out)
    require(rows > 0, "IBWA_PE_DEVICE=1 walked no rows on the device")
    print(f"sampe IBWA_PE_DEVICE=1: {rows} SA rows walked on the device, "
          f"SAM equals host walks", flush=True)
    offered, on_device = bwasw_device(prefix, paths, out)
    require(on_device > 0, "IBWA_BSW_DEVICE=1 computed no extension on "
            f"the device ({offered} offered)")
    print(f"bwasw IBWA_BSW_DEVICE=1: {offered} extension jobs offered, "
          f"{on_device} computed on the device, SAM equals host", flush=True)
    ph.done("offpath")


def run_cards(devices, paths: dict, out: pathlib.Path, ph: Phases) -> None:
    prefix, se = str(paths["fa"]), str(paths["se"])
    native = out / "se.native.sai"
    aln(prefix, se, native, engine="native")
    sai = out / f"se.cards{len(devices)}.sai"
    stats = aln(prefix, se, sai, host_frac="0")
    print(f"aln over {len(devices)} cards stats: {json.dumps(stats)}",
          flush=True)
    require(stats["host_reads"] == 0, "device-only arm sent reads to host")
    require(same_bytes(sai, native),
            f"aln over {len(devices)} cards: .sai differs from native")
    print(f"aln over {len(devices)} cards: .sai byte-identical to native",
          flush=True)
    ph.done(f"aln_{len(devices)}_cards")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4],
                    help="4: only the multi-card aln path and its check")
    args = ap.parse_args(argv)
    if args.cards == 1:
        # the CLI's engine takes every visible device: show it one
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    ph = Phases()
    try:
        devices = check_device(args.cards)
        ph.done("device")
        from ibwa_tpu.compile_cache import enable
        enable()
        paths = make_data(SMOKE / f"s{args.seed}_{FULL.genome}", args.seed,
                          FULL)
        out = SMOKE / "out"
        out.mkdir(parents=True, exist_ok=True)
        ph.done("data")
        if args.cards == 1:
            run_one_card(paths, out, ph)
        else:
            run_cards(devices, paths, out, ph)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
