"""Scale parity: batch-seam + repeat-rich differential runs vs the oracle.

Covers what the unit suite's small fixtures cannot:
  * config A — E. coli-scale SE+PE: >=300k reads, crossing the 0x40000
    batch seam (bwtaln.c:193, bwape.c:476): multi-batch drand48
    continuity, per-batch isize barriers, batch-boundary behavior.
  * config B — repeat-rich 32 Mbp genome (tandem + segmental
    duplications) so >=1000-wide SA intervals and the max_occ paths fire
    (filter_alignments.cpp:77-102, bwape.c:84).

Outputs are byte-compared (.sai exactly; SAM with @PG stripped).

Usage:  python scripts/parity_scale.py [--reads N] [--quick]
`--quick` drops config A to 40k reads (smoke mode for CI-like runs).
"""

from __future__ import annotations

import argparse
import pathlib
import random
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
WORK = REPO / ".bench" / "parity_scale"
ORACLE = REPO / ".refsrc" / "ibwa"


def log(msg):
    print(f"[parity_scale] {msg}", file=sys.stderr, flush=True)


def write_fa(path, contigs):
    with open(path, "w") as f:
        for name, seq in contigs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")


def make_ecoli(rng):
    return "".join(rng.choice("ACGT") for _ in range(4_600_000))


def make_repeat_rich(rng):
    """32 Mbp with heavy repeat structure: a 300 bp tandem unit repeated
    thousands of times, 50 kbp segmental duplications, and unique fill."""
    parts = []
    unit = "".join(rng.choice("ACGT") for _ in range(300))
    parts.append(unit * 4000)                      # 1.2 Mbp tandem array
    seg = "".join(rng.choice("ACGT") for _ in range(50_000))
    for _ in range(40):                            # 2 Mbp of seg-dups
        s = list(seg)
        for _ in range(25):                        # 0.05% divergence
            p = rng.randrange(len(s))
            s[p] = rng.choice("ACGT")
        parts.append("".join(s))
    alu = "".join(rng.choice("ACGT") for _ in range(300))
    fill_target = 32_000_000 - sum(len(p) for p in parts)
    blocks = []
    made = 0
    while made < fill_target:
        if rng.random() < 0.08:                    # interspersed repeats
            blocks.append(alu)
            made += len(alu)
        else:
            n = rng.randrange(2000, 12000)
            blocks.append("".join(rng.choice("ACGT") for _ in range(n)))
            made += n
    parts.extend(blocks)
    rng.shuffle(parts)
    return "".join(parts)[:32_000_000]


def sim_reads(path_prefix, seq, n, rng, read_len=100, err=0.01,
              paired=True, isize_mean=300, isize_sd=40):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}

    def mut(s):
        return "".join(c if rng.random() > err else rng.choice("ACGT")
                       for c in s)

    if paired:
        f1 = open(f"{path_prefix}_1.fq", "w")
        f2 = open(f"{path_prefix}_2.fq", "w")
        for i in range(n):
            isz = max(2 * read_len + 10,
                      int(rng.gauss(isize_mean, isize_sd)))
            pos = rng.randrange(0, len(seq) - isz)
            frag = seq[pos:pos + isz]
            a = frag[:read_len]
            b = "".join(comp[c] for c in reversed(frag[-read_len:]))
            f1.write(f"@s{i}\n{mut(a)}\n+\n{'I' * read_len}\n")
            f2.write(f"@s{i}\n{mut(b)}\n+\n{'I' * read_len}\n")
        f1.close()
        f2.close()
        return [f"{path_prefix}_1.fq", f"{path_prefix}_2.fq"]
    with open(f"{path_prefix}.fq", "w") as f:
        for i in range(n):
            pos = rng.randrange(0, len(seq) - read_len)
            s = mut(seq[pos:pos + read_len])
            if rng.random() < 0.5:
                s = "".join(comp[c] for c in reversed(s))
            f.write(f"@s{i}\n{s}\n+\n{'I' * read_len}\n")
    return [f"{path_prefix}.fq"]


def run_ours(args):
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ibwa_tpu"] + args,
                       capture_output=True, cwd=REPO)
    if r.returncode != 0:
        sys.stderr.write(r.stderr.decode()[-2000:])
        raise SystemExit(f"ours failed: {args}")
    log(f"ours {' '.join(args[:2])}...: {time.perf_counter() - t0:.1f}s")
    return r.stdout


def run_ref(args):
    t0 = time.perf_counter()
    r = subprocess.run([str(ORACLE)] + args, capture_output=True)
    if r.returncode != 0:
        sys.stderr.write(r.stderr.decode()[-2000:])
        raise SystemExit(f"oracle failed: {args}")
    log(f"ref  {' '.join(args[:2])}...: {time.perf_counter() - t0:.1f}s")
    return r.stdout


def strip_pg(sam: bytes) -> bytes:
    return b"\n".join(l for l in sam.split(b"\n")
                      if not l.startswith(b"@PG"))


def check_config(name, fa, fqs, paired):
    fa_ref = fa.with_name(fa.stem + "_ref.fa")
    if not fa_ref.with_suffix(".fa.bwt").exists():
        fa_ref.write_bytes(fa.read_bytes())
        log(f"{name}: indexing both")
        run_ours(["index", str(fa)])
        run_ref(["index", str(fa_ref)])

    sais_o, sais_r = [], []
    for e, fq in enumerate(fqs):
        o = run_ours(["aln", str(fa), fq])
        rr = run_ref(["aln", str(fa_ref), fq])
        assert o == rr, f"{name}: .sai end {e} differs"
        log(f"{name}: .sai end {e} byte-identical "
            f"({len(o)} bytes)")
        po = fa.parent / f"{name}.{e}.ours.sai"
        pr = fa.parent / f"{name}.{e}.ref.sai"
        po.write_bytes(o)
        pr.write_bytes(rr)
        sais_o.append(str(po))
        sais_r.append(str(pr))

    if paired:
        o = run_ours(["sampe", "-R", str(fa), sais_o[0], sais_o[1],
                      fqs[0], fqs[1]])
        rr = run_ref(["sampe", "-R", str(fa_ref), sais_r[0], sais_r[1],
                      fqs[0], fqs[1]])
    else:
        o = run_ours(["samse", str(fa), sais_o[0], fqs[0]])
        rr = run_ref(["samse", str(fa_ref), sais_r[0], fqs[0]])
    a, b = strip_pg(o), strip_pg(rr)
    if a != b:
        la, lb = a.split(b"\n"), b.split(b"\n")
        for i, (x, y) in enumerate(zip(la, lb)):
            if x != y:
                log(f"{name}: first SAM diff at line {i}")
                log(f"  ours: {x[:200]!r}")
                log(f"  ref : {y[:200]!r}")
                break
        raise SystemExit(f"{name}: SAM differs")
    log(f"{name}: SAM byte-identical ({len(a)} bytes, "
        f"{len(a.splitlines())} lines)")


def check_se_prefix(name, fa, fq, n_reads):
    """samse across the seam: ours runs all n_reads (multi-batch); the
    oracle — which crashes past 0x40000 reads — runs on seam-truncated
    inputs; the overlapping SAM prefix must match byte-for-byte."""
    import struct
    fa_ref = fa.with_name(fa.stem + "_ref.fa")
    seam = 0x40000
    sai_o = run_ours(["aln", str(fa), fq])
    sai_r = run_ref(["aln", str(fa_ref), fq])
    assert sai_o == sai_r, f"{name}: .sai differs"
    log(f"{name}: .sai byte-identical ({len(sai_o)} bytes, {n_reads} reads)")
    p_ours = fa.parent / f"{name}.ours.sai"
    p_ours.write_bytes(sai_o)
    # truncate inputs at the seam for the oracle
    off = 64
    for _ in range(seam):
        (n,) = struct.unpack_from("<i", sai_o, off)
        off += 4 + 16 * n
    p_trunc = fa.parent / f"{name}.seam.sai"
    p_trunc.write_bytes(sai_o[:off])
    fq_trunc = fa.parent / f"{name}.seam.fq"
    with open(fq, "rb") as f:
        lines = []
        for _ in range(4 * seam):
            lines.append(f.readline())
    fq_trunc.write_bytes(b"".join(lines))

    ours = strip_pg(run_ours(["samse", str(fa), str(p_ours), fq]))
    ref = strip_pg(run_ref(["samse", str(fa_ref), str(p_trunc),
                            str(fq_trunc)]))
    ours_lines = ours.split(b"\n")
    ref_lines = ref.split(b"\n")
    if ref_lines and ref_lines[-1] == b"":
        ref_lines.pop()
    assert len(ours_lines) > len(ref_lines), "ours must cross the seam"
    for i, rl in enumerate(ref_lines):
        if ours_lines[i] != rl:
            log(f"{name}: prefix diff at line {i}")
            log(f"  ours: {ours_lines[i][:200]!r}")
            log(f"  ref : {rl[:200]!r}")
            raise SystemExit(f"{name}: SAM prefix differs")
    log(f"{name}: {len(ref_lines)}-line SAM prefix byte-identical; ours "
        f"continued past the seam to {len(ours_lines)} lines (the "
        f"reference binary segfaults there)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=300_000)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    n_reads = 40_000 if args.quick else args.reads

    WORK.mkdir(parents=True, exist_ok=True)
    if not ORACLE.exists():
        raise SystemExit("oracle missing; run bench.py once to build it")

    # config A: E. coli-scale PE crossing the 0x40000 batch seam
    rng = random.Random(20260817)
    fa_a = WORK / "ecoli.fa"
    if not fa_a.exists():
        log("generating E. coli-scale genome")
        write_fa(fa_a, [("U00096", make_ecoli(rng))])
    seq_a = "".join(l.strip() for l in open(fa_a).readlines()[1:])
    fq_a = WORK / f"ecoli_pe{n_reads}"
    if not pathlib.Path(f"{fq_a}_1.fq").exists():
        log(f"simulating {n_reads} read pairs "
            f"({'crosses' if n_reads > 0x40000 else 'within'} the "
            f"0x40000 batch seam)")
        fqs_a = sim_reads(str(fq_a), seq_a, n_reads, rng)
    else:
        fqs_a = [f"{fq_a}_1.fq", f"{fq_a}_2.fq"]
    check_config("ecoli_pe", fa_a, fqs_a, paired=True)

    # config A': single-end across the seam (drand48 continuity in samse).
    # KNOWN REFERENCE BUG: the iBWA binary SEGFAULTS whenever samse
    # crosses the 0x40000 batch seam (reproduced at 262200 reads: batch 2
    # crashes in "convert to sequence coordinate" — the fork's per-batch
    # dbset bwt load/unload, bwase.c:643-708 + dbset.c:188-238).  So the
    # oracle runs on exactly-seam-truncated inputs and we byte-compare
    # the overlapping prefix of OUR multi-batch run (batch 1 consumes an
    # identical drand48 stream in both).
    fq_se = WORK / f"ecoli_se{n_reads}"
    if not pathlib.Path(f"{fq_se}.fq").exists():
        fqs_se = sim_reads(str(fq_se), seq_a, n_reads, rng, paired=False)
    else:
        fqs_se = [f"{fq_se}.fq"]
    if n_reads <= 0x40000:
        check_config("ecoli_se", fa_a, fqs_se, paired=False)
    else:
        check_se_prefix("ecoli_se", fa_a, fqs_se[0], n_reads)

    # config B: repeat-rich 32 Mbp genome, PE with wide-interval hits
    rngb = random.Random(777333)
    fa_b = WORK / "repeats.fa"
    if not fa_b.exists():
        log("generating repeat-rich 32 Mbp genome")
        write_fa(fa_b, [("rep1", make_repeat_rich(rngb))])
    seq_b = "".join(l.strip() for l in open(fa_b).readlines()[1:])
    n_b = 8000 if args.quick else 40_000
    fq_b = WORK / f"rep_pe{n_b}"
    if not pathlib.Path(f"{fq_b}_1.fq").exists():
        log(f"simulating {n_b} repeat-region read pairs")
        fqs_b = sim_reads(str(fq_b), seq_b, n_b, rngb)
    else:
        fqs_b = [f"{fq_b}_1.fq", f"{fq_b}_2.fq"]
    check_config("repeat_pe", fa_b, fqs_b, paired=True)

    log("ALL SCALE CONFIGS BYTE-IDENTICAL")


if __name__ == "__main__":
    main()
