"""Command-line interface mirroring the reference binary's subcommands.

Usage: python -m ibwa_tpu <command> [options]
"""

from __future__ import annotations

import argparse
import sys


def cmd_index(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="ibwa-tpu index")
    ap.add_argument("fasta", help="input FASTA")
    ap.add_argument("-p", "--prefix", default=None,
                    help="index prefix [fasta path]")
    ap.add_argument("-c", action="store_true",
                    help="build for color-space (SOLiD) reads")
    ap.add_argument("-a", default="is", choices=["is", "bwtsw", "div"],
                    help="construction algorithm (all via SA-IS; the "
                         "BWT is unique so artifacts are identical)")
    args = ap.parse_args(argv)
    from .index.builder import bwa_index
    bwa_index(args.fasta, args.prefix, color=args.c)
    return 0


def cmd_aln(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="ibwa-tpu aln")
    ap.add_argument("prefix")
    ap.add_argument("fastq")
    ap.add_argument("-n", default=None,
                    help="max #diff (int) or missing prob (float)")
    ap.add_argument("-o", type=int, default=None, help="max gap opens")
    ap.add_argument("-e", type=int, default=-1, help="max gap extensions")
    ap.add_argument("-i", type=int, default=None, help="indel end skip")
    ap.add_argument("-d", type=int, default=None, help="max del occ")
    ap.add_argument("-l", type=int, default=None, help="seed length")
    ap.add_argument("-k", type=int, default=None, help="max seed diff")
    ap.add_argument("-m", type=int, default=None, help="max entries")
    ap.add_argument("-M", type=int, default=None, help="mismatch penalty")
    ap.add_argument("-O", type=int, default=None, help="gap open penalty")
    ap.add_argument("-E", type=int, default=None, help="gap extend penalty")
    ap.add_argument("-R", type=int, default=None, help="max equally-best")
    ap.add_argument("-q", type=int, default=None, help="trim quality")
    ap.add_argument("-N", action="store_true", help="non-iterative mode")
    ap.add_argument("-t", type=int, default=1,
                    help="host threads (device path is batch-parallel; "
                         "this caps the native fallback's OpenMP pool)")
    ap.add_argument("-c", action="store_true", help="color-space reads")
    ap.add_argument("-b", action="store_true", help="BAM input")
    ap.add_argument("-B", type=int, default=0, help="barcode length")
    ap.add_argument("-I", action="store_true",
                    help="input is Illumina 1.3+ quality (64-based)")
    ap.add_argument("-0", dest="b0", action="store_true",
                    help="BAM: use single-end reads only")
    ap.add_argument("-1", dest="b1", action="store_true",
                    help="BAM: use read1 only")
    ap.add_argument("-2", dest="b2", action="store_true",
                    help="BAM: use read2 only")
    ap.add_argument("-f", default=None, help="output file [stdout]")
    ap.add_argument("--engine", default="jax", choices=["jax", "native", "ref"])
    args = ap.parse_args(argv)

    from .align.opts import GapOpt, BWA_MODE_GAPE, BWA_MODE_NONSTOP
    from .align.pipeline import aln_to_stream
    opt = GapOpt()
    if args.n is not None:
        if "." in args.n:
            opt.fnr, opt.max_diff = float(args.n), -1
        else:
            opt.max_diff, opt.fnr = int(args.n), -1.0
    if args.o is not None:
        opt.max_gapo = args.o
    if args.e > 0:
        opt.max_gape = args.e
        opt.mode &= ~BWA_MODE_GAPE
    for flag, attr in [("i", "indel_end_skip"), ("d", "max_del_occ"),
                       ("l", "seed_len"), ("k", "max_seed_diff"),
                       ("m", "max_entries"), ("M", "s_mm"), ("O", "s_gapo"),
                       ("E", "s_gape"), ("R", "max_top2"), ("q", "trim_qual")]:
        v = getattr(args, flag)
        if v is not None:
            setattr(opt, attr, v)
    if args.N:
        opt.mode |= BWA_MODE_NONSTOP
        opt.max_top2 = 0x7FFFFFFF
    opt.n_threads = args.t
    if args.t > 0:
        import os
        os.environ.setdefault("OMP_NUM_THREADS", str(args.t))
    if args.c:
        opt.mode &= ~0x02  # clear BWA_MODE_COMPREAD (bwtaln.c:262)
    if args.b:
        opt.mode |= 0x20
    if args.b0:
        opt.mode |= 0x40
    if args.b1:
        opt.mode |= 0x80
    if args.b2:
        opt.mode |= 0x100
    if args.I:
        opt.mode |= 0x200
    if args.B:
        opt.mode |= args.B << 24
    out = open(args.f, "wb") if args.f else sys.stdout.buffer
    try:
        aln_to_stream(args.prefix, args.fastq, opt, out, engine=args.engine)
    finally:
        if args.f:
            out.close()
    return 0


def cmd_samse(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="ibwa-tpu samse")
    ap.add_argument("prefix")
    ap.add_argument("sai")
    ap.add_argument("fastq")
    ap.add_argument("-n", type=int, default=3, help="max XA hits")
    ap.add_argument("-f", default=None, help="output file [stdout]")
    ap.add_argument("-r", default=None, help="@RG header line")
    args = ap.parse_args(argv)
    from .sam.bwase import sai2sam_se, parse_rg
    rg_line = rg_id = None
    if args.r is not None:
        rg_line, rg_id = parse_rg(args.r)
        if rg_id is None:
            print(f"[{__name__}] malformated @RG line", file=sys.stderr)
            return 1
    out = open(args.f, "w") if args.f else sys.stdout
    try:
        sai2sam_se(args.prefix, args.sai, args.fastq, n_occ=args.n,
                   out=out, rg_line=rg_line, rg_id=rg_id)
    finally:
        if args.f:
            out.close()
    return 0


def cmd_sampe(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="ibwa-tpu sampe")
    ap.add_argument("args", nargs="+",
                    help="<prefix> <1.sai> <2.sai> <1.fq> <2.fq> "
                         "[<prefix2> <sai> <sai> ...]")
    ap.add_argument("-a", type=int, default=500, help="max insert size")
    ap.add_argument("-o", type=int, default=100000, help="max occ per end")
    ap.add_argument("-n", type=int, default=3, help="max multi hits")
    ap.add_argument("-N", type=int, default=10, help="max discordant hits")
    ap.add_argument("-c", type=float, default=1e-5, help="chimeric prior")
    ap.add_argument("-f", default=None, help="output file [stdout]")
    ap.add_argument("-r", default=None, help="@RG header line")
    ap.add_argument("-s", action="store_true", help="disable mate SW")
    ap.add_argument("-A", action="store_true", help="disable isize estimate")
    ap.add_argument("-R", action="store_true", help="enable remapping")
    ap.add_argument("-P", action="store_true", help="preload index")
    ap.add_argument("-t", type=int, default=1, help="threads")
    args = ap.parse_args(argv)
    pos = args.args
    if len(pos) < 5 or (len(pos) - 5) % 3 != 0:
        print("usage: sampe <prefix> <1.sai> <2.sai> <1.fq> <2.fq> ...",
              file=sys.stderr)
        return 1
    prefixes = [pos[0]]
    sai_pairs = [(pos[1], pos[2])]
    fq1, fq2 = pos[3], pos[4]
    i = 5
    while i < len(pos):
        prefixes.append(pos[i])
        sai_pairs.append((pos[i + 1], pos[i + 2]))
        i += 3
    from .sam.bwase import parse_rg
    from .sam.sampe import PeOpt, sai2sam_pe
    popt = PeOpt(max_isize=args.a, max_occ=args.o, n_multi=args.n,
                 N_multi=args.N, ap_prior=args.c,
                 is_sw=0 if args.s else 1, force_isize=1 if args.A else 0,
                 remapping=1 if args.R else 0, n_threads=args.t)
    rg_line = rg_id = None
    if args.r is not None:
        rg_line, rg_id = parse_rg(args.r)
        if rg_id is None:
            print("[sampe] malformated @RG line", file=sys.stderr)
            return 1
    out = open(args.f, "w") if args.f else sys.stdout
    try:
        sai2sam_pe(prefixes, sai_pairs, fq1, fq2, popt, out=out,
                   rg_line=rg_line, rg_id=rg_id)
    finally:
        if args.f:
            out.close()
    return 0


def _two_arg(fn):
    def cmd(argv: list[str]) -> int:
        if len(argv) != 2:
            print("expected: <in> <out>", file=sys.stderr)
            return 1
        fn(argv[0], argv[1])
        return 0
    return cmd


def cmd_fa2pac(argv: list[str]) -> int:
    from .index.builder import fa2pac
    if not argv:
        print("expected: <in.fasta> [<out.prefix>]", file=sys.stderr)
        return 1
    fa2pac(argv[0], argv[1] if len(argv) > 1 else None)
    return 0


def cmd_bwtupdate(argv: list[str]) -> int:
    from .index.builder import bwtupdate
    if len(argv) != 1:
        print("expected: <the.bwt>", file=sys.stderr)
        return 1
    bwtupdate(argv[0])
    return 0


def cmd_bwt2sa(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="ibwa-tpu bwt2sa")
    ap.add_argument("bwt")
    ap.add_argument("sa")
    ap.add_argument("-i", type=int, default=32, help="SA interval")
    args = ap.parse_args(argv)
    from .index.builder import bwt2sa
    bwt2sa(args.bwt, args.sa, args.i)
    return 0


def cmd_bwasw(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="ibwa-tpu bwasw")
    ap.add_argument("prefix")
    ap.add_argument("query")
    ap.add_argument("-a", type=int, default=1, help="match score")
    ap.add_argument("-b", type=int, default=3, help="mismatch penalty")
    ap.add_argument("-q", type=int, default=5, help="gap open penalty")
    ap.add_argument("-r", type=int, default=2, help="gap extension penalty")
    ap.add_argument("-w", type=int, default=50, help="band width")
    ap.add_argument("-T", type=int, default=30, help="score threshold")
    ap.add_argument("-z", type=int, default=1, help="Z-best")
    ap.add_argument("-s", type=int, default=3, help="max seed interval")
    ap.add_argument("-m", type=float, default=0.5, help="mask level")
    ap.add_argument("-c", type=float, default=5.5, help="length coef")
    ap.add_argument("-N", type=int, default=5, help="seeds to trigger rev")
    ap.add_argument("-H", action="store_true", help="hard clipping")
    ap.add_argument("-t", type=int, default=1, help="threads")
    ap.add_argument("-f", default=None, help="output file [stdout]")
    args = ap.parse_args(argv)
    from .bwasw.aux import bsw2_aln
    from .bwasw.core import Bsw2Opt
    opt = Bsw2Opt(a=args.a, b=args.b, q=args.q, r=args.r, bw=args.w,
                  t=args.T, z=args.z, is_=args.s, mask_level=args.m,
                  coef=args.c, t_seeds=args.N,
                  hard_clip=1 if args.H else 0, n_threads=args.t)
    # bwtsw2_main.c:82-83: scale t and coef by the match score
    opt.t *= opt.a
    opt.coef *= opt.a
    out = open(args.f, "w") if args.f else sys.stdout
    try:
        bsw2_aln(opt, args.prefix, args.query, out=out)
    finally:
        if args.f:
            out.close()
    return 0


def cmd_stdsw(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="ibwa-tpu stdsw")
    ap.add_argument("long_fa")
    ap.add_argument("short_fa")
    ap.add_argument("-T", type=int, default=1, help="minimum score")
    ap.add_argument("-g", action="store_true", help="global alignment")
    ap.add_argument("-f", action="store_true", help="forward strand only")
    ap.add_argument("-r", action="store_true", help="reverse strand only")
    args = ap.parse_args(argv)
    strand = (1 if args.f else 0) | (2 if args.r else 0)
    if strand == 0:
        strand = 3
    from .tools.stdsw import stdsw
    stdsw(args.long_fa, args.short_fa, thres=args.T,
          is_global=args.g, strand=strand)
    return 0


def cmd_qualfa2fq(argv: list[str]) -> int:
    if len(argv) != 2:
        print("usage: qualfa2fq <in.fasta> <in.qual>", file=sys.stderr)
        return 1
    from .tools.convert import qualfa2fq
    qualfa2fq(argv[0], argv[1])
    return 0


def cmd_solid2fastq(argv: list[str]) -> int:
    if len(argv) != 2:
        print("usage: solid2fastq <in.prefix> <out.prefix>",
              file=sys.stderr)
        return 1
    from .tools.convert import solid2fastq
    solid2fastq(argv[0], argv[1])
    return 0


def cmd_prepare_remap(argv: list[str]) -> int:
    """.remap generation from a GRC release tree (parse/prepare-grch37.pl)."""
    from .tools.prepare_remap import main as pr_main
    return pr_main(argv)


def _cmds():
    from .index.builder import pac2bwt, pac_rev, pac2cspac
    return {
        "index": cmd_index,
        "aln": cmd_aln,
        "samse": cmd_samse,
        "sampe": cmd_sampe,
        "fa2pac": cmd_fa2pac,
        "pac2bwt": _two_arg(pac2bwt),
        "pac2bwtgen": _two_arg(pac2bwt),  # same artifact; see builder.py
        "bwtupdate": cmd_bwtupdate,
        "pac_rev": _two_arg(pac_rev),
        "bwt2sa": cmd_bwt2sa,
        "pac2cspac": _two_arg(pac2cspac),
        "stdsw": cmd_stdsw,
        "qualfa2fq": cmd_qualfa2fq,
        "solid2fastq": cmd_solid2fastq,
        "bwasw": cmd_bwasw,
        "prepare-remap": cmd_prepare_remap,
    }


COMMANDS = _cmds()


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("ibwa-tpu — iterative read aligner (JAX device engine)",
              file=sys.stderr)
        print(f"commands: {', '.join(COMMANDS)}", file=sys.stderr)
        return 1
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"[ibwa-tpu] unrecognized command '{cmd}'", file=sys.stderr)
        return 1
    from .compile_cache import enable
    enable()
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
