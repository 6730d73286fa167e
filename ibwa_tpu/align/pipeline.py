"""The `aln` stage driver: reads + FM-indexes -> .sai stream.

Mirrors bwa_aln_core (bwtaln.c:173-241): batches of 0x40000 reads, the
original gap_opt_t written as the stream header, per-read hit records.

Engines:
  * "jax"  — the vectorized device engine (ibwa_tpu.align.engine_jax); reads
             whose search overflows the device stack capacity are re-run on
             the host emulator (identical semantics, reference bwtgap.c
             relies on a 2M-entry heap bound instead)
  * "ref"  — the host emulator for everything (slow; testing only)
"""

from __future__ import annotations

import sys
from typing import BinaryIO

from ..index.builder import load_index
from ..fm.fmindex import FmIndex
from ..io import sai
from ..io.reads import load_reads
from . import engine_ref
from .opts import GapOpt

BATCH_SIZE = 0x40000


def aln_to_stream(prefix: str, fq_path: str, opt: GapOpt, out: BinaryIO,
                  engine: str = "jax") -> int:
    fm_fwd = FmIndex(load_index(prefix, 0))
    fm_rev = FmIndex(load_index(prefix, 1))
    fms = (fm_fwd, fm_rev)

    if opt.mode & 0x20:  # BWA_MODE_BAM (bwtaln.c:162-168)
        from ..io.bam import load_reads_bam
        which = 0
        if opt.mode & 0x40:
            which |= 4
        if opt.mode & 0x80:
            which |= 1
        if opt.mode & 0x100:
            which |= 2
        if which == 0:
            which = 7
        reads = load_reads_bam(fq_path, which, trim_qual=opt.trim_qual,
                               is_comp=bool(opt.mode & 0x02))
    else:
        reads = load_reads(fq_path, trim_qual=opt.trim_qual,
                           is_comp=bool(opt.mode & 0x02),
                           is_64=bool(opt.mode & 0x200),
                           l_bc=opt.mode >> 24)
    sai.write_header(out, opt)
    total = 0
    for start in range(0, len(reads), BATCH_SIZE):
        batch = reads[start:start + BATCH_SIZE]
        seqs = [r.seq for r in batch]
        rseqs = [r.rseq for r in batch]
        if engine == "ref":
            results = engine_ref.align_batch(fms, seqs, rseqs, opt)
        elif engine == "native":
            from .engine_jax import native_align_batch
            results = native_align_batch(fms, seqs, rseqs, opt)
        else:
            from . import engine_jax
            results = engine_jax.align_batch(fms, seqs, rseqs, opt)
        for hits in results:
            sai.write_read_hits(out, hits)
        total += len(batch)
        print(f"[aln] {total} sequences processed", file=sys.stderr)
    return total
