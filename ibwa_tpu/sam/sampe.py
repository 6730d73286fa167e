"""sampe: paired-end .sai pairs -> SAM (the reference's bwape.c +
bwapair.c + filter_alignments.cpp + bwasw.c mate rescue).

Faithful to the reference's control flow, including its quirks:
  * primary selection succeeds only when `remap()` reports status 1,
    which only happens under -R (bwape.c:299-369 + remap macro
    bwape.c:223-235) — so sampe without -R unmaps every read, and -R is
    the de-facto default path;
  * drand48 consumption: one draw per best-group hit plus one cached draw
    per replacement (select_sai_ibwa), in read order, end 0 then end 1.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import TextIO

import numpy as np

from .. import native
from ..align.engine_ref import Hit
from ..align.opts import BWA_AVG_ERR, GapOpt, cal_maxdiff
from ..io import sai
from ..io.reads import load_reads
from ..rng import Rand48
from . import bwase
from .bwase import (AlnSeq, Multi, SAM_FPD, SAM_FPP, SAM_FR1, SAM_FR2,
                    TYPE_MATESW, TYPE_NO_MATCH, TYPE_REPEAT, TYPE_UNIQUE,
                    G_LOG_N, approx_mapQ, cigar_create, cigar_len, cigar_op,
                    print_sam1, print_sam_PG, refine_gapped)
from .dbset import DbSet

MIN_HASH_WIDTH = 1000
SW_MIN_MATCH_LEN = 20
SW_MIN_MAPQ = 17
FROM_M, FROM_I, FROM_D, FROM_S = 0, 1, 2, 3
U64_MAX = (1 << 64) - 1


@dataclasses.dataclass
class PeOpt:
    """pe_opt_t defaults (bwa_init_pe_opt, bwape.c:72-87)."""

    max_isize: int = 500
    force_isize: int = 0
    max_occ: int = 100000
    n_multi: int = 3
    N_multi: int = 10
    is_sw: int = 1
    ap_prior: float = 1e-5
    n_threads: int = 1
    remapping: int = 0
    is_preload: int = 0


@dataclasses.dataclass
class IsizeInfo:
    avg: float = -1.0
    std: float = -1.0
    ap_prior: float = 0.0
    low: int = 0
    high: int = 0
    high_bayesian: int = 0


@dataclasses.dataclass
class Alignment:
    """alignment_t (saiset.h): one .sai record + its source db."""

    aln: Hit
    dbidx: int


@dataclasses.dataclass
class Position:
    """position_t (bwapair.h)."""

    pos: int
    remapped_pos: int
    idx_and_end: int
    dbidx: int = 0
    remapped_seqid: int = -1
    remap_identical: int = 0
    n_gapo: int = 0
    n_gape: int = 0
    len: int = 0
    score: int = 0


def unmap_read(s: AlnSeq) -> None:
    s.type = TYPE_NO_MATCH
    s.pos = s.remapped_pos = s.sa = s.c1 = s.c2 = 0
    s.cigar = None


def alngrp_create(saisets, which: int, s_mm: int, count: int
                  ) -> list[Alignment]:
    """alngrp_create (saiset.c:45-78): merge per-db hits, sort + filter."""
    ag: list[Alignment] = []
    for i in range(count):
        hits = sai.read_read_hits(saisets[which][i]) or []
        ag.extend(Alignment(aln=h, dbidx=i) for h in hits)
    if count > 1 and ag:
        ag.sort(key=lambda a: a.aln.score)  # stable ~ ksort insertion
        best = ag[0].aln.score
        for i, a in enumerate(ag):
            if a.aln.score > best + s_mm:
                del ag[i:]
                break
    return ag


def do_remap(p, dbs: DbSet, dbidx: int, remapping: int) -> int:
    """The remap macro (bwape.c:223-235).  Returns the status flag; the
    C code leaves status untouched (0) when remapping is off."""
    p.dbidx = dbidx
    db = dbs.dbs[dbidx]
    if remapping:
        if db.remap is None:  # __remap fast path (bwape.c:205-209)
            p.remapped_seqid = -1
            p.remapped_pos = p.pos
            return 1
        from . import remap as remap_mod
        gap = p.n_gapo + p.n_gape
        return remap_mod.remap_entry(p, dbs, dbidx, gap)
    p.remapped_pos = p.pos
    p.remapped_seqid = -1
    return 0


def select_sai_ibwa(dbs: DbSet, ag: list[Alignment], s: AlnSeq,
                    max_diff: int, remapping: int, rng: Rand48) -> None:
    """select_sai_ibwa (bwape.c:299-369)."""
    if not ag:
        unmap_read(s)
        return

    main_idx = 0
    selected = False
    rng_cache = 0.0
    best = ag[0].aln.score
    cnt = 0
    i = 0
    while i < len(ag):
        p = ag[i].aln
        naln = p.l - p.k + 1
        if p.score > best:
            break
        if rng.drand48() * (p.l - p.k + 1 + cnt) > float(cnt):
            main_idx = i
            rng_cache = rng.drand48()
        cnt += naln
        i += 1
    group_start = main_idx
    top_end = i

    s.c1 = cnt
    for t in range(top_end, len(ag)):
        cnt += ag[t].aln.l - ag[t].aln.k + 1
    s.c2 = cnt - s.c1
    if s.c1 != 0:
        s.type = TYPE_REPEAT if s.c1 > 1 else TYPE_UNIQUE

    while True:
        main_aln = ag[main_idx]
        p = main_aln.aln
        num = p.l - p.k + 1
        start_idx = int(rng_cache * num)
        aidx = start_idx
        while True:
            s.sa = p.k + aidx
            s.n_mm, s.n_gapo, s.n_gape = p.n_mm, p.n_gapo, p.n_gape
            s.strand = p.a
            s.score = p.score
            s.pos = int(dbs.dbs[main_aln.dbidx].sa2seq(
                s.strand, np.array([s.sa]), s.len)[0])
            status = do_remap(s, dbs, main_aln.dbidx, remapping)
            if status == 1:
                selected = True
                break
            aidx += 1
            if aidx >= num:
                aidx = 0
            if aidx == start_idx:
                break
        i += 1
        if i >= top_end:
            i = 0
        if selected or i == group_start:
            break

    if not selected:
        unmap_read(s)
        print(f"Failed to select primary alignment for {s.read.name}",
              file=sys.stderr)
        return
    s.seQ = s.mapQ = approx_mapQ(s, max_diff)


def infer_isize(seqs: tuple[list[AlnSeq], list[AlnSeq]], ii: IsizeInfo,
                ap_prior: float, L: int) -> int:
    """infer_isize (bwape.c:103-199)."""
    isizes = []
    max_len = 1
    for p0, p1 in zip(*seqs):
        x = (p1.pos + p1.len - p0.pos if p0.pos < p1.pos
             else p0.pos + p0.len - p1.pos)
        if p0.mapQ >= 20 and p1.mapQ >= 20 and x < 100000:
            isizes.append(x)
        max_len = max(max_len, p0.len, p1.len)
    return _isize_stats(isizes, max_len, ii, ap_prior, L)


def infer_isize_arrays(i64: np.ndarray, i32: np.ndarray, lens: np.ndarray,
                       ii: IsizeInfo, ap_prior: float, L: int) -> int:
    """infer_isize over the raw state arrays (native emit path)."""
    from .pe_native import NF32, NF64
    pos = i64.reshape(-1, NF64)[:, 0]
    mq = i32.reshape(-1, NF32)[:, 6]
    p0, p1 = pos[0::2], pos[1::2]
    l0 = lens[0::2].astype(np.int64)
    l1 = lens[1::2].astype(np.int64)
    x = np.where(p0 < p1, p1 + l1 - p0, p0 + l0 - p1)
    good = (mq[0::2] >= 20) & (mq[1::2] >= 20) & (x < 100000)
    max_len = int(lens.max()) if len(lens) else 1
    return _isize_stats([int(v) for v in x[good]], max_len, ii, ap_prior, L)


def _isize_stats(isizes: list[int], max_len: int, ii: IsizeInfo,
                 ap_prior: float, L: int) -> int:
    ii.avg = ii.std = -1.0
    ii.low = ii.high = ii.high_bayesian = 0
    tot = len(isizes)
    if tot < 20:
        print("[infer_isize] fail to infer insert size: too few good pairs",
              file=sys.stderr)
        return -1
    isizes.sort()
    p25 = isizes[int(tot * 0.25 + 0.5)]
    p50 = isizes[int(tot * 0.50 + 0.5)]
    p75 = isizes[int(tot * 0.75 + 0.5)]
    tmp = int(p25 - 2.0 * (p75 - p25) + 0.499)
    ii.low = tmp if tmp > max_len else max_len
    ii.high = int(p75 + 2.0 * (p75 - p25) + 0.499)
    n = 0
    x = 0
    for v in isizes:
        if ii.low <= v <= ii.high:
            n += 1
            x += v
    ii.avg = x / n
    std_acc = -1.0  # reference quirk: ii->std accumulates from -1.0
    for v in isizes:
        if ii.low <= v <= ii.high:
            std_acc += (v - ii.avg) ** 2
    ii.std = math.sqrt(std_acc / n)
    y = 1.0
    while y < 10.0:
        if 0.5 * math.erfc(y / math.sqrt(2)) < ap_prior / L * (y * ii.std
                                                               + ii.avg):
            break
        y += 0.01
    ii.high_bayesian = int(y * ii.std + ii.avg + 0.499)
    n_ap = sum(1 for v in isizes if v > ii.high_bayesian)
    ii.ap_prior = 0.01 * (n_ap + 0.01) / tot
    if ii.ap_prior < ap_prior:
        ii.ap_prior = ap_prior
    print(f"[infer_isize] (25, 50, 75) percentile: ({p25}, {p50}, {p75})",
          file=sys.stderr)
    if math.isnan(ii.std) or p75 > 100000:
        ii.low = ii.high = ii.high_bayesian = 0
        ii.avg = ii.std = -1.0
        print("[infer_isize] fail to infer insert size: weird pairing",
              file=sys.stderr)
        return -1
    y = 1.0
    while y < 10.0:
        if 0.5 * math.erfc(y / math.sqrt(2)) < ap_prior / L * (y * ii.std
                                                               + ii.avg):
            break
        y += 0.01
    ii.high_bayesian = int(y * ii.std + ii.avg + 0.499)
    print(f"[infer_isize] inferred external isize from {n} pairs: "
          f"{ii.avg:.3f} +/- {ii.std:.3f}", file=sys.stderr)
    print(f"[infer_isize] inferred maximum insert size: {ii.high_bayesian} "
          f"({y:.2f} sigma)", file=sys.stderr)
    return 0


def compute_seq_coords_and_counts(dbs: DbSet, remapping: int,
                                  aln: tuple[list[Alignment], ...],
                                  p: tuple[AlnSeq, AlnSeq]
                                  ) -> list[Position]:
    """compute_seq_coords_and_counts (filter_alignments.cpp:53-142)."""
    arr: list[Position] = []
    for j in range(2):
        pos2score: dict[int, Alignment] = {}
        min_score = 2**31 - 1
        for k, ar in enumerate(aln[j]):
            min_score = min(min_score, ar.aln.score)
            db = dbs.dbs[ar.dbidx]
            sa_idx = np.arange(ar.aln.k, ar.aln.l + 1, dtype=np.uint32)
            positions = db.sa2seq(ar.aln.a, sa_idx, p[j].len)
            for pos in positions:
                pos = int(pos)
                if pos < db.offset or pos >= db.offset + db.bns.l_pac:
                    continue
                ap = Position(pos=pos, remapped_pos=0, idx_and_end=k << 1 | j,
                              n_gape=ar.aln.n_gape, n_gapo=ar.aln.n_gapo,
                              len=p[j].len, score=ar.aln.score)
                status = do_remap(ap, dbs, ar.dbidx, remapping)
                if not status:
                    continue
                arr.append(ap)
                prev = pos2score.get(ap.remapped_pos)
                if prev is None:
                    pos2score[ap.remapped_pos] = ar
                elif ar.aln.score < prev.aln.score:
                    pos2score[ap.remapped_pos] = ar
        total = [0, 0]
        for a in pos2score.values():
            total[0 if a.aln.score == min_score else 1] += 1
        p[j].c1 = total[0]
        p[j].c2 = total[1]
        if p[j].c1 != 0:
            p[j].type = TYPE_REPEAT if p[j].c1 > 1 else TYPE_UNIQUE
    return arr


def _hash_64(key: int) -> int:
    m = U64_MAX
    key = (key + (~(key << 32) & m)) & m
    key ^= key >> 22
    key = (key + (~(key << 13) & m)) & m
    key ^= key >> 8
    key = (key + (key << 3)) & m
    key ^= key >> 15
    key = (key + (~(key << 27) & m)) & m
    key ^= key >> 31
    return key


def _mappings_overlap(a: Position, b: Position) -> bool:
    if a.pos == U64_MAX or b.pos == U64_MAX:
        return False
    return (a.remapped_pos == b.remapped_pos
            and (a.idx_and_end & 1) == (b.idx_and_end & 1))


def _select_mapping(aln, arr: list[Position], begin: int, end: int
                    ) -> tuple[Position, int]:
    """select_mapping (bwapair.c:62-96); n_optimal stays 1 as in the C."""
    best = arr[begin]
    seen = set()
    # reference quirk: seeds the set from arr[0], not arr[begin]
    if arr[0].pos == arr[0].remapped_pos:
        seen.add(arr[0].pos)
    for i in range(begin + 1, end + 1):
        p = arr[i]
        if p.pos == p.remapped_pos:
            seen.add(p.pos)
        else:
            if p.remapped_pos in seen and p.remap_identical:
                continue
        if p.score < best.score:
            best = p
    return best, 1


class _PairingState:
    def __init__(self, max_len: int):
        self.o_n = 0
        self.subo_n = 0
        self.cnt_chg = 0
        self.max_len = max_len
        dummy = Position(pos=U64_MAX, remapped_pos=U64_MAX, idx_and_end=0)
        self.last_pos = [[dummy, dummy], [dummy, dummy]]
        self.o_pos: list[Position | None] = [None, None]
        self.o_score = U64_MAX
        self.subo_score = U64_MAX


def _pairing_aux(p, opt: PeOpt, ii: IsizeInfo, pint: _PairingState,
                 u: Position, v: Position, n_optimal: int) -> None:
    """pairing_aux (bwapair.c:98-147); v >= u in remapped order."""
    # l is a 32-bit bwtint_t in the reference (bwapair.c:105) — keep wraps
    if (u.remapped_pos != u.pos and v.remapped_pos != v.pos
            and u.dbidx == v.dbidx
            and u.remapped_seqid == v.remapped_seqid):
        l = (v.pos + p[v.idx_and_end & 1].len - u.pos) & 0xFFFFFFFF
    else:
        l = (v.remapped_pos + p[v.idx_and_end & 1].len
             - u.remapped_pos) & 0xFFFFFFFF
    if not (u.remapped_pos != U64_MAX and v.remapped_pos > u.remapped_pos
            and l >= pint.max_len
            and ((ii.high and l <= ii.high_bayesian)
                 or (ii.high == 0 and l <= opt.max_isize))):
        return
    s = v.score + u.score
    s *= 10
    if ii.high:
        s += int(-4.343 * math.log(
            0.5 * math.erfc(abs(l - ii.avg) / ii.std / math.sqrt(2)))
            + 0.499)
    s = ((s << 32) | (_hash_64((u.remapped_pos << 32 | v.remapped_pos)
                               & U64_MAX) & 0xFFFFFFFF)) & U64_MAX

    if s >> 32 == pint.o_score >> 32:
        pint.o_n += n_optimal
    elif s >> 32 < pint.o_score >> 32:
        pint.subo_n += pint.o_n
        pint.o_n = n_optimal
    else:
        pint.subo_n += 1

    if s < pint.o_score:
        pint.subo_score = pint.o_score
        pint.o_score = s
        pint.o_pos[u.idx_and_end & 1] = u
        pint.o_pos[v.idx_and_end & 1] = v
    elif s < pint.subo_score:
        pint.subo_score = s


def _pairing_aux2(aln, pint: _PairingState, read: AlnSeq,
                  pos: Position) -> None:
    """pairing_aux2 (bwapair.c:149-163)."""
    r = aln[pos.idx_and_end & 1][pos.idx_and_end >> 1].aln
    read.extra_flag |= SAM_FPP
    if read.pos != pos.pos or read.strand != r.a:
        read.n_mm, read.n_gapo, read.n_gape = r.n_mm, r.n_gapo, r.n_gape
        read.strand = r.a
        read.score = r.score
        read.pos = pos.pos
        read.dbidx = pos.dbidx
        read.remapped_pos = pos.remapped_pos
        read.remapped_seqid = pos.remapped_seqid
        if read.mapQ > 0:
            pint.cnt_chg += 1


def find_optimal_pair(p: tuple[AlnSeq, AlnSeq], arr: list[Position],
                      aln, opt: PeOpt, s_mm: int, ii: IsizeInfo) -> int:
    """find_optimal_pair (bwapair.c:168-279)."""
    pint = _PairingState(max(p[0].read.full_len, p[1].read.full_len))
    arr.sort(key=lambda a: (a.remapped_pos, a.pos))
    i = 0
    n = len(arr)
    while i < n:
        pos = arr[i]
        a = aln[pos.idx_and_end & 1][pos.idx_and_end >> 1].aln
        strand = a.a
        n_optimal = 1
        if i < n - 1:
            k = i
            while k + 1 < n and _mappings_overlap(pos, arr[k + 1]):
                k += 1
            if k > i:
                pos, n_optimal = _select_mapping(aln, arr, i, k)
                i = k
        if strand == 1:
            y = 1 - (pos.idx_and_end & 1)
            _pairing_aux(p, opt, ii, pint, pint.last_pos[y][1], pos,
                         n_optimal)
            _pairing_aux(p, opt, ii, pint, pint.last_pos[y][0], pos,
                         n_optimal)
        else:
            e = pos.idx_and_end & 1
            pint.last_pos[e][0] = pint.last_pos[e][1]
            pint.last_pos[e][1] = pos
        i += 1

    if pint.o_score != U64_MAX:
        mapQ_p = 0
        if pint.o_n == 1:
            if pint.subo_score == U64_MAX:
                mapQ_p = 29
            elif (pint.subo_score >> 32) - (pint.o_score >> 32) > s_mm * 10:
                mapQ_p = 23
            else:
                nn = min(pint.subo_n, 255)
                mapQ_p = ((pint.subo_score >> 32)
                          - (pint.o_score >> 32)) // 2 - G_LOG_N[nn]
                if mapQ_p < 0:
                    mapQ_p = 0
        rr = [aln[pint.o_pos[0].idx_and_end & 1]
              [pint.o_pos[0].idx_and_end >> 1].aln.a,
              aln[pint.o_pos[1].idx_and_end & 1]
              [pint.o_pos[1].idx_and_end >> 1].aln.a]
        same0 = (p[0].remapped_pos == pint.o_pos[0].remapped_pos
                 and p[0].strand == rr[0])
        same1 = (p[1].remapped_pos == pint.o_pos[1].remapped_pos
                 and p[1].strand == rr[1])
        if same0 and same1:
            if p[0].mapQ > 0 and p[1].mapQ > 0:
                mq = min(p[0].mapQ + p[1].mapQ, 60)
                p[0].mapQ = p[1].mapQ = mq
            else:
                if p[0].mapQ == 0:
                    p[0].mapQ = min(mapQ_p + 7, p[1].mapQ)
                if p[1].mapQ == 0:
                    p[1].mapQ = min(mapQ_p + 7, p[0].mapQ)
        elif same0:  # end 1 moved
            p[1].seQ = 0
            p[1].mapQ = min(p[0].mapQ, mapQ_p)
        elif same1:  # end 0 moved
            p[0].seQ = 0
            p[0].mapQ = min(p[1].mapQ, mapQ_p)
        else:  # both moved
            p[0].seQ = p[1].seQ = 0
            mapQ_p = max(mapQ_p - 20, 0)
            p[0].mapQ = p[1].mapQ = mapQ_p
        _pairing_aux2(aln, pint, p[0], pint.o_pos[0])
        _pairing_aux2(aln, pint, p[1], pint.o_pos[1])
    return pint.cnt_chg


def select_sai_multi(dbs: DbSet, ag: list[Alignment], s: AlnSeq,
                     n_multi: int, rng: Rand48) -> None:
    """select_sai_multi (saiset.c:113-161): XA hits, positions resolved."""
    n_occ = sum(q.aln.l - q.aln.k + 1 for q in ag)
    s.multi = []
    if n_occ > n_multi + 1:
        return
    rest = n_occ
    z: list[Multi] = []
    for a in ag:
        q = a.aln
        db = dbs.dbs[a.dbidx]
        if q.l - q.k + 1 <= rest:
            sa_idx = np.arange(q.k, q.l + 1, dtype=np.uint32)
            for pos in db.sa2seq(q.a, sa_idx, s.len):
                z.append(Multi(pos=int(pos), gap=q.n_gapo + q.n_gape,
                               mm=q.n_mm, strand=q.a, dbidx=a.dbidx))
            rest -= q.l - q.k + 1
        else:  # "we never come here"
            j = rest
            i2 = q.l - q.k + 1
            while j > 0:
                pp = 1.0
                x = rng.drand48()
                while x < pp:
                    pp -= pp * j / i2
                    i2 -= 1
                pos = int(db.sa2seq(q.a, np.array([q.l - 1]), s.len)[0])
                z.append(Multi(pos=pos, gap=q.n_gapo + q.n_gape,
                               mm=q.n_mm, strand=q.a, dbidx=a.dbidx))
                j -= 1
            break
    z = [m for m in z if m.pos != s.pos]
    s.multi = z[:n_multi]


def _batch_max_diffs_lens(lens: np.ndarray, gopt: GapOpt) -> np.ndarray:
    """Per-end-read max_diff from the clip-length array."""
    if gopt.fnr > 0.0:
        by_len = {int(v): cal_maxdiff(int(v), BWA_AVG_ERR, gopt.fnr)
                  for v in np.unique(lens)}
        return np.array([by_len[int(v)] for v in lens], dtype=np.int32)
    return np.full(len(lens), gopt.max_diff, dtype=np.int32)


def _apply_isize_fallbacks(ii: IsizeInfo, last_ii: IsizeInfo,
                           popt: PeOpt) -> None:
    if ii.avg < 0.0 and last_ii.avg > 0.0:
        (ii.avg, ii.std, ii.ap_prior, ii.low, ii.high, ii.high_bayesian) = (
            last_ii.avg, last_ii.std, last_ii.ap_prior, last_ii.low,
            last_ii.high, last_ii.high_bayesian)
    if popt.force_isize:
        print("[cal_pac_pos_pe] discard insert size estimate as user's "
              "request.", file=sys.stderr)
        ii.low = ii.high = 0
        ii.avg = ii.std = -1.0


def cal_pac_pos_pe(dbs: DbSet, seqs, saisets, count: int, ii: IsizeInfo,
                   popt: PeOpt, gopt: GapOpt, last_ii: IsizeInfo,
                   rng: Rand48) -> int:
    """bwa_cal_pac_pos_pe (bwape.c:371-442)."""
    n_seqs = len(seqs[0])
    aln_buf: list[list[list[Alignment]]] = [[], []]

    # SE stage — serial, consumes drand48 in read order
    for i in range(n_seqs):
        for j in range(2):
            p = seqs[j][i]
            p.multi = []
            p.extra_flag |= SAM_FPD | (SAM_FR1 if j == 0 else SAM_FR2)
            ag = alngrp_create(saisets, j, gopt.s_mm, count)
            aln_buf[j].append(ag)
            max_diff = (cal_maxdiff(p.len, BWA_AVG_ERR, gopt.fnr)
                        if gopt.fnr > 0.0 else gopt.max_diff)
            select_sai_ibwa(dbs, ag, p, max_diff, popt.remapping, rng)

    # isize barrier
    infer_isize(seqs, ii, popt.ap_prior, dbs.l_pac)
    if ii.avg < 0.0 and last_ii.avg > 0.0:
        (ii.avg, ii.std, ii.ap_prior, ii.low, ii.high, ii.high_bayesian) = (
            last_ii.avg, last_ii.std, last_ii.ap_prior, last_ii.low,
            last_ii.high, last_ii.high_bayesian)
    if popt.force_isize:
        print("[cal_pac_pos_pe] discard insert size estimate as user's "
              "request.", file=sys.stderr)
        ii.low = ii.high = 0
        ii.avg = ii.std = -1.0

    # PE stage — no RNG, order-independent
    cnt_chg = 0
    for i in range(n_seqs):
        p = (seqs[0][i], seqs[1][i])
        aln = (aln_buf[0][i], aln_buf[1][i])
        arr = compute_seq_coords_and_counts(dbs, popt.remapping, aln, p)
        for j in range(2):
            max_diff = (cal_maxdiff(p[j].len, BWA_AVG_ERR, gopt.fnr)
                        if gopt.fnr > 0.0 else gopt.max_diff)
            if p[j].c1 or p[j].c2:
                p[j].seQ = p[j].mapQ = approx_mapQ(p[j], max_diff)
        if (p[0].type in (TYPE_UNIQUE, TYPE_REPEAT)
                and p[1].type in (TYPE_UNIQUE, TYPE_REPEAT)):
            cnt_chg += find_optimal_pair(p, arr, aln, popt, gopt.s_mm, ii)
        if popt.N_multi or popt.n_multi:
            for j in range(2):
                if p[j].type != TYPE_NO_MATCH:
                    max_multi = popt.n_multi
                    if not (p[j].extra_flag & SAM_FPP) \
                            and p[1 - j].type != TYPE_NO_MATCH:
                        max_multi = (popt.n_multi
                                     if p[j].c1 + p[j].c2 - 1 > popt.N_multi
                                     else popt.N_multi)
                    select_sai_multi(dbs, aln[j], p[j], max_multi, rng)
    return cnt_chg


def bwa_sw_core(dbs: DbSet, length: int, seq: np.ndarray, beg: int,
                reglen: int) -> tuple[list[int] | None, int, int]:
    """bwa_sw_core (bwasw.c:29-112).  Returns (cigar, new_beg, cnt)."""
    if reglen < SW_MIN_MATCH_LEN or dbs.l_pac - beg < length:
        return None, beg, 0
    x = int((seq[:length] >= 4).sum())
    if x / length >= 0.25 or length - x < SW_MIN_MATCH_LEN:
        return None, beg, 0
    ref_seq = dbs.extract_sequence(beg, reglen)
    cigar, score, fi, fj, end_i, end_j, _subo = native.local_aln(
        ref_seq, seq[:length], thres=1)
    if score < 0 or not cigar:
        return None, beg, 0
    # good-enough check: >= 20 aligned bases on both sides
    xlen = sum(cigar_len(c) for c in cigar if cigar_op(c) in (FROM_M, FROM_D))
    ylen = sum(cigar_len(c) for c in cigar if cigar_op(c) in (FROM_M, FROM_I))
    if xlen < SW_MIN_MATCH_LEN or ylen < SW_MIN_MATCH_LEN:
        return None, beg, 0
    # update coordinate + soft clips
    new_beg = beg + (fi if fi else 1) - 1
    start = (fj if fj else 1) - 1
    end = end_j
    if start:
        cigar.insert(0, cigar_create(3, start))
    if end < length:
        cigar.append(cigar_create(3, length - end))
    # count mismatches/gaps against the extracted reference
    n_mm = n_gapo = n_gape = 0
    xx = fi - 1 if fi else 0
    yy = fj - 1 if fj else 0
    for c in cigar:
        ln = cigar_len(c)
        op = cigar_op(c)
        if op == FROM_M:
            for l in range(ln):
                if (ref_seq[xx + l] < 4 and seq[yy + l] < 4
                        and ref_seq[xx + l] != seq[yy + l]):
                    n_mm += 1
            xx += ln
            yy += ln
        elif op == FROM_D:
            xx += ln
            n_gapo += 1
            n_gape += ln - 1
        elif op == FROM_I:
            yy += ln
            n_gapo += 1
            n_gape += ln - 1
    cnt = (n_mm << 16) | (n_gapo << 8) | n_gape
    return cigar, new_beg, cnt


def _set_right_coordinate(ref: AlnSeq, mate: AlnSeq, ii: IsizeInfo,
                          l_pac: int) -> tuple[int, int]:
    beg = int(ref.remapped_pos + ii.avg - 3 * ii.std - mate.len * 1.5)
    end = int(beg + 6 * ii.std + 2 * mate.len)
    if beg < ref.remapped_pos + ref.len:
        beg = ref.remapped_pos + ref.len
    if end > l_pac:
        end = l_pac
    return beg, end


def _set_left_coordinate(ref: AlnSeq, mate: AlnSeq, ii: IsizeInfo
                         ) -> tuple[int, int]:
    beg = int(ref.remapped_pos + ref.len - ii.avg - 3 * ii.std
              - mate.len * 0.5)
    end = int(beg + 6 * ii.std + 2 * mate.len)
    if beg < 0:
        beg = 0
    if end > ref.remapped_pos:
        end = ref.remapped_pos
    return beg, end


def paired_sw(dbs: DbSet, seqs, popt: PeOpt, ii: IsizeInfo) -> None:
    """bwa_paired_sw (bwasw.c:145-304): mate rescue by local SW."""
    if not (popt.is_sw and ii.avg >= 0.0):
        return
    n_tot = [0, 0]
    n_mapped = [0, 0]
    for i in range(len(seqs[0])):
        p = (seqs[0][i], seqs[1][i])
        _paired_sw_pair(dbs, p, popt, ii, n_tot, n_mapped)
    print(f"[bwa_paired_sw] {n_mapped[1]} out of {n_tot[1]} Q{SW_MIN_MAPQ} "
          f"singletons are mated.", file=sys.stderr)
    print(f"[bwa_paired_sw] {n_mapped[0]} out of {n_tot[0]} Q{SW_MIN_MAPQ} "
          f"discordant pairs are fixed.", file=sys.stderr)


def _paired_sw_pair(dbs: DbSet, p, popt: PeOpt, ii: IsizeInfo,
                    n_tot, n_mapped) -> None:
    """One pair's mate-rescue attempt (bwasw.c:158-268)."""
    if True:
        if not ((p[0].mapQ >= SW_MIN_MAPQ or p[1].mapQ >= SW_MIN_MAPQ)
                and (p[0].extra_flag & SAM_FPP) == 0):
            return
        is_singleton = int(p[0].type == TYPE_NO_MATCH
                           or p[1].type == TYPE_NO_MATCH)
        n_tot[is_singleton] += 1
        cigar: list = [None, None]
        beg = [0, 0]
        cnt = [0, 0]
        mq_adjust = [255, 255]
        for k in range(2):
            if p[1 - k].type == TYPE_NO_MATCH:
                continue
            if p[1 - k].strand == 0:
                beg[k], end_k = _set_right_coordinate(
                    p[1 - k], p[k], ii, dbs.l_pac)
                sw_seq = p[k].read.rseq
            else:
                beg[k], end_k = _set_left_coordinate(p[1 - k], p[k], ii)
                sw_seq = p[k].read.seq[::-1]  # forward orientation
            cigar[k], beg[k], cnt[k] = bwa_sw_core(
                dbs, p[k].len, sw_seq, beg[k], end_k - beg[k])
            if cigar[k] and p[k].type != TYPE_NO_MATCH:
                clip = 0
                if cigar_op(cigar[k][0]) == 3:
                    clip += cigar_len(cigar[k][0])
                if cigar_op(cigar[k][-1]) == 3:
                    clip += cigar_len(cigar[k][-1])
                s_old = int((p[k].n_mm * 9 + p[k].n_gapo * 13
                             + p[k].n_gape * 2) / 3.0 * 8.0 + 0.499)
                s_new = int((((cnt[k] >> 16) * 9
                              + ((cnt[k] >> 8) & 0xFF) * 13
                              + (cnt[k] & 0xFF) * 2 + clip * 3)
                             / 3.0 * 8.0 + 0.499))
                s_old = int(s_old + -4.343 * math.log(ii.ap_prior
                                                      / dbs.l_pac))
                s_new = s_new + int(-4.343 * math.log(
                    0.5 * math.erfc(1.5 / math.sqrt(2)) + 0.499))
                if s_old < s_new:  # reject
                    mq_adjust[k] = s_new - s_old
                    cigar[k] = None
                else:
                    mq_adjust[k] = s_old - s_new
        k = -1
        mapQ = 0
        if cigar[0] and cigar[1]:
            k = 0 if p[0].mapQ < p[1].mapQ else 1
            mapQ = abs(p[1].mapQ - p[0].mapQ)
        elif cigar[0]:
            k = 0
            mapQ = p[1].mapQ
        elif cigar[1]:
            k = 1
            mapQ = p[0].mapQ
        if k >= 0 and p[k].pos != beg[k]:
            n_mapped[is_singleton] += 1
            tmp = int(p[1 - k].mapQ) - p[k].mapQ // 2 - 8
            if tmp <= 0:
                tmp = 1
            if mapQ > tmp:
                mapQ = tmp
            p[k].mapQ = p[1 - k].mapQ = mapQ
            seq_q = p[1 - k].seQ if p[1 - k].seQ < mapQ else mapQ
            p[k].seQ = p[1 - k].seQ = seq_q
            if p[k].mapQ > mq_adjust[k]:
                p[k].mapQ = mq_adjust[k]
            if p[k].seQ > mq_adjust[k]:
                p[k].seQ = mq_adjust[k]
            p[k].cigar = cigar[k]
            # __set_fixed (bwasw.c:171-182)
            p[k].type = TYPE_MATESW
            p[k].pos = beg[k]
            p[k].remapped_pos = beg[k]
            p[k].dbidx = 0
            p[k].seQ = p[1 - k].seQ
            p[k].strand = 1 - p[1 - k].strand
            p[k].n_mm = cnt[k] >> 16
            p[k].n_gapo = (cnt[k] >> 8) & 0xFF
            p[k].n_gape = cnt[k] & 0xFF
            p[k].extra_flag |= SAM_FPP
            p[1 - k].extra_flag |= SAM_FPP


class _ArrSeq:
    """AlnSeq-compatible view over the raw state arrays, used to run the
    (unchanged) mate-rescue pair body on the native emit path."""

    _I64 = {"pos": 0, "remapped_pos": 1, "sa": 2, "c1": 3, "c2": 4}
    _I32 = {"type": 0, "strand": 1, "n_mm": 2, "n_gapo": 3, "n_gape": 4,
            "score": 5, "mapQ": 6, "seQ": 7, "dbidx": 8,
            "remapped_seqid": 9, "remap_identical": 10, "extra_flag": 11}
    __slots__ = ("_i64", "_i32", "read", "len", "cigar")

    def __init__(self, i64_row, i32_row, read, length):
        object.__setattr__(self, "_i64", i64_row)
        object.__setattr__(self, "_i32", i32_row)
        object.__setattr__(self, "read", read)
        object.__setattr__(self, "len", length)
        object.__setattr__(self, "cigar", None)

    def __getattr__(self, name):
        f = self._I64.get(name)
        if f is not None:
            return int(self._i64[f])
        f = self._I32.get(name)
        if f is not None:
            return int(self._i32[f])
        raise AttributeError(name)

    def __setattr__(self, name, value):
        f = self._I64.get(name)
        if f is not None:
            self._i64[f] = value
            return
        f = self._I32.get(name)
        if f is not None:
            self._i32[f] = value
            return
        object.__setattr__(self, name, value)


def paired_sw_arrays(dbs: DbSet, reads, lens: np.ndarray, i64: np.ndarray,
                     i32: np.ndarray, popt: PeOpt, ii: IsizeInfo
                     ) -> dict[int, list[int]]:
    """bwa_paired_sw over the raw state arrays; returns the rescue cigars
    keyed by end-read index (for ibwa_pe_emit's in_cig input)."""
    in_cigs: dict[int, list[int]] = {}
    if not (popt.is_sw and ii.avg >= 0.0):
        return in_cigs
    from .pe_native import NF32, NF64
    i64r = i64.reshape(-1, NF64)
    i32r = i32.reshape(-1, NF32)
    mq = i32r[:, 6]
    cand = (((mq[0::2] >= SW_MIN_MAPQ) | (mq[1::2] >= SW_MIN_MAPQ))
            & ((i32r[0::2, 11] & SAM_FPP) == 0))
    n_tot = [0, 0]
    n_mapped = [0, 0]
    for i in np.nonzero(cand)[0]:
        e0, e1 = 2 * int(i), 2 * int(i) + 1
        p = (_ArrSeq(i64r[e0], i32r[e0], reads[0][int(i)], int(lens[e0])),
             _ArrSeq(i64r[e1], i32r[e1], reads[1][int(i)], int(lens[e1])))
        _paired_sw_pair(dbs, p, popt, ii, n_tot, n_mapped)
        for k in (0, 1):
            if p[k].cigar is not None:
                in_cigs[2 * int(i) + k] = p[k].cigar
    print(f"[bwa_paired_sw] {n_mapped[1]} out of {n_tot[1]} Q{SW_MIN_MAPQ} "
          f"singletons are mated.", file=sys.stderr)
    print(f"[bwa_paired_sw] {n_mapped[0]} out of {n_tot[0]} Q{SW_MIN_MAPQ} "
          f"discordant pairs are fixed.", file=sys.stderr)
    return in_cigs


BATCH = 0x40000


class _LazyPairReads:
    """reads[j][i] accessor over two ReadBatch blobs: materializes a Read
    object only when asked (mate-rescue candidates are ~0.1% of a batch,
    so the per-read-object loader was pure overhead)."""

    class _End:
        __slots__ = ("rb", "base")

        def __init__(self, rb, base):
            self.rb = rb
            self.base = base

        def __getitem__(self, i):
            return self.rb.read(self.base + i)

    def __init__(self, rbs, start):
        self._ends = (self._End(rbs[0], start), self._End(rbs[1], start))

    def __getitem__(self, j):
        return self._ends[j]


def _interleave_blobs(rbs, start: int, n: int):
    """End-read-ordered (r0/e0, r0/e1, r1/e0, ...) flat blobs from two
    per-file ReadBatches, sliced to [start, start+n): native memcpy loop
    (the numpy repeat+fancy-index equivalent cost ~1.1 s per 50k pairs)."""
    from .pe_native import interleave_blobs as _il
    rb0, rb1 = rbs
    orig_blob, orig_off = _il(rb0.orig_blob, rb0.orig_off,
                              rb1.orig_blob, rb1.orig_off, start, n)
    qual_blob, qual_off = _il(rb0.qual_blob, rb0.qual_off,
                              rb1.qual_blob, rb1.qual_off, start, n)
    name_blob, name_off = _il(rb0.name_blob, rb0.name_off,
                              rb1.name_blob, rb1.name_off, start, n)
    return (orig_blob, orig_off, qual_blob, qual_off, name_blob, name_off)


def sai2sam_pe(prefixes: list[str], sai_pairs: list[tuple[str, str]],
               fq1: str, fq2: str, popt: PeOpt,
               out: TextIO = sys.stdout, rg_line: str | None = None,
               rg_id: str | None = None) -> None:
    """bwa_sai2sam_pe_core (bwape.c:444-546)."""
    count = len(prefixes)
    fps = [[open(sai_pairs[i][0], "rb") for i in range(count)],
           [open(sai_pairs[i][1], "rb") for i in range(count)]]
    opts = [None, None]
    for which in range(2):
        for i in range(count):
            opts[which] = sai.read_header(fps[which][i])
    gopt0, gopt = opts[0], opts[1]

    color = not (gopt.mode & 0x02)  # dbset.c:144
    dbs = DbSet(prefixes, color_space=color)
    if popt.remapping:
        for db in dbs.dbs:
            from . import remap as remap_mod
            db.remap = remap_mod.load_remap(db.prefix)
    rng = Rand48(dbs.dbs[0].bns.seed)
    out.write(dbs.sam_SQ(rg_line))
    print_sam_PG(out)

    # native per-read stage (pe_stage.cpp) unless IBWA_PURE_PY=1; the
    # Python loops below remain the semantic reference + fallback
    import os as _os
    use_native = not _os.environ.get("IBWA_PURE_PY") and not color
    pe_nat = None
    blobs: list[list[bytes]] = [[], []]
    cursors: list[list[int]] = [[], []]
    walkers = None
    if use_native:
        from .pe_native import PeNative, device_available, scan_sai_batch
        pe_nat = PeNative(dbs, popt, gopt)
        for which in range(2):
            for i in range(count):
                blobs[which].append(fps[which][i].read())
                cursors[which].append(0)
        if device_available():
            from ..fm.walk import DeviceWalker
            walkers = [DeviceWalker(db.load_fm(0), db.load_fm(1))
                       for db in dbs.dbs]
            print("[sai2sam_pe] SA walks on device", file=sys.stderr)

    # flat-blob fast loader (native scan, no per-read Python objects)
    # when no trimming/offset-64/barcode is in play — the object loader
    # cost ~9 us/read, ~0.9 s per 100k-read sampe run
    rbs = None
    if pe_nat is not None and all(
            o.trim_qual < 1 and not (o.mode & 0x200) and not (o.mode >> 24)
            for o in (gopt0, gopt)):
        from ..io.reads import load_read_batch
        rb1 = load_read_batch(fq1)
        rb2 = load_read_batch(fq2)
        if rb1 is not None and rb2 is not None:
            rbs = (rb1, rb2)
    if rbs is None:
        reads = [load_reads(fq1, trim_qual=gopt0.trim_qual,
                            is_comp=bool(gopt0.mode & 0x02),
                            is_64=bool(gopt0.mode & 0x200),
                            l_bc=gopt0.mode >> 24),
                 load_reads(fq2, trim_qual=gopt.trim_qual,
                            is_comp=bool(gopt.mode & 0x02),
                            is_64=bool(gopt.mode & 0x200),
                            l_bc=gopt.mode >> 24)]
        n_reads = len(reads[0])
    else:
        n_reads = rbs[0].n
    last_ii = IsizeInfo()
    tot = 0
    for start in range(0, n_reads, BATCH):
        batch = (None if rbs is not None else
                 (reads[0][start:start + BATCH],
                  reads[1][start:start + BATCH]))
        ii = IsizeInfo()
        if pe_nat is not None:
            # array-state native batch: selection -> isize -> pairing ->
            # rescue -> refine/MD/print, with no per-read Python objects
            from .pe_native import NF32, NF64, scan_sai_batch
            n_batch = (min(BATCH, n_reads - start) if rbs is not None
                       else len(batch[0]))
            recs_by_db: list[list[np.ndarray]] = [[] for _ in range(count)]
            for which in range(2):
                for i in range(count):
                    counts, recs, used = scan_sai_batch(
                        blobs[which][i][cursors[which][i]:], n_batch)
                    cursors[which][i] += used
                    pe_nat.set_sai_batch(which, i, counts, recs, n_batch)
                    recs_by_db[i].append(recs)
            if walkers is not None:
                pe_nat.device_prefill_walks(walkers, recs_by_db)
            lens = np.empty(2 * n_batch, dtype=np.int32)
            fulls = np.empty(2 * n_batch, dtype=np.int32)
            for j in range(2):
                if rbs is not None:
                    lens[j::2] = rbs[j].lens[start:start + n_batch]
                    fulls[j::2] = rbs[j].fulls[start:start + n_batch]
                else:
                    lens[j::2] = [r.clip_len for r in batch[j]]
                    fulls[j::2] = [r.full_len for r in batch[j]]
            md = _batch_max_diffs_lens(lens, gopt)
            i64 = np.zeros(2 * n_batch * NF64, dtype=np.int64)
            i32 = np.zeros(2 * n_batch * NF32, dtype=np.int32)
            i32r = i32.reshape(-1, NF32)
            i32r[0::2, 11] = SAM_FPD | SAM_FR1
            i32r[1::2, 11] = SAM_FPD | SAM_FR2
            pe_nat.se_stage_arrays(n_batch, lens, fulls, md, i64, i32, rng)
            infer_isize_arrays(i64, i32, lens, ii, popt.ap_prior, dbs.l_pac)
            _apply_isize_fallbacks(ii, last_ii, popt)
            cnt_chg, mc, mpos, mmeta, cap = pe_nat.pe_stage_arrays(
                n_batch, lens, fulls, md, ii, popt, i64, i32, rng)
            print(f"[sai2sam_pe] changing coordinates of {cnt_chg} "
                  f"alignments.", file=sys.stderr)
            sw_reads = (_LazyPairReads(rbs, start) if rbs is not None
                        else batch)
            in_cigs = paired_sw_arrays(dbs, sw_reads, lens, i64, i32,
                                       popt, ii)
            if rbs is not None:
                (orig_blob, orig_off, qual_blob, qual_off,
                 name_blob, name_off) = _interleave_blobs(rbs, start,
                                                          n_batch)
                text = pe_nat.emit_blobs(
                    2 * n_batch, orig_blob, orig_off, qual_blob, qual_off,
                    name_blob, name_off, np.zeros(1, np.uint8),
                    np.zeros(2 * n_batch + 1, np.int64), lens, fulls, md,
                    i64, i32, mc, mpos, mmeta, cap, in_cigs, gopt.mode,
                    gopt.max_top2, rg_id, is_pe=True, se_mode=False)
            else:
                reads_by_e = [batch[j][i] for i in range(n_batch)
                              for j in range(2)]
                text = pe_nat.emit(reads_by_e, lens, fulls, md, i64, i32,
                                   mc, mpos, mmeta, cap, in_cigs, gopt.mode,
                                   gopt.max_top2, rg_id, is_pe=True,
                                   se_mode=False)
            out.write(text.decode("latin-1"))
            tot += n_batch
            print(f"[sai2sam_pe] {tot} sequences have been processed.",
                  file=sys.stderr)
            last_ii = ii
            continue
        seqs = ([AlnSeq(read=r) for r in batch[0]],
                [AlnSeq(read=r) for r in batch[1]])
        cnt_chg = cal_pac_pos_pe(dbs, seqs, fps, count, ii, popt, gopt,
                                 last_ii, rng)
        print(f"[sai2sam_pe] changing coordinates of {cnt_chg} alignments.",
              file=sys.stderr)
        paired_sw(dbs, seqs, popt, ii)
        for j in range(2):
            refine_gapped(dbs, seqs[j])
            for s in seqs[j]:
                status = do_remap(s, dbs, s.dbidx, popt.remapping)
                if status == 0:  # always unmaps when -R is off (ref quirk)
                    print(f"Failed to remap read {s.read.name} after "
                          f"refining gaps.", file=sys.stderr)
                    unmap_read(s)
        for i in range(len(seqs[0])):
            p = (seqs[0][i], seqs[1][i])
            if p[0].read.bc or p[1].read.bc:
                bc = p[0].read.bc + p[1].read.bc
                p[0].read.bc = p[1].read.bc = bc
            if popt.remapping:
                p[0].pos, p[0].remapped_pos = p[0].remapped_pos, p[0].pos
                p[1].pos, p[1].remapped_pos = p[1].remapped_pos, p[1].pos
            else:
                p[0].remapped_pos = p[0].pos
                p[1].remapped_pos = p[1].pos
            print_sam1(dbs, p[0], p[1], gopt.mode, gopt.max_top2, out,
                       rg_id)
            print_sam1(dbs, p[1], p[0], gopt.mode, gopt.max_top2, out,
                       rg_id)
        tot += len(seqs[0])
        print(f"[sai2sam_pe] {tot} sequences have been processed.",
              file=sys.stderr)
        last_ii = ii
    for which in range(2):
        for fp in fps[which]:
            fp.close()
