"""Reference-exact emulator of the `aln` search engine.

This is a behavioral re-implementation of bwt_cal_width (bwtaln.c:54-78)
and bwt_match_gap (bwtgap.c:104-264): best-first search over the
(mismatch, gap-open, gap-extend) state space with score-bucketed LIFO
stacks, D(i)-width pruning, seeding, top2/max_top2 early stopping,
gap_shadow width updates and (k,l) deduplication.

It exists to (a) pin down the exact hit-set semantics as a test oracle for
the vectorized device engine and (b) serve as the host fallback for reads whose
search exceeds the device engine's fixed stack capacity.

Hit records mirror bwt_aln1_t (bwtaln.h:34-38).

Subtle behaviors intentionally preserved:
* a child pushed with is_diff=0 inherits the parent's last_diff_pos (in the
  C code this happens via bucket slot reuse, bwtgap.c:45-64)
* max_gapo is clamped by the *batch-level* max_diff (bwtaln.c:92)
* widths are mutated by gap_shadow after each accepted hit (bwtgap.c:81-91)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..fm.fmindex import FmIndex, NEG1
from .opts import (BWA_MODE_GAPE, BWA_MODE_LOGGAP, BWA_MODE_NONSTOP,
                   GapOpt, aln_score, cal_maxdiff)

STATE_M, STATE_I, STATE_D = 0, 1, 2


@dataclasses.dataclass
class Hit:
    n_mm: int
    n_gapo: int
    n_gape: int
    a: int
    k: int
    l: int
    score: int


@dataclasses.dataclass
class _Entry:
    a: int
    i: int
    k: int
    l: int
    n_mm: int
    n_gapo: int
    n_gape: int
    state: int
    last_diff_pos: int
    score: int


def cal_width(fm: FmIndex, seq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """D(i) lower-bound widths (bwtaln.c:54-78); returns (w, bid) arrays of
    length len(seq)+1."""
    n = len(seq)
    w = np.zeros(n + 1, dtype=np.int64)
    bid = np.zeros(n + 1, dtype=np.int32)
    k, l, b = 0, fm.seq_len, 0
    for i in range(n):
        c = int(seq[i])
        if c < 4:
            ok = fm.occ(k - 1 if k > 0 else NEG1, c)
            ol = fm.occ(l, c)
            k = int(fm.L2[c]) + ok + 1
            l = int(fm.L2[c]) + ol
        if k > l or c > 3:
            k, l = 0, fm.seq_len
            b += 1
        w[i] = l - k + 1
        bid[i] = b
    w[n] = 0
    bid[n] = b + 1
    return w, bid


class _Stack:
    """Score-bucketed LIFO stack (bwtgap.c:13-79)."""

    def __init__(self, n_buckets: int):
        self.buckets: list[list[_Entry]] = [[] for _ in range(n_buckets)]
        self.best = n_buckets
        self.n = 0

    def push(self, e: _Entry) -> None:
        self.buckets[e.score].append(e)
        self.n += 1
        if e.score < self.best:
            self.best = e.score

    def pop(self) -> _Entry:
        q = self.buckets[self.best]
        e = q.pop()
        self.n -= 1
        if not q and self.n:
            b = self.best + 1
            while not self.buckets[b]:
                b += 1
            self.best = b
        elif self.n == 0:
            self.best = len(self.buckets)
        return e


def match_gap(fms: tuple[FmIndex, FmIndex], seq: np.ndarray,
              rseq: np.ndarray, widths, seed_widths, opt: GapOpt,
              max_diff: int) -> list[Hit]:
    """bwt_match_gap (bwtgap.c:104-264). fms = (fwd, rev) FM-indexes;
    strand a uses fms[1-a]. widths/seed_widths are [(w,bid), (w,bid)] pairs
    per strand; widths are MUTATED (gap_shadow)."""
    n = len(seq)
    best_score = aln_score(max_diff + 1, opt.max_gapo + 1, opt.max_gape + 1,
                           opt)
    best_diff = max_diff + 1
    best_cnt = 0
    hits: list[Hit] = []
    seqs = (seq, rseq)

    if int((seq > 3).sum()) > max_diff:
        return hits

    n_buckets = aln_score(max_diff + 1, opt.max_gapo + 1, opt.max_gape + 1,
                          opt)
    stack = _Stack(n_buckets + 1)
    stack.push(_Entry(0, n, 0, fms[0].seq_len, 0, 0, 0, 0, 0, 0))
    stack.push(_Entry(1, n, 0, fms[0].seq_len, 0, 0, 0, 0, 0, 0))

    mode_gape = bool(opt.mode & BWA_MODE_GAPE)
    mode_nonstop = bool(opt.mode & BWA_MODE_NONSTOP)
    mode_loggap = bool(opt.mode & BWA_MODE_LOGGAP)

    while stack.n:
        if stack.n > opt.max_entries:
            break
        e = stack.pop()
        a, i, k, l = e.a, e.i, e.k, e.l
        if not mode_nonstop and e.score > best_score + opt.s_mm:
            break

        m = max_diff - (e.n_mm + e.n_gapo)
        if mode_gape:
            m -= e.n_gape
        if m < 0:
            continue
        fm = fms[1 - a]
        s = seqs[a]
        w_arr, bid_arr = widths[a]
        if seed_widths is not None:
            sw_arr, sbid_arr = seed_widths[a]
            m_seed = opt.max_seed_diff - (e.n_mm + e.n_gapo)
            if mode_gape:
                m_seed -= e.n_gape
        if i > 0 and m < bid_arr[i - 1]:
            continue

        # hit detection
        hit_found = False
        if i == 0:
            hit_found = True
        elif m == 0 and (e.state == STATE_M or mode_gape
                         or e.n_gape == opt.max_gape):
            cnt, k2, l2 = fm.match_exact_alt(s[:i], k, l)
            if cnt:
                k, l = k2, l2
                hit_found = True
            else:
                continue

        if hit_found:
            score = aln_score(e.n_mm, e.n_gapo, e.n_gape, opt)
            do_add = True
            if not hits:
                best_score = score
                best_diff = e.n_mm + e.n_gapo
                if mode_gape:
                    best_diff += e.n_gape
                if not mode_nonstop:
                    max_diff = min(best_diff + 1, max_diff)
            if score == best_score:
                best_cnt += l - k + 1
            elif best_cnt > opt.max_top2:
                break
            if e.n_gapo:  # tandem-repeat dedup (bwtgap.c:178-182)
                if any(h.k == k and h.l == l for h in hits):
                    do_add = False
            if do_add:
                _gap_shadow(l - k + 1, fm.seq_len, e.last_diff_pos,
                            w_arr, bid_arr)
                hits.append(Hit(e.n_mm, e.n_gapo, e.n_gape, a, k, l, score))
            continue

        i -= 1
        cnt_k = fm.occ4(k - 1 if k > 0 else NEG1)
        cnt_l = fm.occ4(l)
        occ = l - k + 1

        allow_diff = allow_m = True
        if i > 0:
            ii = i - (n - opt.seed_len)
            if bid_arr[i - 1] > m - 1:
                allow_diff = False
            elif (bid_arr[i - 1] == m - 1 and bid_arr[i] == m - 1
                  and w_arr[i - 1] == w_arr[i]):
                allow_m = False
            if seed_widths is not None and ii > 0:
                if sbid_arr[ii - 1] > m_seed - 1:
                    allow_diff = False
                elif (sbid_arr[ii - 1] == m_seed - 1
                      and sbid_arr[ii] == m_seed - 1
                      and sw_arr[ii - 1] == sw_arr[ii]):
                    allow_m = False

        # indels (bwtgap.c:216-243)
        if mode_loggap:
            tmp = _int_log2(e.n_gape + e.n_gapo) // 2 + 1
        else:
            tmp = e.n_gapo + e.n_gape
        if (allow_diff and i >= opt.indel_end_skip + tmp
                and n - i >= opt.indel_end_skip + tmp):
            if e.state == STATE_M:
                if e.n_gapo < opt.max_gapo:
                    stack.push(_Entry(a, i, k, l, e.n_mm, e.n_gapo + 1,
                                      e.n_gape, STATE_I, i,
                                      aln_score(e.n_mm, e.n_gapo + 1,
                                                e.n_gape, opt)))
                    for j in range(4):
                        kj = int(fm.L2[j] + cnt_k[j]) + 1
                        lj = int(fm.L2[j] + cnt_l[j])
                        if kj <= lj:
                            stack.push(_Entry(a, i + 1, kj, lj, e.n_mm,
                                              e.n_gapo + 1, e.n_gape,
                                              STATE_D, i + 1,
                                              aln_score(e.n_mm, e.n_gapo + 1,
                                                        e.n_gape, opt)))
            elif e.state == STATE_I:
                if e.n_gape < opt.max_gape:
                    stack.push(_Entry(a, i, k, l, e.n_mm, e.n_gapo,
                                      e.n_gape + 1, STATE_I, i,
                                      aln_score(e.n_mm, e.n_gapo,
                                                e.n_gape + 1, opt)))
            elif e.state == STATE_D:
                if e.n_gape < opt.max_gape:
                    if (e.n_gape + e.n_gapo < max_diff
                            or occ < opt.max_del_occ):
                        for j in range(4):
                            kj = int(fm.L2[j] + cnt_k[j]) + 1
                            lj = int(fm.L2[j] + cnt_l[j])
                            if kj <= lj:
                                stack.push(_Entry(a, i + 1, kj, lj, e.n_mm,
                                                  e.n_gapo, e.n_gape + 1,
                                                  STATE_D, i + 1,
                                                  aln_score(e.n_mm, e.n_gapo,
                                                            e.n_gape + 1,
                                                            opt)))

        # mismatches / exact match (bwtgap.c:244-258)
        if allow_diff and allow_m:
            for j in range(1, 5):
                c = (int(s[i]) + j) & 3
                is_mm = (j != 4 or int(s[i]) > 3)
                kj = int(fm.L2[c] + cnt_k[c]) + 1
                lj = int(fm.L2[c] + cnt_l[c])
                if kj <= lj:
                    stack.push(_Entry(a, i, kj, lj, e.n_mm + is_mm, e.n_gapo,
                                      e.n_gape, STATE_M,
                                      i if is_mm else e.last_diff_pos,
                                      aln_score(e.n_mm + is_mm, e.n_gapo,
                                                e.n_gape, opt)))
        elif int(s[i]) < 4:
            c = int(s[i]) & 3
            kj = int(fm.L2[c] + cnt_k[c]) + 1
            lj = int(fm.L2[c] + cnt_l[c])
            if kj <= lj:
                stack.push(_Entry(a, i, kj, lj, e.n_mm, e.n_gapo, e.n_gape,
                                  STATE_M, e.last_diff_pos, e.score))

    return hits


def _gap_shadow(x: int, seq_len: int, last_diff_pos: int, w: np.ndarray,
                bid: np.ndarray) -> None:
    """Subtract found-hit counts from the width bounds (bwtgap.c:81-91)."""
    j = 0
    for i in range(last_diff_pos):
        if w[i] > x:
            w[i] -= x
        elif w[i] == x:
            bid[i] = 1
            j += 1
            w[i] = seq_len - j
    # (w[i] < x "should not happen" per the reference comment)


def _int_log2(v: int) -> int:
    c = 0
    if v & 0xFFFF0000:
        v >>= 16
        c |= 16
    if v & 0xFF00:
        v >>= 8
        c |= 8
    if v & 0xF0:
        v >>= 4
        c |= 4
    if v & 0xC:
        v >>= 2
        c |= 2
    if v & 0x2:
        c |= 1
    return c


def align_batch(fms: tuple[FmIndex, FmIndex], seqs: list[np.ndarray],
                rseqs: list[np.ndarray], opt: GapOpt) -> list[list[Hit]]:
    """bwa_cal_sa_reg_gap (bwtaln.c:80-140) over one read batch.

    seqs[i] is the REVERSED read, rseqs[i] the reverse-complement, exactly
    as prepared by bwa_read_seq (bwaseqio.c:189-192).
    """
    if not seqs:
        return []
    max_len = max(len(s) for s in seqs)
    batch_opt = dataclasses.replace(opt)
    if opt.fnr > 0.0:
        batch_opt.max_diff = cal_maxdiff(max_len, thres=opt.fnr)
    if batch_opt.max_diff < batch_opt.max_gapo:
        batch_opt.max_gapo = batch_opt.max_diff
    out = []
    for seq, rseq in zip(seqs, rseqs):
        n = len(seq)
        if opt.fnr > 0.0:
            max_diff = cal_maxdiff(n, thres=opt.fnr)
        else:
            max_diff = batch_opt.max_diff
        local = dataclasses.replace(batch_opt)
        local.seed_len = opt.seed_len if opt.seed_len < n else 0x7FFFFFFF
        widths = [cal_width(fms[0], seq), cal_width(fms[1], rseq)]
        if n > opt.seed_len:
            seed_widths = [cal_width(fms[0], seq[n - opt.seed_len:]),
                           cal_width(fms[1], rseq[n - opt.seed_len:])]
        else:
            seed_widths = None
        out.append(match_gap(fms, seq, rseq, widths, seed_widths, local,
                             max_diff))
    return out
