"""Vectorized device engine for the `aln` gapped search.

Re-implements bwt_match_gap (bwtgap.c:104-264) + bwt_cal_width
(bwtaln.c:54-78) as one SPMD program over a read batch.  The reference's
score-bucketed LIFO stack (gap_stack_t, bwtgap.c:13-79) defines the hit
set through its pop order (lowest score bucket, LIFO within).  On device
each read gets a flat entry arena with a packed priority key

    key = score << 20 | (0xFFFFF - push_seqno)

so a single argmin reproduces that exact order (min score, then most
recent push).  Each step's `stack_update` frees the popped slot, places
the children in the free slots by rank and takes the next pop's argmin:
elementwise passes over the arena planes, no scatters.

Divergences from a literal translation, all motivated by batching on
the device:
  * one search step per read per iteration, batched over B reads
    (replaces the per-thread DFS loop); finished reads are masked out
  * bwt_match_exact_alt (bwt.c:235-250), called inline by the reference
    when the remaining diff budget hits 0, becomes a 4th entry state
    ("E"): the partial exact extension is pushed back onto the stack and
    consumes one base per pop.  Because it re-enters its own score bucket
    and buckets are LIFO, the chain pops consecutively — semantically the
    same atomic extension, but each step is a fixed-shape occ gather.
  * capacity overflows (bucket depth, hit count, iteration bound) mark
    the read for the host emulator (engine_ref), which is semantically
    identical — mirroring how the reference itself bails out of
    pathological reads at max_entries (bwtgap.c:139).

Packed entry layout (uint32[4] per stack slot; score == bucket index):
  word0 = k, word1 = l
  word2 = state(2) | a(1) | i(13, bit 3) | last_diff_pos(13, bit 16)
  word3 = n_mm(8) | n_gapo(8) | n_gape(8)
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fm.device import DeviceFmPair, occ1, occ2, occ4
from ..fm.fmindex import FmIndex
from .opts import (BWA_MODE_GAPE, BWA_MODE_LOGGAP, BWA_MODE_NONSTOP, GapOpt,
                   aln_score, cal_maxdiff)
from . import engine_ref
from .engine_ref import Hit

STATE_M, STATE_I, STATE_D, STATE_E = 0, 1, 2, 3
U32 = jnp.uint32
I32 = jnp.int32
INT32_MAX = 0x7FFFFFFF

# device capacity knobs (overflow => host fallback, never wrong answers)
ACAP = 256       # default entry arena slots per read (see make_config:
                 # wide search budgets get 1024); overflow -> host
                 # fallback.  The argmin and stack update scale with the
                 # arena; too small an arena collapses into overflow.
HCAP = 64        # max hits recorded per read
MAX_ITERS = 16384
MAX_SEQ = 0xFFFFF  # seqno field width in the priority key
DEV_BATCH = 1024   # persistent device lanes per dispatch
PERSIST_N = 2048   # reads streamed through the lanes per dispatch; chunks
                   # are dispatched back-to-back so chunk i's host-side
                   # fallback + decode overlap chunk i+1's device time
                   # (small chunks pay lane-drain iterations, big chunks
                   # lose fallback/decode overlap).

HOST_FRAC_INIT = 0.30  # starting share of each batch routed straight to
                       # the native CPU engine (hybrid co-processing);
                       # adapts per batch toward balanced completion.
                       # Override with IBWA_HOST_FRAC.
HOST_CHUNK = 2048      # reads per native job (keeps results streaming)

_FB_POOL = None


def _fallback_pool():
    """Single-worker pool for the native heavy-tail fallback (the C++
    search is OpenMP-parallel internally, so one worker suffices)."""
    global _FB_POOL
    if _FB_POOL is None:
        import concurrent.futures
        _FB_POOL = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    return _FB_POOL


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static (compile-time) search parameters."""

    L: int            # padded read length
    SL: int           # seed length (opt.seed_len)
    NB: int           # number of score buckets
    s_mm: int
    s_gapo: int
    s_gape: int
    max_gapo: int
    max_gape: int
    max_del_occ: int
    indel_end_skip: int
    max_top2: int
    max_entries: int
    max_seed_diff: int
    iter_cap: int     # per-read device step budget (tail -> host search)
    acap: int         # entry arena slots per read
    gape_mode: bool   # BWA_MODE_GAPE
    nonstop: bool     # BWA_MODE_NONSTOP
    loggap: bool      # BWA_MODE_LOGGAP
    # E-chain dimer stages per step (0 = dimer table absent: fall back to
    # single-base occ1 unrolling).  Each stage is ONE row gather of the
    # 2-mer occ table and consumes TWO exact-extension bases (fm/device.py
    # ::occ2) — an E pop burns 1 + 2*dimer_unroll bases.
    dimer_unroll: int = 0
    # PROFILING ONLY (scripts/profile_step.py): component names to stub
    # out of the step so marginal Δwall/Δsteps isolates each one's cost.
    # Stubbed steps are semantically WRONG — never set outside profiling.
    # Names: occ4, eunroll, meta, shadow, stack, hits.
    profile_skips: tuple = ()


def _pack_m2(nmm, gapo, gape):
    return (nmm.astype(U32) | (gapo.astype(U32) << 8)
            | (gape.astype(U32) << 16))


def _pack_m1(state, a, i, ldp):
    return (state.astype(U32) | (a.astype(U32) << 2)
            | (i.astype(U32) << 3) | (ldp.astype(U32) << 16))


def _int_log2(v):
    """Exact integer log2 (stdaln-style bit scan); log2(0) == 0."""
    return jnp.where(v <= 0, 0, 31 - jax.lax.clz(jnp.maximum(v, 1)))


def _compute_widths(fm: DeviceFmPair, seqs, lens, Lw: int):
    """bwt_cal_width (bwtaln.c:54-78), batched over [B, 2] lanes.

    seqs: uint8[B, 2, Lw] (strand 0 indexed vs fwd fm, strand 1 vs rev);
    lens: int32[B].  Returns (w uint32[B,2,Lw+1], bid int32[B,2,Lw+1]).
    """
    B = seqs.shape[0]
    strand = jnp.broadcast_to(jnp.arange(2, dtype=U32)[None, :], (B, 2))
    w = jnp.zeros((B, 2, Lw + 1), dtype=U32)
    bid = jnp.zeros((B, 2, Lw + 1), dtype=I32)

    def body(t, carry):
        k, l, b, w, bid = carry
        c = seqs[:, :, t].astype(U32)
        valid = (t < lens)[:, None]
        cn = jnp.minimum(c, 3)
        ok = occ1(fm, strand, k - 1, cn)
        ol = occ1(fm, strand, l, cn)
        base = fm.L2[cn]
        k2 = base + ok + 1
        l2 = base + ol
        usable = c < 4
        k2 = jnp.where(usable, k2, k)
        l2 = jnp.where(usable, l2, l)
        reset = (k2 > l2) | ~usable
        k3 = jnp.where(reset, 0, k2)
        l3 = jnp.where(reset, jnp.uint32(fm.seq_len), l2)
        b2 = b + reset.astype(I32)
        k = jnp.where(valid, k3, k)
        l = jnp.where(valid, l3, l)
        b = jnp.where(valid, b2, b)
        w = w.at[:, :, t].set(jnp.where(valid, l - k + 1, w[:, :, t]))
        bid = bid.at[:, :, t].set(jnp.where(valid, b, bid[:, :, t]))
        return k, l, b, w, bid

    k0 = jnp.zeros((B, 2), dtype=U32)
    l0 = jnp.full((B, 2), fm.seq_len, dtype=U32)
    b0 = jnp.zeros((B, 2), dtype=I32)
    k, l, b, w, bid = jax.lax.fori_loop(0, Lw, body, (k0, l0, b0, w, bid))
    rows = jnp.arange(B)[:, None]
    cols = jnp.arange(2)[None, :]
    n = jnp.minimum(lens, Lw)[:, None]
    w = w.at[rows, cols, n].set(0)
    bid = bid.at[rows, cols, n].set(b + 1)
    return w, bid


def _pack_meta(w, bid):
    """Pop-time width summary, one u32 per position: bid[i-1] (14b) |
    bid[i] << 14 | (w[i-1] == w[i]) << 28, with position 0 clamping
    i-1 to 0 (matching the gather's max(i-1, 0)).  The pop only ever
    consumes these three facts, so one [B,2]-position gather of this
    plane replaces two [B,4]-position gathers of w/bid."""
    wp = jnp.concatenate([w[..., :1], w[..., :-1]], axis=-1)
    bp = jnp.concatenate([bid[..., :1], bid[..., :-1]], axis=-1)
    return (bp.astype(U32) | (bid.astype(U32) << 14)
            | ((wp == w).astype(U32) << 28))


def _base_bits(cfg: EngineConfig, seqs):
    """Bits 29-31 of the meta plane: the read base per main position
    (dimer mode only) — lets the pop's meta gather double as the base +
    E-window fetch.  Seed-region positions carry 4 (never read)."""
    if not cfg.dimer_unroll:
        return jnp.uint32(0)
    B = seqs.shape[0]
    pad = jnp.full((B, 2, cfg.SL + 2), 4, dtype=U32)
    return jnp.concatenate([seqs.astype(U32), pad], axis=2) << 29


def _sel4(c, table):
    """table[..., c] via arithmetic select (avoids slow tiny gathers)."""
    out = jnp.zeros(c.shape, table.dtype)
    for j in range(4):
        out = out + jnp.where(c == j, table[..., j], 0)
    return out


def stack_update(slot0, act, cv, ofs, kv, ck, cl, cm1, cm2,
                 key, sk, sl, sm1, sm2):
    """Apply one step's pop-free + pushes to the five [B, ACAP] planes.

    slot0/act: [B] popped slot + active mask; cv/ofs/kv/ck/cl/cm1/cm2:
    [B, 10] child descriptors (valid, exclusive push rank, priority key,
    field words).  Free slots are the key sentinel; child j takes the
    free slot of rank ofs[j].  Slot CHOICE does not affect the search
    semantics (only the priority key does), so rank order stands in for
    the reference's free-list discipline.  Also returns the next step's
    pop: the per-row argmin slot, its key and its entry words.

    Returns (key, sk, sl, sm1, sm2, ovf[B], npush[B],
             pslot, pkey, pk, pl, pm1, pm2).
    """
    with jax.named_scope("stack_update"):
        B, acap = key.shape
        li = jnp.arange(acap, dtype=I32)[None, :]
        key = jnp.where((li == slot0[:, None]) & act[:, None], INT32_MAX,
                        key)
        free = key == INT32_MAX
        rank = jnp.cumsum(free.astype(I32), axis=1)
        fits = ofs < rank[:, -1:]
        ovf = (cv & ~fits).any(axis=1)
        npush = (cv & fits).sum(axis=1)
        for j in range(cv.shape[1]):
            m = (free & (rank - 1 == ofs[:, j:j + 1]) & cv[:, j:j + 1]
                 & fits[:, j:j + 1])
            key = jnp.where(m, kv[:, j:j + 1], key)
            sk = jnp.where(m, ck[:, j:j + 1], sk)
            sl = jnp.where(m, cl[:, j:j + 1], sl)
            sm1 = jnp.where(m, cm1[:, j:j + 1], sm1)
            sm2 = jnp.where(m, cm2[:, j:j + 1], sm2)
        rows = jnp.arange(B)
        pslot = jnp.argmin(key, axis=1).astype(I32)
        return (key, sk, sl, sm1, sm2, ovf, npush,
                pslot, key[rows, pslot], sk[rows, pslot], sl[rows, pslot],
                sm1[rows, pslot], sm2[rows, pslot])


def _search_step(cfg: EngineConfig, fm: DeviceFmPair, seqs, st):
    """One pop-expand step for every active read.

    Layout rules: keep every loop-carried scatter target a flat [B, N]
    plane (a packed [B, N, k] array drags a full-array layout copy
    through every iteration), fuse the two occ queries into one
    [B, 2]-row gather of the interleaved block table, and keep
    reductions off tiny trailing axes.
    """
    (rid, lens, has_seed, lane_it,
     sk, sl_, sm1, sm2, key, seqc, stack_n,
     w, bid, meta,
     hk, hl, hm, n_hits,
     best_score, best_cnt, max_diff, done, fb, it,
     pslot, pkey, pk, pl, pm1, pm2) = st
    B = lens.shape[0]
    rows = jnp.arange(B)
    seq_len_u = jnp.uint32(fm.seq_len)

    act = ~done & ~fb
    empty = stack_n == 0
    done = done | (act & empty)
    act = act & ~empty
    over = stack_n > cfg.max_entries
    done = done | (act & over)
    act = act & ~over
    # heavy-tail cap: a read burning > ITER_CAP device steps is routed to
    # the native host search instead of stalling the whole lane block
    lane_it = lane_it + act.astype(I32)
    fb = fb | (act & (lane_it > cfg.iter_cap))
    act = act & (lane_it <= cfg.iter_cap)

    # ---- pop: min (score, -push_seqno) == gap_pop (bwtgap.c:66-79);
    # the argmin + entry words were computed by the previous step's
    # stack update (carried in the state)
    slot0 = pslot
    e_k = pk
    e_l = pl
    m1 = pm1
    m2 = pm2
    e_score = pkey >> 20
    stack_n = stack_n - act.astype(I32)
    e_state = (m1 & 3).astype(I32)
    e_a = ((m1 >> 2) & 1).astype(I32)
    e_i = ((m1 >> 3) & 0x1FFF).astype(I32)
    e_ldp = ((m1 >> 16) & 0x1FFF).astype(I32)
    e_nmm = (m2 & 0xFF).astype(I32)
    e_gapo = ((m2 >> 8) & 0xFF).astype(I32)
    e_gape = ((m2 >> 16) & 0xFF).astype(I32)

    if not cfg.nonstop:
        brk = e_score > best_score + cfg.s_mm
        done = done | (act & brk)
        act = act & ~brk

    sidx = (1 - e_a).astype(U32)     # FM strand used for search (fms[1-a])
    is_e = act & (e_state == STATE_E)
    is_norm = act & (e_state != STATE_E)
    i2 = jnp.maximum(e_i - 1, 0)

    # ---- fused gathers -------------------------------------------------
    # occ4 at (k-1, l): serves the expansion (bwtgap.c:201) AND the
    # E-state exact extension (bwt.c:243-246) — one [B,2]-row gather
    kl = jnp.stack([e_k - 1, e_l], axis=-1)
    if "occ4" in cfg.profile_skips:   # profiling stub: no row gather
        cnt_kl = jnp.broadcast_to(
            ((e_k + e_l)[:, None, None] & jnp.uint32(0x3FF))
            + jnp.arange(4, dtype=U32)[None, None, :], (B, 2, 4))
    else:
        cnt_kl = occ4(fm, sidx[:, None], kl)         # [B, 2, 4]
    cnt_k = cnt_kl[:, 0]
    cnt_l = cnt_kl[:, 1]
    l2b = fm.L2[:4][None, :]
    kj = l2b + cnt_k + 1                             # [B, 4]
    lj = l2b + cnt_l
    # width/bid facts at (i2-1, i2) + seed equivalents: precomputed into
    # the packed meta plane (main table then seed table on the position
    # axis), so the pop needs ONE [B,2]-position gather.  In dimer mode
    # the plane's bits 29-31 also carry the read base, and the same
    # gather fetches the 2*dimer_unroll window bases the E stages need —
    # folding what were three serial gathers (meta, base, window) into
    # one (every op on this part runs serially; fewer ops == less wall).
    ii = i2 - (lens - cfg.SL)
    ii_c = jnp.clip(ii, 0, cfg.SL)
    SOFF = cfg.L + 1
    if cfg.dimer_unroll:
        wrel = jnp.arange(1, 2 * cfg.dimer_unroll + 1, dtype=I32)[None, :]
        wpos = jnp.maximum(i2[:, None] - wrel, 0)
        pos2 = jnp.concatenate(
            [jnp.stack([i2, ii_c + SOFF], axis=-1), wpos], axis=-1)
    else:
        pos2 = jnp.stack([i2, ii_c + SOFF], axis=-1)
    r2 = rows[:, None]
    a2 = e_a[:, None]
    # flat-index the element gather (a 1-D-indexed gather instead of a
    # multi-dim-indexed one)
    midx = (r2 * meta.shape[1] + a2) * meta.shape[2] + pos2
    if "meta" in cfg.profile_skips:   # profiling stub: no element gather
        mg = midx.astype(U32) & jnp.uint32(0xFFF)
    else:
        mg = meta.reshape(-1)[midx.reshape(-1)].reshape(midx.shape)
    mm_, ms_ = mg[:, 0], mg[:, 1]
    bm1 = (mm_ & 0x3FFF).astype(I32)
    b0_ = ((mm_ >> 14) & 0x3FFF).astype(I32)
    weq = (mm_ >> 28) & 1
    sbm1 = (ms_ & 0x3FFF).astype(I32)
    sb0 = ((ms_ >> 14) & 0x3FFF).astype(I32)
    sweq = (ms_ >> 28) & 1
    if cfg.dimer_unroll:
        base = (mm_ >> 29).astype(I32)               # read base (both paths)
    elif "meta" in cfg.profile_skips:  # profiling stub: no seqs gather
        base = i2 & 3
    else:
        base = seqs[rid, e_a, i2].astype(I32)        # read base (both paths)

    # ---- normal entry: budget + D(i) width pruning ----
    m = max_diff - (e_nmm + e_gapo)
    if cfg.gape_mode:
        m = m - e_gape
    alive = is_norm & (m >= 0) & ~((e_i > 0) & (m < b0_))

    hit_direct = alive & (e_i == 0)
    cond_e = alive & (e_i > 0) & (m == 0)
    if not cfg.gape_mode:
        cond_e = cond_e & ((e_state == STATE_M) | (e_gape == cfg.max_gape))
    expand = alive & ~hit_direct & ~cond_e

    # ---- E entry: one base of bwt_match_exact_alt (bwt.c:235-250) ----
    e_cn = jnp.minimum(base, 3)
    e_k2 = _sel4(e_cn, kj)
    e_l2 = _sel4(e_cn, lj)
    e_go = is_e & (e_i > 0) & (base < 4) & (e_k2 <= e_l2)
    hit_e = is_e & (e_i == 0)

    # ---- hit bookkeeping (bwtgap.c:159-196) ----
    hit = hit_direct | hit_e
    first = hit & (n_hits == 0)
    best_score = jnp.where(first, e_score, best_score)
    bdiff = e_nmm + e_gapo + (e_gape if cfg.gape_mode else 0)
    if not cfg.nonstop:
        max_diff = jnp.where(first, jnp.minimum(bdiff + 1, max_diff),
                             max_diff)
    same = e_score == best_score
    width = (e_l - e_k + 1).astype(I32)
    brk2 = hit & ~same & (best_cnt > cfg.max_top2)
    best_cnt = jnp.where(hit & same, best_cnt + width, best_cnt)
    done = done | brk2
    add = hit & ~brk2
    hseen = jnp.arange(HCAP)[None, :] < n_hits[:, None]
    dup = ((hk == e_k[:, None]) & (hl == e_l[:, None]) & hseen).any(axis=1)
    do_add = add & ~((e_gapo > 0) & dup)
    hovf = do_add & (n_hits >= HCAP)
    fb = fb | hovf
    do_add = do_add & ~hovf
    slot = jnp.minimum(n_hits, HCAP - 1)
    nmeta = (_pack_m2(e_nmm, e_gapo, e_gape) | (e_a.astype(U32) << 24))
    hrow = jnp.where(do_add, rows, B)
    if "hits" not in cfg.profile_skips:   # profiling: skip hit scatters
        hk = hk.at[hrow, slot].set(e_k, mode="drop")
        hl = hl.at[hrow, slot].set(e_l, mode="drop")
        hm = hm.at[hrow, slot].set(nmeta, mode="drop")
    n_hits = n_hits + do_add.astype(I32)

    # gap_shadow (bwtgap.c:81-91): masked elementwise over both strands
    if "shadow" not in cfg.profile_skips:  # profiling: skip plane refresh
        x = e_l - e_k + 1
        strand_sel = (jnp.arange(2)[None, :, None] == e_a[:, None, None])
        # position axis is main [0..L] ++ seed [L+1..L+SL+1]; e_ldp <= L
        # keeps the shadow off the seed region (the reference shadows only
        # the main width array, bwtgap.c:81-91)
        inr = (jnp.arange(cfg.L + cfg.SL + 2)[None, None, :]
               < e_ldp[:, None, None])
        upd = do_add[:, None, None] & strand_sel & inr
        meq = upd & (w == x[:, None, None])
        j = jnp.cumsum(meq.astype(I32), axis=2)
        w = jnp.where(upd & (w > x[:, None, None]), w - x[:, None, None],
                      jnp.where(meq, seq_len_u - j.astype(U32), w))
        bid = jnp.where(meq, 1, bid)
        # cheap full-plane elementwise refresh; bits 29-31 (read base in
        # dimer mode, zero otherwise) are invariant for a loaded read
        meta = _pack_meta(w, bid) | (meta & jnp.uint32(0xE0000000))

    # ---- expansion (bwtgap.c:198-258) ----
    occv = e_l - e_k + 1

    # allow_diff / allow_m from widths + seed widths
    ad1 = bm1 > m - 1
    am1 = ~ad1 & (bm1 == m - 1) & (b0_ == m - 1) & (weq == 1)
    m_seed = cfg.max_seed_diff - (e_nmm + e_gapo)
    if cfg.gape_mode:
        m_seed = m_seed - e_gape
    sgate = has_seed & (ii > 0)
    ad2 = sgate & (sbm1 > m_seed - 1)
    am2 = sgate & ~(sbm1 > m_seed - 1) & (sbm1 == m_seed - 1) \
        & (sb0 == m_seed - 1) & (sweq == 1)
    at_end = i2 == 0
    allow_diff = at_end | (~ad1 & ~ad2)
    allow_m = at_end | (~am1 & ~am2)

    if cfg.loggap:
        tmp = _int_log2(e_gape + e_gapo) // 2 + 1
    else:
        tmp = e_gapo + e_gape
    ok_indel = (expand & allow_diff
                & (i2 >= cfg.indel_end_skip + tmp)
                & (lens - i2 >= cfg.indel_end_skip + tmp))

    # children slots 0..9 in reference push order
    nch = 10
    c_valid = [None] * nch
    c_k = [None] * nch
    c_l = [None] * nch
    c_i = [None] * nch
    c_state = [None] * nch
    c_nmm = [None] * nch
    c_gapo = [None] * nch
    c_gape = [None] * nch
    c_ldp = [None] * nch

    # slot 0: I open (from M) or I extend (from I) — same push position
    io = ok_indel & (e_state == STATE_M) & (e_gapo < cfg.max_gapo)
    ie = ok_indel & (e_state == STATE_I) & (e_gape < cfg.max_gape)
    c_valid[0] = io | ie
    c_k[0] = e_k
    c_l[0] = e_l
    c_i[0] = i2
    c_state[0] = jnp.full_like(e_state, STATE_I)
    c_nmm[0] = e_nmm
    c_gapo[0] = e_gapo + io.astype(I32)
    c_gape[0] = e_gape + ie.astype(I32)
    c_ldp[0] = i2

    # slots 1-4: D open (from M) or D extend (from D), base j = 0..3
    d_open = ok_indel & (e_state == STATE_M) & (e_gapo < cfg.max_gapo)
    d_ext = (ok_indel & (e_state == STATE_D) & (e_gape < cfg.max_gape)
             & ((e_gape + e_gapo < max_diff) | (occv < cfg.max_del_occ)))
    d_any = d_open | d_ext
    for j2 in range(4):
        c_valid[1 + j2] = d_any & (kj[:, j2] <= lj[:, j2])
        c_k[1 + j2] = kj[:, j2]
        c_l[1 + j2] = lj[:, j2]
        c_i[1 + j2] = i2 + 1
        c_state[1 + j2] = jnp.full_like(e_state, STATE_D)
        c_nmm[1 + j2] = e_nmm
        c_gapo[1 + j2] = e_gapo + d_open.astype(I32)
        c_gape[1 + j2] = e_gape + d_ext.astype(I32)
        c_ldp[1 + j2] = i2 + 1

    # slots 5-8: mismatch/match, j = 1..4, c = (base + j) & 3
    allow_full = allow_diff & allow_m
    for j2 in range(1, 5):
        c = (base + j2) & 3
        is_mm = (j2 != 4) | (base > 3)
        kc = _sel4(c, kj)
        lc = _sel4(c, lj)
        v = expand & (kc <= lc)
        if j2 != 4:
            v = v & allow_full
        else:
            v = v & (allow_full | (base < 4))
        s5 = 4 + j2
        c_valid[s5] = v
        c_k[s5] = kc
        c_l[s5] = lc
        c_i[s5] = i2
        c_state[s5] = jnp.full_like(e_state, STATE_M)
        if isinstance(is_mm, bool):
            mmv = jnp.full_like(e_nmm, int(is_mm))
        else:
            mmv = is_mm.astype(I32)
        c_nmm[s5] = e_nmm + mmv
        c_gapo[s5] = e_gapo
        c_gape[s5] = e_gape
        c_ldp[s5] = jnp.where(mmv > 0, i2, e_ldp)

    # slot 9: exact-extension chain entry (spawn or continuation).
    # E-steps are ~85% of all iterations (one per remaining base,
    # bwt.c:243-246), so burn down additional bases here — the chain is
    # atomic under LIFO order, so this is order-exact.  With the dimer
    # table each extra stage is one occ2 row gather consuming TWO bases
    # (fm/device.py::occ2); without it, one occ1 gather per base.
    ev = cond_e | e_go
    ek9 = jnp.where(cond_e, e_k, e_k2)
    el9 = jnp.where(cond_e, e_l, e_l2)
    ei9 = jnp.where(cond_e, e_i, e_i - 1)
    if cfg.dimer_unroll > 0:
        # stage bases come from the fused meta gather: Q[j] = read base
        # at position i2 - j (Q[0] is `base`); a cond_e lane's chain
        # starts one base later than an e_go lane's, hence the offset
        # select.  A failed/exhausted stage freezes ei9 AND kills ev, so
        # the static per-stage indices stay consistent.
        Q = [base.astype(U32)] + [mg[:, 2 + j] >> 29
                                  for j in range(2 * cfg.dimer_unroll)]
        blocks2, oc2c, dtot, corr = fm.dimer
        oc2row = oc2c[sidx]                              # [B, 16]
        for _u in range(cfg.dimer_unroll):
            cont = ev & (ei9 >= 2)
            b_lo = jnp.where(cond_e, Q[2 * _u],
                             Q[2 * _u + 1]).astype(I32)
            b_hi = jnp.where(cond_e, Q[2 * _u + 1],
                             Q[2 * _u + 2]).astype(I32)
            du = (jnp.minimum(b_hi, 3) << 2 | jnp.minimum(b_lo, 3)
                  ).astype(U32)
            klu = jnp.stack([ek9 - 1, el9], axis=-1)
            ou = occ2(fm, sidx[:, None], klu, du[:, None])   # [B, 2]
            c2u = jnp.minimum(b_hi, 3).astype(U32)
            l2u = _sel4(c2u, jnp.broadcast_to(fm.L2[:4][None, :], (B, 4)))
            occc = jnp.zeros((B,), U32)
            for j in range(16):
                occc = occc + jnp.where(du == j, oc2row[:, j], 0)
            k2u = l2u + occc + ou[:, 0] + 1
            l2v = l2u + occc + ou[:, 1]
            okx = cont & (b_lo < 4) & (b_hi < 4) & (k2u <= l2v)
            ev = ev & ~(cont & ~okx)
            ek9 = jnp.where(okx, k2u, ek9)
            el9 = jnp.where(okx, l2v, el9)
            ei9 = jnp.where(okx, ei9 - 2, ei9)
    else:
        for _u in range(E_UNROLL - 1
                        if "eunroll" not in cfg.profile_skips else 0):
            cont = ev & (ei9 > 0)
            bu = seqs[rid, e_a, jnp.maximum(ei9 - 1, 0)].astype(I32)
            cu = jnp.minimum(bu, 3).astype(U32)
            klu = jnp.stack([ek9 - 1, el9], axis=-1)
            ou = occ1(fm, sidx[:, None], klu, cu[:, None])   # [B, 2]
            l2u = _sel4(cu, jnp.broadcast_to(fm.L2[:4][None, :], (B, 4)))
            k2u = l2u + ou[:, 0] + 1
            l2v = l2u + ou[:, 1]
            okx = cont & (bu < 4) & (k2u <= l2v)
            ev = ev & ~(cont & ~okx)
            ek9 = jnp.where(okx, k2u, ek9)
            el9 = jnp.where(okx, l2v, el9)
            ei9 = jnp.where(okx, ei9 - 1, ei9)
    c_valid[9] = ev
    c_k[9] = ek9
    c_l[9] = el9
    c_i[9] = ei9
    c_state[9] = jnp.full_like(e_state, STATE_E)
    c_nmm[9] = e_nmm
    c_gapo[9] = e_gapo
    c_gape[9] = e_gape
    c_ldp[9] = e_ldp

    # ---- push children, batched per-plane scatters (LIFO via seqno) ----
    ck_ = jnp.stack(c_k, axis=1)                         # [B, 10]
    cl_ = jnp.stack(c_l, axis=1)
    cnmm = jnp.stack(c_nmm, axis=1)
    cgapo = jnp.stack(c_gapo, axis=1)
    cgape = jnp.stack(c_gape, axis=1)
    cm1 = _pack_m1(jnp.stack(c_state, axis=1), e_a[:, None],
                   jnp.stack(c_i, axis=1), jnp.stack(c_ldp, axis=1))
    cm2 = _pack_m2(cnmm, cgapo, cgape)
    sc = cnmm * cfg.s_mm + cgapo * cfg.s_gapo + cgape * cfg.s_gape
    cv = jnp.stack(c_valid, axis=1) & act[:, None]
    cs = jnp.cumsum(cv.astype(I32), axis=1)
    ofs = cs - cv.astype(I32)                            # exclusive rank
    seq_ovf = cv & (seqc[:, None] + ofs >= MAX_SEQ)
    fb = fb | seq_ovf.any(axis=1)
    cv = cv & ~seq_ovf
    kv = (sc << 20) | (MAX_SEQ - (seqc[:, None] + ofs))
    if "stack" in cfg.profile_skips:   # profiling stub: no stack update
        ovf = jnp.zeros((B,), bool)
        npush = cv.astype(I32).sum(axis=1)
        pslot, pkey = slot0, kv[:, 0]
        pk, pl, pm1, pm2 = ck_[:, 0], cl_[:, 0], cm1[:, 0], cm2[:, 0]
    else:
        (key, sk, sl_, sm1, sm2, ovf, npush,
         pslot, pkey, pk, pl, pm1, pm2) = stack_update(
            slot0, act, cv, ofs, kv, ck_, cl_, cm1, cm2,
            key, sk, sl_, sm1, sm2)
    fb = fb | ovf
    seqc = seqc + npush
    stack_n = stack_n + npush

    it = it + 1
    return (rid, lens, has_seed, lane_it,
            sk, sl_, sm1, sm2, key, seqc, stack_n,
            w, bid, meta,
            hk, hl, hm, n_hits,
            best_score, best_cnt, max_diff, done, fb, it,
            pslot, pkey, pk, pl, pm1, pm2)


def _init_state(cfg: EngineConfig, fm: DeviceFmPair, seqs, lens, max_diff0,
                has_seed, seed_seqs, bad):
    """Fresh whole-batch search state (shared by _run_search and the
    component-budget profiler, scripts/profile_step.py)."""
    B = lens.shape[0]
    seq_len = fm.seq_len

    w, bid = _compute_widths(fm, seqs, lens, cfg.L)
    slens = jnp.where(has_seed, cfg.SL, 0)
    sw, sbid = _compute_widths(fm, seed_seqs, slens, cfg.SL)
    w = jnp.concatenate([w, sw], axis=2)
    bid = jnp.concatenate([bid, sbid], axis=2)
    meta = _pack_meta(w, bid) | _base_bits(cfg, seqs)

    # stack planes (flat [B, acap] per field; see _search_step docstring)
    sk = jnp.zeros((B, cfg.acap), dtype=U32)
    sl_ = jnp.zeros((B, cfg.acap), dtype=U32)
    sm1 = jnp.zeros((B, cfg.acap), dtype=U32)
    sm2 = jnp.zeros((B, cfg.acap), dtype=U32)
    key = jnp.full((B, cfg.acap), INT32_MAX, dtype=I32)
    # roots in slots 0/1: (a=0, seq 0) then (a=1, seq 1) — a=1 pops first
    sl_ = sl_.at[:, 0].set(seq_len).at[:, 1].set(seq_len)
    m1_root = lambda a: _pack_m1(
        jnp.full((B,), STATE_M, I32), jnp.full((B,), a, I32),
        lens, jnp.zeros((B,), I32))
    sm1 = sm1.at[:, 0].set(m1_root(0)).at[:, 1].set(m1_root(1))
    key = key.at[:, 0].set(MAX_SEQ - 0)
    key = key.at[:, 1].set(MAX_SEQ - 1)
    seqc = jnp.full((B,), 2, I32)
    stack_n = jnp.full((B,), 2, I32)

    hk = jnp.zeros((B, HCAP), dtype=U32)
    hl = jnp.zeros((B, HCAP), dtype=U32)
    hm = jnp.zeros((B, HCAP), dtype=U32)
    n_hits = jnp.zeros((B,), dtype=I32)
    best_score = (max_diff0 + 1) * cfg.s_mm + (cfg.max_gapo + 1) * cfg.s_gapo \
        + (cfg.max_gape + 1) * cfg.s_gape
    best_cnt = jnp.zeros((B,), dtype=I32)
    done = bad
    fb = jnp.zeros((B,), dtype=bool)
    it = jnp.zeros((), dtype=I32)

    rid = jnp.arange(B, dtype=I32)
    lane_it = jnp.zeros((B,), I32)
    return (rid, lens, has_seed, lane_it,
            sk, sl_, sm1, sm2, key, seqc, stack_n,
            w, bid, meta,
            hk, hl, hm, n_hits,
            best_score, best_cnt, max_diff0, done, fb, it,
            jnp.ones((B,), I32), jnp.full((B,), MAX_SEQ - 1, I32),
            jnp.zeros((B,), U32), jnp.full((B,), seq_len, U32),
            m1_root(1), jnp.zeros((B,), U32))


@functools.partial(jax.jit, static_argnums=(0,),
                   static_argnames=("seq_len", "n_blk", "shard_axis"))
def _run_search(cfg: EngineConfig, blocks, L2, l2diff, primary,
                seqs, lens, max_diff0, has_seed, seed_seqs, bad,
                seq_len: int, n_blk: int, shard_axis: str | None = None,
                dimer=None):
    if not cfg.dimer_unroll:
        dimer = None
    elif dimer is not None:
        # closure-captured numpy tables can't be indexed by tracers
        dimer = tuple(jnp.asarray(a) for a in dimer)
    # block interval is implied by the (static) row width: 4 ckpt words
    # + intv/16 text words
    fm = DeviceFmPair(blocks, L2, l2diff, primary, dimer,
                      seq_len, n_blk, shard_axis,
                      (blocks.shape[1] - 4) << 4)
    st = _init_state(cfg, fm, seqs, lens, max_diff0, has_seed, seed_seqs,
                     bad)

    def cond(st):
        done, fb, it = st[21], st[22], st[23]
        return jnp.any(~done & ~fb) & (it < MAX_ITERS)

    def body(st):
        return _search_step(cfg, fm, seqs, st)

    st = jax.lax.while_loop(cond, body, st)
    (rid, lens, has_seed, lane_it,
     sk, sl_, sm1, sm2, key, seqc, stack_n,
     w, bid, meta,
     hk, hl, hm, n_hits,
     best_score, best_cnt, max_diff, done, fb, it,
     pslot, pkey, pk, pl, pm1, pm2) = st
    fb = fb | (~done)   # iteration bound hit
    hits = jnp.stack([hm, hk, hl], axis=-1)
    return hits, n_hits, fb, it


E_UNROLL = 2     # exact-extension bases consumed per E pop.  Each
                 # unroll iteration is one serial occ gather; chains
                 # longer than E_UNROLL simply re-pop.  Only used when
                 # the dimer table is absent.
DIMER_UNROLL = 2  # occ2 (2-base) stages per step when the dimer table is
                  # present: an E pop consumes 1 + 2*DIMER_UNROLL bases
                  # for the same number of serial gathers as E_UNROLL=2+1.
ITER_CAP = 384    # pushes before a read is routed to the host emulator
SWITCH_K = 16    # search steps between lane-switch phases


@functools.partial(jax.jit, static_argnums=(0,),
                   static_argnames=("seq_len", "n_blk", "n_lanes",
                                    "shard_axis"))
def _run_search_persistent(cfg: EngineConfig, blocks, L2, l2diff, primary,
                           seqs, lens, max_diff0, has_seed, seed_seqs, bad,
                           seq_len: int, n_blk: int, n_lanes: int,
                           shard_axis: str | None = None, dimer=None):
    """Persistent-lane scheduler: B lanes stream through N reads.

    A plain batched dispatch pays max-pops-over-batch iterations while
    most lanes idle (the straggler tax).  Here each lane processes reads
    round-robin (lane b takes reads b, b+B, ...): every SWITCH_K steps a
    switch phase flushes finished lanes' hits to the [N] output arrays
    and reloads them with their next read, so total iterations track the
    MEAN pops per read instead of the max.
    """
    if not cfg.dimer_unroll:
        dimer = None
    elif dimer is not None:
        dimer = tuple(jnp.asarray(a) for a in dimer)
    fm = DeviceFmPair(blocks, L2, l2diff, primary, dimer,
                      seq_len, n_blk, shard_axis,
                      (blocks.shape[1] - 4) << 4)
    N = lens.shape[0]
    B = n_lanes

    big_w, big_bid = _compute_widths(fm, seqs, lens, cfg.L)
    slens = jnp.where(has_seed, cfg.SL, 0)
    big_sw, big_sbid = _compute_widths(fm, seed_seqs, slens, cfg.SL)
    big_w = jnp.concatenate([big_w, big_sw], axis=2)
    big_bid = jnp.concatenate([big_bid, big_sbid], axis=2)
    big_meta = _pack_meta(big_w, big_bid) | _base_bits(cfg, seqs)

    out_hk = jnp.zeros((N, HCAP), dtype=U32)
    out_hl = jnp.zeros((N, HCAP), dtype=U32)
    out_hm = jnp.zeros((N, HCAP), dtype=U32)
    out_nh = jnp.zeros((N,), dtype=I32)
    out_fb = jnp.zeros((N,), dtype=bool)

    rows = jnp.arange(B)

    def switch(carry):
        (remaining, out_hk, out_hl, out_hm, out_nh, out_fb, st) = carry
        (rid, lens_l, hs_l, lane_it,
         sk, sl_, sm1, sm2, key, seqc, stack_n,
         w, bid, meta,
         hk, hl, hm, n_hits,
         best_score, best_cnt, max_diff, done, fb, it,
         pslot, pkey, pk, pl, pm1, pm2) = st

        fin = done | fb
        valid = (rid >= 0) & (rid < N) & fin
        orow = jnp.where(valid, rid, N)
        out_hk = out_hk.at[orow].set(hk, mode="drop")
        out_hl = out_hl.at[orow].set(hl, mode="drop")
        out_hm = out_hm.at[orow].set(hm, mode="drop")
        out_nh = out_nh.at[orow].set(n_hits, mode="drop")
        out_fb = out_fb.at[orow].set(fb, mode="drop")
        remaining = remaining - valid.astype(I32).sum()

        new_rid = jnp.where(fin, rid + B, rid)
        load = fin & (new_rid < N)
        park = fin & (new_rid >= N)
        rid = new_rid
        crid = jnp.clip(rid, 0, N - 1)

        lens_l = jnp.where(load, lens[crid], lens_l)
        hs_l = jnp.where(load, has_seed[crid], hs_l)
        md_new = max_diff0[crid]
        max_diff = jnp.where(load, md_new, max_diff)
        bad_l = bad[crid]

        l3 = load[:, None, None]
        w = jnp.where(l3, big_w[crid], w)
        bid = jnp.where(l3, big_bid[crid], bid)
        meta = jnp.where(l3, big_meta[crid], meta)

        lrow = jnp.where(load, rows, B)
        key = jnp.where(load[:, None], INT32_MAX, key)
        key = key.at[lrow, 0].set(MAX_SEQ - 0, mode="drop")
        key = key.at[lrow, 1].set(MAX_SEQ - 1, mode="drop")
        sl_ = sl_.at[lrow, 0].set(seq_len, mode="drop")
        sl_ = sl_.at[lrow, 1].set(seq_len, mode="drop")
        sk = sk.at[lrow, 0].set(0, mode="drop")
        sk = sk.at[lrow, 1].set(0, mode="drop")
        sm2 = sm2.at[lrow, 0].set(0, mode="drop")
        sm2 = sm2.at[lrow, 1].set(0, mode="drop")
        zeros_b = jnp.zeros((B,), I32)
        sm1 = sm1.at[lrow, 0].set(
            _pack_m1(jnp.full((B,), STATE_M, I32), zeros_b, lens_l,
                     zeros_b), mode="drop")
        sm1 = sm1.at[lrow, 1].set(
            _pack_m1(jnp.full((B,), STATE_M, I32), jnp.ones((B,), I32),
                     lens_l, zeros_b), mode="drop")
        seqc = jnp.where(load, 2, seqc)
        stack_n = jnp.where(load, 2, stack_n)
        # fresh lanes pop the slot-1 root (a=1 strand) first
        pslot = jnp.where(load, 1, pslot)
        pkey = jnp.where(load, MAX_SEQ - 1, pkey)
        pk = jnp.where(load, jnp.uint32(0), pk)
        pl = jnp.where(load, jnp.uint32(seq_len), pl)
        pm1 = jnp.where(load, _pack_m1(
            jnp.full((B,), STATE_M, I32), jnp.ones((B,), I32), lens_l,
            jnp.zeros((B,), I32)), pm1)
        pm2 = jnp.where(load, jnp.uint32(0), pm2)
        lane_it = jnp.where(load, 0, lane_it)
        n_hits = jnp.where(load, 0, n_hits)
        best_score = jnp.where(
            load, (md_new + 1) * cfg.s_mm + (cfg.max_gapo + 1) * cfg.s_gapo
            + (cfg.max_gape + 1) * cfg.s_gape, best_score)
        best_cnt = jnp.where(load, 0, best_cnt)
        done = jnp.where(fin, park | (load & bad_l), done)
        fb = jnp.where(fin, False, fb)

        st = (rid, lens_l, hs_l, lane_it,
              sk, sl_, sm1, sm2, key, seqc, stack_n,
              w, bid, meta,
              hk, hl, hm, n_hits,
              best_score, best_cnt, max_diff, done, fb, it,
              pslot, pkey, pk, pl, pm1, pm2)
        return (remaining, out_hk, out_hl, out_hm, out_nh, out_fb, st)

    # lane state starts "pre-first-read": rid = rows - B, everything done,
    # so the first switch() performs the initial load (rid<0 rows drop)
    zb = jnp.zeros((B,), I32)
    zu = jnp.zeros((B, cfg.acap), U32)
    st0 = (rows.astype(I32) - B, zb + 1, jnp.zeros((B,), bool), zb,
           zu, zu, zu, zu, jnp.full((B, cfg.acap), INT32_MAX, I32),
           zb + 2, zb,
           jnp.zeros((B, 2, cfg.L + cfg.SL + 2), U32),
           jnp.zeros((B, 2, cfg.L + cfg.SL + 2), I32),
           jnp.zeros((B, 2, cfg.L + cfg.SL + 2), U32),
           jnp.zeros((B, HCAP), U32), jnp.zeros((B, HCAP), U32),
           jnp.zeros((B, HCAP), U32), zb,
           zb, zb, zb, jnp.ones((B,), bool), jnp.zeros((B,), bool),
           jnp.zeros((), I32),
           zb, zb, jnp.zeros((B,), U32), jnp.zeros((B,), U32),
           jnp.zeros((B,), U32), jnp.zeros((B,), U32))
    carry = (jnp.asarray(N, I32), out_hk, out_hl, out_hm, out_nh, out_fb,
             st0)

    def cond(carry):
        return (carry[0] > 0) & (carry[6][23] < MAX_ITERS * 8)

    def body(carry):
        carry = switch(carry)
        st = carry[6]

        def inner(_, st):
            return _search_step(cfg, fm, seqs, st)

        st = jax.lax.fori_loop(0, SWITCH_K, inner, st)
        return carry[:6] + (st,)

    carry = jax.lax.while_loop(cond, body, carry)
    remaining, out_hk, out_hl, out_hm, out_nh, out_fb, st = carry
    out_fb = out_fb | (remaining > 0)  # iteration-bound hit: all fall back
    hits = jnp.stack([out_hm, out_hk, out_hl], axis=-1)
    return hits, out_nh, out_fb, st[23]


def make_config(L: int, max_diff_hi: int, opt: GapOpt,
                seq_len: int = 0, dimer: bool = False) -> EngineConfig:
    """Static compile-time search parameters for a read batch."""
    nb = aln_score(max_diff_hi + 1, opt.max_gapo + 1, opt.max_gape + 1,
                   opt) + 1
    return EngineConfig(
        dimer_unroll=DIMER_UNROLL if dimer else 0,
        L=L, SL=min(opt.seed_len, L), NB=nb,
        s_mm=opt.s_mm, s_gapo=opt.s_gapo, s_gape=opt.s_gape,
        max_gapo=opt.max_gapo, max_gape=opt.max_gape,
        max_del_occ=opt.max_del_occ,
        indel_end_skip=opt.indel_end_skip, max_top2=opt.max_top2,
        max_entries=min(opt.max_entries, INT32_MAX),
        max_seed_diff=opt.max_seed_diff,
        iter_cap=ITER_CAP,
        # narrow default budgets on big genomes fit the small fast arena;
        # wide budgets (more diffs/gap opens, nonstop) and small genomes
        # (wide SA intervals) fan out far more entries
        acap=(ACAP if max_diff_hi <= 5 and opt.max_gapo <= 1
              and not (opt.mode & BWA_MODE_NONSTOP)
              and seq_len >= (1 << 22) else max(ACAP, 1024)),
        gape_mode=bool(opt.mode & BWA_MODE_GAPE),
        nonstop=bool(opt.mode & BWA_MODE_NONSTOP),
        loggap=bool(opt.mode & BWA_MODE_LOGGAP),
    )


class JaxAlnEngine:
    """Batched device search with host-emulator overflow fallback.

    With >1 device visible (or an explicit `devices` list) the dispatches
    go through a `dp` mesh (parallel/mesh.py): the FM block table is
    replicated per device, each chunk's read batch is sharded over dp, and
    every device runs its own persistent-lane scheduler on its shard —
    the production CLI path and `dryrun_multichip` exercise the same code.
    """

    def __init__(self, fms: tuple[FmIndex, FmIndex], devices=None):
        from ..fm.device import build_device_pair
        self.fms = fms
        if devices is None:
            devices = jax.devices()
        self.mesh = None
        self.n_dev = 1
        if len(devices) > 1:
            import jax.sharding as jsh
            from ..parallel import mesh as pmesh
            self.mesh = pmesh.make_mesh(devices=devices)
            # chunk geometry is per-PROCESS: under jax.distributed each
            # process feeds only its addressable devices' rows
            self.n_dev = sum(1 for d in devices
                             if d.process_index == jax.process_index())
            repl = jsh.NamedSharding(self.mesh, jsh.PartitionSpec())
            put = functools.partial(jax.device_put, device=repl)
            self.dfm = build_device_pair(fms[0], fms[1], put=put)
        else:
            put = functools.partial(jax.device_put, device=devices[0])
            self.dfm = build_device_pair(fms[0], fms[1], put=put)
        self.stats = {"device_reads": 0, "fallback_reads": 0,
                      "host_reads": 0, "iterations": 0}
        import os
        self.host_frac = float(os.environ.get("IBWA_HOST_FRAC",
                                              HOST_FRAC_INIT))
        # an explicit env override is a FIXED share (no adaptation):
        # 0 puts every read on the device except capacity overflow,
        # 1 runs the whole batch through the native search
        self._frac_fixed = "IBWA_HOST_FRAC" in os.environ

    def _config(self, L: int, max_diff_hi: int, opt: GapOpt) -> EngineConfig:
        return make_config(L, max_diff_hi, opt, seq_len=self.dfm.seq_len,
                           dimer=self.dfm.dimer is not None)

    def batch_config(self, seqs: list[np.ndarray], opt: GapOpt):
        """The static engine configuration a read batch dispatches with.

        Returns (cfg, lens int32[n], max_diff int32[n])."""
        n_reads = len(seqs)
        max_len = max(len(s) for s in seqs)
        batch_opt = dataclasses.replace(opt)
        if opt.fnr > 0.0:
            batch_opt.max_diff = cal_maxdiff(max_len, thres=opt.fnr)
        if batch_opt.max_diff < batch_opt.max_gapo:
            batch_opt.max_gapo = batch_opt.max_diff

        lens = np.array([len(s) for s in seqs], dtype=np.int32)
        if opt.fnr > 0.0:
            md_by_len = {int(n): cal_maxdiff(int(n), thres=opt.fnr)
                         for n in np.unique(lens)}
            max_diff = np.array([md_by_len[int(n)] for n in lens],
                                dtype=np.int32)
        else:
            max_diff = np.full(n_reads, batch_opt.max_diff, dtype=np.int32)

        L = int(max(8, (max_len + 7) // 8 * 8))
        cfg = self._config(L, int(max_diff.max()), batch_opt)
        return cfg, lens, max_diff

    def align_batch(self, seqs: list[np.ndarray], rseqs: list[np.ndarray],
                    opt: GapOpt) -> list[list[Hit]]:
        """bwa_cal_sa_reg_gap semantics over a read batch (bwtaln.c:80-140).

        Returns per-read hit lists identical to engine_ref.align_batch."""
        if not seqs:
            return []
        n_reads = len(seqs)
        cfg, lens, max_diff = self.batch_config(seqs, opt)
        L, SL = cfg.L, cfg.SL

        out: list[list[Hit] | None] = [None] * n_reads

        # ---- hybrid co-processing: a deliberate fraction of reads goes
        # straight to the native CPU engine (same C++ search the heavy-
        # tail fallback uses; byte-identical results), running in the
        # background pool WHILE the device chews its share.  The host
        # core is otherwise idle during device time, and on its own it
        # roughly matches the reference binary — so total throughput
        # approaches device_rate + host_rate.  The fraction adapts
        # between batches to balance the two completion times.
        import time as _time
        if self.host_frac >= 0.999:  # full-host mode
            n_host = n_reads
        else:
            n_host = int(n_reads * self.host_frac) if n_reads > 2048 else 0
        host_lo = n_reads - n_host
        host_jobs: list[tuple[int, int, object]] = []
        t_start = _time.perf_counter()
        self._host_busy = 0.0

        def _timed_native(s, r):
            t0 = _time.perf_counter()
            res = native_align_batch(self.fms, s, r, opt)
            self._host_busy += _time.perf_counter() - t0
            return res

        for lo in range(host_lo, n_reads, HOST_CHUNK):
            hi = min(lo + HOST_CHUNK, n_reads)
            fut = _fallback_pool().submit(
                _timed_native, seqs[lo:hi], rseqs[lo:hi])
            host_jobs.append((lo, hi, fut))

        # Dispatch every device chunk up front (JAX dispatch is async:
        # the device executes them back-to-back while the host decodes +
        # runs the native jobs in the background thread — ctypes releases
        # the GIL, so the C++ search truly overlaps device time).
        # vectorized input packing for the whole device share (the
        # per-read Python loop costs several us/read — measurable once
        # the device+host pipeline overlaps everything else)
        n_dev_reads = host_lo
        cat = (np.concatenate(seqs[:n_dev_reads]) if n_dev_reads
               else np.zeros(0, np.uint8))
        catr = (np.concatenate(rseqs[:n_dev_reads]) if n_dev_reads
                else np.zeros(0, np.uint8))
        dlens = lens[:n_dev_reads]
        starts = np.zeros(n_dev_reads, dtype=np.int64)
        if n_dev_reads:
            starts[1:] = np.cumsum(dlens[:-1])
        all_sq = np.full((n_dev_reads, 2, L), 4, dtype=np.uint8)
        lmask = np.arange(L)[None, :] < dlens[:, None]
        all_sq[:, 0][lmask] = cat
        all_sq[:, 1][lmask] = catr
        all_hs = dlens > opt.seed_len
        sidx = (starts + dlens - SL)[:, None] + np.arange(SL)[None, :]
        sidx = np.clip(sidx, 0, max(len(cat) - 1, 0))
        all_ssq = np.full((n_dev_reads, 2, SL), 4, dtype=np.uint8)
        if len(cat):
            all_ssq[:, 0] = cat[sidx]
            all_ssq[:, 1] = catr[sidx]
        all_ssq[~all_hs] = 4
        nN = (np.add.reduceat((cat > 3).astype(np.int32), starts)
              if n_dev_reads else np.zeros(0, np.int32))
        all_bad = nN > max_diff[:n_dev_reads]

        pending = []
        chunk_n = PERSIST_N * self.n_dev
        for lo in range(0, host_lo, chunk_n):
            hi = min(lo + chunk_n, host_lo)
            B = hi - lo
            # ONE dispatch shape per engine config: the tail chunk pads up
            # to the same PB as full chunks.  A second (smaller) bucket
            # costs a full XLA compile of this engine on first sight plus
            # a per-process executable load — far more than the few
            # padded lanes ever cost.
            PB = chunk_n
            sq = np.full((PB, 2, L), 4, dtype=np.uint8)
            ssq = np.full((PB, 2, SL), 4, dtype=np.uint8)
            hs = np.zeros(PB, dtype=bool)
            bad = np.ones(PB, dtype=bool)
            p_lens = np.ones(PB, dtype=np.int32)
            p_md = np.zeros(PB, dtype=np.int32)
            p_lens[:B] = lens[lo:hi]
            p_md[:B] = max_diff[lo:hi]
            sq[:B] = all_sq[lo:hi]
            ssq[:B] = all_ssq[lo:hi]
            hs[:B] = all_hs[lo:hi]
            bad[:B] = all_bad[lo:hi]
            if self.mesh is not None:
                from ..parallel import mesh as pmesh
                res = pmesh.run_sharded_search_persistent(
                    cfg, self.mesh, self.dfm, sq, p_lens, p_md, hs, ssq,
                    bad, n_lanes=DEV_BATCH)
            else:
                res = _run_search_persistent(
                    cfg, self.dfm.blocks, self.dfm.L2,
                    self.dfm.l2diff, self.dfm.primary,
                    jnp.asarray(sq), jnp.asarray(p_lens),
                    jnp.asarray(p_md), jnp.asarray(hs),
                    jnp.asarray(ssq), jnp.asarray(bad),
                    seq_len=self.dfm.seq_len, n_blk=self.dfm.n_blk,
                    n_lanes=DEV_BATCH, dimer=self.dfm.dimer)
            pending.append((lo, hi, res))

        fb_jobs: list[tuple[list[int], object]] = []
        n_fb = 0
        for lo, hi, (harr, n_hits, fb, it) in pending:
            B = hi - lo
            if self.mesh is not None:
                from ..parallel import mesh as pmesh
                _np = pmesh.to_local_np
            else:
                _np = np.asarray
            harr = _np(harr)[:B]
            nh = _np(n_hits)[:B].tolist()
            fb = _np(fb)[:B]
            self.stats["iterations"] += int(np.max(_np(it)))
            chunk_fb = np.nonzero(fb)[0]
            if len(chunk_fb):
                idxs = [lo + int(b) for b in chunk_fb]
                n_fb += len(idxs)
                fut = _fallback_pool().submit(
                    native_align_batch, self.fms,
                    [seqs[i] for i in idxs], [rseqs[i] for i in idxs], opt)
                fb_jobs.append((idxs, fut))
            # vectorized decode: mask down to the valid hit slots, unpack
            # the fields in numpy, convert to Python lists once (C-speed),
            # then build the per-read Hit objects
            nh_arr = np.where(fb, 0, np.asarray(nh, dtype=np.int64))
            valid = np.arange(harr.shape[1])[None, :] < nh_arr[:, None]
            vh = harr[valid].astype(np.int64)  # [T, 3] read-major
            meta = vh[:, 0]
            nmm, gapo, gape = meta & 0xFF, (meta >> 8) & 0xFF, \
                (meta >> 16) & 0xFF
            flat = np.stack(
                [nmm, gapo, gape, (meta >> 24) & 1, vh[:, 1], vh[:, 2],
                 nmm * opt.s_mm + gapo * opt.s_gapo + gape * opt.s_gape],
                axis=-1).tolist()
            fbl = fb.tolist()
            start = 0
            for b, n in enumerate(nh_arr.tolist()):
                end = start + n
                if not fbl[b]:
                    out[lo + b] = [Hit(*c) for c in flat[start:end]]
                start = end

        t_dev = _time.perf_counter() - t_start
        self.stats["device_reads"] += host_lo - n_fb
        self.stats["fallback_reads"] += n_fb
        self.stats["host_reads"] = self.stats.get("host_reads", 0) + n_host
        for idxs, fut in fb_jobs:
            for i, h in zip(idxs, fut.result()):
                out[i] = h
        for lo, hi, fut in host_jobs:
            res = fut.result()
            for i, h in enumerate(res):
                out[lo + i] = h
        if (not self._frac_fixed) and n_host and host_lo \
                and self._host_busy > 0:
            # rate-based balance: size the next batch's host share so the
            # background pool's total work (pre-split reads + overflow
            # fallback) just fits inside the device wall
            done_pool = n_host + n_fb
            per_read = self._host_busy / max(done_pool, 1)
            want = t_dev / per_read - n_fb
            f_star = min(max(want / n_reads, 0.02), 0.85)
            self.host_frac = 0.5 * self.host_frac + 0.5 * f_star
        self.stats["host_frac"] = round(self.host_frac, 3)
        return out  # type: ignore[return-value]


_ENGINES: dict[int, JaxAlnEngine] = {}


def align_batch(fms, seqs, rseqs, opt):
    """Module-level entry matching engine_ref.align_batch's signature."""
    key = id(fms[0])
    eng = _ENGINES.get(key)
    if eng is None or eng.fms[0] is not fms[0]:
        eng = JaxAlnEngine(fms)
        _ENGINES.clear()
        _ENGINES[key] = eng
    return eng.align_batch(seqs, rseqs, opt)


def native_align_batch(fms, seqs, rseqs, opt):
    """bwa_cal_sa_reg_gap over a batch via the C++ search (identical
    semantics to engine_ref; OpenMP over reads).  Used for the device
    engine's heavy-tail fallback and as a standalone CPU engine."""
    from .. import native

    if not seqs:
        return []
    max_len = max(len(s) for s in seqs)
    batch_opt = dataclasses.replace(opt)
    if opt.fnr > 0.0:
        batch_opt.max_diff = cal_maxdiff(max_len, thres=opt.fnr)
    if batch_opt.max_diff < batch_opt.max_gapo:
        batch_opt.max_gapo = batch_opt.max_diff
    if opt.fnr > 0.0:
        md = np.array([cal_maxdiff(len(s), thres=opt.fnr) for s in seqs],
                      dtype=np.int32)
    else:
        md = np.full(len(seqs), batch_opt.max_diff, dtype=np.int32)
    sl = np.array([opt.seed_len if opt.seed_len < len(s) else INT32_MAX
                   for s in seqs], dtype=np.int32)
    harr, hn = native.match_gap_batch(fms[0], fms[1], seqs, rseqs, md, sl,
                                      batch_opt)
    # vectorized decode (same trick as the device path): unpack all hit
    # fields in numpy, one tolist(), then build Hit objects — a per-
    # read/per-hit Python loop is a visible tax on the hybrid's host
    # share
    hn_arr = np.asarray(hn, dtype=np.int64)
    okl = (hn_arr >= 0).tolist()
    nh = np.maximum(hn_arr, 0)
    valid = np.arange(harr.shape[1])[None, :] < nh[:, None]
    vh = harr[valid]  # [T, 4] read-major, uint32
    meta = vh[:, 0].astype(np.int64)
    flat = np.stack(
        [meta & 0xFF, (meta >> 8) & 0xFF, (meta >> 16) & 0xFF,
         (meta >> 24) & 1, vh[:, 1].astype(np.int64),
         vh[:, 2].astype(np.int64),
         vh[:, 3].astype(np.int32).astype(np.int64)], axis=-1).tolist()
    out = []
    start = 0
    for i, n in enumerate(nh.tolist()):
        end = start + n
        if okl[i]:
            out.append([Hit(*c) for c in flat[start:end]])
        else:  # per-read hit capacity overflow: exact re-run
            out.append(engine_ref.align_batch(
                fms, [seqs[i]], [rseqs[i]], opt)[0])
        start = end
    return out
