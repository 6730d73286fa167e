"""Device-resident FM-index + batched occ kernels (the #1 hot op).

The reference's interleaved layout (bwt.h:56-63) is re-laid-out as a
structure of arrays per strand, stacked so both strands live in one pair of
device buffers:

    ckpt:  uint32[2 * (n_blk + 1), 4]   occ checkpoints before each block
    words: uint32[2 * n_blk, 8]         2-bit packed BWT text

A batched occ query (bwt_occ / bwt_occ4, bwt.c:90-214) is a row gather of
one checkpoint + up to 8 text words followed by a masked popcount —
elementwise integer work that XLA vectorizes over the whole query batch.  All interval
arithmetic is uint32, matching the reference's bwtint_t; k == 0xFFFFFFFF
plays the role of (bwtint_t)(-1).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .fmindex import FmIndex

OCC_INTV = 128
NEG1 = 0xFFFFFFFF

@dataclasses.dataclass
class DeviceFmPair:
    """Both strands' FM-indexes as device arrays (fwd = strand 0).

    blocks packs each 128-base block's 4 occ checkpoints + 8 text words
    into ONE row (the reference's interleaved layout, bwt.h:56-63) so an
    occ query is a single 48-byte row gather.

    dimer (optional) is the 2-mer occ table: per 128-base block, 16
    dimer-checkpoint words + 16 words of 4-bit dimer codes, where the
    dimer at BWT row i is (char-two-before << 2) | bwt-char.  It powers
    TWO-base LF steps on E-chains via the exact identity (verified
    exhaustively in round 3)

        occ(c2, C[c1] + occ_excl(c1, s)) = occ(c2, C[c1]) + occ2(d, s)

    i.e. one row gather advances an exact-match chain by two bases —
    the serial dependent-gather latency per base is halved on the pops
    that dominate the search (~85% are E pops)."""

    blocks: jax.Array   # uint32[2*n_blk, 12]: 4 ckpt words + 8 text words
    L2: jax.Array       # uint32[5] (identical for both strands)
    l2diff: jax.Array   # uint32[4] = L2[1:5] - L2[0:4]
    primary: jax.Array  # uint32[2]
    # dimer table: None, or (blocks2 u32[2*n_blk, 32], oc2 u32[2,16],
    # dtot u32[2,16], corr u32[2,2]) where oc2[s,d] = occ(c2, C[c1]),
    # dtot[s,d] = total dimer-d count, corr[s] = (packed row index of the
    # one sentinel-preceded row, its stored nibble) — that row's true
    # dimer is ($, c) and must never count, see occ2.
    dimer: tuple | None
    seq_len: int        # static
    n_blk: int          # static
    # sharded-index mode (>HBM genomes): the 2*n_blk rows of `blocks` are
    # split contiguously over this mesh axis; every row gather becomes a
    # masked local gather + a psum over the axis (see _gather_block)
    shard_axis: str | None = None   # static
    # occ block interval: 128 (4 ckpt + 8 text words, 48 B rows — the
    # disk layout), 64 (32 B rows, the default) or 32 (24 B rows).  The
    # dimer table is always 128-base blocked, independent of this.
    intv: int = 128     # static

    @property
    def wpb(self) -> int:
        """Text words per block (intv bases / 16 per u32)."""
        return self.intv >> 4

    def tree_flatten(self):
        return ((self.blocks, self.L2, self.l2diff, self.primary,
                 self.dimer),
                (self.seq_len, self.n_blk, self.shard_axis, self.intv))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


jax.tree_util.register_pytree_node(
    DeviceFmPair, DeviceFmPair.tree_flatten, DeviceFmPair.tree_unflatten)


# dimer tables cost 1 byte/base/strand of HBM; past this length skip them
# (the sharded-index >HBM mode never builds them either)
DIMER_MAX_LEN = 1 << 30


def _build_dimer_strand(fm: FmIndex):
    """Host-side construction of one strand's dimer stream + checkpoints.

    Returns (row u32[n_blk, 32], oc2 u32[16], dtot u32[16],
    corr u32[2]).  Pure vectorized numpy over the packed BWT: unpack the
    2-bit codes, build LF per channel (LF(r) = L2[c] + rank(r)), read
    the char-two-before as code_full[LF(r)], pack 4-bit dimers 8/word.
    """
    n = fm.seq_len
    n_blk = (n + OCC_INTV - 1) // OCC_INTV
    flatw = np.ascontiguousarray(fm.words).reshape(-1)
    shifts = ((15 - np.arange(16, dtype=np.uint32)) * 2).astype(np.uint32)
    codes = ((flatw[:, None] >> shifts[None, :]) & 3).astype(
        np.uint8).reshape(-1)[:n]
    primary = int(fm.primary)
    # full row space 0..n with the sentinel at `primary`
    code_full = np.empty(n + 1, dtype=np.int8)
    code_full[:primary] = codes[:primary]
    code_full[primary] = -1
    code_full[primary + 1:] = codes[primary:]
    L2 = fm.L2.astype(np.int64)
    lf = np.zeros(n + 1, dtype=np.uint32)
    for c in range(4):
        idx = np.flatnonzero(code_full == c)
        # LF(r) = L2[c] + inclusive-rank(r); t-th occurrence has rank t+1
        lf[idx] = (L2[c] + 1 + np.arange(len(idx))).astype(np.uint32)
    # char two before: bwt of the LF row; rows mapping INTO the primary
    # row read the sentinel (-1) automatically (SA[r] == 1 rows)
    b2 = code_full[lf]
    b2[primary] = 0  # unused (row skipped below); avoid the stale lf[0]
    keep = np.ones(n + 1, dtype=bool)
    keep[primary] = False
    b1s = codes
    b2s = b2[keep]
    bad = b2s < 0
    d = ((np.where(bad, 0, b2s).astype(np.uint8) << 2) | b1s)
    i1 = int(np.flatnonzero(bad)[0]) if bad.any() else 0xFFFFFFFF
    v1 = int(d[i1]) if i1 != 0xFFFFFFFF else 0
    dtot = np.bincount(d, minlength=16).astype(np.uint32)
    if i1 != 0xFFFFFFFF:
        dtot[v1] -= 1
    # oc2[d=(c2<<2|c1)] = occ(c2, C[c1]) = count of c2 in rows 0..L2[c1]
    # (rows strictly before the c1 bucket, which starts at L2[c1]+1)
    oc2 = np.zeros(16, dtype=np.uint32)
    for c1 in range(4):
        pre = np.bincount(code_full[:L2[c1] + 1] + 1, minlength=5)
        for c2 in range(4):
            oc2[(c2 << 2) | c1] = pre[c2 + 1]
    dpad = np.zeros(n_blk * OCC_INTV, dtype=np.uint8)
    dpad[:n] = d
    per = dpad.reshape(n_blk, OCC_INTV)
    ck = np.zeros((n_blk, 16), dtype=np.uint32)
    for dd in range(16):
        ck[:, dd] = (per == dd).sum(axis=1)
    ck = np.cumsum(ck, axis=0, dtype=np.uint32) - ck  # counts BEFORE block
    # pack nibbles top-down within each word (mirrors the 2-bit layout)
    d32 = per.astype(np.uint32).reshape(n_blk, 16, 8)
    sh2 = ((7 - np.arange(8, dtype=np.uint32)) * 4).astype(np.uint32)
    words2 = np.zeros((n_blk, 16), dtype=np.uint32)
    for j in range(8):
        words2 |= d32[:, :, j] << sh2[j]
    row = np.concatenate([ck, words2], axis=1)
    corr = np.array([i1 & 0xFFFFFFFF, v1], dtype=np.uint32)
    return row, oc2, dtot, corr


def _popcount_bases(words: np.ndarray) -> np.ndarray:
    """Per-block counts of each base code in a [n, k]-word 2-bit stream.

    Returns uint32[n, 4].  Zero padding counts as base 0 — callers must
    only use rows whose every word is real text."""
    out = np.zeros((words.shape[0], 4), dtype=np.uint32)
    for c in range(4):
        x = words ^ np.uint32(0x55555555 * c)
        t = (~x) & ((~x) >> np.uint32(1)) & np.uint32(0x55555555)
        # vectorized popcount via uint8 view + bit table
        bits = np.unpackbits(t.view(np.uint8), axis=-1)
        out[:, c] = bits.reshape(words.shape[0], -1).sum(axis=1)
    return out


def _rechunk_blocks(ckpt: np.ndarray, words: np.ndarray, seq_len: int,
                    intv: int) -> np.ndarray:
    """Re-checkpoint one strand's 128-base layout at `intv`-base intervals.

    Returns uint32[n_intv, 4 + intv/16] rows: 4 ckpt words + intv/16 text
    words.  Sub-block i's checkpoint = the 128-block checkpoint + the
    counts of the preceding i*intv bases; a trailing row whose checkpoint
    prefix contains padding is never gathered (queries clamp to
    seq_len - 1) and is trimmed when possible."""
    sub = OCC_INTV // intv            # sub-blocks per 128-base block
    w = intv >> 4                     # text words per sub-block
    n128 = (seq_len + OCC_INTV - 1) // OCC_INTV
    n_intv = (seq_len + intv - 1) // intv
    rows = np.zeros((sub * n128, 4 + w), dtype=np.uint32)
    acc = ckpt[:n128].copy()
    for i in range(sub):
        rows[i::sub, :4] = acc
        rows[i::sub, 4:] = words[:, w * i:w * (i + 1)]
        if i + 1 < sub:
            acc = acc + _popcount_bases(words[:, w * i:w * (i + 1)])
    return np.ascontiguousarray(rows[:n_intv])


def build_device_pair(fwd: FmIndex, rev: FmIndex,
                      put=jnp.asarray, dimer: bool | None = None,
                      intv: int | None = None) -> DeviceFmPair:
    assert fwd.seq_len == rev.seq_len
    if intv is None:
        import os
        intv = int(os.environ.get("IBWA_DEV_INTV", "64"))
    assert intv in (32, 64, 128), intv
    if intv != 128:
        n_blk = (fwd.seq_len + intv - 1) // intv
        blocks = np.concatenate(
            [_rechunk_blocks(fwd.ckpt, fwd.words, fwd.seq_len, intv),
             _rechunk_blocks(rev.ckpt, rev.words, rev.seq_len, intv)],
            axis=0)
    else:
        n_blk = (fwd.seq_len + OCC_INTV - 1) // OCC_INTV
        blocks = np.empty((2 * n_blk, 12), dtype=np.uint32)
        blocks[:n_blk, :4] = fwd.ckpt[:n_blk]
        blocks[:n_blk, 4:] = fwd.words
        blocks[n_blk:, :4] = rev.ckpt[:n_blk]
        blocks[n_blk:, 4:] = rev.words
    l2 = fwd.L2.astype(np.uint32)
    if dimer is None:
        import os
        # Default OFF: the dimer table halves *steps* but each step
        # gathers more and bigger rows (128 B occ2 vs 32-48 B occ4/occ1),
        # which measured slower end to end on the previous accelerator.
        # IBWA_DIMER=1 opts back in.
        dimer = (fwd.seq_len <= DIMER_MAX_LEN
                 and os.environ.get("IBWA_DIMER") == "1"
                 and not os.environ.get("IBWA_NO_DIMER"))
    dimer_arrays = None
    if dimer:
        rf, of, tf, cf = _build_dimer_strand(fwd)
        rr, orv, tr, cr = _build_dimer_strand(rev)
        dimer_arrays = (
            put(np.concatenate([rf, rr], axis=0)),
            put(np.stack([of, orv])),
            put(np.stack([tf, tr])),
            put(np.stack([cf, cr])),
        )
    return DeviceFmPair(
        blocks=put(blocks),
        L2=put(l2),
        l2diff=put((l2[1:5] - l2[0:4]).astype(np.uint32)),
        primary=put(np.array([fwd.primary, rev.primary], dtype=np.uint32)),
        dimer=dimer_arrays,
        seq_len=fwd.seq_len,
        n_blk=n_blk,
        intv=intv,
    )


def _gather_block(fm: DeviceFmPair, strand, k):
    """Common block gather: returns (ck[..,4], w[..,wpb], nw, nb) for
    queries already adjusted for the primary sentinel and clamped in
    range."""
    shift = fm.intv.bit_length() - 1
    roww = 4 + fm.wpb
    blk = (k >> shift).astype(jnp.uint32)
    blk = jnp.minimum(blk, jnp.uint32(fm.n_blk - 1))
    off = k & jnp.uint32(fm.intv - 1)
    flat = strand * jnp.uint32(fm.n_blk) + blk
    if fm.shard_axis is None:
        # flatten the index before the gather: one flat [2B] row gather
        # instead of a [B, 2]-indexed one
        if flat.ndim > 1:
            row = fm.blocks[flat.reshape(-1)].reshape(*flat.shape, roww)
        else:
            row = fm.blocks[flat]                          # [..., roww]
    else:
        # sharded-index mode: rows are split contiguously over the mesh
        # axis; fetch what this shard owns, zero elsewhere, and psum the
        # one-hot rows over the axis (one u32 row per query)
        n_local = fm.blocks.shape[0]
        lo = (jax.lax.axis_index(fm.shard_axis).astype(jnp.uint32)
              * jnp.uint32(n_local))
        loc = flat - lo
        owned = loc < jnp.uint32(n_local)   # u32 wrap puts out-of-range high
        safe = jnp.minimum(loc, jnp.uint32(n_local - 1)).astype(jnp.int32)
        row = jnp.where(owned[..., None], fm.blocks[safe], jnp.uint32(0))
        row = jax.lax.psum(row, fm.shard_axis)
    ck = row[..., :4]
    w = row[..., 4:]
    nw = (off >> 4).astype(jnp.int32)       # number of fully-counted words
    nb = ((off & 15) + 1).astype(jnp.uint32)  # bases counted in word nw
    return ck, w, nw, nb


def _partial_mask(nb):
    """Keep the top nb 2-bit fields of a word (bwt.c:109: the
    ~((1<<((15-(k&15)+1)<<1))-1) trick with nb = (k&15)+1)."""
    shift = (jnp.uint32(16) - nb) * 2
    return ~((jnp.uint32(1) << shift) - 1)


def occ4(fm: DeviceFmPair, strand, k):
    """Batched bwt_occ4 (bwt.c:139-175): counts of each base in B0[0..k].

    strand, k: uint32[...]; returns uint32[..., 4].
    k == NEG1 -> 0; k == seq_len -> L2[c+1]-L2[c].
    """
    k = k.astype(jnp.uint32)
    is_neg = k == jnp.uint32(NEG1)
    is_full = k == jnp.uint32(fm.seq_len)
    prim = fm.primary[strand]
    kk = k - (k >= prim).astype(jnp.uint32)
    kk = jnp.minimum(kk, jnp.uint32(max(fm.seq_len - 1, 0)))
    ck, w, nw, nb = _gather_block(fm, strand, kk)

    pats = jnp.uint32(0x55555555) * jnp.arange(4, dtype=jnp.uint32)
    x = w[..., None, :] ^ pats[..., :, None]           # [..., 4, wpb]
    t = (~x) & ((~x) >> 1) & jnp.uint32(0x55555555)
    widx = jnp.arange(fm.wpb, dtype=jnp.int32)
    full = widx < nw[..., None, None]
    part = widx == nw[..., None, None]
    pm = _partial_mask(nb)[..., None, None]
    sel = jnp.where(full, t, 0) | jnp.where(part, t & pm, 0)
    pc = jax.lax.population_count(sel)
    # unrolled sum over the tiny trailing word axis: elementwise adds
    # instead of a reduction
    cnt = ck
    for j in range(fm.wpb):
        cnt = cnt + pc[..., j]
    cnt = jnp.where(is_neg[..., None], 0, cnt)
    cnt = jnp.where(is_full[..., None], fm.l2diff, cnt)
    return cnt


def occ2(fm: DeviceFmPair, strand, k, d):
    """Batched dimer occ: count of rows j <= k whose (char-two-before,
    bwt-char) dimer equals d (4-bit code c2<<2|c1).  Same conventions as
    occ1: k == NEG1 -> 0, k == seq_len -> total, primary-row skip.

    The single row whose true dimer is ($, c) stores a placeholder
    nibble; its false contribution is subtracted via fm.dimer's corr."""
    blocks2, _oc2, dtot, corr = fm.dimer
    k = k.astype(jnp.uint32)
    d = d.astype(jnp.uint32)
    is_neg = k == jnp.uint32(NEG1)
    is_full = k == jnp.uint32(fm.seq_len)
    prim = fm.primary[strand]
    kk = k - (k >= prim).astype(jnp.uint32)
    kk = jnp.minimum(kk, jnp.uint32(max(fm.seq_len - 1, 0)))
    # the dimer table is always 128-base blocked (independent of fm.intv)
    n128 = (fm.seq_len + OCC_INTV - 1) // OCC_INTV
    blk = (kk >> 7).astype(jnp.uint32)
    blk = jnp.minimum(blk, jnp.uint32(n128 - 1))
    off = kk & jnp.uint32(127)
    flat2 = strand * jnp.uint32(n128) + blk
    if flat2.ndim > 1:
        # flat-index the pair gather (see _gather_block's note)
        row = blocks2[flat2.reshape(-1)].reshape(*flat2.shape, 32)
    else:
        row = blocks2[flat2]                             # [..., 32]
    ck = row[..., :16]
    w = row[..., 16:]
    nw = (off >> 3).astype(jnp.int32)        # fully-counted nibble words
    nb = ((off & 7) + 1).astype(jnp.uint32)  # nibbles counted in word nw
    # nibble-equality: marker bit set where the nibble DIFFERS from d
    pat = (d * jnp.uint32(0x11111111))[..., None]
    x = w ^ pat
    t = (x | (x >> 1) | (x >> 2) | (x >> 3)) & jnp.uint32(0x11111111)
    widx = jnp.arange(16, dtype=jnp.int32)
    # partial word: force the bottom (8-nb) nibbles to "differs"
    shift = (jnp.uint32(8) - nb) * 4
    pmask = ((jnp.uint32(1) << shift) - 1) & jnp.uint32(0x11111111)
    full = widx < nw[..., None]
    part = widx == nw[..., None]
    eq_full = jnp.uint32(8) - jax.lax.population_count(t)
    eq_part = jnp.uint32(8) - jax.lax.population_count(
        t | pmask[..., None])
    sel = (jnp.where(full, eq_full, 0) | jnp.where(part, eq_part, 0))
    # checkpoint channel select + unrolled lane sum (see occ4's note on
    # tiny trailing-axis reductions)
    cnt = jnp.zeros_like(d)
    for j in range(16):
        cnt = cnt + jnp.where(d == j, ck[..., j], 0)
    for j in range(16):
        cnt = cnt + sel[..., j]
    # subtract the sentinel-preceded row's placeholder when counted
    i1 = corr[strand, 0]
    v1 = corr[strand, 1]
    cnt = cnt - ((kk >= i1) & (d == v1) & ~is_neg).astype(jnp.uint32)
    cnt = jnp.where(is_neg, 0, cnt)
    ftot = jnp.zeros_like(d)
    for j in range(16):
        ftot = ftot + jnp.where(d == j, dtot[strand, j], 0)
    cnt = jnp.where(is_full, ftot, cnt)
    return cnt


def occ1(fm: DeviceFmPair, strand, k, c):
    """Batched bwt_occ (bwt.c:90-113) for one base code per lane."""
    k = k.astype(jnp.uint32)
    c = c.astype(jnp.uint32)
    is_neg = k == jnp.uint32(NEG1)
    is_full = k == jnp.uint32(fm.seq_len)
    prim = fm.primary[strand]
    kk = k - (k >= prim).astype(jnp.uint32)
    kk = jnp.minimum(kk, jnp.uint32(max(fm.seq_len - 1, 0)))
    ck, w, nw, nb = _gather_block(fm, strand, kk)

    pat = (jnp.uint32(0x55555555) * c)[..., None]
    x = w ^ pat
    t = (~x) & ((~x) >> 1) & jnp.uint32(0x55555555)
    widx = jnp.arange(fm.wpb, dtype=jnp.int32)
    full = widx < nw[..., None]
    part = widx == nw[..., None]
    pm = _partial_mask(nb)[..., None]
    sel = jnp.where(full, t, 0) | jnp.where(part, t & pm, 0)
    pc = jax.lax.population_count(sel)
    # select ck[c] arithmetically + unrolled lane sum (see occ4)
    cnt = jnp.zeros_like(c)
    for j in range(4):
        cnt = cnt + jnp.where(c == j, ck[..., j], 0)
    for j in range(fm.wpb):
        cnt = cnt + pc[..., j]
    cnt = jnp.where(is_neg, 0, cnt)
    lc = jnp.zeros_like(c)
    for j in range(4):
        lc = lc + jnp.where(c == j, fm.l2diff[j], 0)
    cnt = jnp.where(is_full, lc, cnt)
    return cnt
