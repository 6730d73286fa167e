"""Batched banded DP on the device — the bwasw/refine hot kernels.

`extend_batch` is a lane-parallel transcription of the reference's
one-sided seed extension (aln_extend_core, stdaln.c:862-1008; host twin
`ibwa_extend_aln`, native/src/core.cpp:932-1008): banded SW seeded with
G0 at the origin, adaptive band shrink, score/endpoint only (no
traceback).  bwasw spends ~20% of its wall here (gprofng r5), in ~2-40
independent jobs per read — batched across a whole read chunk they are
thousands of independent lanes, which is exactly what the chip wants.

Value-exactness notes (each pinned by tests/test_dp_device.py against
the native scalar):
  * The reference's in-row F chain  f = max(f - r, max(h - qr, 0))  with
    h = max(diag, e, f) collapses to a closed form: an F-sourced h
    contributes f' - qr <= f' - r, which the direct decay already
    dominates (q >= 0), so F[i] = max_{i'<i}(g[i'] - (i-i')*r) with
    g = max(max(diag_h, e) - qr, 0) — one exclusive running max
    (cummax of g + i*r) instead of a serial loop.
  * The adaptive band (start = first h>0 cell, end = last + 3, break on
    empty rows) is replicated exactly with carried per-lane start/end —
    NOT widened — because cells outside the adaptive window keep stale
    values that later rows may re-read (the reference relies on this).
  * The 16-bit overflow rescale (kOverflowThreshold) is NOT implemented:
    callers must route jobs whose score bound  G0 + len2 * max(matrix)
    approaches 32000 to the host kernel (extend_gate_ok).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32
NEG_BIG = -(1 << 29)


def extend_gate_ok(qlen: int, g0: int, max_match: int) -> bool:
    """True if the job can't trip the host kernel's 16-bit rescale."""
    return g0 + qlen * max_match < 30000


@functools.partial(jax.jit, static_argnames=("L1", "L2", "W"))
def _extend_scan(targets, tlens, queries, qlens, g0, band, matrix,
                 gap_open, gap_ext, L1: int, L2: int, W: int):
    """All arrays batched on axis 0 (B jobs).

    targets: uint8[B, L1+2] with targets[:, i] = seq1[i-1] (one left pad
    column; the +2 keeps every window slice in range).  queries:
    uint8[B, L2].  Returns (score, end_i, end_j) int32[B] — score is the
    raw max (callers subtract 1 like the reference's `of_base - 1`).
    """
    B = targets.shape[0]
    qr = gap_open + gap_ext
    r = gap_ext
    widx = jnp.arange(W, dtype=I32)

    eh_h0 = jnp.zeros((B, L1 + 2), I32).at[:, 1].set(g0)
    eh_e0 = jnp.zeros((B, L1 + 2), I32)
    st0 = (eh_h0, eh_e0,
           jnp.ones((B,), I32), jnp.full((B,), 2, I32),   # start, end
           jnp.ones((B,), bool),                           # alive
           jnp.zeros((B,), I32), jnp.zeros((B,), I32),     # score, end_i
           jnp.zeros((B,), I32))                           # end_j

    def row2(st, j):
        (eh_h, eh_e, start, end, alive, score, end_i, end_j) = st
        valid = alive & (j <= qlens)
        s2 = jnp.maximum(j - band, 1)
        e2 = jnp.minimum(j + band, tlens + 1)
        start2 = jnp.where(valid & (s2 > start), s2, start)
        end2 = jnp.where(valid & (e2 < end), e2, end)
        dead = valid & (start2 == end2)
        alive = alive & ~dead
        valid = valid & ~dead

        w0 = jnp.clip(j - 1 - (W // 2 - 1), 0, L1 + 2 - W)
        i_abs = w0 + widx[None, :]
        hwin = jax.lax.dynamic_slice(eh_h, (0, w0), (B, W))
        ewin = jax.lax.dynamic_slice(eh_e, (0, w0), (B, W))
        tl = jax.lax.dynamic_slice(targets, (0, w0), (B, W)).astype(I32)
        qj = queries[:, jnp.maximum(j - 1, 0)].astype(I32)
        sc = matrix[qj[:, None] * 5 + tl]

        incell = ((i_abs >= start2[:, None]) & (i_abs < end2[:, None])
                  & valid[:, None])
        hde = jnp.where(hwin != 0, hwin + sc, 0)
        de = jnp.maximum(hde, ewin)
        g = jnp.where(incell, jnp.maximum(de - qr, 0), NEG_BIG)
        # f_{i+1} = max(f_i - r, g_i): g_i reaches cell i+k decayed by
        # (k-1)*r, hence the +1 in the key
        key = g + (i_abs + 1) * r
        cm = jax.lax.cummax(key, axis=1)
        cm_excl = jnp.concatenate(
            [jnp.full((B, 1), NEG_BIG, I32), cm[:, :-1]], axis=1)
        f = cm_excl - i_abs * r
        h = jnp.where(incell, jnp.maximum(de, f), 0)

        rowmax = jnp.max(h, axis=1)
        pos = jnp.argmax(h, axis=1).astype(I32)
        upd = valid & (rowmax > score)
        score = jnp.where(upd, rowmax, score)
        end_i = jnp.where(upd, w0 + pos, end_i)
        end_j = jnp.where(upd, j, end_j)

        posm = (h > 0) & incell
        anyp = posm.any(axis=1)
        nstart = w0 + jnp.argmax(posm, axis=1).astype(I32)
        nend = w0 + (W - 1) - jnp.argmax(posm[:, ::-1], axis=1).astype(I32)

        h_shift = jnp.concatenate(
            [jnp.zeros((B, 1), I32), h[:, :-1]], axis=1)
        hmask = ((i_abs >= start2[:, None]) & (i_abs <= end2[:, None])
                 & valid[:, None])
        e_new = jnp.maximum(ewin - r, jnp.maximum(h - qr, 0))
        new_h = jnp.where(hmask, h_shift, hwin)
        new_e = jnp.where(incell, e_new,
                          jnp.where((i_abs == end2[:, None])
                                    & valid[:, None], 0, ewin))
        eh_h = jax.lax.dynamic_update_slice(eh_h, new_h, (0, w0))
        eh_e = jax.lax.dynamic_update_slice(eh_e, new_e, (0, w0))

        alive = alive & jnp.where(valid, anyp, True)
        start = jnp.where(valid & anyp, nstart, start2)
        end = jnp.where(valid & anyp, nend + 3, end2)
        return ((eh_h, eh_e, start, end, alive, score, end_i, end_j),
                None)

    js = jnp.arange(1, L2 + 1, dtype=I32)
    st, _ = jax.lax.scan(row2, st0, js)
    (_, _, _, _, _, score, end_i, end_j) = st
    return score - 1, end_i, end_j


# bucket grids: static compile shapes (each compiles once on first use
# and lands in the persistent compile cache).  L1 (target length) only
# sizes the carry arrays — per-row work is the W window — so one generous
# bucket suffices; L2 sets the scan length and B the lane count.
L1_CAP = 4096
L2_BUCKETS = (128, 256, 512, 1024, 2048)
B_BUCKETS = (256, 1024, 4096)


def extend_jobs(targets: list[np.ndarray], queries: list[np.ndarray],
                g0: np.ndarray, band: np.ndarray, matrix: np.ndarray,
                gap_open: int, gap_ext: int) -> tuple[np.ndarray, list[int]]:
    """Bucketed batch: routes jobs into fixed (B, L2) compile shapes.

    Returns (out int32[n, 3], host_idx) where host_idx lists jobs the
    device can't take (too long, or 16-bit-rescale-prone scores) — the
    caller runs those on the host scalar kernel.
    """
    n = len(targets)
    out = np.zeros((n, 3), dtype=np.int32)
    out[:, 0] = -1
    mm = int(matrix.max())
    host: list[int] = []
    buckets: dict[int, list[int]] = {}
    for i in range(n):
        lt, lq = len(targets[i]), len(queries[i])
        if not lt or not lq:
            continue  # (-1, 0, 0) like the host kernel
        if (lt > L1_CAP - 2 or lq > L2_BUCKETS[-1]
                or not extend_gate_ok(lq, int(g0[i]), mm)):
            host.append(i)
            continue
        for l2 in L2_BUCKETS:
            if lq <= l2:
                buckets.setdefault(l2, []).append(i)
                break
    W = 128
    while W < 2 * int(band.max() if n else 0) + 2:
        W *= 2
    for l2, idxs in sorted(buckets.items()):
        for lo in range(0, len(idxs), B_BUCKETS[-1]):
            sub = idxs[lo:lo + B_BUCKETS[-1]]
            B = next(b for b in B_BUCKETS if b >= len(sub))
            tp = np.zeros((B, max(L1_CAP + 2, W)), dtype=np.uint8)
            qp = np.zeros((B, l2), dtype=np.uint8)
            tl = np.zeros(B, np.int32)
            ql = np.zeros(B, np.int32)
            g0b = np.zeros(B, np.int32)
            bb = np.ones(B, np.int32)
            for bi, i in enumerate(sub):
                t, q = targets[i], queries[i]
                tp[bi, 1:len(t) + 1] = t
                qp[bi, :len(q)] = q
                tl[bi], ql[bi] = len(t), len(q)
                g0b[bi], bb[bi] = g0[i], band[i]
            sc, ei, ej = _extend_scan(
                jnp.asarray(tp), jnp.asarray(tl), jnp.asarray(qp),
                jnp.asarray(ql), jnp.asarray(g0b), jnp.asarray(bb),
                jnp.asarray(matrix.astype(np.int32).reshape(-1)),
                int(gap_open), int(gap_ext),
                L1=int(tp.shape[1] - 2), L2=int(l2), W=W)
            res = np.stack([np.asarray(sc), np.asarray(ei),
                            np.asarray(ej)], axis=1)
            out[sub] = res[:len(sub)]
    return out, host


def extend_batch(targets: list[np.ndarray], queries: list[np.ndarray],
                 g0: np.ndarray, band: np.ndarray, matrix: np.ndarray,
                 gap_open: int, gap_ext: int,
                 max_w: int = 128) -> np.ndarray:
    """Run a batch of extension jobs; returns int32[n, 3] (score, ei, ej).

    Jobs are padded to the batch max (callers should bucket by size).
    Empty jobs (len 0 target or query) return (-1, 0, 0) like the host.
    """
    n = len(targets)
    out = np.zeros((n, 3), dtype=np.int32)
    out[:, 0] = -1
    run = [i for i in range(n) if len(targets[i]) and len(queries[i])]
    if not run:
        return out
    L1 = max(len(targets[i]) for i in run)
    L2 = max(len(queries[i]) for i in run)
    W = int(max_w)
    while W < 2 * int(band.max()) + 2:
        W *= 2
    B = len(run)
    tp = np.zeros((B, max(L1 + 2, W)), dtype=np.uint8)
    qp = np.zeros((B, L2), dtype=np.uint8)
    tl = np.zeros(B, np.int32)
    ql = np.zeros(B, np.int32)
    for bi, i in enumerate(run):
        t, q = targets[i], queries[i]
        tp[bi, 1:len(t) + 1] = t
        qp[bi, :len(q)] = q
        tl[bi], ql[bi] = len(t), len(q)
    sc, ei, ej = _extend_scan(
        jnp.asarray(tp), jnp.asarray(tl), jnp.asarray(qp), jnp.asarray(ql),
        jnp.asarray(g0[run].astype(np.int32)),
        jnp.asarray(band[run].astype(np.int32)),
        jnp.asarray(matrix.astype(np.int32).reshape(-1)),
        int(gap_open), int(gap_ext),
        L1=int(tp.shape[1] - 2), L2=int(L2), W=W)
    out[run, 0] = np.asarray(sc)
    out[run, 1] = np.asarray(ei)
    out[run, 2] = np.asarray(ej)
    return out
