"""The search step's stack update against a plain NumPy model, and the
arena size make_config chooses.

The model frees the popped slot, hands child j the free slot of rank
ofs[j] (free slots in ascending order, ranked before any push), counts a
child with no free slot left as overflow, and picks the next pop as the
first slot of least key."""

import numpy as np
import pytest

from ibwa_tpu.align import engine_jax
from ibwa_tpu.align.opts import BWA_MODE_NONSTOP, GapOpt

INT32_MAX = engine_jax.INT32_MAX
NCH = 10


def stack_update_model(slot0, act, cv, ofs, kv, ck, cl, cm1, cm2,
                       key, sk, sl, sm1, sm2):
    key, sk, sl, sm1, sm2 = (a.copy() for a in (key, sk, sl, sm1, sm2))
    B, _ = key.shape
    ovf = np.zeros(B, bool)
    npush = np.zeros(B, np.int64)
    pick = np.zeros(B, np.int64)
    for b in range(B):
        if act[b]:
            key[b, slot0[b]] = INT32_MAX
        free = np.flatnonzero(key[b] == INT32_MAX)
        for j in range(NCH):
            if not cv[b, j]:
                continue
            if ofs[b, j] >= len(free):
                ovf[b] = True
                continue
            s = free[ofs[b, j]]
            key[b, s], sk[b, s], sl[b, s] = kv[b, j], ck[b, j], cl[b, j]
            sm1[b, s], sm2[b, s] = cm1[b, j], cm2[b, j]
            npush[b] += 1
        pick[b] = int(np.argmin(key[b]))
    r = np.arange(B)
    return (key, sk, sl, sm1, sm2, ovf, npush, pick, key[r, pick],
            sk[r, pick], sl[r, pick], sm1[r, pick], sm2[r, pick])


def stack_inputs(rng, B, acap):
    """Random stack-update arguments: planes from empty to nearly full
    (a quarter of the rows overflow), pushes ranked the way _search_step
    ranks them (exclusive cumsum of the valid children)."""
    fill = rng.uniform(0, 1, (B, 1))
    fill[: B // 4] = 1.0 - 3.0 / acap   # 3 free slots at most: overflow
    used = rng.uniform(0, 1, (B, acap)) < fill
    key = np.where(used, rng.integers(0, 1 << 30, (B, acap)), INT32_MAX)
    key = key.astype(np.int32)
    u32 = lambda *shape: rng.integers(0, 1 << 32, shape, dtype=np.uint64
                                      ).astype(np.uint32)
    slot0 = rng.integers(0, acap, B).astype(np.int32)
    act = rng.uniform(0, 1, B) < 0.8
    cv = (rng.uniform(0, 1, (B, NCH)) < 0.5) & act[:, None]
    ofs = (np.cumsum(cv, axis=1) - cv).astype(np.int32)
    kv = rng.integers(0, 1 << 30, (B, NCH)).astype(np.int32)
    kv[:, 3] = kv[:, 1]   # equal keys: argmin must take the first slot
    children = [u32(B, NCH) for _ in range(4)]
    planes = [u32(B, acap) for _ in range(4)]
    return (slot0, act, cv, ofs, kv, *children, key, *planes)


@pytest.mark.parametrize("acap", [256, 1024])
def test_stack_update_matches_model(acap):
    rng = np.random.default_rng(acap)
    args = stack_inputs(rng, 64, acap)
    got = [np.asarray(x) for x in engine_jax.stack_update(*args)]
    want = stack_update_model(*args)
    names = ["key", "sk", "sl", "sm1", "sm2", "ovf", "npush", "pslot",
             "pkey", "pk", "pl", "pm1", "pm2"]
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert want[5].any() and not want[5].all()   # some rows overflow


@pytest.mark.parametrize("case,seq_len,acap", [
    ("default", 1 << 26, engine_jax.ACAP),
    ("small_genome", 1 << 20, 1024),
    ("wide_diff", 1 << 26, 1024),
    ("two_gap_opens", 1 << 26, 1024),
    ("nonstop", 1 << 26, 1024),
])
def test_make_config_arena(case, seq_len, acap):
    """Narrow default budgets on big genomes take the small arena; wide
    budgets and small genomes (wide SA intervals) the 1024-slot one."""
    opt = GapOpt()
    max_diff = 4
    if case == "wide_diff":
        max_diff = 6
    elif case == "two_gap_opens":
        opt = GapOpt(max_gapo=2)
    elif case == "nonstop":
        opt = GapOpt(mode=GapOpt().mode | BWA_MODE_NONSTOP)
    cfg = engine_jax.make_config(104, max_diff, opt, seq_len=seq_len)
    assert cfg.acap == acap
    assert cfg.L == 104 and cfg.SL == opt.seed_len
