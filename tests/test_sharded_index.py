"""Sharded-index mode: the FM block table split over an idx mesh axis
(>HBM genomes) must return bit-identical hits to the replicated path."""

import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ibwa_tpu.align import engine_jax
from ibwa_tpu.align.opts import GapOpt, cal_maxdiff
from ibwa_tpu.fm.device import build_device_pair
from ibwa_tpu.fm.fmindex import FmIndex
from ibwa_tpu.index.builder import build_bwt_index
from ibwa_tpu.parallel import mesh as pmesh


def _problem(n_reads=32, read_len=40, glen=16384, seed=3):
    rng = random.Random(seed)
    seq = np.array([rng.randrange(4) for _ in range(glen)], dtype=np.uint8)
    fwd = FmIndex(build_bwt_index(seq))
    rev = FmIndex(build_bwt_index(seq[::-1].copy()))
    dfm = build_device_pair(fwd, rev, put=np.asarray)
    opt = GapOpt()
    L = (read_len + 7) // 8 * 8
    seqs = np.full((n_reads, 2, L), 4, dtype=np.uint8)
    lens = np.full(n_reads, read_len, dtype=np.int32)
    for b in range(n_reads):
        pos = rng.randrange(glen - read_len)
        r = seq[pos:pos + read_len].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1].copy()
        r[rng.randrange(read_len)] = rng.randrange(4)
        seqs[b, 0] = np.pad(r[::-1], (0, L - read_len), constant_values=4)
        seqs[b, 1] = np.pad((3 - r)[::-1], (0, L - read_len),
                            constant_values=4)
    md = np.full(n_reads, cal_maxdiff(read_len, thres=opt.fnr),
                 dtype=np.int32)
    has_seed = np.full(n_reads, read_len > opt.seed_len, dtype=bool)
    SL = min(opt.seed_len, L)
    seed_seqs = (seqs[:, :, read_len - SL:read_len].copy()
                 if read_len > SL
                 else np.full((n_reads, 2, SL), 4, dtype=np.uint8))
    bad = np.zeros(n_reads, dtype=bool)
    cfg = engine_jax.make_config(L, int(md.max()), opt)
    return dfm, cfg, (seqs, lens, md, has_seed, seed_seqs, bad)


def test_sharded_index_matches_replicated():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    dfm, cfg, batch = _problem()

    # pad the block table so 2*n_blk divides the idx axis
    n_idx = 4
    rows = dfm.blocks.shape[0]
    pad = (-rows) % n_idx
    if pad:
        dfm.blocks = np.concatenate(
            [dfm.blocks, np.zeros((pad, 12), np.uint32)])

    mesh2 = pmesh.make_mesh_2d(2, n_idx, devices=devs[:8])
    got = pmesh.run_sharded_index_search(cfg, mesh2, dfm, *batch,
                                         n_lanes=8)
    g_hits, g_nh, g_fb, _ = jax.tree.map(np.asarray, got)

    want = engine_jax._run_search_persistent(
        cfg, *map(np.asarray, (dfm.blocks, dfm.L2, dfm.l2diff,
                               dfm.primary)), *batch,
        seq_len=dfm.seq_len, n_blk=dfm.n_blk, n_lanes=8)
    w_hits, w_nh, w_fb, _ = jax.tree.map(np.asarray, want)

    assert (g_nh == w_nh).all()
    assert (g_fb == w_fb).all()
    assert not w_fb.any()
    assert int(w_nh.sum()) > 0
    for i in range(len(w_nh)):
        assert (g_hits[i, :w_nh[i]] == w_hits[i, :w_nh[i]]).all()
