"""Parity tests for the device SA-resolution LF walker (fm/walk.py).

The SAM stages resolve SA rows to text coordinates via bwt_sa-style LF
walks (reference bwt.c:61-79).  `DeviceWalker.resolve` batches those
walks on the device; these tests pin it bit-equal to the host walk
(`FmIndex.sa_at`) on the CPU backend, and smoke-test the
`IBWA_PE_DEVICE=1` sampe path end-to-end against the host default
(no untested code behind an env flag).
"""

import io
import random

import numpy as np
import pytest

from ibwa_tpu.fm.fmindex import FmIndex
from ibwa_tpu.index import builder

from conftest import make_genome, simulate_reads


@pytest.fixture(scope="module")
def walk_index(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("walk")
    fa = tmp / "g.fa"
    genome = make_genome(fa, [("c1", "", 30000, 0.0), ("c2", "", 12000, 0.0)],
                         seed=515)
    builder.bwa_index(str(fa))
    fms = (FmIndex(builder.load_index(str(fa), 0)),
           FmIndex(builder.load_index(str(fa), 1)))
    return tmp, fa, fms, genome


def test_device_walker_matches_host_sa_walk(walk_index):
    _, _, fms, _ = walk_index
    from ibwa_tpu.fm.walk import DeviceWalker

    w = DeviceWalker(fms[0], fms[1])
    rng = np.random.default_rng(99)
    n = 3000
    rows = rng.integers(0, fms[0].seq_len + 1, n).astype(np.uint32)
    strand = rng.integers(0, 2, n).astype(np.uint32)
    got = w.resolve(strand, rows)
    # the sampled array stores sa[0] = (bwtint_t)-1 (reference bwt.c
    # convention); the walk result wraps mod 2^32 like the reference's
    # uint32 arithmetic, so mask the host oracle's Python int the same way
    want = np.array(
        [fms[int(s)].sa_at(int(k)) & 0xFFFFFFFF
         for s, k in zip(strand, rows)], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


def test_device_walker_covers_every_sampled_phase(walk_index):
    """Rows exactly on / adjacent to sampled slots, plus the primary row
    (the k == primary -> 0 special case inside the LF step)."""
    _, _, fms, _ = walk_index
    from ibwa_tpu.fm.walk import DeviceWalker

    w = DeviceWalker(fms[0], fms[1])
    intv = fms[0].sa_intv
    edge = []
    for base in (0, intv, 7 * intv, fms[0].seq_len // intv * intv):
        for d in (-1, 0, 1):
            k = base + d
            if 0 <= k <= fms[0].seq_len:
                edge.append(k)
    edge.append(fms[0].primary)
    edge.append(fms[1].primary)
    rows = np.array(edge * 2, dtype=np.uint32)
    strand = np.array([0] * len(edge) + [1] * len(edge), dtype=np.uint32)
    got = w.resolve(strand, rows)
    want = np.array(
        [fms[int(s)].sa_at(int(k)) & 0xFFFFFFFF
         for s, k in zip(strand, rows)], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


def test_sampe_device_walks_match_host(walk_index, monkeypatch):
    """IBWA_PE_DEVICE=1 sampe output == host-default sampe output."""
    from ibwa_tpu.align.opts import GapOpt
    from ibwa_tpu.align.pipeline import aln_to_stream
    from ibwa_tpu.sam import pe_native
    from ibwa_tpu.sam.sampe import PeOpt, sai2sam_pe

    tmp, fa, _, genome = walk_index
    fq1, fq2 = simulate_reads(str(tmp / "pe"), genome, 120, paired=True,
                              seed=808)
    sais = []
    for fq in (fq1, fq2):
        sai = fq + ".sai"
        with open(sai, "wb") as f:
            aln_to_stream(str(fa), fq, GapOpt(), f)
        sais.append(sai)

    def run():
        out = io.StringIO()
        sai2sam_pe([str(fa)], [tuple(sais)], fq1, fq2, PeOpt(), out=out)
        return out.getvalue()

    monkeypatch.delenv("IBWA_PE_DEVICE", raising=False)
    host_sam = run()
    monkeypatch.setenv("IBWA_PE_DEVICE", "1")
    assert pe_native.device_available()
    dev_sam = run()
    assert dev_sam == host_sam
