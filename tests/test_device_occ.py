"""Direct parity of the device occ kernels across block intervals.

`build_device_pair(intv=...)` re-checkpoints the 128-base disk layout at
64- or 32-base intervals (smaller rows, fewer bytes per gather).  These
tests pin occ4/occ1
and the LF walk bit-equal to the host FmIndex (reference bwt.c:90-214
semantics) for every supported interval, including the sentinel-adjusted
edge rows (k == NEG1, k == seq_len, k at/around primary).
"""

import numpy as np
import pytest

from ibwa_tpu.fm.fmindex import FmIndex
from ibwa_tpu.index import builder

from conftest import make_genome


@pytest.fixture(scope="module")
def occ_index(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("occ")
    fa = tmp / "g.fa"
    make_genome(fa, [("c1", "", 20000, 0.0), ("c2", "", 7001, 0.0)],
                seed=902)
    builder.bwa_index(str(fa))
    return (FmIndex(builder.load_index(str(fa), 0)),
            FmIndex(builder.load_index(str(fa), 1)))


def _edge_ks(fm):
    n = fm.seq_len
    prim = int(fm.primary)
    ks = [0, 1, 15, 16, 31, 32, 63, 64, 127, 128, n - 1, n, 0xFFFFFFFF,
          prim - 1, prim, prim + 1]
    return [k & 0xFFFFFFFF for k in ks if -1 <= k <= n or k == 0xFFFFFFFF]


@pytest.mark.parametrize("intv", [32, 64, 128])
def test_occ4_occ1_parity(occ_index, intv):
    import jax.numpy as jnp
    from ibwa_tpu.fm.device import build_device_pair, occ1, occ4

    fms = occ_index
    dfm = build_device_pair(fms[0], fms[1], intv=intv, dimer=False)
    rng = np.random.default_rng(7)
    n = fms[0].seq_len
    ks = np.concatenate([
        rng.integers(0, n + 1, 500).astype(np.uint32),
        np.array(_edge_ks(fms[0]), dtype=np.uint32),
        np.array(_edge_ks(fms[1]), dtype=np.uint32),
    ])
    strand = (np.arange(len(ks)) % 2).astype(np.uint32)
    got4 = np.asarray(occ4(dfm, jnp.asarray(strand), jnp.asarray(ks)))
    want4 = np.stack([
        fms[int(s)].occ4(int(np.int64(k)) if k != 0xFFFFFFFF else -1)
        for s, k in zip(strand, ks)]).astype(np.uint32)
    np.testing.assert_array_equal(got4, want4)

    cs = rng.integers(0, 4, len(ks)).astype(np.uint32)
    got1 = np.asarray(occ1(dfm, jnp.asarray(strand), jnp.asarray(ks),
                           jnp.asarray(cs)))
    want1 = np.array([
        fms[int(s)].occ(int(np.int64(k)) if k != 0xFFFFFFFF else -1, int(c))
        for s, k, c in zip(strand, ks, cs)], dtype=np.uint32)
    np.testing.assert_array_equal(got1, want1)


@pytest.mark.parametrize("intv", [32, 64])
def test_device_walk_parity_small_intv(occ_index, intv):
    from ibwa_tpu.fm.walk import DeviceWalker

    fms = occ_index
    w = DeviceWalker(fms[0], fms[1])
    from ibwa_tpu.fm.device import build_device_pair
    w.fm = build_device_pair(fms[0], fms[1], intv=intv, dimer=False)
    rng = np.random.default_rng(11)
    rows = rng.integers(0, fms[0].seq_len + 1, 600).astype(np.uint32)
    strand = rng.integers(0, 2, 600).astype(np.uint32)
    got = w.resolve(strand, rows)
    want = np.array([fms[int(s)].sa_at(int(k)) & 0xFFFFFFFF
                     for s, k in zip(strand, rows)], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)
