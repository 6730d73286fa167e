"""chip_smoke.py on the CPU: its data, its comparisons on a tiny genome,
its last line, and its refusal to run (or to claim a result) without a
GPU.  The script itself runs on the card; these check its logic."""

import json
import os
import subprocess
import sys
import types

import pytest

from conftest import REPO

sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(genome=150_000, reads=240, pairs=120, long=10)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    d = tmp_path_factory.mktemp("smoke")
    paths = chip_smoke.make_data(d / "data", 5, TINY)
    out = d / "out"
    out.mkdir()
    return paths, out


@pytest.fixture(scope="module")
def arms(smoke):
    paths, out = smoke
    return chip_smoke.aln_arms(str(paths["fa"]), str(paths["se"]), out)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "GPU" in r.stderr
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout


def test_data_shapes(smoke):
    paths, _ = smoke

    def fastq(p):
        lines = p.read_text().splitlines()
        return lines[1::4]

    fa = paths["fa"].read_text().splitlines()
    assert fa[0].startswith(">")
    assert all(len(ln) == 70 for ln in fa[1:-1]) and 0 < len(fa[-1]) <= 70
    assert sum(len(ln) for ln in fa[1:]) == TINY.genome
    se = fastq(paths["se"])
    assert len(se) == TINY.reads and {len(s) for s in se} == {100}
    assert len(fastq(paths["pe1"])) == len(fastq(paths["pe2"])) == TINY.pairs
    long = fastq(paths["long"])
    assert len(long) == TINY.long
    assert all(400 <= len(s) < 1000 for s in long)
    assert paths["fa"].with_suffix(".fa.bwt").exists()


def test_aln_arms_match_native(arms):
    for arm in ("hybrid", "device_only"):
        st = arms[arm]
        assert st["device_reads"] + st["fallback_reads"] == TINY.reads
        assert st["host_reads"] == 0


def test_aln_arms_catch_a_differing_sai(smoke, monkeypatch):
    """One flipped byte in a device .sai must fail the phase."""
    paths, out = smoke
    real = chip_smoke.aln

    def corrupt(prefix, fq, dst, engine="jax", host_frac=None):
        stats = real(prefix, fq, dst, engine=engine, host_frac=host_frac)
        if engine == "jax":
            b = bytearray(dst.read_bytes())
            b[-1] ^= 1
            dst.write_bytes(bytes(b))
        return stats

    monkeypatch.setattr(chip_smoke, "aln", corrupt)
    (out / "corrupt").mkdir()
    with pytest.raises(chip_smoke.SmokeFailure, match="differs"):
        chip_smoke.aln_arms(str(paths["fa"]), str(paths["se"]),
                            out / "corrupt")


def test_sam_and_offpath(smoke, arms):
    paths, out = smoke
    prefix = str(paths["fa"])
    sam = chip_smoke.sam_stage(prefix, paths, out)
    body = chip_smoke.sam_body(sam["sam"]["sampe", "device"])
    assert not any(ln.startswith("@PG") for ln in body)
    assert sum(not ln.startswith("@") for ln in body) == 2 * TINY.pairs
    assert chip_smoke.pe_device_walks(prefix, paths, sam, out) > 0
    offered, on_device = chip_smoke.bwasw_device(prefix, paths, out)
    assert 0 < on_device <= offered


def test_result_line():
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1
