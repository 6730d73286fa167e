"""Differential tests for the auxiliary tools: stdsw vs the oracle binary,
qualfa2fq / solid2fastq vs the reference Perl scripts."""

import random
import subprocess

import pytest

from ibwa_tpu import cli


def _run_ours(args, capsys):
    rc = cli.main(args)
    out = capsys.readouterr().out
    assert rc == 0
    return out


@pytest.fixture(scope="module")
def rng():
    return random.Random(99)


def _seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def test_stdsw_matches_oracle(tmp_path, oracle, capsys, rng):
    """stdsw local alignment text output vs `.refsrc/ibwa stdsw`."""
    ref = tmp_path / "target.fa"
    qry = tmp_path / "query.fa"
    base = _seq(rng, 600)
    with open(ref, "w") as f:
        f.write(">target_sequence_with_a_long_name descr\n")
        for i in range(0, len(base), 60):
            f.write(base[i:i + 60] + "\n")
    with open(qry, "w") as f:
        for i in range(6):
            pos = rng.randrange(0, 400)
            q = list(base[pos:pos + 150])
            for _ in range(rng.randrange(6)):
                j = rng.randrange(len(q))
                r = rng.random()
                if r < 0.6:
                    q[j] = rng.choice("ACGT")
                elif r < 0.8:
                    del q[j]
                else:
                    q.insert(j, rng.choice("ACGT"))
            f.write(f">q{i}\n{''.join(q)}\n")

    want = subprocess.run(
        [str(oracle), "stdsw", str(ref), str(qry)],
        capture_output=True, text=True, check=True).stdout
    got = _run_ours(["stdsw", str(ref), str(qry)], capsys)
    assert got == want


def test_qualfa2fq_matches_perl(tmp_path, capsys, rng, reference_tree):
    fa = tmp_path / "reads.fa"
    qual = tmp_path / "reads.qual"
    with open(fa, "w") as ffa, open(qual, "w") as fq:
        for i in range(8):
            n = rng.randrange(30, 80)
            s = _seq(rng, n)
            qs = " ".join(str(rng.randrange(0, 45)) for _ in range(n))
            ffa.write(f">read{i} comment here\n")
            for j in range(0, n, 60):
                ffa.write(s[j:j + 60] + "\n")
            fq.write(f">read{i} comment here\n{qs}\n")

    want = subprocess.run(
        ["perl", str(reference_tree / "qualfa2fq.pl"), str(fa), str(qual)],
        capture_output=True, text=True, check=True).stdout
    got = _run_ours(["qualfa2fq", str(fa), str(qual)], capsys)
    assert got == want


def _write_solid(d, title, tag, ids, rng):
    """csfasta + _QV.qual for one tag, sorted by panel_x_y like SOLiD."""
    with open(d / f"{title}{tag}.csfasta", "w") as fc, \
            open(d / f"{title}{tag}_QV.qual", "w") as fq:
        fc.write("# Title: run\n")
        fq.write("# Title: run\n")
        for panel, x, y in ids:
            n = 25
            colors = "".join(rng.choice("0123.") for _ in range(n))
            quals = " ".join(
                str(rng.choice([-1] + list(range(40))))
                for _ in range(n))
            fc.write(f">{panel}_{x}_{y}_{tag}\nT{colors}\n")
            fq.write(f">{panel}_{x}_{y}_{tag}\n{quals}\n")


def test_solid2fastq_paired_matches_perl(tmp_path, rng, monkeypatch,
                                         reference_tree):
    """Paired csfasta+qual -> three gz fastqs, byte-compared vs the Perl
    (sorted merge, /1 in read2.gz swap, -1 quals, unpaired singles)."""
    f3 = [(1, 2, y) for y in (3, 5, 8, 11, 20)] + [(1, 3, 1)]
    r3 = [(1, 2, y) for y in (3, 8, 12, 20)] + [(1, 4, 7)]
    da = tmp_path / "perl"
    db = tmp_path / "ours"
    for d in (da, db):
        d.mkdir()
        _write_solid(d, "in", "F3", f3, random.Random(5))
        _write_solid(d, "in", "R3", r3, random.Random(6))

    subprocess.run(
        ["perl", str(reference_tree / "solid2fastq.pl"), "in", "out"],
        cwd=da, capture_output=True, text=True, check=True)
    monkeypatch.chdir(db)
    assert cli.main(["solid2fastq", "in", "out"]) == 0

    import gzip
    for suffix in ("single", "read1", "read2"):
        wa = gzip.open(da / f"out.{suffix}.fastq.gz").read()
        wb = gzip.open(db / f"out.{suffix}.fastq.gz").read()
        assert wa == wb, f"{suffix} differs"


def test_solid2fastq_single_end_matches_perl(tmp_path, rng, monkeypatch,
                                             reference_tree):
    f3 = [(1, 2, 3), (1, 2, 9), (2, 0, 4)]
    da = tmp_path / "perl"
    db = tmp_path / "ours"
    for d in (da, db):
        d.mkdir()
        _write_solid(d, "in", "F3", f3, random.Random(7))
    subprocess.run(
        ["perl", str(reference_tree / "solid2fastq.pl"), "in", "out"],
        cwd=da, capture_output=True, text=True, check=True)
    monkeypatch.chdir(db)
    assert cli.main(["solid2fastq", "in", "out"]) == 0
    import gzip
    assert (gzip.open(da / "out.single.fastq.gz").read()
            == gzip.open(db / "out.single.fastq.gz").read())
    assert not (db / "out.read1.fastq.gz").exists()
