"""Adversarial differential cases: N-runs in reads,
-q trimming combined with -I (Illumina-1.3 offset-64 quals), batch-seam
crossing in aln (BAM input) and samse/sampe, and a 3-database remap
corpus.  Oracle: the reference binary (bwaseqio.c:74-141, saiset.c:45-78
are the paths most at risk)."""

import io
import random
import subprocess

import pytest

from ibwa_tpu.align.opts import GapOpt, BWA_MODE_BAM
from ibwa_tpu.align import pipeline
from ibwa_tpu.align.pipeline import aln_to_stream
from ibwa_tpu.index import builder
from ibwa_tpu.sam import bwase, sampe
from ibwa_tpu.sam.bwase import sai2sam_se
from ibwa_tpu.sam.sampe import PeOpt, sai2sam_pe

from conftest import make_genome, simulate_reads
from test_bam import write_bam, COMP
from test_remap import _make_alt, _write_fa


@pytest.fixture(scope="module")
def adv_case(tmp_path_factory, oracle):
    tmp = tmp_path_factory.mktemp("adv")
    fa = tmp / "g.fa"
    # n_rate > 0: the genome itself has N holes (.amb records)
    genome = make_genome(str(fa), [("achr", "", 60000, 0.002)], seed=777)
    fa_ref = tmp / "g_ref.fa"
    fa_ref.write_bytes(fa.read_bytes())
    subprocess.run([oracle, "index", str(fa_ref)], check=True,
                   capture_output=True)
    builder.bwa_index(str(fa))
    return tmp, fa, fa_ref, genome


def test_nrun_reads_samse(adv_case, oracle):
    """Reads carrying long N-runs (3-30 bp) through aln + samse."""
    tmp, fa, fa_ref, genome = adv_case
    rng = random.Random(11)
    seq = genome["achr"]
    rc = lambda s: "".join(COMP[c] for c in reversed(s))
    fq = tmp / "nrun.fq"
    with open(fq, "w") as f:
        for i in range(150):
            pos = rng.randrange(0, len(seq) - 90)
            s = list(seq[pos:pos + 80])
            # inject an N-run (sometimes longer than max_diff allows)
            at = rng.randrange(0, 70)
            run = rng.choice([1, 2, 3, 5, 8, 15, 30])
            s[at:at + run] = "N" * min(run, 80 - at)
            s = "".join(s)
            if rng.random() < 0.5:
                s = rc(s)
            q = "".join(chr(33 + rng.randrange(2, 41)) for _ in s)
            f.write(f"@n{i}\n{s}\n+\n{q}\n")
    ref_sai = tmp / "nrun.ref.sai"
    ref_sai.write_bytes(subprocess.run(
        [oracle, "aln", str(fa_ref), str(fq)], check=True,
        capture_output=True).stdout)
    buf = io.BytesIO()
    aln_to_stream(str(fa), str(fq), GapOpt(), buf, engine="jax")
    assert buf.getvalue() == ref_sai.read_bytes(), ".sai mismatch"
    our_sai = tmp / "nrun.our.sai"
    our_sai.write_bytes(buf.getvalue())
    ref_sam = subprocess.run(
        [oracle, "samse", str(fa_ref), str(ref_sai), str(fq)], check=True,
        capture_output=True).stdout.decode()
    out = io.StringIO()
    sai2sam_se(str(fa), str(our_sai), str(fq), out=out)
    ours = [l for l in out.getvalue().split("\n") if not l.startswith("@PG")]
    refs = [l for l in ref_sam.split("\n") if not l.startswith("@PG")]
    assert ours == refs


def test_trim_plus_illumina64(adv_case, oracle):
    """-q 20 trimming combined with -I (offset-64 quals) end to end."""
    tmp, fa, fa_ref, genome = adv_case
    rng = random.Random(22)
    seq = genome["achr"]
    fq = tmp / "i64.fq"
    with open(fq, "w") as f:
        for i in range(120):
            pos = rng.randrange(0, len(seq) - 90)
            s = "".join(c if rng.random() > 0.02 else rng.choice("ACGT")
                        for c in seq[pos:pos + 76])
            # offset-64 quality with a decaying 3' tail so -q triggers
            q = "".join(chr(64 + max(2, 40 - rng.randrange(0, j + 2)))
                        for j in range(len(s)))
            f.write(f"@i{i}\n{s}\n+\n{q}\n")
    ref_sai = tmp / "i64.ref.sai"
    ref_sai.write_bytes(subprocess.run(
        [oracle, "aln", "-q", "20", "-I", str(fa_ref), str(fq)],
        check=True, capture_output=True).stdout)
    opt = GapOpt(trim_qual=20, mode=GapOpt().mode | 0x200)
    buf = io.BytesIO()
    aln_to_stream(str(fa), str(fq), opt, buf, engine="jax")
    assert buf.getvalue() == ref_sai.read_bytes(), ".sai mismatch"
    our_sai = tmp / "i64.our.sai"
    our_sai.write_bytes(buf.getvalue())
    ref_sam = subprocess.run(
        [oracle, "samse", str(fa_ref), str(ref_sai), str(fq)], check=True,
        capture_output=True).stdout.decode()
    out = io.StringIO()
    sai2sam_se(str(fa), str(our_sai), str(fq), out=out)
    ours = [l for l in out.getvalue().split("\n") if not l.startswith("@PG")]
    refs = [l for l in ref_sam.split("\n") if not l.startswith("@PG")]
    assert ours == refs


def test_bam_input_batch_seam(adv_case, oracle, monkeypatch):
    """BAM-input aln with the pipeline batch shrunk so reads cross the
    batch seam (the reference streams in 0x40000 chunks, bwtaln.c:192);
    seam position must not perturb the .sai stream."""
    tmp, fa, fa_ref, genome = adv_case
    rng = random.Random(33)
    seq = genome["achr"]
    records = []
    for i in range(90):
        pos = rng.randrange(0, len(seq) - 90)
        s = "".join(c if rng.random() > 0.02 else rng.choice("ACGT")
                    for c in seq[pos:pos + 70]).replace("N", "A")
        flag = 0
        if rng.random() < 0.5:
            s = "".join(COMP[c] for c in reversed(s))
            flag = 0x10
        records.append((f"m{i}", flag, s, "I" * len(s)))
    bam = tmp / "seam.bam"
    write_bam(str(bam), records)
    ref_sai = subprocess.run(
        [oracle, "aln", "-b", str(fa_ref), str(bam)], check=True,
        capture_output=True).stdout
    monkeypatch.setattr(pipeline, "BATCH_SIZE", 32)  # 90 reads -> 3 seams
    opt = GapOpt(mode=GapOpt().mode | BWA_MODE_BAM)
    buf = io.BytesIO()
    aln_to_stream(str(fa), str(bam), opt, buf, engine="jax")
    assert buf.getvalue() == ref_sai


def test_sam_stage_batch_seam(adv_case, oracle, monkeypatch):
    """samse/sampe with their record batch shrunk below the read count:
    selection RNG, isize stats and XA expansion must be seam-invariant."""
    tmp, fa, fa_ref, genome = adv_case
    simulate_reads(str(tmp / "seam"), genome, 100, read_len=70, err=0.02,
                   seed=44, paired=True)
    ref_sai1 = tmp / "s1.ref.sai"
    ref_sai2 = tmp / "s2.ref.sai"
    f1, f2 = str(tmp / "seam_1.fq"), str(tmp / "seam_2.fq")
    for sai, fq_ in [(ref_sai1, f1), (ref_sai2, f2)]:
        sai.write_bytes(subprocess.run(
            [oracle, "aln", str(fa_ref), fq_], check=True,
            capture_output=True).stdout)
        buf = io.BytesIO()
        aln_to_stream(str(fa), fq_, GapOpt(), buf, engine="jax")
        assert buf.getvalue() == sai.read_bytes()
    # samse seam
    ref_sam = subprocess.run(
        [oracle, "samse", str(fa_ref), str(ref_sai1), f1], check=True,
        capture_output=True).stdout.decode()
    monkeypatch.setattr(bwase, "BATCH", 32)
    out = io.StringIO()
    sai2sam_se(str(fa), str(ref_sai1), f1, out=out)
    ours = [l for l in out.getvalue().split("\n") if not l.startswith("@PG")]
    refs = [l for l in ref_sam.split("\n") if not l.startswith("@PG")]
    assert ours == refs
    # sampe: isize stats are PER-BATCH state in the reference
    # (bwape.c:603), so parity requires matching batch geometry — the
    # shrunken-batch seam case lives in scripts/parity_scale.py at 300k
    # pairs; here sampe runs at default geometry on the same corpus.
    ref_pe = subprocess.run(
        [oracle, "sampe", str(fa_ref), str(ref_sai1), str(ref_sai2),
         f1, f2], check=True, capture_output=True).stdout.decode()
    out = io.StringIO()
    sai2sam_pe([str(fa)], [(str(ref_sai1), str(ref_sai2))], f1, f2,
               PeOpt(), out=out)
    ours = [l for l in out.getvalue().split("\n") if not l.startswith("@PG")]
    refs = [l for l in ref_pe.split("\n") if not l.startswith("@PG")]
    assert ours == refs


def test_softmask_iupac(tmp_path_factory, oracle):
    """Real-world sequence properties the simulator lacks: soft-masked
    lowercase runs and IUPAC ambiguity codes (both common in public
    assemblies; nst_nt4_table maps them case-insensitively / to N,
    bntseq.c).  Index artifacts + aln + samse byte parity."""
    tmp = tmp_path_factory.mktemp("iupac")
    rng = random.Random(5)
    chars = []
    for _ in range(30000):
        c = rng.choice("ACGT")
        if rng.random() < 0.3:
            c = c.lower()
        if rng.random() < 0.003:
            c = rng.choice("MRWSYKVHDBN")
        chars.append(c)
    s = "".join(chars)
    fa = tmp / "g.fa"
    fa_ref = tmp / "g_ref.fa"
    for p in (fa, fa_ref):
        with open(p, "w") as f:
            f.write(">iu ctg\n")
            for i in range(0, len(s), 61):
                f.write(s[i:i + 61] + "\n")
    subprocess.run([oracle, "index", str(fa_ref)], check=True,
                   capture_output=True)
    builder.bwa_index(str(fa))
    for ext in ("pac", "rpac", "ann", "amb", "bwt", "rbwt", "sa", "rsa"):
        assert (tmp / f"g.fa.{ext}").read_bytes() == \
            (tmp / f"g_ref.fa.{ext}").read_bytes(), ext
    comp = dict(zip("ACGTacgt", "TGCAtgca"))
    fq = tmp / "r.fq"
    with open(fq, "w") as f:
        for i in range(150):
            p = rng.randrange(0, len(s) - 80)
            r = s[p:p + 72]
            if rng.random() < 0.5:
                r = "".join(comp.get(c, "N") for c in reversed(r))
            q = "".join(chr(33 + rng.randrange(2, 41)) for _ in r)
            f.write(f"@u{i}\n{r}\n+\n{q}\n")
    ref_sai = tmp / "r.ref.sai"
    ref_sai.write_bytes(subprocess.run(
        [oracle, "aln", str(fa_ref), str(fq)], check=True,
        capture_output=True).stdout)
    buf = io.BytesIO()
    aln_to_stream(str(fa), str(fq), GapOpt(), buf, engine="jax")
    assert buf.getvalue() == ref_sai.read_bytes(), ".sai mismatch"
    ref_sam = subprocess.run(
        [oracle, "samse", str(fa_ref), str(ref_sai), str(fq)], check=True,
        capture_output=True).stdout.decode()
    out = io.StringIO()
    sai2sam_se(str(fa), str(ref_sai), str(fq), out=out)
    ours = [l for l in out.getvalue().split("\n") if not l.startswith("@PG")]
    refs = [l for l in ref_sam.split("\n") if not l.startswith("@PG")]
    assert ours == refs


@pytest.fixture(scope="module")
def remap3_case(tmp_path_factory, oracle):
    """Primary + TWO alt databases (3 prefixes), mixed exact/edited."""
    tmp = tmp_path_factory.mktemp("remap3")
    rng = random.Random(555)
    pfa = tmp / "p.fa"
    genome = make_genome(str(pfa), [("c1", "", 40000, 0.0),
                                    ("c2", "", 15000, 0.0)], seed=888)
    c1, c2 = genome["c1"], genome["c2"]
    alt1, cig1, stop1 = _make_alt(c1, 8000, [
        ("snp", 300, 0), ("del", 400, 2), ("ins", 350, 3),
        ("snp", 250, 0)], rng)
    a1fa = tmp / "alt1.fa"
    _write_fa(str(a1fa), [("a1", alt1)])
    with open(str(a1fa) + ".remap", "w") as f:
        f.write(f">x1-c1|{8000 + 1}|{stop1}\n")
        for i in range(0, len(cig1), 60):
            f.write(cig1[i:i + 60] + "\n")
    alt2, cig2, stop2 = _make_alt(c2, 3000, [
        ("snp", 200, 0), ("ins", 300, 2), ("del", 280, 1),
        ("snp", 150, 0)], rng)
    a2fa = tmp / "alt2.fa"
    _write_fa(str(a2fa), [("a2", alt2)])
    with open(str(a2fa) + ".remap", "w") as f:
        f.write(f">x2-c2|{3000 + 1}|{stop2}\n")
        for i in range(0, len(cig2), 60):
            f.write(cig2[i:i + 60] + "\n")
    fas = [pfa, a1fa, a2fa]
    ref_fas = []
    for fa in fas:
        rfa = tmp / (fa.stem + "_ref.fa")
        rfa.write_bytes(fa.read_bytes())
        rm = tmp / (fa.name + ".remap")
        if rm.exists():
            (tmp / (rfa.name + ".remap")).write_bytes(rm.read_bytes())
        subprocess.run([oracle, "index", str(rfa)], check=True,
                       capture_output=True)
        builder.bwa_index(str(fa))
        ref_fas.append(rfa)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = lambda s: "".join(comp[c] for c in reversed(s))
    f1, f2 = tmp / "r_1.fq", tmp / "r_2.fq"
    sources = [c1, c2, alt1, alt2]
    with open(f1, "w") as o1, open(f2, "w") as o2:
        for i in range(160):
            src = sources[i % len(sources)]
            isize = max(170, int(rng.gauss(250, 20)))
            pos = rng.randrange(0, len(src) - isize)
            frag = src[pos:pos + isize]
            r1, r2 = frag[:70], rc(frag[-70:])
            if rng.random() < 0.5:
                r1, r2 = r2, r1
            o1.write(f"@q{i}/1\n{r1}\n+\n{'I' * 70}\n")
            o2.write(f"@q{i}/2\n{r2}\n+\n{'I' * 70}\n")
    return tmp, fas, ref_fas, (str(f1), str(f2))


def test_sampe_remap_3db(remap3_case, oracle):
    tmp, fas, ref_fas, fqs = remap3_case
    opt = GapOpt()
    sais = {}
    for j, (fa, rfa) in enumerate(zip(fas, ref_fas)):
        for e, fq in enumerate(fqs):
            ref_sai = tmp / f"d{j}e{e}.sai"
            ref_sai.write_bytes(subprocess.run(
                [oracle, "aln", str(rfa), fq], check=True,
                capture_output=True).stdout)
            buf = io.BytesIO()
            aln_to_stream(str(fa), fq, opt, buf, engine="jax")
            assert buf.getvalue() == ref_sai.read_bytes(), f"sai d{j}e{e}"
            sais[(j, e)] = str(ref_sai)
    ref_sam = subprocess.run(
        [oracle, "sampe", "-R", str(ref_fas[0]), sais[(0, 0)],
         sais[(0, 1)], fqs[0], fqs[1],
         str(ref_fas[1]), sais[(1, 0)], sais[(1, 1)],
         str(ref_fas[2]), sais[(2, 0)], sais[(2, 1)]],
        check=True, capture_output=True).stdout.decode()
    out = io.StringIO()
    sai2sam_pe([str(f) for f in fas],
               [(sais[(0, 0)], sais[(0, 1)]),
                (sais[(1, 0)], sais[(1, 1)]),
                (sais[(2, 0)], sais[(2, 1)])],
               fqs[0], fqs[1], PeOpt(remapping=1), out=out)
    ours = [l for l in out.getvalue().split("\n") if not l.startswith("@PG")]
    refs = [l for l in ref_sam.split("\n") if not l.startswith("@PG")]
    assert len(ours) == len(refs)
    for i, (a, b) in enumerate(zip(ours, refs)):
        assert a == b, f"line {i}:\nours: {a}\nref:  {b}"
