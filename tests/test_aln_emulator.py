"""Differential tests: our `aln` search vs the reference binary's .sai output.

The host emulator (engine_ref) is the semantic oracle for the device engine, so
it must be bit-exact against the reference binary first.
"""

import hashlib
import io
import random
import subprocess

import pytest

from ibwa_tpu.align.opts import GapOpt, BWA_MODE_NONSTOP
from ibwa_tpu.align.pipeline import aln_to_stream
from ibwa_tpu.index import builder

from conftest import make_genome


@pytest.fixture(scope="module")
def small_case(tmp_path_factory, oracle):
    """Tiny genome + reads with subs and indels, indexed by both pipelines."""
    tmp = tmp_path_factory.mktemp("aln")
    fa = tmp / "g.fa"
    genome = make_genome(str(fa), [("c1", "", 60000, 0.0)], seed=5150)
    fa_ref = tmp / "g_ref.fa"
    fa_ref.write_bytes(fa.read_bytes())
    subprocess.run([oracle, "index", str(fa_ref)], check=True,
                   capture_output=True)
    builder.bwa_index(str(fa))

    rng = random.Random(33)
    seq = genome["c1"]
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    fq = tmp / "r.fq"
    with open(fq, "w") as f:
        for i in range(25):
            pos = rng.randrange(0, len(seq) - 120)
            s = list(seq[pos:pos + 110])
            r = rng.random()
            if r < 0.4:
                d = rng.randrange(20, 80)
                del s[d:d + rng.randrange(1, 4)]
            elif r < 0.8:
                p = rng.randrange(20, 80)
                s = s[:p] + [rng.choice("ACGT")
                             for _ in range(rng.randrange(1, 4))] + s[p:]
            s = s[:100]
            for j in range(len(s)):
                if rng.random() < 0.01:
                    s[j] = rng.choice("ACGT")
            if rng.random() < 0.5:
                s = [comp[c] for c in reversed(s)]
            f.write(f"@r{i}\n{''.join(s)}\n+\n{'I' * len(s)}\n")
    return tmp, fa, fa_ref, fq


CASES = {
    "default": ([], GapOpt()),
    "exact": (["-n", "0"], GapOpt(max_diff=0, fnr=-1.0)),
    "gappy": (["-o", "2", "-e", "5", "-n", "6"],
              GapOpt(max_gapo=2, max_gape=5, max_diff=6, fnr=-1.0,
                     mode=GapOpt().mode & ~0x01)),
    "seeded": (["-l", "20", "-k", "1"], GapOpt(seed_len=20, max_seed_diff=1)),
    "nonstop": (["-N"], GapOpt(mode=GapOpt().mode | BWA_MODE_NONSTOP,
                               max_top2=0x7FFFFFFF)),
}


@pytest.mark.parametrize("engine", ["ref", "jax"])
@pytest.mark.parametrize("case", list(CASES))
def test_sai_parity(small_case, oracle, case, engine):
    tmp, fa, fa_ref, fq = small_case
    flags, opt = CASES[case]
    ref_sai = subprocess.run([oracle, "aln"] + flags + [str(fa_ref), str(fq)],
                             check=True, capture_output=True).stdout
    buf = io.BytesIO()
    aln_to_stream(str(fa), str(fq), opt, buf, engine=engine)
    assert hashlib.md5(buf.getvalue()).hexdigest() == \
        hashlib.md5(ref_sai).hexdigest()
