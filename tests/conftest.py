"""Shared test fixtures.

Tests run JAX on CPU with 8 virtual devices so multi-device sharding logic is
exercised without an accelerator. The reference binary (oracle) is built on
demand from the reference source tree for differential tests; tests that need
that tree skip where it is absent.
"""

import os
import pathlib
import random
import shutil
import subprocess

# must be set before jax import anywhere in the test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# the CLI turns on the persistent compile cache in the checkout; keep the
# suite from writing there (tests/test_compile_cache.py turns it back on
# in its own subprocess)
os.environ.setdefault("JAX_ENABLE_COMPILATION_CACHE", "false")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Pin the config as well as the env var, so the suite stays on the CPU
# backend (with its 8 virtual devices) even where an accelerator plugin
# is installed and would otherwise make itself the default.
import jax
jax.config.update("jax_platforms", "cpu")

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = pathlib.Path("/root/reference")
REFSRC = REPO / ".refsrc"


@pytest.fixture(scope="session")
def reference_tree():
    """The reference source tree (its Perl tools; skip if absent)."""
    if not REFERENCE.exists():
        pytest.skip("reference source not available")
    return REFERENCE


@pytest.fixture(scope="session")
def oracle():
    """Path to the compiled reference ibwa binary (skip if unbuildable)."""
    binary = REFSRC / "ibwa"
    if binary.exists():
        return str(binary)
    if not REFERENCE.exists():
        pytest.skip("reference source not available")
    REFSRC.mkdir(exist_ok=True)
    subprocess.run(f"cp -r {REFERENCE}/* {REFSRC}/", shell=True, check=True)
    subprocess.run(["chmod", "-R", "u+w", str(REFSRC)], check=True)
    subprocess.run(
        "sed -e 's/@FULL_VERSION@/0.5.9-ibwa/' -e 's/@CMAKE_BUILD_TYPE@/Release/'"
        " version.h.in > version.h",
        shell=True, cwd=REFSRC, check=True)
    r = subprocess.run(
        ["make", "CFLAGS=-g -Wall -O2 -fgnu89-inline", "-j8"],
        cwd=REFSRC, capture_output=True)
    # the in-tree Makefile misses the C++ objects; finish the link manually
    for f in ["bwaremap", "translate_cigar", "filter_alignments"]:
        subprocess.run(["g++", "-c", "-O2", "-DHAVE_PTHREAD", f"{f}.cpp",
                        "-o", f"{f}.o"], cwd=REFSRC, check=True)
    for f in ["bwapair", "bwasw", "byteorder"]:
        subprocess.run(["gcc", "-c", "-O2", "-fgnu89-inline",
                        "-DHAVE_PTHREAD", f"{f}.c", "-o", f"{f}.o"],
                       cwd=REFSRC, check=True)
    r = subprocess.run(
        "g++ -O2 *.o -o ibwa -lm -lz -lpthread -Lbwt_gen -lbwtgen",
        shell=True, cwd=REFSRC, capture_output=True)
    if not binary.exists():
        pytest.skip(f"could not build oracle: {r.stderr.decode()[-500:]}")
    return str(binary)


def make_genome(path, contigs, seed=1234):
    """Write a deterministic random FASTA; contigs = [(name, comment, length, n_rate)]."""
    rng = random.Random(seed)
    seqs = {}
    with open(path, "w") as f:
        for name, comment, length, n_rate in contigs:
            header = f">{name} {comment}" if comment else f">{name}"
            f.write(header + "\n")
            chars = []
            i = 0
            while i < length:
                if n_rate and rng.random() < n_rate:
                    run = rng.randrange(1, 20)
                    chars.append("N" * run)
                    i += run
                else:
                    chars.append(rng.choice("ACGT"))
                    i += 1
            seq = "".join(chars)[:length]
            seqs[name] = seq
            for j in range(0, len(seq), 70):
                f.write(seq[j:j + 70] + "\n")
    return seqs


def simulate_reads(path, genome, n_reads, read_len=100, err=0.01, seed=99,
                   paired=False, isize_mean=300, isize_sd=30):
    """Simple uniform read simulator with substitution errors."""
    rng = random.Random(seed)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}

    def rc(s):
        return "".join(comp[c] for c in reversed(s))

    def mutate(s):
        out = list(s)
        for i in range(len(out)):
            if rng.random() < err:
                out[i] = rng.choice("ACGT")
        return "".join(out)

    names = list(genome)
    if not paired:
        with open(path, "w") as f:
            for i in range(n_reads):
                ctg = rng.choice(names)
                seq = genome[ctg]
                pos = rng.randrange(0, max(1, len(seq) - read_len))
                s = seq[pos:pos + read_len]
                if rng.random() < 0.5:
                    s = rc(s)
                s = mutate(s)
                f.write(f"@r{i}_{ctg}_{pos}\n{s}\n+\n{'I' * len(s)}\n")
        return [path]
    p1, p2 = path + "_1.fq", path + "_2.fq"
    with open(p1, "w") as f1, open(p2, "w") as f2:
        for i in range(n_reads):
            ctg = rng.choice(names)
            seq = genome[ctg]
            isize = max(read_len + 10, int(rng.gauss(isize_mean, isize_sd)))
            pos = rng.randrange(0, max(1, len(seq) - isize))
            frag = seq[pos:pos + isize]
            r1, r2 = frag[:read_len], rc(frag[-read_len:])
            if rng.random() < 0.5:
                r1, r2 = r2, r1
            f1.write(f"@p{i}_{ctg}_{pos}/1\n{mutate(r1)}\n+\n{'I' * read_len}\n")
            f2.write(f"@p{i}_{ctg}_{pos}/2\n{mutate(r2)}\n+\n{'I' * read_len}\n")
    return [p1, p2]
