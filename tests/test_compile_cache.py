"""Where the CLI keeps JAX's persistent compile cache."""

import os
import subprocess
import sys

import jax

from ibwa_tpu import compile_cache

from conftest import REPO, make_genome, simulate_reads


def test_default_is_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        compile_cache.enable()
        assert jax.config.jax_compilation_cache_dir == str(REPO / ".jaxcache")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    compile_cache.enable()
    assert jax.config.jax_compilation_cache_dir == old


def test_cli_aln_writes_to_env_dir(tmp_path):
    """A CLI `aln` in a fresh process with the variable set caches its
    executables there."""
    fa = tmp_path / "g.fa"
    genome = make_genome(fa, [("c1", "", 20000, 0.0)], seed=8)
    (fq,) = simulate_reads(str(tmp_path / "r.fq"), genome, 20, seed=9)
    assert subprocess.run([sys.executable, "-m", "ibwa_tpu", "index",
                           str(fa)], cwd=REPO, capture_output=True).returncode == 0
    cache = tmp_path / "cache"
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_ENABLE_COMPILATION_CACHE="true",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    r = subprocess.run([sys.executable, "-m", "ibwa_tpu", "aln", "-f",
                        str(tmp_path / "r.sai"), str(fa), fq],
                       cwd=REPO, env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    assert any(p.name.endswith("-cache") for p in cache.iterdir())
