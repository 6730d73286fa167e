"""Where compiled XLA executables persist between processes."""

from __future__ import annotations

import os
import pathlib

CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parent.parent / ".jaxcache"


def enable() -> None:
    """Turn on JAX's persistent compile cache; call before the first jit.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets no other directory.  Otherwise the cache lives at a path fixed
    relative to the package (<checkout>/.jaxcache), so every process run
    from this checkout finds what an earlier one compiled.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
