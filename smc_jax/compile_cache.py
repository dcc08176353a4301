"""JAX's persistent compilation cache, configured in one place.

Compiling the fused SMC recursion for a DSGE likelihood takes tens of
seconds to minutes; the persistent cache lets a later process load the
compiled executable instead. The cache directory is chosen once:

  * `JAX_COMPILATION_CACHE_DIR`, if set — no other directory is set in code;
  * otherwise `<checkout>/.jax_cache`, derived from this package's location,
    so every process of one checkout shares it whatever its working
    directory, and the path never moves between runs.

`smc()` itself sets no cache; entry points (scripts, benchmarks, the test
suite) call `enable_compile_cache()` once at start-up.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """`<checkout>/.jax_cache`: the directory beside the package."""
    package_dir = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(package_dir), ".jax_cache")


def cache_dir() -> str:
    """The directory `enable_compile_cache` uses."""
    return os.environ.get(ENV_VAR) or default_cache_dir()


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.
    Every compile of at least one second is cached."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
