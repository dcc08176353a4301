"""The persistent compile cache helper (smc_jax/compile_cache.py)."""

import os
import subprocess
import sys

import jax

from smc_jax import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_honours_env_var(tmp_path, monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    target = tmp_path / "cache_from_env"
    monkeypatch.setenv(compile_cache.ENV_VAR, str(target))
    try:
        assert compile_cache.enable_compile_cache() == str(target)
        assert jax.config.jax_compilation_cache_dir == str(target)
        assert target.is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_is_checkout_dir_independent_of_cwd_and_pid(tmp_path):
    """Without the env var the cache is <checkout>/.jax_cache: two processes
    started from different working directories report the same path."""
    env = {k: v for k, v in os.environ.items()
           if k != compile_cache.ENV_VAR}
    env["PYTHONPATH"] = REPO
    code = ("from smc_jax.compile_cache import cache_dir, default_cache_dir;"
            "assert cache_dir() == default_cache_dir(); print(cache_dir())")
    paths = []
    for cwd in (tmp_path, REPO):
        out = subprocess.run([sys.executable, "-c", code], cwd=str(cwd),
                             env=env, capture_output=True, text=True,
                             timeout=120, check=True)
        paths.append(out.stdout.strip())
    assert paths[0] == paths[1] == os.path.join(REPO, ".jax_cache")
