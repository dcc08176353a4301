"""Every example script must RUN: each is executed end-to-end in a
subprocess under SMC_SMOKE=1 (tiny particle counts, same code path).

The subprocess forces the CPU backend itself and shares the checkout's
compile cache (smc_jax.compile_cache) so the smoke runs are compile-cheap."""

import os
import subprocess
import sys

import pytest

EXAMPLES = ["estimate_regression.py", "estimate_linear.py",
            "estimate_capm.py", "estimate_as_dsge.py",
            "estimate_sw_dsge.py", "estimate_sw_real.py"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = (
    "import jax;"
    "jax.config.update('jax_platforms','cpu');"
    "from smc_jax.compile_cache import enable_compile_cache;"
    "enable_compile_cache();"
    "import runpy,sys;"
    "runpy.run_path(sys.argv[1], run_name='__main__')"
)


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_runs(script, tmp_path):
    path = os.path.join(REPO, "examples", script)
    env = dict(os.environ, SMC_SMOKE="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _PRELUDE, path],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, (
        f"{script} crashed:\nSTDOUT:\n{out.stdout[-2000:]}\n"
        f"STDERR:\n{out.stderr[-2000:]}")
    assert "log marginal data density" in out.stdout
