"""chip_smoke.py and bench.py: refusal without a GPU, and the smoke run's
checks exercised on the CPU at small sizes (the full-size run needs the
card: `python chip_smoke.py`)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, script)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "GPU" in out.stderr


def test_compare_lanes_band_and_flips():
    ref = np.array([-100.0, -120.0, -149.0, -500.0, -np.inf, -600.0])
    got = ref.copy()
    got[0] *= 1 + 1e-12
    got[5] = -np.inf          # a flip outside the 50-nat band
    st = chip_smoke.compare_lanes(got, ref)
    assert st["band"] == 3
    assert st["band_finite_mismatch"] == 0
    assert st["out_of_band_finite_mismatch"] == 1
    assert st["max_rel_err"] == pytest.approx(1e-12, rel=1e-3)
    assert st["nan_or_posinf"] == 0
    got[1] = -np.inf          # a flip inside the band
    assert chip_smoke.compare_lanes(got, ref)["band_finite_mismatch"] == 1


def test_as_likelihood_parity_small():
    st = chip_smoke.as_likelihood_parity(n_draws=96, T=20)
    assert st["band"] > 0 and st["max_rel_err"] <= chip_smoke.PARITY_RTOL


def test_linear_likelihood_parity_small():
    st = chip_smoke.linear_likelihood_parity(n_draws=64)
    assert st["finite"] == 64


def test_poisoned_lane_that_stays_finite_fails():
    """The NaN-lane check must fail when a poisoned lane is not -inf."""
    f = lambda th: np.sum(np.nan_to_num(th), axis=1)
    th = np.ones((4, 2))
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.poisoned_lanes_check(
            f, th, f(th), (0,), lambda t: t.__setitem__(0, np.nan))


def _trace_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "trace_as_likelihood",
        os.path.join(REPO, "benchmarks", "trace_as_likelihood.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_reduction_helpers():
    """Busy time merges overlapping kernel intervals; the operation and
    byte models scale with the sample length and the state size."""
    t = _trace_module()
    assert t.merged_busy_ns([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    step = t.flops_per_particle(T=81) - t.flops_per_particle(T=80)
    assert step > 0
    assert t.flops_per_particle(T=160) - t.flops_per_particle() == 80 * step
    # s, K, F, W, M read and written; T, Z, d read: (2*60 + 57) doubles
    assert t.carry_bytes_per_step() == 8 * (2 * 60 + 57)
