"""Observability layer: verbosity gating, stage prints, NaN-ESS forensics
(reference src/util.jl:117-180, src/helpers.jl:270-305)."""

import numpy as np
import pytest
import jax.numpy as jnp

from smc_jax.cloud import Cloud
from smc_jax.diagnostics import (VERBOSITY, vprint, init_stage_print,
                                 end_stage_print, check_nan_ess)
from smc_jax import smc
from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                   generate_linear_data)


def test_verbosity_dict_matches_reference():
    assert VERBOSITY == {"none": 0, "low": 1, "high": 2}  # src/SMC.jl:19


def test_vprint_gating(capsys):
    vprint("none", "low", "hidden")
    vprint("low", "low", "shown")
    vprint("low", "high", "hidden2")
    vprint("high", "high", "shown2")
    out = capsys.readouterr().out
    assert "shown" in out and "shown2" in out
    assert "hidden" not in out and "hidden2" not in out


def _cloud():
    c = Cloud.create(3, 10)
    c.ESS = [10.0, float("nan")]
    c.stage_index = 2
    return c


def test_check_nan_ess_raises_with_cause_analysis():
    c = _cloud()
    inc = np.array([1.0, np.inf, np.nan] + [1.0] * 7)
    norm = np.zeros(10)
    with pytest.raises(AssertionError) as e:
        check_nan_ess(c, 2, inc, norm, "", False)
    msg = str(e.value)
    assert "No particles have non-zero weight." in msg
    assert "infinite log-likelihoods" in msg
    assert "NaN log-likelihoods" in msg
    assert "machine-error" in msg


def test_check_nan_ess_debug_dump(tmp_path):
    c = _cloud()
    path = str(tmp_path / "cloud.npz")
    with pytest.raises(AssertionError) as e:
        check_nan_ess(c, 2, np.ones(10), np.zeros(10), path, True)
    import os
    dump = str(tmp_path / "cloud_debug_assertion.npz")
    assert os.path.exists(dump)
    assert "dumped" in str(e.value)


def test_check_nan_ess_noop_when_finite():
    c = Cloud.create(3, 10)
    c.ESS = [10.0, 7.3]
    c.stage_index = 2
    check_nan_ess(c, 2, np.ones(10), np.ones(10), "", False)  # no raise


def test_stage_prints_smoke(capsys):
    c = Cloud.create(3, 10)
    c.n_phi = 50
    init_stage_print(c, ["a", "b", "c"], verbose="high")
    end_stage_print(c, ["a", "b", "c"], verbose="high", stage_time=0.5)
    out = capsys.readouterr().out
    assert "SMC stage" in out
    assert "ESS" in out
    assert "mean" in out  # high verbosity prints the parameter table


def test_verbose_low_end_to_end(capsys):
    """verbose='low' prints a line per stage (parity with the reference's
    init/end stage prints)."""
    data, X = generate_linear_data(seed=1793)
    ll = make_linear_loglike(X)
    smc(ll, linear_parameters(), data, n_parts=100, n_phi=10, lam=2.0,
        verbose="low", seed=0)
    out = capsys.readouterr().out
    assert "SMC recursion starts" in out
    assert "stage 10/10" in out


def test_profile_dir_writes_trace(tmp_path):
    """smc(profile_dir=...) must actually start/stop a jax.profiler trace
    and leave trace artifacts on disk."""
    import os
    data, X = generate_linear_data(seed=1793)
    ll = make_linear_loglike(X)
    pdir = str(tmp_path / "trace")
    smc(ll, linear_parameters(), data, n_parts=64, n_phi=6, lam=2.0,
        verbose="none", seed=0, profile_dir=pdir)
    files = [os.path.join(r, f) for r, _, fs in os.walk(pdir) for f in fs]
    assert files, "profile_dir produced no trace artifacts"
    assert any(f.endswith((".pb", ".json.gz", ".xplane.pb", ".trace.json.gz"))
               for f in files), files
