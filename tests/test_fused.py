"""Fused device-side recursion (make_fused_recursion: the whole tempering
loop in ONE lax.while_loop) must reproduce the host-loop driver exactly —
same key discipline, same stage math, zero per-stage host syncs."""

import numpy as np
import pytest
import jax

from smc_jax import smc
from smc_jax.models.regression import (regression_parameters,
                                       make_regression_loglike,
                                       generate_regression_data)
from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                   generate_linear_data)


@pytest.fixture(scope="module")
def reg():
    y, x = generate_regression_data(n=100, seed=1793)
    return y, make_regression_loglike(x)


def _assert_runs_match(a, b):
    np.testing.assert_allclose(np.asarray(a.cloud.params),
                               np.asarray(b.cloud.params))
    np.testing.assert_allclose(np.asarray(a.cloud.loglh),
                               np.asarray(b.cloud.loglh))
    np.testing.assert_allclose(a.cloud.tempering_schedule,
                               b.cloud.tempering_schedule)
    np.testing.assert_allclose(a.cloud.ESS, b.cloud.ESS)
    np.testing.assert_allclose(a.w, b.w)
    np.testing.assert_allclose(a.W, b.W)
    assert a.cloud.resamples == b.cloud.resamples
    assert a.cloud.stage_index == b.cloud.stage_index
    np.testing.assert_allclose(a.log_mdd, b.log_mdd, rtol=1e-12)
    np.testing.assert_allclose(a.cloud.c, b.cloud.c, rtol=1e-12)


def test_fused_matches_host_fixed_schedule(reg):
    y, ll = reg
    kw = dict(n_parts=512, n_phi=50, lam=2.0, alpha=0.9, seed=3,
              verbose="none")
    host = smc(ll, regression_parameters(), y, fused=False, **kw)
    fused = smc(ll, regression_parameters(), y, fused=True, **kw)
    _assert_runs_match(host, fused)


def test_fused_matches_host_adaptive_schedule(reg):
    y, ll = reg
    kw = dict(n_parts=512, n_phi=100, lam=2.0, alpha=0.9, seed=4,
              verbose="none", use_fixed_schedule=False,
              tempering_target=0.95)
    host = smc(ll, regression_parameters(), y, fused=False, **kw)
    fused = smc(ll, regression_parameters(), y, fused=True, **kw)
    assert 2 < len(fused.cloud.tempering_schedule) < 100
    _assert_runs_match(host, fused)


def test_fused_matches_host_blocked_multistep():
    data, X = generate_linear_data(seed=1793)
    ll = make_linear_loglike(X)
    kw = dict(n_parts=512, n_phi=40, lam=2.0, alpha=0.9, n_blocks=3,
              n_mh_steps=2, seed=5, verbose="none")
    host = smc(ll, linear_parameters(), data, fused=False, **kw)
    fused = smc(ll, linear_parameters(), data, fused=True, **kw)
    _assert_runs_match(host, fused)


def test_fused_chunk_stages_matches_host(reg):
    """fused_chunk_stages bounds stages per dispatch (deadline-limited
    devices); chunking must not change the chain."""
    y, ll = reg
    kw = dict(n_parts=512, n_phi=50, lam=2.0, alpha=0.9, seed=3,
              verbose="none")
    host = smc(ll, regression_parameters(), y, fused=False, **kw)
    fused = smc(ll, regression_parameters(), y, fused=True,
                fused_chunk_stages=7, **kw)
    _assert_runs_match(host, fused)


def test_fused_matches_host_across_chunk_boundaries(reg):
    """Adaptive runs can exceed n_phi stages; the fused driver then re-invokes
    the compiled program with fresh trace buffers. Crossing chunk boundaries
    must not change a single bit of the chain."""
    y, ll = reg
    kw = dict(n_parts=512, n_phi=16, lam=2.0, alpha=0.9, seed=6,
              verbose="none", use_fixed_schedule=False,
              tempering_target=0.97)
    host = smc(ll, regression_parameters(), y, fused=False, **kw)
    fused = smc(ll, regression_parameters(), y, fused=True, **kw)
    # the run must actually span multiple 16-stage chunks
    assert len(fused.cloud.tempering_schedule) > 2 * 16
    _assert_runs_match(host, fused)


def test_fused_auto_selection_and_validation(reg):
    y, ll = reg
    # auto: verbose="none" without checkpointing -> fused; result identical
    # either way, so just check the incompatible-combination error
    with pytest.raises(ValueError):
        smc(ll, regression_parameters(), y, n_parts=256, n_phi=20,
            verbose="low", fused=True, run_test=True)


def test_fused_no_weight_matrices(reg):
    y, ll = reg
    res = smc(ll, regression_parameters(), y, n_parts=512, n_phi=50,
              lam=2.0, seed=3, verbose="none", fused=True,
              store_weight_matrices=False)
    assert res.w is None and res.W is None
    assert np.isfinite(res.log_mdd)
