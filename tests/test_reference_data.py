"""Estimation/likelihood checks on the reference's SHIPPED datasets
(estimation on a fixed shipped dataset is what makes cross-framework
parity checks possible).

Assets (all read straight from the read-only reference mount with h5py —
JLD2 is HDF5 underneath):
  * test/reference/test_data.h5 — linear fixture data (covered in
    tests/test_oracle.py against the exact posterior)
  * examples/data/capm.jld2     — 3 assets x 36 periods of returns
  * examples/data/sw_orig_smc.h5 — the 7x197 US dataset of the SW example
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smc_jax import smc

pytest.importorskip("h5py")

CAPM_PATH = "/root/reference/examples/data/capm.jld2"
SW_PATH = "/root/reference/examples/data/sw_orig_smc.h5"


@pytest.mark.skipif(not os.path.exists(CAPM_PATH),
                    reason="reference data not mounted")
def test_capm_estimation_on_shipped_data():
    """Estimate the CAPM on the reference's own 36-period dataset
    (reference estimate_capm.jl:40-42) and check the posterior against the
    per-asset OLS fit — with diffuse Normal(0,1e3) priors and T=36 the
    posterior must center on OLS."""
    from smc_jax.models.capm import (capm_parameters, make_capm_loglike,
                                     load_reference_capm_data)
    lik_data, market = load_reference_capm_data()
    assert lik_data.shape[0] == 3 and lik_data.shape[1] == 36
    ll = make_capm_loglike(market)
    # This dataset has returns ~0.03 (posterior sigma ~0.02) under the
    # example's U(0,1e3) priors — a 4.7-order-of-magnitude tempering
    # transport. n_phi=400 with 3 MH steps gives the kernel enough budget
    # (measured: posterior matches OLS to 3 decimals; at the example's
    # n_phi=100 the cloud never arrives — same sigma-phase-transition
    # physics as benchmarks/README.md documents for the linear fixture).
    res = smc(ll, capm_parameters(), lik_data,
              n_parts=2000, n_phi=400, lam=2.0, n_mh_steps=3, alpha=0.9,
              verbose="none", seed=11)
    mu = res.posterior_mean()
    X = np.column_stack([np.ones_like(market), market])
    for i in range(3):
        coef, resid, *_ = np.linalg.lstsq(X, lik_data[i], rcond=None)
        sd_ols = np.sqrt(np.mean((lik_data[i] - X @ coef) ** 2))
        assert abs(mu[3 * i] - coef[0]) < 0.02, (i, mu[3 * i], coef[0])
        assert abs(mu[3 * i + 1] - coef[1]) < 0.1, (i, mu[3 * i + 1], coef[1])
        assert abs(mu[3 * i + 2] - sd_ols) < 0.3 * sd_ols
    assert np.isfinite(res.log_mdd)


@pytest.mark.skipif(not os.path.exists(SW_PATH),
                    reason="reference data not mounted")
def test_sw_likelihood_on_shipped_us_data():
    """The SW model must assign a finite, locally-peaked likelihood to the
    reference's shipped US dataset (examples/data/sw_orig_smc.h5, used by
    dsge_model.jl) at the SW2007-mode parameters."""
    from smc_jax.models.sw_dsge import (smets_wouters, load_reference_sw_data,
                                        TRUE_PARAMS)
    data = load_reference_sw_data()
    assert data.shape == (7, 197)
    model = smets_wouters()
    theta = jnp.asarray(TRUE_PARAMS, jnp.float64)
    ll_mode = float(model.loglike(theta, data))
    assert np.isfinite(ll_mode)
    # per-observation magnitude sanity: a fitted quarterly macro model sits
    # around -1 to -3 nats per observation point
    assert -10.0 < ll_mode / data.size < 0.5, ll_mode
    # perturbing a policy parameter away from the mode must fit worse
    worse = np.array(TRUE_PARAMS, dtype=np.float64)
    worse[1] = 2.5   # csigma far off
    worse[20] = 0.2  # price stickiness far off
    ll_worse = float(model.loglike(jnp.asarray(worse), data))
    assert ll_mode > ll_worse
