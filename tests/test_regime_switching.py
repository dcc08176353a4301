"""Regime-switching estimation (reference test/regime_switching_smc.jl):
21-column flattened parameter space, posterior means near truth in all
three regimes."""

import numpy as np
import pytest

from smc_jax import smc
from smc_jax.params import ParamSpace
from smc_jax.models.linear import (rs_linear_parameters,
                                   make_rs_linear_loglike,
                                   generate_rs_linear_data)


@pytest.fixture(scope="module")
def result():
    data, Xrs = generate_rs_linear_data(seed=1793)
    space = ParamSpace(rs_linear_parameters(), regime_switching=True)
    ll = make_rs_linear_loglike(Xrs, space)
    # reference config (test/regime_switching_smc.jl:27-30): 120 stages,
    # polyalgo; default 5000 particles — the rs prior scale is 10 so the
    # problem is easier, but keep the reference's particle count.
    return space, smc(ll, space, data,
                      n_parts=5000, n_phi=120, lam=2.1, alpha=0.9,
                      resampling_method="polyalgo", verbose="none",
                      seed=42, regime_switching=True)


def test_posterior_means_near_truth(result):
    """DGP: beta regime r = (r, r+1, r+2); alpha = (1, 2, 3) all regimes;
    sigma (as variance) = 1. alpha_3 fixed at 3 in all regimes. The
    reference's gate is means within 0.5 of truth across regimes
    (test/regime_switching_smc.jl:67-69)."""
    space, res = result
    mu = dict(zip(res.para_names, res.posterior_mean()))

    # alphas: estimated for eq 1,2 in all regimes
    for i in (1, 2):
        for suffix in ("", "_reg2", "_reg3"):
            assert abs(mu[f"alpha{i}{suffix}"] - i) < 0.5, (i, suffix, mu)
    # alpha3 fixed at 3.0 everywhere
    for suffix in ("", "_reg2", "_reg3"):
        assert abs(mu[f"alpha3{suffix}"] - 3.0) < 1e-9
    # betas: regime r truth = eq + (r-1)
    for i in (1, 2, 3):
        assert abs(mu[f"beta{i}"] - i) < 0.5
        assert abs(mu[f"beta{i}_reg2"] - (i + 1)) < 0.5
        assert abs(mu[f"beta{i}_reg3"] - (i + 2)) < 0.5
    # sigma-as-variance near 1
    for i in (1, 2, 3):
        assert abs(mu[f"sigma{i}"] - 1.0) < 0.5


def test_fixed_regime_columns_constant(result):
    space, res = result
    params = np.asarray(res.cloud.params)
    for name in ("alpha3", "alpha3_reg2", "alpha3_reg3"):
        col = space.names.index(name)
        np.testing.assert_array_equal(params[:, col], 3.0)
