"""Generalized tempering / time-tempered ("online") estimation — the
reference's bridging integration test (test/smc.jl:93-139): estimate on the
first half-sample, then re-estimate on the full sample starting from the old
cloud, both with prior weight 0 (pure tempered update) and 0.5 (bridge
distribution)."""

import numpy as np
import pytest

from smc_jax import smc
from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                   generate_linear_data)

TRUE = np.array([1.0, 1.0, 1.0, 2.0, 2.0, 1.0, 3.0, 3.0, 1.0])


@pytest.fixture(scope="module")
def halves():
    data, X = generate_linear_data(seed=1793)
    ll = make_linear_loglike(X)
    return data[:, :50], data, ll


@pytest.fixture(scope="module")
def old_result(halves):
    half, _, ll = halves
    # reference bridging part 1 config (test/smc.jl:108-113): 1000 particles
    return smc(ll, linear_parameters(), half,
               n_parts=1000, n_phi=100, lam=2.1, alpha=0.9,
               resampling_method="polyalgo", verbose="none", seed=42)


def test_tempered_update_prior_weight_zero(halves, old_result):
    """omega = 0, same N: pure tempered update reusing the old cloud
    (reference src/smc_main.jl:249-258)."""
    half, full, ll = halves
    res = smc(ll, linear_parameters(), full,
              n_parts=1000, n_phi=100, lam=2.1, alpha=0.9,
              resampling_method="polyalgo", verbose="none", seed=43,
              old_data=half, old_cloud=old_result.cloud,
              tempered_update_prior_weight=0.0)
    mu = res.posterior_mean()
    assert np.max(np.abs(mu - TRUE)) < 0.5
    # old_loglh must have been populated from the previous estimation
    assert np.any(np.asarray(res.cloud.old_loglh) != 0.0)


def test_bridge_distribution(halves, old_result):
    """omega = 0.5: half resampled old cloud + half fresh prior draws
    evaluated on old data (reference src/smc_main.jl:260-329, and the
    reference's bridging test config test/smc.jl:126-139)."""
    half, full, ll = halves
    res = smc(ll, linear_parameters(), full,
              n_parts=1000, n_phi=100, lam=2.1, alpha=0.9,
              resampling_method="polyalgo", verbose="none", seed=44,
              old_data=half, old_cloud=old_result.cloud,
              tempered_update_prior_weight=0.5,
              log_prob_old_data=old_result.log_mdd)
    mu = res.posterior_mean()
    assert np.max(np.abs(mu - TRUE)) < 0.5


def test_bridge_with_different_n_parts(halves, old_result):
    """old_n != n_parts forces the bridge path even at omega=0
    (reference src/smc_main.jl:260)."""
    half, full, ll = halves
    res = smc(ll, linear_parameters(), full,
              n_parts=500, n_phi=100, lam=2.1, alpha=0.9,
              resampling_method="polyalgo", verbose="none", seed=45,
              old_data=half, old_cloud=old_result.cloud,
              tempered_update_prior_weight=0.0)
    assert res.cloud.n_parts == 500
    mu = res.posterior_mean()
    assert np.max(np.abs(mu - TRUE)) < 0.6


def test_invalid_prior_weight_raises(halves, old_result):
    half, full, ll = halves
    with pytest.raises(ValueError, match="tempered_update_prior_weight"):
        smc(ll, linear_parameters(), full, old_data=half,
            old_cloud=old_result.cloud, tempered_update_prior_weight=1.5)
