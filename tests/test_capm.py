"""CAPM example model end-to-end (reference examples/capm_model)."""

import numpy as np
import pytest

from smc_jax import smc
from smc_jax.models.capm import (capm_parameters, make_capm_loglike,
                                 generate_capm_data)

TRUE = np.array([0.1, 0.8, 0.5, 0.2, 1.0, 0.5, 0.3, 1.2, 0.5])


def test_capm_estimation():
    lik_data, market = generate_capm_data(T=200, seed=1793)
    ll = make_capm_loglike(market)
    res = smc(ll, capm_parameters(), lik_data,
              n_parts=5000, n_phi=100, lam=2.1, alpha=0.9,
              resampling_method="systematic", verbose="none", seed=42)
    mu, sd = res.posterior_mean(), res.posterior_std()
    z = np.abs(mu - TRUE) / np.maximum(sd, 1e-9)
    assert np.all(z < 5.0), f"mean={mu} z={z}"
    assert np.isfinite(res.log_mdd)
