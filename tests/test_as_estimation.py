"""End-to-end An-Schorfheide DSGE estimation (the reference's
examples/dsge_models/small_dsge_model.jl config: 400 particles, n_phi=100,
lambda=2.0, systematic resampling) on synthetic data from the true DGP.

The accuracy gate is statistical: every posterior mean within 4 posterior
standard deviations of the DGP values (piA/rA are weakly identified in this
model at T=80, so a tight absolute gate would be wrong)."""

import numpy as np
import pytest

from smc_jax import smc
from smc_jax.models.as_dsge import (an_schorfheide, an_schorfheide_parameters,
                                    generate_as_data, TRUE_PARAMS)


@pytest.fixture(scope="module")
def result():
    model = an_schorfheide()
    data = generate_as_data(T=80, seed=1793)
    return smc(model.loglike_batched, an_schorfheide_parameters(), data,
               batched=True,
               n_parts=400, n_phi=100, lam=2.0,
               resampling_method="systematic", verbose="none", seed=42)


def test_posterior_within_4_std(result):
    mu, sd = result.posterior_mean(), result.posterior_std()
    z = np.abs(mu - TRUE_PARAMS) / np.maximum(sd, 1e-9)
    assert np.all(z < 4.0), f"z-scores {dict(zip(result.para_names, z))}"


def test_mdd_finite_and_bookkeeping(result):
    assert np.isfinite(result.log_mdd)
    c = result.cloud
    assert c.tempering_schedule[-1] == 1.0
    assert 0.0 < c.accept_rate < 1.0
    # all surviving particles solve the model (finite loglh)
    assert np.all(np.isfinite(np.asarray(c.loglh)))


def test_posterior_tighter_than_prior(result):
    """The data must actually inform: posterior std well below prior std on
    identified parameters (tau, kappa, rhos, sigmas)."""
    sd = dict(zip(result.para_names, result.posterior_std()))
    assert sd["tau"] < 0.5      # prior std 0.5
    assert sd["kappa"] < 0.29   # prior std ~0.289 (U[0,1])
    assert sd["rho_g"] < 0.1
    assert sd["sig_g"] < 0.2
