"""Smets-Wouters end-to-end estimation on simulated data with a posterior
z-score gate against the DGP (posterior-accuracy validation at SW scale).
Reference production shape:
examples/dsge_models/dsge_model.jl:27-35 (blocked mutation, alpha=0.9,
multinomial resampling on the FRBNY cluster).

Marked slow: a real (if modest: 1024 particles, n_phi=80, 3 blocks)
estimation of the 36-parameter model. The fused recursion keeps this to a
single compile + one device program.
"""

import numpy as np
import pytest
import jax

from smc_jax import smc
from smc_jax.models.sw_dsge import (smets_wouters, sw_parameters,
                                    generate_sw_data, TRUE_PARAMS,
                                    PARAM_NAMES)


@pytest.mark.slow
def test_sw_posterior_covers_dgp():
    model = smets_wouters()
    data = generate_sw_data(T=156, seed=1793)
    res = smc(model.loglike_batched, sw_parameters(), data, batched=True,
              n_parts=1024, n_phi=80, lam=2.1, n_blocks=3, alpha=0.9,
              resampling_method="systematic", verbose="none", seed=42)

    mu, sd = res.posterior_mean(), res.posterior_std()
    true = np.asarray(TRUE_PARAMS)
    z = np.abs(mu - true) / np.maximum(sd, 1e-8)

    # bookkeeping sanity
    sched = np.asarray(res.cloud.tempering_schedule)
    assert sched[-1] == 1.0 and np.all(np.diff(sched) > 0)
    assert np.all(np.isfinite(np.asarray(res.cloud.loglh)))
    assert np.isfinite(res.log_mdd)

    # posterior covers the DGP: with 36 params, a few 2-3 sigma excursions
    # are expected (finite T=156 sample + prior pull); systematic failure is
    # a z-score blowing far past that, or many params outside 3 sigma.
    assert np.max(z) < 6.0, dict(zip(PARAM_NAMES, np.round(z, 2)))
    assert np.mean(z < 3.0) > 0.85, dict(zip(PARAM_NAMES, np.round(z, 2)))

    # well-identified AR roots must also be close in absolute terms
    idx = {n: i for i, n in enumerate(PARAM_NAMES)}
    for name in ("crhoa", "crhog"):
        if name in idx:
            assert abs(mu[idx[name]] - true[idx[name]]) < 0.1, name
