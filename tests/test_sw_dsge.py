"""Smets-Wouters (2007) model: solution structure, likelihood shape, and a
3-stage SMC smoke run (the full estimation is accelerator-scale work — reference
examples/dsge_models/dsge_model.jl ran it on a 40-worker cluster)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smc_jax import smc
from smc_jax.params import ParamSpace
from smc_jax.models.dsge import solve_linear_re
from smc_jax.models.sw_dsge import (smets_wouters, sw_parameters, _system,
                                    generate_sw_data, TRUE_PARAMS,
                                    PARAM_NAMES, STATE_NAMES, N_STATE)


@pytest.fixture(scope="module")
def model_and_data():
    return smets_wouters(), generate_sw_data(T=156, seed=1793)


def test_dimensions():
    assert len(PARAM_NAMES) == 36      # SW2007 estimated parameter count
    assert len(sw_parameters()) == 36
    assert N_STATE == len(STATE_NAMES) == 37


def test_solution_at_mode():
    A, B, C, D = _system(jnp.asarray(TRUE_PARAMS))
    X, M, ok = solve_linear_re(A, B, C, D)
    assert bool(ok)
    resid = np.asarray(A + B @ X + C @ (X @ X))
    assert np.max(np.abs(resid)) < 1e-8
    Xn = np.asarray(X)
    idx = {n: i for i, n in enumerate(STATE_NAMES)}
    # exogenous AR structure survives on the diagonal
    assert abs(Xn[idx["a"], idx["a"]] - 0.95) < 1e-8    # crhoa
    assert abs(Xn[idx["g"], idx["g"]] - 0.97) < 1e-8    # crhog
    # lag bookkeeping: ylag_t = y_{t-1}, so row ylag of X selects column y
    # with coefficient 1 and nothing else
    ylag_row = Xn[idx["ylag"]]
    assert abs(ylag_row[idx["y"]] - 1.0) < 1e-8
    assert np.sum(np.abs(ylag_row)) - 1.0 < 1e-8
    assert abs(Xn[idx["clag"], idx["c"]] - 1.0) < 1e-8
    assert np.max(np.abs(np.linalg.eigvals(Xn))) < 1.0


def test_passive_policy_indeterminate():
    """Passive policy (crpi well below 1 with tiny output responses) makes
    SW indeterminate; the solver must reject the draw like gensys."""
    theta = TRUE_PARAMS.copy()
    theta[10] = 0.5    # crpi
    theta[12] = 0.001  # cry
    theta[13] = 0.001  # crdy
    A, B, C, D = _system(jnp.asarray(theta))
    _, _, ok = solve_linear_re(A, B, C, D)
    assert not bool(ok)


def test_likelihood_finite_and_peaked(model_and_data):
    model, data = model_and_data
    ll_true = float(model.loglike(jnp.asarray(TRUE_PARAMS), data))
    assert np.isfinite(ll_true)
    th2 = TRUE_PARAMS.copy()
    th2[0], th2[20] = 8.0, 0.5
    assert ll_true > float(model.loglike(jnp.asarray(th2), data))


def test_prior_draws_mostly_solve(model_and_data):
    model, data = model_and_data
    space = ParamSpace(sw_parameters())
    draws = space.sample_prior(jax.random.PRNGKey(0), 64)
    lls = np.asarray(jax.jit(jax.vmap(lambda th: model.loglike(th, data)))(draws))
    assert not np.any(np.isnan(lls))
    assert np.isfinite(lls).mean() > 0.5


def test_smc_smoke(model_and_data):
    """3 stages of the full pipeline at the reference's dsge_model.jl shape
    (blocked mutation, alpha=0.9)."""
    model, data = model_and_data
    res = smc(model.loglike, sw_parameters(), data,
              n_parts=128, n_phi=60, lam=2.1, alpha=0.9, n_blocks=3,
              resampling_method="systematic", verbose="none", seed=42,
              run_test=True)
    assert res.cloud.stage_index == 3
    assert np.all(np.isfinite(np.asarray(res.cloud.loglh)))
