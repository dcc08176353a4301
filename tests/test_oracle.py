"""Exact accuracy oracle: the Gaussian linear-regression model with Normal
priors and known noise variance has a closed-form posterior N(mu_n, Sigma_n)
and a closed-form log marginal likelihood. The SMC estimates must match the
analytic values within Monte-Carlo error — the cross-framework ground truth
SURVEY.md §4 calls for (replacing the un-runnable Julia golden files; the
reference's own gate is the looser mean-within-0.5, test/smc.jl:53-57).

Model: y = alpha + beta x + eps, eps ~ N(0, sigma2 I), theta ~ N(mu0, S0).
  Sigma_n = (S0^-1 + X'X / sigma2)^-1
  mu_n    = Sigma_n (S0^-1 mu0 + X'y / sigma2)
  log Z   = log N(y; X mu0, sigma2 I + X S0 X')
"""

import numpy as np
import pytest
import jax

from smc_jax import smc
from smc_jax.cloud import weighted_cov
from smc_jax.models.regression import (regression_parameters,
                                       make_regression_loglike,
                                       generate_regression_data)

SIGMA2 = 1.0
PRIOR_SD = 10.0
N_PARTS = 4000
R = 4  # replications


@pytest.fixture(scope="module")
def oracle():
    y, x = generate_regression_data(n=100, seed=1793)
    yv = y[0]
    X = np.column_stack([np.ones_like(x), x])
    S0 = PRIOR_SD ** 2 * np.eye(2)
    prec_n = np.linalg.inv(S0) + X.T @ X / SIGMA2
    Sigma_n = np.linalg.inv(prec_n)
    mu_n = Sigma_n @ (X.T @ yv / SIGMA2)  # mu0 = 0
    # log evidence via the marginal Gaussian
    S_marg = SIGMA2 * np.eye(len(yv)) + X @ S0 @ X.T
    sign, logdet = np.linalg.slogdet(S_marg)
    quad = yv @ np.linalg.solve(S_marg, yv)
    log_z = -0.5 * (len(yv) * np.log(2 * np.pi) + logdet + quad)
    return (y, x), mu_n, Sigma_n, float(log_z)


@pytest.fixture(scope="module")
def runs(oracle):
    (y, x), _, _, _ = oracle
    ll = make_regression_loglike(x, sigma2=SIGMA2)
    out = []
    for r in range(R):
        res = smc(ll, regression_parameters(), y,
                  n_parts=N_PARTS, n_phi=100, lam=2.0, alpha=0.9,
                  verbose="none", seed=7000 + r)
        out.append(res)
    return out


def test_posterior_mean_matches_analytic(oracle, runs):
    _, mu_n, Sigma_n, _ = oracle
    sd_n = np.sqrt(np.diag(Sigma_n))
    for res in runs:
        mu = res.posterior_mean()
        # SMC MC error with N_eff ~ few hundred is ~sd/15; allow 5x slack
        assert np.all(np.abs(mu - mu_n) < 0.35 * sd_n), (mu, mu_n, sd_n)


def test_posterior_cov_matches_analytic(oracle, runs):
    _, _, Sigma_n, _ = oracle
    for res in runs:
        cov = np.asarray(weighted_cov(res.cloud))
        # relative error on the 2x2 covariance
        rel = np.abs(cov - Sigma_n) / np.abs(Sigma_n).max()
        assert rel.max() < 0.25, (cov, Sigma_n)


def test_log_mdd_matches_analytic(oracle, runs):
    """The log marginal data density — the quantity the reference saves the
    full w/W matrices for (src/smc_main.jl:354-367) — against the exact
    evidence. Each replication must land within 0.2 nats and the
    across-replication mean within 0.1."""
    _, _, _, log_z = oracle
    mdds = np.array([res.log_mdd for res in runs])
    assert np.all(np.abs(mdds - log_z) < 0.2), (mdds, log_z)
    assert abs(mdds.mean() - log_z) < 0.1, (mdds.mean(), log_z)


def test_estimation_on_reference_shipped_data():
    """Cross-framework parity on IDENTICAL data: estimate the linear fixture
    on the reference's own shipped test/reference/test_data.h5 (the data its
    CI gate uses, test/smc.jl:20) and gate against the exact posterior for
    that data. This is the parity check golden files can't provide across
    RNGs (SURVEY.md §4)."""
    h5py = pytest.importorskip("h5py")
    import os
    path = "/root/reference/test/reference/test_data.h5"
    if not os.path.exists(path):
        pytest.skip("reference data not mounted")
    from smc_jax.models.linear import (load_reference_data, linear_parameters,
                                       make_linear_loglike,
                                       exact_linear_posterior)
    data, X = load_reference_data(path)
    oracle = exact_linear_posterior(data, X)
    ll = make_linear_loglike(X)
    res = smc(ll, linear_parameters(), data,
              n_parts=5000, n_phi=300, lam=2.1, alpha=0.9,
              verbose="none", seed=42)
    mu = res.posterior_mean()
    assert np.max(np.abs(mu - oracle["mean"])) < 0.5, (mu, oracle["mean"])
    # and the reference's own published gate on its own data
    TRUE9 = np.array([1., 1., 1., 2., 2., 1., 3., 3., 1.])
    assert np.max(np.abs(mu - TRUE9)) < 0.5


def test_posterior_mean_unbiased_across_replications(oracle, runs):
    """Across-replication average should beat any single run (MC error
    averaging): a systematic bias larger than pooled MC error fails."""
    _, mu_n, Sigma_n, _ = oracle
    sd_n = np.sqrt(np.diag(Sigma_n))
    mus = np.stack([res.posterior_mean() for res in runs])
    pooled = mus.mean(0)
    assert np.all(np.abs(pooled - mu_n) < 0.2 * sd_n), (pooled, mu_n)
