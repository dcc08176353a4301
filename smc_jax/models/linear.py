"""Linear-regression test model: the reference's shared test fixture
(reference test/modelsetup.jl) as a JAX likelihood.

Three independent regressions y_i = alpha_i + beta_i x_i + eps_i,
eps ~ N(0, sigma_i^2), i = 1..3: nine parameters ordered
(alpha_1, beta_1, sigma_1, ..., alpha_3, beta_3, sigma_3) with
Normal(0, 1000) priors on alphas/betas and Uniform(0, 1000) on sigmas
(test/modelsetup.jl:14-31). True values used by the reference's accuracy
gate: alpha = beta = (1, 2, 3), sigma = 1 (test/smc.jl:53-57 asserts
posterior mean within 0.5).

The regime-switching variant (test/modelsetup.jl:47-64, 140-169) gives each
alpha_i and beta_i three regimes (alpha_3 fixed in all regimes; the betas get
regime-specific priors) over 300 periods split into three 100-period regimes.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import jax.numpy as jnp

from smc_jax.distributions import Normal, Uniform
from smc_jax.params import Parameter, parameter, Untransformed, SquareRoot

_LOG_2PI = 1.8378770664093453
_N_EQ = 3


def linear_parameters(regime_switching: bool = False) -> List[Parameter]:
    """The 9-parameter spec (test/modelsetup.jl:13-31). With
    regime_switching=True, adds the 3-regime structure of
    test/modelsetup.jl:47-64 (prior scale 10 instead of 1000)."""
    prior_scale = 10.0 if regime_switching else 1000.0
    params: List[Parameter] = []
    for i in range(1, _N_EQ + 1):
        if regime_switching:
            # alpha_i: 3 regime values; alpha_3 fixed in every regime
            a_fixed = (i == 3)
            a_vals = {1: 3.0 if a_fixed else -0.1 * i,
                      2: 3.0 if a_fixed else 0.1 * i,
                      3: 3.0}
            params.append(parameter(
                f"alpha{i}", a_vals[1], (-1e5, 1e5),
                transform=Untransformed(), prior=Normal(0, prior_scale),
                fixed=a_fixed,
                regimes={"value": a_vals,
                         "fixed": {1: a_fixed, 2: a_fixed, 3: a_fixed}}))
            params.append(parameter(
                f"beta{i}", 0.2 * i, (-1e5, 1e5),
                transform=Untransformed(), prior=Normal(0, prior_scale),
                regimes={"value": {1: 0.2 * i, 2: -0.1 * i, 3: 0.1 * i},
                         "prior": {1: Normal(0, prior_scale),
                                   2: Normal(0, prior_scale * 1.2),
                                   3: Normal(0, prior_scale * 1.5)}}))
        else:
            params.append(parameter(
                f"alpha{i}", 0.0, (-1e5, 1e5), transform=Untransformed(),
                prior=Normal(0, prior_scale)))
            params.append(parameter(
                f"beta{i}", 0.0, (-1e5, 1e5), transform=Untransformed(),
                prior=Normal(0, prior_scale)))
        params.append(parameter(
            f"sigma{i}", 1.0, (1e-5, 1e5), transform=SquareRoot(),
            prior=Uniform(0, prior_scale)))
    return params


def rs_linear_parameters() -> List[Parameter]:
    return linear_parameters(regime_switching=True)


def generate_linear_data(seed: int = 1793, T: int = 100
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(data, X): y = beta x + alpha + eps with alpha=beta=(1,2,3), sigma=1
    (test/modelsetup.jl:71-79; same spec, numpy RNG stream)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((_N_EQ, T))
    err = rng.standard_normal((_N_EQ, T))
    coef = np.arange(1, _N_EQ + 1, dtype=np.float64)[:, None]
    data = coef * X + coef + err
    return data, X


def make_linear_loglike(X: np.ndarray):
    """Gaussian log-likelihood over (3, T) data (test/modelsetup.jl:119-138).

    theta is the flat 9-vector; vmapping over particles turns the error
    computation into [N, 3, T] broadcasts. Total: sigma
    <= 0 yields -inf (the prior already excludes it; this keeps the function
    safe at arbitrary proposal values).
    """
    Xj = jnp.asarray(X, jnp.float64)

    def loglike(theta, data):
        d = jnp.asarray(data, jnp.float64)
        T = d.shape[1]
        alpha = theta[0::3]
        beta = theta[1::3]
        sigma = theta[2::3]
        var = sigma * sigma
        ok = jnp.all(var > 0)
        var_safe = jnp.where(var > 0, var, 1.0)
        errors = d - alpha[:, None] - beta[:, None] * Xj[:, :T]
        quad = jnp.sum(errors * errors / var_safe[:, None])
        logdet = jnp.sum(jnp.log(var_safe))
        ll = T * (-0.5 * _N_EQ * _LOG_2PI - 0.5 * logdet) - 0.5 * quad
        return jnp.where(ok, ll, -jnp.inf)

    return loglike


# --------------------------------------------------------------------------
# Regime-switching variant (test/modelsetup.jl:140-169): 300 periods in three
# 100-period regimes; alpha/beta switch by regime, sigma is common. NOTE: the
# reference's rs likelihood uses Sigma_ii = p[sigma_i] (the *value*, not
# squared — test/modelsetup.jl:148), so the "sigma" parameters there are
# variances; we reproduce that exactly.
# --------------------------------------------------------------------------


def generate_rs_linear_data(seed: int = 1793, T_per_regime: int = 100
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(rsdata, Xrs) with per-regime coefficients matching
    test/modelsetup.jl:82-97: beta_r = (r, r+1, r+2) per regime r offsets,
    alpha = (1,2,3) in all regimes."""
    rng = np.random.default_rng(seed + 1)
    T = 3 * T_per_regime
    Xrs = rng.standard_normal((_N_EQ, T))
    err = rng.standard_normal((_N_EQ, T))
    base = np.arange(1, _N_EQ + 1, dtype=np.float64)[:, None]
    data = np.empty_like(err)
    for r in range(3):
        sl = slice(r * T_per_regime, (r + 1) * T_per_regime)
        beta_r = base + r
        data[:, sl] = beta_r * Xrs[:, sl] + base + err[:, sl]
    return data, Xrs


def load_reference_data(path: str = "/root/reference/test/reference/test_data.h5"
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Load the reference's own shipped test data (test/reference/
    test_data.h5, generated under Julia Random.seed!(1793) —
    test/modelsetup.jl:71-115). h5py reads the Julia (3, 100) matrices
    transposed, so transpose back. Returns (data [3, T], X [3, T])."""
    import h5py
    with h5py.File(path, "r") as f:
        data = f["data"][()].T
        X = f["X"][()].T
    return np.ascontiguousarray(data), np.ascontiguousarray(X)


def exact_linear_posterior(data: np.ndarray, X: np.ndarray,
                           prior_scale: float = 1000.0,
                           n_grid: int = 4000):
    """EXACT posterior moments and log evidence for the linear fixture.

    The three equations are independent, and per equation the model is
    y = alpha + beta x + eps, eps ~ N(0, sigma^2), alpha/beta ~ N(0, s0^2),
    sigma ~ U(0, s0). Conditional on sigma the coefficient posterior is
    Gaussian in closed form; the 1-D sigma marginal is integrated by
    quadrature. This is the cross-framework ground truth the SMC estimates
    (posterior mean AND log-MDD) must match within MC error — the exact
    version of the reference's mean-within-0.5 gate (test/smc.jl:53-57).

    Returns dict(mean [9], sd [9], log_evidence float).
    """
    n_eq, T = data.shape
    s0sq = prior_scale ** 2
    # integrate sigma on a log-spaced grid (posterior concentrates near the
    # residual scale, but keep full U(0, prior_scale) support)
    sig = np.exp(np.linspace(np.log(1e-3), np.log(prior_scale), n_grid))
    log_prior_sig = -np.log(prior_scale)  # uniform density
    means, sds, log_evs = [], [], []
    for i in range(n_eq):
        y = data[i]
        Xd = np.column_stack([np.ones(T), X[i]])          # [T, 2]
        XtX = Xd.T @ Xd
        Xty = Xd.T @ y
        yty = y @ y
        # log m(sigma) = log N(y; 0, sigma^2 I + s0^2 Xd Xd')
        # via the 2x2 Woodbury identities
        lm = np.empty(n_grid)
        cond_mean = np.empty((n_grid, 2))
        cond_cov = np.empty((n_grid, 2, 2))
        for g, s in enumerate(sig):
            s2 = s * s
            prec = np.eye(2) / s0sq + XtX / s2
            cov = np.linalg.inv(prec)
            mu = cov @ (Xty / s2)
            sign, logdet_prec = np.linalg.slogdet(prec)
            # log evidence given sigma (completing the square)
            lm[g] = (-0.5 * T * (np.log(2 * np.pi) + np.log(s2))
                     - 0.5 * (2 * np.log(s0sq) + logdet_prec)
                     - 0.5 * (yty / s2 - mu @ prec @ mu))
            cond_mean[g] = mu
            cond_cov[g] = cov
        # posterior over sigma on the grid (trapezoid in sigma)
        lw = lm + log_prior_sig
        lw_max = lw.max()
        w = np.exp(lw - lw_max)
        Z = np.trapezoid(w, sig)
        log_ev = lw_max + np.log(Z)
        p_sig = w / Z
        mean_ab = np.trapezoid(p_sig[:, None] * cond_mean, sig, axis=0)
        mean_sig = np.trapezoid(p_sig * sig, sig)
        # E[theta theta'] = E[cov + mu mu'] for the coefficient block
        second_ab = np.trapezoid(
            p_sig[:, None, None]
            * (cond_cov + cond_mean[:, :, None] * cond_mean[:, None, :]),
            sig, axis=0)
        var_ab = np.diag(second_ab) - mean_ab ** 2
        var_sig = np.trapezoid(p_sig * sig * sig, sig) - mean_sig ** 2
        means.extend([mean_ab[0], mean_ab[1], mean_sig])
        sds.extend([np.sqrt(var_ab[0]), np.sqrt(var_ab[1]), np.sqrt(var_sig)])
        log_evs.append(log_ev)
    return {"mean": np.array(means), "sd": np.array(sds),
            "log_evidence": float(np.sum(log_evs))}


def make_rs_linear_loglike(Xrs: np.ndarray, space, T_per_regime: int = 100):
    """Regime-switching Gaussian log-likelihood (test/modelsetup.jl:140-169).

    Uses space.regime_matrix() to gather each base parameter's regime-r value
    from the flat (regime-flattened) theta with one indexed read — the
    column-flattening that replaces the reference's toggle_regime! churn
    (SURVEY.md §7).
    """
    Xj = jnp.asarray(Xrs, jnp.float64)
    regmat = jnp.asarray(space.regime_matrix())  # [9, 3] flat column per regime

    def loglike(theta, data):
        d = jnp.asarray(data, jnp.float64)
        per_regime = theta[regmat]               # [9, 3] values by regime
        alpha = per_regime[0::3, :]              # [3 eq, 3 regimes]
        beta = per_regime[1::3, :]
        # sigma lives in base columns 2/5/8 only (no regime columns); the
        # flat theta is longer than 9, so slice the base block explicitly
        var = theta[jnp.array([2, 5, 8])]        # sigma param used AS variance
        ok = jnp.all(var > 0)
        var_safe = jnp.where(var > 0, var, 1.0)

        ll = 0.0
        for r in range(3):
            sl = slice(r * T_per_regime, (r + 1) * T_per_regime)
            errors = (d[:, sl] - alpha[:, r][:, None]
                      - beta[:, r][:, None] * Xj[:, sl])
            quad = jnp.sum(errors * errors / var_safe[:, None])
            ll += (T_per_regime * (-0.5 * _N_EQ * _LOG_2PI
                                   - 0.5 * jnp.sum(jnp.log(var_safe)))
                   - 0.5 * quad)
        return jnp.where(ok, ll, -jnp.inf)

    return loglike
