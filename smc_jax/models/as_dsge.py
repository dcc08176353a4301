"""An-Schorfheide 3-equation New Keynesian DSGE (the reference's
examples/dsge_models/small_dsge_model.jl, which delegates to DSGE.jl's
AnSchorfheide + Kalman likelihood).

Log-linearized system (Herbst & Schorfheide 2014, "Sequential Monte Carlo
Sampling for DSGE Models"):

  IS:    y_t = E[y_{t+1}] + g_t - E[g_{t+1}]
               - (1/tau) (R_t - E[pi_{t+1}] - E[z_{t+1}])
  NKPC:  pi_t = beta E[pi_{t+1}] + kappa (y_t - g_t)
  MP:    R_t = rho_R R_{t-1}
               + (1 - rho_R)(psi1 pi_t + psi2 (y_t - g_t)) + eps_R
  g_t = rho_g g_{t-1} + eps_g ;  z_t = rho_z z_{t-1} + eps_z
  beta = 1 / (1 + rA/400)

Observables:
  YGR  = gammaQ + 100 (y_t - y_{t-1} + z_t)
  INFL = piA + 400 pi_t
  INT  = piA + rA + 4 gammaQ + 400 R_t

State x = [y, pi, R, g, z, y_lag]; solved by linear time iteration and
filtered with the lax.scan Kalman filter (smc_jax.models.dsge). Draws where
the RE solution fails (indeterminate/explosive/non-convergent) get -inf
log-likelihood, mirroring DSGE.jl's catch_errors=true behavior
(reference examples/dsge_models/small_dsge_model.jl:37-43).

Priors follow Herbst & Schorfheide (2014) Table 2 (as in DSGE.jl's
AnSchorfheide): Gamma priors specified by (mean, std) and converted to
(shape, scale); sigma priors are RootInverseGamma(nu=4, tau).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from smc_jax.distributions import (Gamma, Uniform, Normal, RootInverseGamma)
from smc_jax.params import Parameter, parameter
from smc_jax.models.dsge import LinearDSGE

# parameter order
PARAM_NAMES = ["tau", "kappa", "psi1", "psi2", "rA", "piA", "gammaQ",
               "rho_R", "rho_g", "rho_z", "sig_R", "sig_g", "sig_z"]

# Herbst-Schorfheide DGP values used for simulation / accuracy checks.
TRUE_PARAMS = np.array([2.0, 0.33, 1.5, 0.125, 1.0, 3.2, 0.55,
                        0.75, 0.95, 0.9, 0.2, 0.6, 0.18])

_N_STATE = 6   # [y, pi, R, g, z, y_lag]
_N_SHOCK = 3   # [eps_R, eps_g, eps_z]
_N_OBS = 3


def _gamma_ms(mean, std):
    """Gamma prior from (mean, std) -> Gamma(shape, scale)."""
    shape = (mean / std) ** 2
    return Gamma(shape, std * std / mean)


def an_schorfheide_parameters() -> List[Parameter]:
    return [
        parameter("tau", 2.0, (1e-5, 100.0), prior=_gamma_ms(2.0, 0.5)),
        parameter("kappa", 0.33, (1e-8, 1.0), prior=Uniform(0.0, 1.0)),
        parameter("psi1", 1.5, (1e-8, 50.0), prior=_gamma_ms(1.5, 0.25)),
        parameter("psi2", 0.125, (1e-8, 50.0), prior=_gamma_ms(0.5, 0.25)),
        parameter("rA", 1.0, (1e-8, 50.0), prior=_gamma_ms(0.5, 0.5)),
        parameter("piA", 3.2, (1e-8, 50.0), prior=_gamma_ms(7.0, 2.0)),
        parameter("gammaQ", 0.55, (-5.0, 5.0), prior=Normal(0.4, 0.2)),
        parameter("rho_R", 0.75, (1e-8, 0.99999), prior=Uniform(0.0, 1.0)),
        parameter("rho_g", 0.95, (1e-8, 0.99999), prior=Uniform(0.0, 1.0)),
        parameter("rho_z", 0.9, (1e-8, 0.99999), prior=Uniform(0.0, 1.0)),
        parameter("sig_R", 0.2, (1e-8, 10.0), prior=RootInverseGamma(4.0, 0.4)),
        parameter("sig_g", 0.6, (1e-8, 10.0), prior=RootInverseGamma(4.0, 1.0)),
        parameter("sig_z", 0.18, (1e-8, 10.0), prior=RootInverseGamma(4.0, 0.5)),
    ]


def _system(theta):
    """theta -> (A, B, C, D) with A x_{t-1} + B x_t + C E x_{t+1} + D eps = 0."""
    tau, kappa, psi1, psi2, rA = theta[0], theta[1], theta[2], theta[3], theta[4]
    rho_R, rho_g, rho_z = theta[7], theta[8], theta[9]
    beta = 1.0 / (1.0 + rA / 400.0)
    inv_tau = 1.0 / tau

    A = jnp.zeros((_N_STATE, _N_STATE), jnp.float64)
    B = jnp.zeros((_N_STATE, _N_STATE), jnp.float64)
    C = jnp.zeros((_N_STATE, _N_STATE), jnp.float64)
    D = jnp.zeros((_N_STATE, _N_SHOCK), jnp.float64)
    y, pi, R, g, z, ylag = range(_N_STATE)
    eR, eg, ez = range(_N_SHOCK)

    # IS
    B = B.at[0, y].set(-1.0).at[0, g].set(1.0).at[0, R].set(-inv_tau)
    C = C.at[0, y].set(1.0).at[0, pi].set(inv_tau)
    C = C.at[0, g].set(-1.0).at[0, z].set(inv_tau)
    # NKPC
    B = B.at[1, pi].set(-1.0).at[1, y].set(kappa).at[1, g].set(-kappa)
    C = C.at[1, pi].set(beta)
    # MP rule
    A = A.at[2, R].set(rho_R)
    B = B.at[2, R].set(-1.0)
    B = B.at[2, pi].set((1.0 - rho_R) * psi1)
    B = B.at[2, y].set((1.0 - rho_R) * psi2)
    B = B.at[2, g].set(-(1.0 - rho_R) * psi2)
    D = D.at[2, eR].set(1.0)
    # g AR(1)
    A = A.at[3, g].set(rho_g)
    B = B.at[3, g].set(-1.0)
    D = D.at[3, eg].set(1.0)
    # z AR(1)
    A = A.at[4, z].set(rho_z)
    B = B.at[4, z].set(-1.0)
    D = D.at[4, ez].set(1.0)
    # y_lag bookkeeping
    A = A.at[5, y].set(1.0)
    B = B.at[5, ylag].set(-1.0)
    return A, B, C, D


def _measurement(theta):
    rA, piA, gammaQ = theta[4], theta[5], theta[6]
    y, pi, R, g, z, ylag = range(_N_STATE)
    Z = jnp.zeros((_N_OBS, _N_STATE), jnp.float64)
    Z = Z.at[0, y].set(100.0).at[0, ylag].set(-100.0).at[0, z].set(100.0)
    Z = Z.at[1, pi].set(400.0)
    Z = Z.at[2, R].set(400.0)
    d = jnp.stack([gammaQ, piA, piA + rA + 4.0 * gammaQ])
    # No measurement error in the AS model; a tiny jitter keeps the Cholesky
    # of the forecast covariance well-posed at degenerate draws.
    H = 1e-10 * jnp.eye(_N_OBS, dtype=jnp.float64)
    return d, Z, H


def _shock_cov(theta):
    sig = theta[10:13]
    return jnp.diag(sig * sig)


def an_schorfheide() -> LinearDSGE:
    return LinearDSGE(an_schorfheide_parameters(), _system, _measurement,
                      _N_SHOCK, _shock_cov)


def _measurement_2obs(theta):
    """2-observable variant (output growth + inflation; the policy rate
    dropped): exercises the n_obs != 3 innovation-solve path
    (ops/linalg.py bl_chol_solve — the cofactor closed form is 3x3-only)."""
    d, Z, H = _measurement(theta)
    return d[:2], Z[:2], H[:2, :2]


def an_schorfheide_2obs() -> LinearDSGE:
    """An-Schorfheide with 2 observables — the bl_chol_solve (unrolled
    Cholesky) innovation path, vs the default model's 3-obs cofactor path."""
    return LinearDSGE(an_schorfheide_parameters(), _system,
                      _measurement_2obs, _N_SHOCK, _shock_cov)


def generate_as_data(T: int = 80, seed: int = 1793,
                     theta: np.ndarray = TRUE_PARAMS) -> np.ndarray:
    """Simulate observables [3, T] from the model at `theta` (the reference
    loads FRED data through DSGE.jl; synthetic data from the true DGP serves
    the same role for accuracy/benchmark purposes)."""
    model = an_schorfheide()
    key = jax.random.PRNGKey(seed)
    obs = model.simulate(jnp.asarray(theta, jnp.float64), T, key)
    return np.asarray(obs)
