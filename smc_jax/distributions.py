"""Prior distribution families for the parameter layer.

Replaces the Distributions.jl surface the reference consumes through
ModelConstructors.jl (SURVEY.md §2.9): every family provides a *total*
``logpdf`` (finite-or--inf, never raises — the traced analogue of the
reference's try/catch-of-ParamBoundsError discipline, reference
src/initialization.jl:46-54) and a ``sample``.

All families are parameterized by two scalars ``(a, b)`` so that a
heterogeneous vector of priors can be evaluated as a handful of vectorized
masked ops over all columns at once (no per-parameter Python loops inside
jit). Family encoding for the stacked representation lives in
``FAMILY_CODES``.

Conventions match Distributions.jl since the reference's model files use it:
  Normal(mu, sigma)           — sigma is the *standard deviation*
  Uniform(a, b)
  Gamma(shape, scale)
  Beta(alpha, beta)
  InverseGamma(shape, scale)  — pdf ∝ x^-(shape+1) exp(-scale/x)
  RootInverseGamma(nu, tau)   — DSGE-style prior on std devs:
                                 nu*tau^2 / sigma^2 ~ chi2(nu)
  TruncatedNormal(mu, sigma)  — truncation bounds come from the parameter's
                                 valuebounds (handled in params.py)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp_special

# Integer codes for the stacked (vectorized-over-columns) representation.
FAMILY_CODES = {
    "point": 0,  # degenerate / fixed parameter: logpdf contribution 0
    "normal": 1,
    "uniform": 2,
    "gamma": 3,
    "beta": 4,
    "inverse_gamma": 5,
    "root_inverse_gamma": 6,
    "truncated_normal": 7,
}

_NEG_INF = -jnp.inf


@dataclasses.dataclass(frozen=True)
class Distribution:
    """One scalar prior. `a`, `b` are the two family parameters."""

    family: str
    a: float
    b: float

    @property
    def code(self) -> int:
        return FAMILY_CODES[self.family]

    def logpdf(self, x):
        return logpdf_family(self.code, jnp.asarray(self.a, jnp.float64),
                             jnp.asarray(self.b, jnp.float64), x)

    def sample(self, key, shape=()):
        return sample_family(self.code, jnp.asarray(self.a, jnp.float64),
                             jnp.asarray(self.b, jnp.float64), key, shape)

    def mean(self) -> float:
        import numpy as np
        a, b = self.a, self.b
        if self.family in ("normal", "truncated_normal"):
            return a
        if self.family == "uniform":
            return (a + b) / 2.0
        if self.family == "gamma":
            return a * b
        if self.family == "beta":
            return a / (a + b)
        if self.family == "inverse_gamma":
            return b / (a - 1.0) if a > 1 else np.nan
        if self.family == "root_inverse_gamma":
            # E[sigma] for nu*tau^2/sigma^2 ~ chi2(nu)
            from math import gamma as _g, sqrt
            nu, tau = a, b
            if nu > 1:
                return sqrt(nu * tau**2 / 2.0) * _g((nu - 1) / 2.0) / _g(nu / 2.0)
            return np.nan
        return np.nan


def Normal(mu: float, sigma: float) -> Distribution:
    return Distribution("normal", float(mu), float(sigma))


def Uniform(a: float, b: float) -> Distribution:
    return Distribution("uniform", float(a), float(b))


def Gamma(shape: float, scale: float) -> Distribution:
    return Distribution("gamma", float(shape), float(scale))


def Beta(alpha: float, beta: float) -> Distribution:
    return Distribution("beta", float(alpha), float(beta))


def InverseGamma(shape: float, scale: float) -> Distribution:
    return Distribution("inverse_gamma", float(shape), float(scale))


def RootInverseGamma(nu: float, tau: float) -> Distribution:
    return Distribution("root_inverse_gamma", float(nu), float(tau))


def TruncatedNormal(mu: float, sigma: float) -> Distribution:
    return Distribution("truncated_normal", float(mu), float(sigma))


def Point() -> Distribution:
    return Distribution("point", 0.0, 0.0)


# ---------------------------------------------------------------------------
# Vectorized logpdfs — each is total: finite or -inf, never nan, never raises.
# Inputs outside the support produce -inf via masking (the arguments fed to
# log/gammaln etc. are sanitized first so no nan leaks through the mask).
# ---------------------------------------------------------------------------

_LOG_2PI = 1.8378770664093453  # log(2*pi)


def _normal_logpdf(mu, sigma, x):
    z = (x - mu) / sigma
    return -0.5 * (_LOG_2PI + z * z) - jnp.log(sigma)


def _uniform_logpdf(a, b, x):
    inside = (x >= a) & (x <= b)
    return jnp.where(inside, -jnp.log(b - a), _NEG_INF)


def _gamma_logpdf(shape, scale, x):
    ok = x > 0
    xs = jnp.where(ok, x, 1.0)
    lp = ((shape - 1.0) * jnp.log(xs) - xs / scale
          - jsp_special.gammaln(shape) - shape * jnp.log(scale))
    return jnp.where(ok, lp, _NEG_INF)


def _beta_logpdf(alpha, beta, x):
    ok = (x > 0) & (x < 1)
    xs = jnp.where(ok, x, 0.5)
    lp = ((alpha - 1.0) * jnp.log(xs) + (beta - 1.0) * jnp.log1p(-xs)
          - jsp_special.betaln(alpha, beta))
    return jnp.where(ok, lp, _NEG_INF)


def _inverse_gamma_logpdf(shape, scale, x):
    ok = x > 0
    xs = jnp.where(ok, x, 1.0)
    lp = (shape * jnp.log(scale) - jsp_special.gammaln(shape)
          - (shape + 1.0) * jnp.log(xs) - scale / xs)
    return jnp.where(ok, lp, _NEG_INF)


def _root_inverse_gamma_logpdf(nu, tau, x):
    # pdf(sigma) = 2 (nu tau^2/2)^(nu/2) / Gamma(nu/2) * sigma^(-nu-1)
    #              * exp(-nu tau^2 / (2 sigma^2))
    ok = x > 0
    xs = jnp.where(ok, x, 1.0)
    half_nu = 0.5 * nu
    lp = (jnp.log(2.0) + half_nu * jnp.log(half_nu * tau * tau)
          - jsp_special.gammaln(half_nu)
          - (nu + 1.0) * jnp.log(xs)
          - half_nu * tau * tau / (xs * xs))
    return jnp.where(ok, lp, _NEG_INF)


class DegenerateMvNormal:
    """Multivariate normal that tolerates a rank-deficient covariance —
    the ModelConstructors.DegenerateMvNormal surface the reference consumes
    for its mixture-proposal densities (reference src/helpers.jl:103,
    135-136, 154-155; SURVEY.md §2.9).

    logpdf uses the eigendecomposition pseudo-inverse: directions with
    (near-)zero eigenvalue contribute neither to the quadratic form nor the
    log-determinant, and `rank` replaces the dimension in the normalization —
    matching the Julia implementation's pinv-based density. `rand` draws in
    the span of the retained eigenvectors only.
    """

    def __init__(self, mu, sigma, tol: float = 1e-12):
        self.mu = jnp.asarray(mu, jnp.float64)
        self.sigma = jnp.asarray(sigma, jnp.float64)
        lam, U = jnp.linalg.eigh(self.sigma)
        lam_max = jnp.maximum(jnp.max(lam), 0.0)
        keep = lam > tol * jnp.maximum(lam_max, 1e-300)
        safe = jnp.where(keep, lam, 1.0)
        self._U = U
        self._sqrt_lam = jnp.where(keep, jnp.sqrt(safe), 0.0)
        self._inv_lam = jnp.where(keep, 1.0 / safe, 0.0)
        self.rank = jnp.sum(keep).astype(jnp.float64)
        self._logdet = jnp.sum(jnp.where(keep, jnp.log(safe), 0.0))

    def logpdf(self, x):
        diff = jnp.asarray(x, jnp.float64) - self.mu
        z = diff @ self._U
        quad = jnp.sum(z * z * self._inv_lam, axis=-1)
        return -0.5 * (self.rank * _LOG_2PI + self._logdet + quad)

    def rand(self, key, shape=()):
        eps = jax.random.normal(
            key, tuple(shape) + self.mu.shape, dtype=jnp.float64)
        return self.mu + (eps * self._sqrt_lam) @ self._U.T

    # jax.scipy-style alias
    sample = rand

    def cov(self):
        """Covariance extractor (reference get_cov, src/helpers.jl:102-103)."""
        return self.sigma


def get_cov(d):
    """Covariance of a DegenerateMvNormal or anything exposing .cov()/.sigma
    (reference get_cov, src/helpers.jl:102-103)."""
    if hasattr(d, "cov"):
        c = d.cov
        return c() if callable(c) else c
    return d.sigma


def logpdf_family(code, a, b, x):
    """Total logpdf dispatched on integer family code. All args broadcast.

    `truncated_normal` is evaluated as a plain normal here; the truncation
    renormalization constant and support mask are applied by ParamSpace,
    which owns the bounds.
    """
    code = jnp.asarray(code)
    x = jnp.asarray(x, jnp.float64)
    return jnp.select(
        [
            code == FAMILY_CODES["point"],
            code == FAMILY_CODES["normal"],
            code == FAMILY_CODES["uniform"],
            code == FAMILY_CODES["gamma"],
            code == FAMILY_CODES["beta"],
            code == FAMILY_CODES["inverse_gamma"],
            code == FAMILY_CODES["root_inverse_gamma"],
            code == FAMILY_CODES["truncated_normal"],
        ],
        [
            jnp.zeros_like(x),
            _normal_logpdf(a, b, x),
            _uniform_logpdf(a, b, x),
            _gamma_logpdf(a, b, x),
            _beta_logpdf(a, b, x),
            _inverse_gamma_logpdf(a, b, x),
            _root_inverse_gamma_logpdf(a, b, x),
            _normal_logpdf(a, b, x),
        ],
        default=jnp.full_like(x, _NEG_INF),
    )


def sample_family(code, a, b, key, shape=()):
    """Draw from the family given by integer `code`.

    When `code`/`a`/`b` are arrays (stacked priors for P columns), every
    family is sampled for every column and the right one selected — a few
    vectorized RNG calls regardless of P, fully jit-compatible.
    """
    code = jnp.asarray(code)
    a = jnp.asarray(a, jnp.float64)
    b = jnp.asarray(b, jnp.float64)
    full = jnp.broadcast_shapes(code.shape, a.shape, b.shape)
    out_shape = tuple(shape) + full

    kn, ku, kg, kb, kig, krig, ktn = jax.random.split(key, 7)

    normal = a + b * jax.random.normal(kn, out_shape, dtype=jnp.float64)
    uniform = a + (b - a) * jax.random.uniform(ku, out_shape, dtype=jnp.float64)
    # Gamma(shape=a, scale=b)
    gamma = b * jax.random.gamma(kg, jnp.broadcast_to(jnp.maximum(a, 1e-12), full),
                                 shape=out_shape, dtype=jnp.float64)
    beta = jax.random.beta(kb, jnp.broadcast_to(jnp.maximum(a, 1e-12), full),
                           jnp.broadcast_to(jnp.maximum(b, 1e-12), full),
                           shape=out_shape, dtype=jnp.float64)
    # InverseGamma(shape=a, scale=b): 1 / Gamma(shape=a, rate=b)
    ig_g = jax.random.gamma(kig, jnp.broadcast_to(jnp.maximum(a, 1e-12), full),
                            shape=out_shape, dtype=jnp.float64)
    inv_gamma = b / jnp.maximum(ig_g, 1e-300)
    # RootInverseGamma(nu=a, tau=b): sigma = tau * sqrt(nu / chi2_nu),
    # chi2_nu = 2 * Gamma(nu/2, 1)
    chi2 = 2.0 * jax.random.gamma(
        krig, jnp.broadcast_to(jnp.maximum(a / 2.0, 1e-12), full),
        shape=out_shape, dtype=jnp.float64)
    root_inv_gamma = b * jnp.sqrt(a / jnp.maximum(chi2, 1e-300))
    trunc_normal = a + b * jax.random.normal(ktn, out_shape, dtype=jnp.float64)

    return jnp.select(
        [
            code == FAMILY_CODES["point"],
            code == FAMILY_CODES["normal"],
            code == FAMILY_CODES["uniform"],
            code == FAMILY_CODES["gamma"],
            code == FAMILY_CODES["beta"],
            code == FAMILY_CODES["inverse_gamma"],
            code == FAMILY_CODES["root_inverse_gamma"],
            code == FAMILY_CODES["truncated_normal"],
        ],
        [
            jnp.zeros(out_shape, jnp.float64),
            normal, uniform, gamma, beta, inv_gamma, root_inv_gamma,
            trunc_normal,
        ],
        default=jnp.zeros(out_shape, jnp.float64),
    )
