"""Two-parameter OLS regression example (reference examples/regression_model/
estimate_regression.jl): y = alpha + beta x with known sigma^2 = 1, priors
Normal(0, 10) on both coefficients, estimated with 100 particles."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import jax.numpy as jnp

from smc_jax.distributions import Normal
from smc_jax.params import Parameter, parameter

_LOG_2PI = 1.8378770664093453


def regression_parameters() -> List[Parameter]:
    return [
        parameter("alpha1", 0.0, (-1e5, 1e5), prior=Normal(0, 10.0)),
        parameter("beta1", 0.0, (-1e5, 1e5), prior=Normal(0, 10.0)),
    ]


def generate_regression_data(n: int = 100, seed: int = 1793, noise: bool = True
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(y [1, n], x [n]) with alpha = beta = 1 (the reference script's DGP
    at estimate_regression.jl:28-34 — it actually omits the noise term;
    noise=True adds the N(0,1) errors its sigma2=1 likelihood assumes)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=n)
    y = 1.0 + 1.0 * x + (rng.standard_normal(n) if noise else 0.0)
    return y[None, :], x


def make_regression_loglike(x: np.ndarray, sigma2: float = 1.0):
    xj = jnp.asarray(x, jnp.float64)

    def loglike(theta, data):
        y = jnp.asarray(data, jnp.float64)[0]
        n = y.shape[0]
        errors = y - theta[0] - theta[1] * xj[:n]
        return (-0.5 * n * (_LOG_2PI + jnp.log(sigma2))
                - 0.5 * jnp.sum(errors * errors) / sigma2)

    return loglike
