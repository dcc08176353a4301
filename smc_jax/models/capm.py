"""Single-factor CAPM example model (reference examples/capm_model/
estimate_capm.jl): R_it = alpha_i + beta_i R_Mt + eps_it, eps ~ N(0, sigma_i^2)
for N=3 assets, 9 parameters (alpha_i, beta_i, sigma_i) with the same priors
as the linear fixture (Normal(0,1e3) / Uniform(0,1e3), reference
estimate_capm.jl:16-33).

Note: the reference's likelihood has a quirk — it assigns
beta[i] = p[i*3-2] (the alpha slot, estimate_capm.jl:59) and sums the
full-sample error dot product inside the time loop. We implement the CAPM
likelihood as documented in its own comments (alpha from slot 1, beta from
slot 2, per-period errors), which is the model the example *describes*.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import jax.numpy as jnp

from smc_jax.distributions import Normal, Uniform
from smc_jax.params import Parameter, parameter, Untransformed, SquareRoot

_LOG_2PI = 1.8378770664093453
_N_ASSETS = 3


def capm_parameters() -> List[Parameter]:
    params: List[Parameter] = []
    for i in range(1, _N_ASSETS + 1):
        params.append(parameter(f"alpha{i}", 0.0, (-1e5, 1e5),
                                transform=Untransformed(),
                                prior=Normal(0, 1e3)))
        params.append(parameter(f"beta{i}", 0.0, (-1e5, 1e5),
                                transform=Untransformed(),
                                prior=Normal(0, 1e3)))
        params.append(parameter(f"sigma{i}", 1.0, (1e-5, 1e5),
                                transform=SquareRoot(),
                                prior=Uniform(0, 1e3)))
    return params


def generate_capm_data(T: int = 200, seed: int = 1793
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(lik_data [3, T] asset returns, market_data [T] market returns) with a
    known DGP: alpha = (0.1, 0.2, 0.3), beta = (0.8, 1.0, 1.2), sigma = 0.5."""
    rng = np.random.default_rng(seed)
    market = rng.standard_normal(T) * 2.0 + 0.5
    alpha = np.array([0.1, 0.2, 0.3])[:, None]
    beta = np.array([0.8, 1.0, 1.2])[:, None]
    data = alpha + beta * market[None, :] + 0.5 * rng.standard_normal((3, T))
    return data, market


def load_reference_capm_data(
        path: str = "/root/reference/examples/data/capm.jld2"
        ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's SHIPPED CAPM dataset (examples/data/capm.jld2,
    loaded by estimate_capm.jl:40-42): 3 asset return series and the market
    return, 36 periods. JLD2 is HDF5 underneath, so h5py reads it directly.
    Returns (lik_data [3, T], market_data [T]) — estimation on this fixed
    dataset is what makes cross-framework parity checks possible."""
    import h5py
    with h5py.File(path, "r") as f:
        lik = f["lik_data"][()]      # stored (36, 3) -> Julia (3, 36)
        mkt = f["market_data"][()]   # stored (36, 1) -> Julia (1, 36)
    return np.ascontiguousarray(lik.T), np.ascontiguousarray(mkt.T[0])


def make_capm_loglike(market_data: np.ndarray):
    """CAPM Gaussian log-likelihood; same batched structure as the linear
    fixture (vmap -> [N, 3, T] broadcasts)."""
    m = jnp.asarray(market_data, jnp.float64)

    def loglike(theta, data):
        d = jnp.asarray(data, jnp.float64)
        T = d.shape[1]
        alpha = theta[0::3]
        beta = theta[1::3]
        sigma = theta[2::3]
        var = sigma * sigma
        ok = jnp.all(var > 0)
        var_safe = jnp.where(var > 0, var, 1.0)
        errors = d - alpha[:, None] - beta[:, None] * m[None, :T]
        quad = jnp.sum(errors * errors / var_safe[:, None])
        ll = (T * (-0.5 * _N_ASSETS * _LOG_2PI
                   - 0.5 * jnp.sum(jnp.log(var_safe))) - 0.5 * quad)
        return jnp.where(ok, ll, -jnp.inf)

    return loglike
