"""Estimate the 2-parameter regression (reference examples/regression_model/
estimate_regression.jl: 100 particles, all-default schedule).

Run: python examples/estimate_regression.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import smc_jax
from smc_jax.models.regression import (regression_parameters,
                                       make_regression_loglike,
                                       generate_regression_data)


def main():
    y, x = generate_regression_data(n=100, seed=1793)
    loglike = make_regression_loglike(x)

    kw = dict(n_parts=100, verbose="low", seed=0)
    if _os.environ.get("SMC_SMOKE"):  # CI smoke: tiny but same code path
        kw.update(n_parts=64, n_phi=10, verbose="none")
    result = smc_jax.smc(loglike, regression_parameters(), y, **kw)

    mu, sd = result.posterior_mean(), result.posterior_std()
    print(f"\nalpha: mean={mu[0]:.3f} std={sd[0]:.3f} (true 1.0)")
    print(f"beta : mean={mu[1]:.3f} std={sd[1]:.3f} (true 1.0)")
    print(f"log marginal data density: {result.log_mdd:.3f}")


if __name__ == "__main__":
    main()
