"""Estimate the An-Schorfheide 3-equation New Keynesian DSGE
(reference examples/dsge_models/small_dsge_model.jl: 400 particles,
n_phi=100, lambda=2.0, systematic resampling).

The linear RE solution runs by linear time iteration and the likelihood is a
lax.scan Kalman filter — both vmapped across particles into batched linear
algebra (see smc_jax/models/dsge.py). Data is simulated from the model at
the Herbst-Schorfheide DGP values.

Run: python examples/estimate_as_dsge.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import smc_jax
from smc_jax.models.as_dsge import (an_schorfheide, an_schorfheide_parameters,
                                    generate_as_data, TRUE_PARAMS, PARAM_NAMES)


def main():
    model = an_schorfheide()
    data = generate_as_data(T=80, seed=1793)

    kw = dict(n_parts=400, n_phi=100, lam=2.0,
              resampling_method="systematic", verbose="low", seed=42)
    if _os.environ.get("SMC_SMOKE"):  # CI smoke: tiny but same code path
        kw.update(n_parts=64, n_phi=10, verbose="none")
    result = smc_jax.smc(model.loglike_batched, an_schorfheide_parameters(),
                         data, batched=True, **kw)

    mu, sd = result.posterior_mean(), result.posterior_std()
    print(f"\n{'param':>8s} {'true':>7s} {'mean':>8s} {'std':>8s}")
    for name, t, m, s in zip(PARAM_NAMES, TRUE_PARAMS, mu, sd):
        print(f"{name:>8s} {t:7.3f} {m:8.3f} {s:8.3f}")
    print(f"\nlog marginal data density: {result.log_mdd:.3f}")


if __name__ == "__main__":
    main()
