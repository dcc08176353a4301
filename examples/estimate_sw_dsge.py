"""Estimate the Smets-Wouters (2007) medium-scale DSGE — the reference's
production-scale config (examples/dsge_models/dsge_model.jl: n_parts=1000+,
3 blocks, alpha=0.9, multinomial resampling, 40 cluster workers; here: one
accelerator, batched likelihoods).

Run: python examples/estimate_sw_dsge.py     (heavy on CPU; sized for a GPU)
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import smc_jax
from smc_jax.models.sw_dsge import (smets_wouters, sw_parameters,
                                    generate_sw_data, TRUE_PARAMS,
                                    PARAM_NAMES)


def main():
    model = smets_wouters()
    data = generate_sw_data(T=156, seed=1793)

    kw = dict(n_parts=1000, n_phi=100, lam=2.1, n_blocks=3, alpha=0.9,
              resampling_method="multinomial", verbose="low", seed=42)
    if _os.environ.get("SMC_SMOKE"):  # CI smoke: tiny but same code path
        kw.update(n_parts=64, n_phi=8, verbose="none")
    result = smc_jax.smc(model.loglike_batched, sw_parameters(), data,
                         batched=True, **kw)

    mu, sd = result.posterior_mean(), result.posterior_std()
    print(f"\n{'param':>11s} {'mode':>7s} {'mean':>8s} {'std':>7s}")
    for name, t, m, s in zip(PARAM_NAMES, TRUE_PARAMS, mu, sd):
        print(f"{name:>11s} {t:7.3f} {m:8.3f} {s:7.3f}")
    print(f"\nlog marginal data density: {result.log_mdd:.3f}")


if __name__ == "__main__":
    main()
