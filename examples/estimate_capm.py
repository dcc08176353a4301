"""Estimate the single-factor CAPM (reference examples/capm_model/
estimate_capm.jl): R_it = alpha_i + beta_i R_Mt + eps_it for 3 assets.

Run: python examples/estimate_capm.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import smc_jax
from smc_jax.models.capm import (capm_parameters, make_capm_loglike,
                                 generate_capm_data)


def main():
    # prefer the reference's shipped dataset (examples/data/capm.jld2, as
    # estimate_capm.jl:40-42 loads) when mounted; else simulate
    true = None
    try:
        from smc_jax.models.capm import load_reference_capm_data
        lik_data, market_data = load_reference_capm_data()
        print("using the reference's shipped capm.jld2 dataset")
    except Exception:
        lik_data, market_data = generate_capm_data(T=200, seed=1793)
        true = np.array([0.1, 0.8, 0.5, 0.2, 1.0, 0.5, 0.3, 1.2, 0.5])
    loglike = make_capm_loglike(market_data)

    # All-default settings, as the reference example runs it
    # (estimate_capm.jl:74) — shrunk particle count for a quick demo.
    kw = dict(n_parts=1000, n_phi=100, lam=2.0, verbose="low", seed=0)
    if _os.environ.get("SMC_SMOKE"):  # CI smoke: tiny but same code path
        kw.update(n_parts=64, n_phi=10, verbose="none")
    result = smc_jax.smc(loglike, capm_parameters(), lik_data, **kw)

    mu, sd = result.posterior_mean(), result.posterior_std()
    if true is None:
        print(f"\n{'param':>8s} {'mean':>8s} {'std':>8s}")
        for name, m, s in zip(result.para_names, mu, sd):
            print(f"{name:>8s} {m:8.3f} {s:8.3f}")
    else:
        print(f"\n{'param':>8s} {'true':>6s} {'mean':>8s} {'std':>8s}")
        for name, t, m, s in zip(result.para_names, true, mu, sd):
            print(f"{name:>8s} {t:6.2f} {m:8.3f} {s:8.3f}")
    print(f"\nlog marginal data density: {result.log_mdd:.3f}")


if __name__ == "__main__":
    main()
