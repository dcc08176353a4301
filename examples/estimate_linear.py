"""Estimate the 9-parameter linear regression model with SMC
(the reference's examples/regression_model writ large — this is the shared
test fixture of reference test/modelsetup.jl).

Run: python examples/estimate_linear.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import smc_jax
from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                   generate_linear_data)


def main():
    data, X = generate_linear_data(seed=1793)
    loglike = make_linear_loglike(X)

    kw = dict(n_parts=400, n_phi=120, lam=2.0,
              resampling_method="systematic", verbose="low", seed=42,
              savepath="smc_cloud.npz", particle_store_path="smcsave.npy")
    if _os.environ.get("SMC_SMOKE"):  # CI smoke: tiny but same code path
        kw.update(n_parts=64, n_phi=10, verbose="none",
                  savepath=None, particle_store_path=None)
    result = smc_jax.smc(loglike, linear_parameters(), data, **kw)

    true = np.array([1, 1, 1, 2, 2, 1, 3, 3, 1], dtype=float)
    mu, sd = result.posterior_mean(), result.posterior_std()
    print(f"\n{'param':>8s} {'true':>6s} {'mean':>8s} {'std':>8s}")
    for name, t, m, s in zip(result.para_names, true, mu, sd):
        print(f"{name:>8s} {t:6.2f} {m:8.3f} {s:8.3f}")
    print(f"\nlog marginal data density: {result.log_mdd:.3f}")
    print(f"max |posterior mean - truth| = {np.max(np.abs(mu - true)):.3f}")


if __name__ == "__main__":
    main()
