"""Accuracy harness: posterior-moment Monte-Carlo error and log-MDD
dispersion across independent SMC replications — the Herbst-Schorfheide /
Cai et al. style of accuracy evidence the reference's papers report
(BASELINE.md: accuracy numbers must be measured, not quoted).

Runs R independent seeds of the linear-model estimation and prints one JSON
line with across-replication statistics.

Run: python benchmarks/bench_accuracy.py [R]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import json
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

from smc_jax import smc
from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                   generate_linear_data)

TRUE = np.array([1.0, 1.0, 1.0, 2.0, 2.0, 1.0, 3.0, 3.0, 1.0])


def main():
    from smc_jax.models.linear import exact_linear_posterior

    R = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    n_blocks = 3 if "--blocks3" in sys.argv else 1
    n_phi = 300 if "--phi300" in sys.argv else 120
    data, X = generate_linear_data(seed=1793)
    ll = make_linear_loglike(X)
    oracle = exact_linear_posterior(data, X)

    means, mdds, fails = [], [], 0
    for r in range(R):
        res = smc(ll, linear_parameters(), data,
                  n_parts=5000, n_phi=n_phi, lam=2.1, alpha=0.9,
                  n_blocks=n_blocks,
                  resampling_method="systematic", verbose="none", seed=1000 + r)
        mu = res.posterior_mean()
        if np.max(np.abs(mu - TRUE)) > 0.5:
            fails += 1
        means.append(mu)
        mdds.append(res.log_mdd)

    means = np.stack(means)
    print(json.dumps({
        "metric": "linear_model_accuracy",
        "n_blocks": n_blocks,
        "n_phi": n_phi,
        "replications": R,
        "gate_failures": fails,
        "mean_abs_error": round(float(np.abs(means - TRUE).mean()), 4),
        "max_err_vs_exact_posterior": round(
            float(np.abs(means - oracle["mean"]).max()), 4),
        "across_rep_std_of_means": round(float(means.std(0).mean()), 4),
        "log_mdd_mean": round(float(np.mean(mdds)), 2),
        "log_mdd_std": round(float(np.std(mdds)), 2),
        "log_mdd_exact": round(oracle["log_evidence"], 2),
    }))


if __name__ == "__main__":
    main()
