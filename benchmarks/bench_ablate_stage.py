"""Ablate the SMC stage superstep to locate the device-time budget.

The linear model's likelihood is ~177 MFLOP of f64 math per stage at
32,768 particles, a small share of a stage. This script times each stage
ingredient as its own jitted program (post-compile, best of 10) and prints
one JSON line per item.

Run on the default backend: python benchmarks/bench_ablate_stage.py [n]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

from smc_jax.compile_cache import enable_compile_cache
from smc_jax.params import ParamSpace
from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                   generate_linear_data)
from smc_jax.ops.resample import resample as resample_indices
from smc_jax.ops.mutation import make_mutation_step, _deg_factor
from smc_jax.smc import make_superstep


def timeit(fn, *args, reps=10):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    enable_compile_cache()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 32768
    data, X = generate_linear_data(seed=1793)
    space = ParamSpace(linear_parameters())
    ll = make_linear_loglike(X)
    llb = jax.vmap(lambda th: ll(th, data))

    key = jax.random.PRNGKey(0)
    params = space.sample_prior(key, n)
    loglh = llb(params)
    logprior = space.log_prior(params)
    weights = jnp.ones(n, jnp.float64)
    old_loglh = jnp.zeros(n, jnp.float64)

    results = {}

    results["likelihood_eval"] = timeit(jax.jit(llb), params)
    results["log_prior"] = timeit(jax.jit(space.log_prior), params)

    @jax.jit
    def rand_block(k):
        k1, k2, k3 = jax.random.split(k, 3)
        eps = jax.random.normal(k1, (n, 9), dtype=jnp.float64)
        comp = jax.random.choice(k2, 3, (n,),
                                 p=jnp.array([0.9, 0.05, 0.05]))
        u = jnp.log(jax.random.uniform(k3, (n,), dtype=jnp.float64))
        return eps, comp, u
    results["rng_draws"] = timeit(rand_block, key)

    @jax.jit
    def resample_block(k, w):
        idx = resample_indices(k, w, method="systematic")
        return jnp.take(params, idx, axis=0)
    results["resample_gather"] = timeit(resample_block, key, weights)

    @jax.jit
    def moments(w, p):
        vals = p[:, space.free_inds]
        mu = (w @ vals) / jnp.sum(w)
        dev = vals - mu
        cov = (dev.T * w) @ dev / jnp.sum(w)
        return mu, cov
    results["weighted_moments"] = timeit(moments, weights, params)

    mu, cov = moments(weights, params)
    results["eigh_3x"] = timeit(
        jax.jit(lambda c: [_deg_factor(c[i * 3:(i + 1) * 3,
                                         i * 3:(i + 1) * 3])[0]
                           for i in range(3)]), cov)

    mstep = jax.jit(make_mutation_step(space, llb, 3, 1, 0.9))
    perm = jnp.arange(9)
    results["mutation_3blocks"] = timeit(
        mstep, key, params, loglh, logprior, old_loglh, mu, cov, perm,
        jnp.float64(0.5), jnp.float64(0.1), jnp.float64(0.05))

    ss = make_superstep(space, llb, 3, 1, 0.9, "systematic", 0.5 * n)
    results["full_superstep"] = timeit(
        ss, key, params, loglh, logprior, old_loglh, weights,
        jnp.float64(0.1), jnp.float64(0.05), jnp.float64(0.5))

    dev = str(jax.devices()[0])
    for k, v in results.items():
        print(json.dumps({"metric": "stage_ablation", "item": k,
                          "ms": round(v * 1e3, 3), "n_parts": n,
                          "device": dev}))


if __name__ == "__main__":
    main()
