"""In-loop ablation of the LINEAR-model SMC stage on the chip.

This script measures each stage ingredient INSIDE a `lax.while_loop` of K
iterations (one dispatch per item, so per-dispatch overhead divides out),
giving the device-side marginal cost of every component of the superstep
at the bench shape (RNG, exp/log transcendentals, eigh, mixture
densities, resampling).

Emits one JSON line per item: {"metric": "linear_ablate", "item", "ms", ...}

Usage: python benchmarks/bench_linear_ablate_inloop.py [n_parts] [K]
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

from smc_jax.params import ParamSpace
from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                   generate_linear_data)
from smc_jax.ops.mutation import make_mutation_step, _deg_factor
from smc_jax.ops.resample import resample as resample_indices
from smc_jax.ops.correction import correct


def weighted_mean_cov_free(params, weights, free_inds):
    vals = params[:, jnp.asarray(free_inds)]
    wsum = jnp.sum(weights)
    mu = (weights @ vals) / wsum
    dev = vals - mu
    cov = (dev.T * weights) @ dev / wsum
    return mu, 0.5 * (cov + cov.T)


def loop_time(make_body, state, K, label):
    """Time K iterations of body inside ONE lax.while_loop dispatch."""
    def run(state):
        def cond(c):
            return c[0] < K
        def body(c):
            i, key, st = c
            key = jax.random.fold_in(key, i)
            st = make_body(key, st)
            return i + 1, key, st
        return jax.lax.while_loop(cond, body,
                                  (jnp.int32(0), jax.random.PRNGKey(0), state))
    jrun = jax.jit(run)
    out = jrun(state)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = jrun(state)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best / K


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 32768
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    data, X = generate_linear_data(seed=1793)
    space = ParamSpace(linear_parameters())
    ll = make_linear_loglike(X)
    llb = jax.vmap(lambda th: ll(th, data))
    P = space.n_para
    nf = space.n_free

    key = jax.random.PRNGKey(0)
    params = space.sample_prior(key, n)
    loglh = llb(params)
    logprior = space.log_prior(params)
    weights = jnp.ones(n, jnp.float64)
    mean_free, cov_free = weighted_mean_cov_free(params, weights,
                                                 space.free_inds)
    perm = jnp.arange(nf, dtype=jnp.int32)
    base = dict(params=params, loglh=loglh, logprior=logprior,
                weights=weights)

    results = {}

    def emit(item, s_per_iter):
        ms = s_per_iter * 1e3
        results[item] = ms
        print(json.dumps({"metric": "linear_ablate", "item": item,
                          "ms": round(ms, 4), "n_parts": n, "K": K,
                          "device": str(jax.devices()[0])}), flush=True)

    # 0. loop overhead
    emit("loop_overhead", loop_time(
        lambda k, st: {**st, "loglh": st["loglh"] + 1e-12}, base, K, "ovh"))

    # 1. RNG: one f64 normal [N, nf] (erfinv path)
    emit("rng_normal", loop_time(
        lambda k, st: {**st, "loglh": st["loglh"]
                       + jax.random.normal(k, (n, nf),
                                           dtype=jnp.float64)[:, 0] * 1e-12},
        base, K, "rng"))

    # 2. RNG full per-block set x3: normal + choice + uniform + log
    def rng_full(k, st):
        acc = st["loglh"]
        for b in range(3):
            kb = jax.random.fold_in(k, b)
            k1, k2, k3 = jax.random.split(kb, 3)
            eps = jax.random.normal(k1, (n, 3), dtype=jnp.float64)
            comp = jax.random.choice(k2, 3, (n,),
                                     p=jnp.array([0.9, 0.05, 0.05]))
            lu = jnp.log(jax.random.uniform(k3, (n,), dtype=jnp.float64))
            acc = acc + (eps[:, 0] + comp + lu) * 1e-15
        return {**st, "loglh": acc}
    emit("rng_full_3blocks", loop_time(rng_full, base, K, "rngf"))

    # 3. correction + ESS (log-space)
    def corr(k, st):
        inc_w, w_new, ess, mdd = correct(
            st["loglh"], jnp.zeros_like(st["loglh"]), st["weights"],
            jnp.float64(0.51), jnp.float64(0.5))
        return {**st, "weights": w_new,
                "loglh": st["loglh"] + (ess + mdd) * 1e-18}
    emit("correction_ess", loop_time(corr, base, K, "corr"))

    # 4. systematic resample indices + 4-array gather (every iter)
    def resamp(k, st):
        idx = resample_indices(k, st["weights"], method="systematic")
        return {**st,
                "params": jnp.take(st["params"], idx, axis=0),
                "loglh": jnp.take(st["loglh"], idx),
                "logprior": jnp.take(st["logprior"], idx),
                "weights": jnp.ones_like(st["weights"])}
    emit("resample_gather", loop_time(resamp, base, K, "rs"))

    # 5. weighted moments (mean + cov over free params)
    def moments(k, st):
        m, cv = weighted_mean_cov_free(st["params"], st["weights"],
                                       space.free_inds)
        return {**st, "loglh": st["loglh"] + (m[0] + cv[0, 0]) * 1e-18}
    emit("weighted_moments", loop_time(moments, base, K, "mom"))

    # 6. eigh factor of 3x3 blocks x3
    def eighs(k, st):
        acc = st["loglh"]
        for b in range(3):
            cb = cov_free[b * 3:(b + 1) * 3, b * 3:(b + 1) * 3]
            U, sq, il, r, ld = _deg_factor(cb + acc[0] * 1e-30)
            acc = acc + (U[0, 0] + sq[0] + ld) * 1e-18
        return {**st, "loglh": acc}
    emit("eigh_3x3_x3", loop_time(eighs, base, K, "eig"))

    # 7. likelihood eval x3
    def likes(k, st):
        acc = st["loglh"]
        for b in range(3):
            acc = acc + llb(st["params"] + acc[0] * 1e-30) * 1e-18
        return {**st, "loglh": acc}
    emit("likelihood_x3", loop_time(likes, base, K, "ll"))

    # 8. log-prior x3
    def priors(k, st):
        acc = st["loglh"]
        for b in range(3):
            acc = acc + space.log_prior(st["params"] + acc[0] * 1e-30) * 1e-18
        return {**st, "loglh": acc}
    emit("logprior_x3", loop_time(priors, base, K, "pr"))

    # 9. full mutation step (3 blocks, alpha=0.9)
    mstep = make_mutation_step(space, llb, 3, 1, 0.9)
    def mut(k, st):
        p, l, lp, ol, af = mstep(k, st["params"], st["loglh"], st["logprior"],
                                 jnp.zeros(n, jnp.float64), mean_free,
                                 cov_free, perm, jnp.float64(0.5),
                                 jnp.float64(0.51), jnp.float64(0.5))
        return {**st, "params": p, "loglh": l, "logprior": lp}
    emit("mutation_full_3b", loop_time(mut, base, K, "mut"))

    # 9b. mutation with alpha=1 (no mixture densities / logsumexp)
    mstep1 = make_mutation_step(space, llb, 3, 1, 1.0)
    def mut1(k, st):
        p, l, lp, ol, af = mstep1(k, st["params"], st["loglh"], st["logprior"],
                                  jnp.zeros(n, jnp.float64), mean_free,
                                  cov_free, perm, jnp.float64(0.5),
                                  jnp.float64(0.51), jnp.float64(0.5))
        return {**st, "params": p, "loglh": l, "logprior": lp}
    emit("mutation_alpha1_3b", loop_time(mut1, base, K, "mut1"))

    # 9c. mutation 1 block alpha=0.9
    mstepb1 = make_mutation_step(space, llb, 1, 1, 0.9)
    def mutb1(k, st):
        p, l, lp, ol, af = mstepb1(k, st["params"], st["loglh"], st["logprior"],
                                   jnp.zeros(n, jnp.float64), mean_free,
                                   cov_free, perm, jnp.float64(0.5),
                                   jnp.float64(0.51), jnp.float64(0.5))
        return {**st, "params": p, "loglh": l, "logprior": lp}
    emit("mutation_1b", loop_time(mutb1, base, K, "mutb1"))

    # 10. full superstep body (what the fused recursion runs per stage)
    from smc_jax.smc import make_superstep
    ss = make_superstep(space, llb, 3, 1, 0.9, "systematic", 0.5 * n)
    def sup(k, st):
        (p, l, lp, ol, w, acc, iw, W, ess, dr, am, mi) = ss(
            k, st["params"], st["loglh"], st["logprior"],
            jnp.zeros(n, jnp.float64), st["weights"], jnp.float64(0.51),
            jnp.float64(0.5), jnp.float64(0.5))
        return {**st, "params": p, "loglh": l, "logprior": lp, "weights": w}
    emit("full_superstep_3b", loop_time(sup, base, K, "sup"))

    print(json.dumps({"metric": "linear_ablate_summary", "n_parts": n,
                      **{k: round(v, 3) for k, v in results.items()}}),
          flush=True)


if __name__ == "__main__":
    main()
