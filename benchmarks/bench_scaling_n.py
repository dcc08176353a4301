"""Large-N scaling envelope on one chip.

The pitch of this framework is massive particle counts — the reference
caps at 12k particles over 40 Distributed.jl workers
(reference examples/dsge_models/dsge_model.jl:27-35). This script maps, on
a single chip: superstep ms/stage and mutations/s as N doubles, for the
linear fixture (32k -> 1M) and the An-Schorfheide DSGE (16k -> 256k),
until OOM — emitting one JSON line per point so a failed compile loses
nothing.

Usage: python benchmarks/bench_scaling_n.py [linear|as|sw] [max_n]
  sw: Smets-Wouters at the production config (3 blocks), 2k -> 16k
      (does the 56-state batch-last path scale with N like AS does?)
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
from smc_jax.smc import make_superstep


def emit(**kw):
    print(json.dumps({"metric": "n_scaling",
                      "device": str(jax.devices()[0]), **kw}), flush=True)


def bench_superstep(space, llb, n, n_blocks, alpha, K=20, reps=2):
    """Time K supersteps INSIDE one `lax.while_loop` dispatch, so the
    per-dispatch overhead divides out of the per-superstep time."""
    ss = make_superstep(space, llb, n_blocks, 1, alpha, "systematic",
                        0.5 * n)
    key = jax.random.PRNGKey(0)
    params = space.sample_prior(key, n)
    loglh = llb(params)
    logprior = space.log_prior(params)
    zeros = jnp.zeros(n, jnp.float64)
    ones = jnp.ones(n, jnp.float64)

    @jax.jit
    def run(params, loglh, logprior, weights):
        def body(c):
            i, p, l, lp, w = c
            k = jax.random.fold_in(jax.random.PRNGKey(7), i)
            out = ss(k, p, l, lp, zeros, w, jnp.float64(0.1),
                     jnp.float64(0.05), jnp.float64(0.5))
            return i + 1, out[0], out[1], out[2], out[4]
        out = jax.lax.while_loop(lambda c: c[0] < K, body,
                                 (jnp.int32(0), params, loglh, logprior,
                                  weights))
        # in-graph scalar reduction so nothing can be elided or deferred
        return out[1].sum() + out[2].sum() + out[4].sum()

    t0 = time.perf_counter()
    float(run(params, loglh, logprior, ones))
    t_compile = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        float(run(params, loglh, logprior, ones))
        best = min(best, time.perf_counter() - t0)
    return best / K, t_compile


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "linear"
    defaults = {"linear": 1_048_576, "as": 262_144, "sw": 16_384}
    max_n = int(sys.argv[2]) if len(sys.argv) > 2 else defaults[which]

    if which == "linear":
        from smc_jax.models.linear import (linear_parameters,
                                           make_linear_loglike,
                                           generate_linear_data)
        data, X = generate_linear_data(seed=1793)
        space = ParamSpace(linear_parameters())
        ll = make_linear_loglike(X)
        llb = jax.vmap(lambda th: ll(th, data))
        n0, n_blocks, alpha, K = 32_768, 3, 0.9, 20
    elif which == "as":
        from smc_jax.models.as_dsge import (an_schorfheide,
                                            an_schorfheide_parameters,
                                            generate_as_data)
        model = an_schorfheide()
        as_data = generate_as_data(T=80, seed=1793)
        space = ParamSpace(an_schorfheide_parameters())
        llb = lambda th: model.loglike_batched(th, as_data)
        n0, n_blocks, alpha, K = 16_384, 1, 0.9, 10
    else:
        from smc_jax.models.sw_dsge import (smets_wouters,
                                            load_reference_sw_data)
        model = smets_wouters()
        sw_data = load_reference_sw_data()
        space = ParamSpace(model.parameters)
        llb = lambda th: model.loglike_batched(th, sw_data)
        n0, n_blocks, alpha, K = 2_048, 3, 0.9, 2

    n = int(_os.environ.get("SCALE_N0", n0))  # resume mid-envelope after
    while n <= max_n:                         # an infra crash
        try:
            best, tc = bench_superstep(space, llb, n, n_blocks, alpha, K=K)
            emit(model=which, n_parts=n, stage_ms=round(best * 1e3, 2),
                 mutations_per_s=round(n / best, 1),
                 compile_s=round(tc, 1))
        except Exception as e:
            msg = repr(e)
            oom = "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower()
            emit(model=which, n_parts=n, error=msg[:200], oom=oom)
            if oom:
                break
        n *= 2


if __name__ == "__main__":
    main()
