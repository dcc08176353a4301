"""Adaptive-schedule An-Schorfheide estimation on the chip: the adaptive
path's per-stage ESS bisection (~70 extra ESS reductions) and chunked
re-invocation, which the fixed-schedule benchmarks never run.

Runs the fused recursion with use_fixed_schedule=False at the reference's
tempering_target=0.97 (src/smc_main.jl:133) and reports stages-to-phi=1,
ms/stage, and chunk re-invocation count, next to a fixed-schedule run of
the same model/particles for comparison.

Usage: python benchmarks/bench_as_adaptive.py [n_parts] [chunk]
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
from smc_jax.models.as_dsge import (an_schorfheide, an_schorfheide_parameters,
                                    generate_as_data)
from smc_jax.smc import make_fused_recursion
from smc_jax.ops.schedule import fixed_schedule
from smc_jax.ops.initialization import initial_draw


def run_fused(space, llb, n, n_phi, use_fixed, chunk, seed=0):
    sched = fixed_schedule(n_phi, 2.0)
    fused = make_fused_recursion(
        space, llb, 1, 1, 0.9, "systematic", 0.5 * n, n_phi, sched,
        use_fixed, 0.97, 0.25, store_weight_matrices=False,
        chunk_stages=chunk)
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    cloud = initial_draw(k0, space, llb, n)
    jax.block_until_ready(cloud.params)

    def one(k):
        arrays = (cloud.params, cloud.loglh, cloud.logprior,
                  cloud.old_loglh, jnp.ones(n, jnp.float64))
        state = (0.5, 0.25, 0.0, float(n), 1, 0.0, False)
        s_global, phi, log_mdd, n_chunks = 0, 0.0, 0.0, 0
        while phi < 1.0:
            st = fused(k, *arrays, *state, s_global)
            jax.block_until_ready(st["params"])
            if int(st["s"]) == s_global:
                raise RuntimeError(f"no progress at phi={float(st['phi'])}")
            n_chunks += 1
            s_global = int(st["s"])
            phi = float(st["phi"])
            log_mdd += float(st["log_mdd"])
            k = st["key"]
            arrays = (st["params"], st["loglh"], st["logprior"],
                      st["old_loglh"], st["weights"])
            state = (float(st["c"]), float(st["accept_rate"]), phi,
                     float(st["ess_prev"]), int(st["j"]),
                     float(st["phi_prop"]), bool(st["resampled_last"]))
        return s_global, log_mdd, n_chunks

    t0 = time.perf_counter()
    one(key)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    stages, mdd, n_chunks = one(jax.random.PRNGKey(seed + 1))
    dt = time.perf_counter() - t0
    return stages, dt, t_first, mdd, n_chunks


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    chunk = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    n_phi = 100
    model = an_schorfheide()
    data = generate_as_data(T=80, seed=1793)
    space = ParamSpace(an_schorfheide_parameters())
    llb = lambda th: model.loglike_batched(th, data)

    for mode, fixed in (("adaptive", False), ("fixed", True)):
        stages, dt, t_first, mdd, n_chunks = run_fused(
            space, llb, n, n_phi, fixed, chunk)
        print(json.dumps({
            "metric": "as_adaptive", "schedule": mode, "n_parts": n,
            "n_stages": stages, "wall_s": round(dt, 2),
            "ms_per_stage": round(dt / stages * 1e3, 1),
            "n_chunks": n_chunks, "chunk_stages": chunk,
            "log_mdd": round(mdd, 2),
            "first_run_plus_compile_s": round(t_first, 1),
            "device": str(jax.devices()[0]),
        }), flush=True)


if __name__ == "__main__":
    main()
