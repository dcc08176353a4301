"""An-Schorfheide DSGE benchmark: particles-mutated/s/chip on the superstep
(mutation = RE solve by cyclic reduction + Kalman scan per proposal) and
wall-clock of a full estimation to target ESS (BASELINE.json north-star).

Run on the default backend (the GPU when one is present):
  python benchmarks/bench_as.py [n_parts] [--full]
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
from smc_jax.smc import make_superstep, smc


def throughput(n_parts: int):
    model = an_schorfheide()
    data = generate_as_data(T=80, seed=1793)
    space = ParamSpace(an_schorfheide_parameters())
    llb = jax.vmap(lambda th: model.loglike(th, data))
    ss = make_superstep(space, llb, 1, 1, 0.9, "systematic", 0.5 * n_parts)

    @jax.jit
    def init(key):
        draws = space.sample_prior(key, n_parts)
        loglh = llb(draws)
        loglh = jnp.where(jnp.isnan(loglh), -jnp.inf, loglh)
        return draws, loglh, space.log_prior(draws)

    key = jax.random.PRNGKey(0)
    params, loglh, logprior = init(key)
    jax.block_until_ready(params)
    state = (params, loglh, logprior, jnp.zeros(n_parts), jnp.ones(n_parts))
    out = ss(key, *state, jnp.float64(0.05), jnp.float64(0.0),
             jnp.float64(0.4))
    jax.block_until_ready(out[0])  # compile

    n_stages = 10
    t0 = time.perf_counter()
    for s in range(n_stages):
        key, sk = jax.random.split(key)
        out = ss(sk, *out[:5], jnp.float64(0.05 + 0.09 * (s + 1)),
                 jnp.float64(0.05 + 0.09 * s), jnp.float64(0.4))
    jax.block_until_ready(out[0])
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": "as_particles_mutated_per_s_per_chip",
        "value": round(n_parts * n_stages / dt / len(jax.devices()), 1),
        "unit": "particle-mutations/s/chip",
        "stage_ms": round(dt / n_stages * 1e3, 1),
        "n_parts": n_parts,
    }))


def full_estimation(n_parts: int):
    model = an_schorfheide()
    data = generate_as_data(T=80, seed=1793)
    t0 = time.perf_counter()
    res = smc(model.loglike, an_schorfheide_parameters(), data,
              n_parts=n_parts, n_phi=100, lam=2.0,
              resampling_method="systematic", verbose="none", seed=42)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": "as_full_estimation_wall_clock",
        "value": round(dt, 1),
        "unit": "s",
        "n_parts": n_parts,
        "log_mdd": round(res.log_mdd, 2),
        "final_ess": round(res.cloud.ESS[-1], 1),
    }))


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 16384
    throughput(n)
    if "--full" in sys.argv:
        full_estimation(min(n, 4096))
