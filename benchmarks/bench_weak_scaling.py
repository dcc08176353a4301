"""Weak-scaling of the sharded SMC superstep: fixed particles-per-device,
1 -> 2 -> 4 -> 8 devices on a virtual CPU mesh (the same SPMD program that
runs sharded over several GPUs; BASELINE.json targets >=85% efficiency at
2 hosts).

Prints one JSON line per mesh size:
  {"metric": "weak_scaling", "devices": d, "stage_ms": t, "efficiency": e}

Run: python benchmarks/bench_weak_scaling.py [particles_per_device]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from smc_jax.params import ParamSpace
from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                   generate_linear_data)
from smc_jax.smc import make_superstep
from smc_jax.parallel.mesh import particle_mesh


def run(n_devices: int, per_device: int) -> float:
    n = per_device * n_devices
    mesh = particle_mesh(jax.devices()[:n_devices])
    sh = NamedSharding(mesh, P("parts"))
    sh2 = NamedSharding(mesh, P("parts", None))

    data, X = generate_linear_data(seed=1793)
    space = ParamSpace(linear_parameters())
    ll = make_linear_loglike(X)
    llb = jax.vmap(lambda th: ll(th, data))
    ss = make_superstep(space, llb, 1, 1, 0.9, "systematic", 0.5 * n)

    key = jax.random.PRNGKey(0)
    params = jax.device_put(space.sample_prior(key, n), sh2)
    loglh = jax.device_put(llb(params), sh)
    logprior = jax.device_put(space.log_prior(params), sh)
    state = (params, loglh, logprior,
             jax.device_put(jnp.zeros(n), sh),
             jax.device_put(jnp.ones(n), sh))

    out = ss(key, *state, jnp.float64(0.05), jnp.float64(0.0),
             jnp.float64(0.5))
    jax.block_until_ready(out[0])  # compile

    n_stages = 20
    t0 = time.perf_counter()
    o = out
    for s in range(n_stages):
        key, sk = jax.random.split(key)
        o = ss(sk, *o[:5], jnp.float64(0.05 + 0.04 * (s + 1)),
               jnp.float64(0.05 + 0.04 * s), jnp.float64(0.5))
    jax.block_until_ready(o[0])
    return (time.perf_counter() - t0) / n_stages


def main():
    per_device = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    base = None
    for d in (1, 2, 4, 8):
        t = run(d, per_device)
        if base is None:
            base = t
        eff = base / t
        print(json.dumps({"metric": "weak_scaling", "devices": d,
                          "particles": per_device * d,
                          "stage_ms": round(t * 1e3, 2),
                          "efficiency": round(eff, 3)}))


if __name__ == "__main__":
    main()
