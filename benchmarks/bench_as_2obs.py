"""n_obs != 3 innovation-solve path (bl_chol_solve) on the chip.

The unrolled-Cholesky PSD path (ops/linalg.py bl_chol_solve) is used
whenever n_obs != 3, e.g. Smets-Wouters' 7 observables. This times the
2-obs An-Schorfheide variant's full batch-last likelihood IN-LOOP (K
iterations inside one lax.while_loop dispatch, so per-dispatch overhead
divides out) and asserts parity against the vmapped f64 path.

Usage: python benchmarks/bench_as_2obs.py [n_parts] [K]
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
from smc_jax.models.as_dsge import (an_schorfheide_2obs,
                                    an_schorfheide_parameters,
                                    generate_as_data)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    model = an_schorfheide_2obs()
    data = jnp.asarray(generate_as_data(T=80, seed=1793)[:2])
    space = ParamSpace(an_schorfheide_parameters())
    thetas = space.sample_prior(jax.random.PRNGKey(0), n)
    jax.block_until_ready(thetas)
    llb = lambda th: model.loglike_batched(th, data)

    # parity vs the vmapped f64 path on a subsample (vmapped path is slow)
    sub = thetas[:2048]
    ll_bl = np.asarray(jax.jit(llb)(sub))
    ll_vm = np.asarray(jax.jit(jax.vmap(
        lambda th: model.loglike(th, data)))(sub))
    fin = np.isfinite(ll_bl) & np.isfinite(ll_vm)
    rel = float(np.max(np.abs(ll_bl[fin] - ll_vm[fin])
                       / np.abs(ll_vm[fin]))) if fin.any() else float("nan")
    assert fin.sum() > 500 and rel < 1e-8, (
        f"bl_chol_solve parity broke: rel={rel:.3e}, n_fin={int(fin.sum())}")

    @jax.jit
    def run():
        def body(c):
            i, acc = c
            ll = llb(thetas + i * 1e-14)
            return i + 1, acc + jnp.sum(jnp.where(jnp.isfinite(ll), ll, 0.0))
        return jax.lax.while_loop(lambda c: c[0] < K, body,
                                  (jnp.int32(0), jnp.float64(0.0)))[1]

    t0 = time.perf_counter()
    v = float(run())
    tc = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        v = float(run())
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({
        "metric": "as_2obs_chol", "item": "likelihood_full_xla_chol",
        "ms_inloop": round(best / K * 1e3, 3), "n_parts": n, "K": K,
        "parity_rel_vs_vmapped": rel, "n_finite": int(fin.sum()),
        "compile_plus_first_s": round(tc, 1),
        "device": str(jax.devices()[0])}), flush=True)


if __name__ == "__main__":
    main()
