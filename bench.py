"""Benchmark: particles-mutated/s per chip on the FUSED SMC recursion.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...extras}. Runs only on a GPU: with any other platform it exits non-zero
before compiling anything.

Baseline (BASELINE.md): the reference's linear-model test — 9 params, 400
particles, n_phi=120, 1 MH step — takes ~3 minutes on a 2-core CI runner
(reference test/smc.jl:24), i.e. 400*119/180s ~= 264 particle-mutations/s.

Each workload times a COMPLETE estimation through the fused recursion (the
entire tempering loop inside one XLA while_loop per chunk —
smc_jax.smc.make_fused_recursion): the linear fixture, n_phi=120 fixed
schedule, 32768 particles (primary metric), plus the An-Schorfheide DSGE
(RE-solve by cyclic reduction + Kalman scan per mutation proposal) at 16384
particles as extra fields. Each is run twice: compile+run, then a timed run
with another seed.
"""

import json
import sys
import time

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

BASELINE_MUTATIONS_PER_S = 400 * 119 / 180.0  # reference CI wall-clock
N_PARTS = 32768
N_PHI = 120
AS_N_PARTS = 16384
AS_N_PHI = 100


def time_fused_estimation(space, loglike_batched, n_parts, n_phi, lam,
                          n_blocks, alpha, seed, chunk_stages=None):
    """Run a complete fused estimation twice (compile+run, then timed run).
    chunk_stages bounds the stages per device dispatch, as smc() does at
    its default verbosity. Returns (n_stages, wall_s, compile_plus_run_s,
    log_mdd, n_devices), n_devices counting the devices the cloud ran on."""
    from smc_jax.smc import make_fused_recursion
    from smc_jax.ops.schedule import fixed_schedule
    from smc_jax.ops.initialization import initial_draw

    sched = fixed_schedule(n_phi, lam)
    fused = make_fused_recursion(
        space, loglike_batched, n_blocks, 1, alpha, "systematic",
        0.5 * n_parts, n_phi, sched, True, 0.97, 0.25,
        store_weight_matrices=False, chunk_stages=chunk_stages)

    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    cloud = initial_draw(k0, space, loglike_batched, n_parts)
    jax.block_until_ready(cloud.params)

    def run(k):
        state = (0.5, 0.25, 0.0, float(n_parts), 1, 0.0, False)
        s_global, log_mdd, phi = 0, 0.0, 0.0
        arrays = (cloud.params, cloud.loglh, cloud.logprior,
                  cloud.old_loglh, cloud.weights)
        while phi < 1.0:
            st = fused(k, *arrays, *state, s_global)
            jax.block_until_ready(st["params"])
            if bool(st["nan_ess"]):
                raise RuntimeError("NaN ESS in fused bench run")
            if int(st["s"]) == s_global:
                raise RuntimeError(f"no progress at phi={float(st['phi'])}")
            s_global = int(st["s"])
            phi = float(st["phi"])
            log_mdd += float(st["log_mdd"])
            k = st["key"]
            arrays = (st["params"], st["loglh"], st["logprior"],
                      st["old_loglh"], st["weights"])
            state = (float(st["c"]), float(st["accept_rate"]), phi,
                     float(st["ess_prev"]), int(st["j"]),
                     float(st["phi_prop"]), bool(st["resampled_last"]))
        return s_global, log_mdd, len(st["params"].sharding.device_set)

    t0 = time.perf_counter()
    run(key)
    t_first = time.perf_counter() - t0

    t0 = time.perf_counter()
    n_stages, mdd, n_devices = run(jax.random.PRNGKey(seed + 1))
    dt = time.perf_counter() - t0
    return n_stages, dt, t_first, mdd, n_devices


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found platform "
                 f"{dev.platform!r} ({dev.device_kind})")

    from smc_jax.compile_cache import enable_compile_cache
    from smc_jax.params import ParamSpace
    from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                       generate_linear_data)
    from smc_jax.models.as_dsge import (an_schorfheide,
                                        an_schorfheide_parameters,
                                        generate_as_data)
    enable_compile_cache()

    data, X = generate_linear_data(seed=1793)
    space = ParamSpace(linear_parameters())
    ll = make_linear_loglike(X)
    llb = jax.vmap(lambda th: ll(th, data))

    n_stages, dt, t_first, mdd, n_dev = time_fused_estimation(
        space, llb, N_PARTS, N_PHI, 2.1, 3, 0.9, seed=0)
    value = N_PARTS * n_stages / dt / n_dev

    model = an_schorfheide()
    as_data = generate_as_data(T=80, seed=1793)
    as_space = ParamSpace(an_schorfheide_parameters())
    as_llb = lambda th: model.loglike_batched(th, as_data)
    as_stages, as_dt, as_first, as_mdd, as_dev = time_fused_estimation(
        as_space, as_llb, AS_N_PARTS, AS_N_PHI, 2.0, 1, 0.9, seed=0,
        chunk_stages=25)
    if not (np.isfinite(mdd) and np.isfinite(as_mdd)):
        raise RuntimeError(f"non-finite log-MDD: linear {mdd}, AS {as_mdd}")

    print(json.dumps({
        "metric": "particles_mutated_per_s_per_chip",
        "value": round(value, 1),
        "unit": "particle-mutations/s/chip",
        "vs_baseline": round(value / BASELINE_MUTATIONS_PER_S, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": n_dev},
        "as_mutations_per_s_per_chip": round(
            AS_N_PARTS * as_stages / as_dt / as_dev, 1),
        "as_full_estimation_s": round(as_dt, 2),
        "as_n_parts": AS_N_PARTS,
        "as_n_stages": as_stages,
        "as_log_mdd": round(as_mdd, 2),
    }))
    print(f"# linear: n_parts={N_PARTS} stages={n_stages} "
          f"stage_time={dt/n_stages*1e3:.2f}ms total={dt:.2f}s "
          f"first(run+compile)={t_first:.1f}s log_mdd={mdd:.2f}",
          file=sys.stderr)
    print(f"# AS: {as_stages} stages in {as_dt:.2f}s "
          f"({as_dt/as_stages*1e3:.1f} ms/stage), first(run+compile)="
          f"{as_first:.1f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
