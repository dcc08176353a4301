"""Where the An-Schorfheide likelihood's device time goes, on a GPU.

    python benchmarks/trace_as_likelihood.py [--out DIR] [--no-graphs]

1. Times the jitted batch-last likelihood alone (16,384 prior draws, T=80).
2. Runs the AS estimation's fused recursion (n_phi=100, chunks of 5
   stages, so 5 likelihood evaluations per chunk at n_blocks=1): the first
   chunk compiles, the second is timed, the third is traced with
   jax.profiler. The device trace is reduced by named scope — the
   likelihood's (re_solve, lyapunov, kalman_scan) and the stage's
   (correction, resample, moments, mutation) — to device time per stage
   and per evaluation, kernels launched per Kalman scan step, and the
   device's busy share of the traced window. XLA replays the loop bodies
   as CUDA graphs, whose kernels carry no op metadata in the trace; with
   --no-graphs (XLA flag --xla_gpu_enable_command_buffer= ) each kernel is
   launched alone and keeps its scope, at the price of launch overhead, so
   attribute with --no-graphs and take times without it.
3. Sets both against the H100's f64 roofline, using the operation count of
   the algorithm (`flops_per_particle`) and the bytes one scan step's
   carried state moves if it round-trips device memory.

Exits non-zero without a GPU. The trace is left under DIR.
"""

import argparse
import glob
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published peaks of one H100 SXM (NVIDIA data sheet), keyed by device_kind.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(f64_vector_flops=34e12,
                                  f64_tensor_flops=67e12, hbm_bytes=3.35e12),
}
# likelihood scopes first: they nest inside "mutation"
SCOPES = ("re_solve", "lyapunov", "kalman_scan", "correction", "resample",
          "moments", "mutation")
LIKELIHOOD_SCOPES = SCOPES[:3]
N_PARTS = 16_384
T_OBS = 80
TRACE_STAGES = 5


def flops_per_particle(n_s=6, n_o=3, n_e=3, T=T_OBS, cr_iter=16,
                       lyap_iter=30, squarings=12):
    """f64 operations one particle's likelihood needs, from the shapes of
    models/dsge.py's batch-last path (a matmul [i,j]@[j,k] is 2ijk)."""
    mm = lambda i, j, k: 2 * i * j * k
    gj = lambda n, m: 2 * n * n * (n + m)        # Gauss-Jordan, m rhs
    cof = lambda m: 30 + 6 * n_o * m             # 3x3 adjugate solve
    re = (cr_iter * (gj(n_s, 2 * n_s) + 4 * mm(n_s, n_s, n_s))
          + gj(n_s, n_s) + gj(n_s, n_e) + gj(n_s, n_s)
          + 2 * squarings * mm(n_s, n_s, n_s))
    lyap = lyap_iter * 3 * mm(n_s, n_s, n_s)
    step = (mm(n_o, n_s, 1) + mm(n_o, n_s, n_o) + cof(1 + n_o)
            + mm(n_s, n_s, 1) + mm(n_s, n_o, 1) + mm(n_o, n_o, n_o)
            + mm(n_s, n_o, n_o) + mm(n_o, n_s, n_o) + mm(n_s, n_s, n_o)
            + mm(n_s, n_s, n_o) + mm(n_s, n_o, n_o) + cof(n_o)
            + 2 * mm(n_o, n_o, n_o))
    return re + lyap + T * step


def carry_bytes_per_step(n_s=6, n_o=3):
    """Bytes one particle's scan step moves if its carried state (s, K, F,
    W, M) is read and written once and the system matrices (T, Z, d) are
    read once: the floor for a scan whose steps are separate kernels."""
    carry = n_s + n_s * n_o + n_o * n_o + n_s * n_o + n_o * n_o
    system = n_s * n_s + n_o * n_s + n_o
    return 8 * (2 * carry + system)


def merged_busy_ns(intervals):
    busy, end = 0, -1
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def reduce_trace(path, n_evals):
    """Device time by likelihood scope, from one .xplane.pb. Counts the
    kernel events on the GPU planes' stream lines. A kernel is attributed
    to a scope when the scope's name appears in its name or a string stat
    (the HLO op's metadata); if no kernel carries scope names, the Kalman
    scan is recognised by trip count instead: kernels launched a multiple
    of T_OBS * n_evals times."""
    from jax.profiler import ProfileData
    prof = ProfileData.from_file(path)
    events, line_names, samples = [], set(), []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        line_names.update(f"{plane.name}:{ln.name}" for ln in lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for ev in line.events:
                stats = [(k, v) for k, v in ev.stats]
                if len(samples) < 3:
                    samples.append((ev.name, stats))
                label = " ".join([ev.name] + [v for _, v in stats
                                              if isinstance(v, str)])
                events.append((ev.name, label, ev.start_ns, ev.end_ns))
    if not events:
        raise RuntimeError(f"no GPU device events in {path}")
    by_kernel = {}
    for name, _, s, e in events:
        k = by_kernel.setdefault(name, [0, 0])
        k[0] += 1
        k[1] += e - s
    by_scope = {sc: [0, 0] for sc in SCOPES}
    for _, label, s, e in events:
        for sc in SCOPES:
            if sc in label:
                by_scope[sc][0] += 1
                by_scope[sc][1] += e - s
                break
    attributed_by = "named scope"
    if not any(c for c, _ in by_scope.values()):
        attributed_by = "trip count"
        for name, (c, ns) in by_kernel.items():
            if c % (T_OBS * n_evals) == 0:
                by_scope["kalman_scan"][0] += c
                by_scope["kalman_scan"][1] += ns
    window = max(e for *_, e in events) - min(s for _, _, s, _ in events)
    busy = merged_busy_ns([(s, e) for _, _, s, e in events])
    return dict(by_scope=by_scope, by_kernel=by_kernel, window_ns=window,
                busy_ns=busy, line_names=sorted(line_names),
                samples=samples, attributed_by=attributed_by)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/as_trace")
    ap.add_argument("--no-graphs", action="store_true",
                    help="launch kernels one by one so the trace keeps "
                         "their named scopes")
    args = ap.parse_args()
    if args.no_graphs:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_gpu_enable_command_buffer=")
    import jax
    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {dev.platform!r}")
    from smc_jax import smc
    from smc_jax.compile_cache import enable_compile_cache
    from smc_jax.params import ParamSpace
    from smc_jax.models.as_dsge import (an_schorfheide,
                                        an_schorfheide_parameters,
                                        generate_as_data)
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
    peaks = PEAKS[dev.device_kind]
    n = N_PARTS
    model = an_schorfheide()
    data = generate_as_data(T=T_OBS, seed=1793)
    space = ParamSpace(an_schorfheide_parameters())

    # 1. the likelihood alone
    thetas = space.sample_prior(jax.random.PRNGKey(0), n)
    f = jax.jit(lambda th: model.loglike_batched(th, data))
    jax.block_until_ready(f(thetas))
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(thetas)
    jax.block_until_ready(out)
    alone_ms = (time.perf_counter() - t0) / reps * 1e3
    flops = flops_per_particle() * n
    print(f"likelihood alone: {alone_ms:.3f} ms/evaluation at N={n}, "
          f"T={T_OBS}; {flops / 1e9:.3f} GFLOP -> "
          f"{flops / (alone_ms * 1e-3) / 1e12:.3f} TFLOP/s f64 "
          f"({flops / (alone_ms * 1e-3) / peaks['f64_vector_flops']:.2%} of "
          f"the {peaks['f64_vector_flops'] / 1e12:g} TFLOP/s vector peak) "
          f"[{card}]")

    # 2. inside the estimation: chunks of the fused recursion
    from smc_jax.smc import make_fused_recursion
    from smc_jax.ops.schedule import fixed_schedule
    from smc_jax.ops.initialization import initial_draw
    n_phi = 100
    fused = make_fused_recursion(
        space, lambda th: model.loglike_batched(th, data), 1, 1, 0.9,
        "systematic", 0.5 * n, n_phi, fixed_schedule(n_phi, 2.0), True,
        0.97, 0.25, store_weight_matrices=False, chunk_stages=TRACE_STAGES)
    cloud = initial_draw(jax.random.PRNGKey(1), space,
                         lambda th: model.loglike_batched(th, data), n)
    st = dict(key=jax.random.PRNGKey(2), params=cloud.params,
              loglh=cloud.loglh, logprior=cloud.logprior,
              old_loglh=cloud.old_loglh, weights=cloud.weights, c=0.5,
              accept_rate=0.25, phi=0.0, ess_prev=float(n), j=1,
              phi_prop=0.0, resampled_last=False, s=0)

    def chunk(st):
        out = fused(st["key"], st["params"], st["loglh"], st["logprior"],
                    st["old_loglh"], st["weights"], float(st["c"]),
                    float(st["accept_rate"]), float(st["phi"]),
                    float(st["ess_prev"]), int(st["j"]),
                    float(st["phi_prop"]), bool(st["resampled_last"]),
                    int(st["s"]))
        jax.block_until_ready(out["params"])
        return out

    st = chunk(st)                                   # compile
    t0 = time.perf_counter()
    st = chunk(st)
    chunk_ms = (time.perf_counter() - t0) * 1e3
    print(f"fused chunk of {TRACE_STAGES} stages: {chunk_ms:.3f} ms wall, "
          f"{chunk_ms / TRACE_STAGES:.3f} ms/stage [{card}]")
    jax.profiler.start_trace(args.out)
    st = chunk(st)
    jax.profiler.stop_trace()
    path = max(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    red = reduce_trace(path, TRACE_STAGES)
    print(f"trace {path}; device lines {red['line_names']}")
    for name, stats in red["samples"]:
        print(f"  sample event {name}: {stats}")
    print(f"kernels attributed to scopes by {red['attributed_by']}")
    print(f"device busy {red['busy_ns'] / 1e6:.3f} ms of a "
          f"{red['window_ns'] / 1e6:.3f} ms window "
          f"(idle share {1 - red['busy_ns'] / red['window_ns']:.3f})")
    total_ll = 0
    for s, (cnt, ns) in red["by_scope"].items():
        total_ll += ns if s in LIKELIHOOD_SCOPES else 0
        print(f"  {s:12s}: {cnt / TRACE_STAGES:9.1f} kernels/stage, "
              f"{ns / TRACE_STAGES / 1e6:8.3f} ms/stage")
    other = red["busy_ns"] - sum(ns for _, ns in red["by_scope"].values())
    print(f"  {'unscoped':12s}: {other / TRACE_STAGES / 1e6:8.3f} ms/stage "
          f"(busy time outside the scopes, copies included)")
    cnt = red["by_scope"]["kalman_scan"][0]
    step_ns = red["by_scope"]["kalman_scan"][1] / (TRACE_STAGES * T_OBS)
    step_bytes = carry_bytes_per_step() * n
    if not step_ns:
        print("no kernel attributed to kalman_scan (CUDA graphs hide the "
              "scopes: rerun with --no-graphs)")
        step_ns = float("nan")
    print(f"likelihood in the estimation: {total_ll / TRACE_STAGES / 1e6:.3f}"
          f" ms/evaluation; kalman scan {cnt / (TRACE_STAGES * T_OBS):.1f} "
          f"kernels/step, {step_ns / 1e3:.2f} us/step; carried state "
          f"{step_bytes / 1e6:.2f} MB/step -> "
          f"{step_bytes / (step_ns * 1e-9) / 1e9:.1f} GB/s "
          f"({step_bytes / (step_ns * 1e-9) / peaks['hbm_bytes']:.2%} of "
          f"{peaks['hbm_bytes'] / 1e12:g} TB/s) [{card}]")
    copies = {k: v for k, v in red["by_kernel"].items()
              if k.startswith("Memcpy")}
    for k, (c, ns) in sorted(copies.items()):
        print(f"  {k}: {c / TRACE_STAGES:.1f}/stage, "
              f"{ns / TRACE_STAGES / 1e6:.3f} ms/stage")
    print(f"f64 compute floor: {flops / peaks['f64_vector_flops'] * 1e3:.4f}"
          f" ms/evaluation")
    top = sorted(red["by_kernel"].items(), key=lambda kv: -kv[1][1])[:12]
    for name, (c, ns) in top:
        print(f"  kernel {name[:60]:60s} x{c:6d} {ns / 1e6:9.3f} ms")


if __name__ == "__main__":
    main()
