"""Smoke run of the SMC engine on a GPU at full size, through smc().

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --mesh4    # four GPUs: the sharded AS phase only

Phases (one process; any failure raises and the exit code is non-zero):

  1. device: JAX must find a GPU, else exit before compiling anything;
     prints the card (nvidia-smi name and power limit), JAX version, x64,
     XLA_FLAGS and the compile-cache directory.
  2. likelihood parity: the An-Schorfheide batch-last likelihood on the GPU
     against its plain reference (the vmapped per-particle likelihood, f64,
     on the host CPU) over 16,384 prior draws; a NaN draw and an explosive
     draw must give -inf without changing any other lane. The same checks,
     cheaper, for the linear likelihood.
  3. linear estimation: smc() at 32,768 particles, gated against the exact
     posterior mean.
  4. An-Schorfheide estimation: smc(batched=True) at 16,384 particles,
     gated by posterior z-scores against the data-generating parameters.
  5. timings of 3 and 4: set-up (first call: tracing, compilation, initial
     draw and run), run (second call, another seed), ms/stage and
     particle-mutations/s, each printed beside the card.

--mesh4 runs phase 1 and the sharded AS phase: 65,536 particles over four
cards against one card (short run, rtol 1e-9), then a full sharded
estimation with phase 4's gates, a check that the cloud stays sharded, and
a check that the compiled likelihood has no all-gather.

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
from jax import monitoring  # noqa: E402

jax.config.update("jax_enable_x64", True)

AS_PARITY_DRAWS = 16_384
LINEAR_PARITY_DRAWS = 32_768
PARITY_BAND_NATS = 50.0      # lanes within this of the best draw
PARITY_RTOL = 1e-9
MAX_OUT_OF_BAND_FLIPS = 16   # finite/-inf flips allowed outside the band
LINEAR_CFG = dict(n_parts=32_768, n_phi=120, lam=2.1, n_blocks=3, alpha=0.9,
                  resampling_method="systematic")
AS_CFG = dict(n_parts=16_384, n_phi=100, lam=2.0, n_blocks=1, alpha=0.9,
              resampling_method="systematic")
MESH_N_PARTS = 65_536
MESH_SHORT_N_PHI = 8
MESH_RTOL = 1e-9


class PhaseError(RuntimeError):
    """A phase's gate failed."""


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def card_description():
    """`name, power.limit` of every visible card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def require_gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found platform "
                 f"{dev.platform!r} ({dev.device_kind})")
    return dev


class CompileClock:
    """Sums XLA backend-compile time (a compile or a persistent-cache load)
    from JAX's monitoring events while a `with` block runs."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.total = 0.0
        self._on = False
        monitoring.register_event_duration_secs_listener(self._listen)

    def _listen(self, event, duration, **_):
        if self._on and event == self.EVENT:
            self.total += duration

    @contextlib.contextmanager
    def measure(self):
        self.total, self._on = 0.0, True
        try:
            yield self
        finally:
            self._on = False


# ---------------------------------------------------------------------------
# 2. likelihood parity
# ---------------------------------------------------------------------------


def _on_cpu(fn, x):
    """fn(x) computed on the host CPU in f64: the plain reference."""
    cpu = jax.devices("cpu")[0]
    return np.asarray(jax.jit(fn)(jax.device_put(np.asarray(x), cpu)))


def compare_lanes(got, ref, band_nats=PARITY_BAND_NATS):
    """Parity statistics of a device likelihood `got` against the reference
    `ref` over the posterior band: lanes within band_nats of either side's
    best draw."""
    fin_g, fin_r = np.isfinite(got), np.isfinite(ref)
    band = np.zeros(got.shape, bool)
    for v, fin in ((got, fin_g), (ref, fin_r)):
        if fin.any():
            band |= fin & (v > v[fin].max() - band_nats)
    both = band & fin_g & fin_r
    rel = (np.abs(got[both] - ref[both]) / np.abs(ref[both])).max() \
        if both.any() else np.inf
    return dict(band=int(band.sum()),
                band_finite_mismatch=int(np.sum((fin_g != fin_r) & band)),
                out_of_band_finite_mismatch=int(
                    np.sum((fin_g != fin_r) & ~band)),
                max_rel_err=float(rel),
                nan_or_posinf=int(np.sum(np.isnan(got) | np.isposinf(got))))


def poisoned_lanes_check(fn, thetas, ll_clean, lanes, poison):
    """Replace `lanes` of the batch via poison(thetas_copy) (N unchanged):
    those lanes must give -inf and every other lane must be bit-identical
    to the clean run."""
    bad = np.array(thetas, copy=True)
    poison(bad)
    ll_bad = np.asarray(fn(bad))
    keep = np.ones(len(bad), bool)
    keep[list(lanes)] = False
    check(np.all(ll_bad[list(lanes)] == -np.inf),
          f"poisoned lanes {lanes} gave {ll_bad[list(lanes)]}, not -inf")
    check(np.array_equal(ll_bad[keep], ll_clean[keep]),
          f"poisoned lanes changed {int(np.sum(ll_bad[keep] != ll_clean[keep]))}"
          f" other lanes")


def as_likelihood_parity(n_draws=AS_PARITY_DRAWS, T=80, seed=1793):
    """Phase 2 for An-Schorfheide. Returns the parity statistics."""
    from smc_jax.params import ParamSpace
    from smc_jax.models.as_dsge import (an_schorfheide, PARAM_NAMES,
                                        an_schorfheide_parameters,
                                        generate_as_data)
    model = an_schorfheide()
    data = generate_as_data(T=T, seed=seed)
    space = ParamSpace(an_schorfheide_parameters())
    thetas = np.asarray(space.sample_prior(jax.random.PRNGKey(seed), n_draws))

    dev_fn = jax.jit(lambda th: model.loglike_batched(th, data))
    out = dev_fn(thetas)
    check(out.dtype == np.float64, f"device likelihood dtype {out.dtype}")
    ll = np.asarray(out)
    ref = _on_cpu(jax.vmap(lambda th: model.loglike(th, data)), thetas)
    stats = compare_lanes(ll, ref)
    check(stats["band"] > 0, "no finite lane in the posterior band")
    check(stats["max_rel_err"] <= PARITY_RTOL,
          f"AS likelihood parity {stats['max_rel_err']:.3e} > {PARITY_RTOL}")
    check(stats["band_finite_mismatch"] == 0,
          f"{stats['band_finite_mismatch']} finite/-inf mismatches in band")
    check(stats["out_of_band_finite_mismatch"] <= MAX_OUT_OF_BAND_FLIPS,
          f"{stats['out_of_band_finite_mismatch']} finite/-inf mismatches "
          f"outside the band (at most {MAX_OUT_OF_BAND_FLIPS})")
    check(stats["nan_or_posinf"] == 0, "likelihood returned nan or +inf")

    # poison two lanes that carried finite likelihoods
    finite = np.flatnonzero(np.isfinite(ll))
    check(len(finite) >= 2, "fewer than two finite lanes to poison")
    i_nan, i_exp = int(finite[0]), int(finite[-1])
    rho_g = PARAM_NAMES.index("rho_g")

    def poison(th):
        th[i_nan] = np.nan
        th[i_exp, rho_g] = 1.5            # g_t = 1.5 g_{t-1}: explosive
    poisoned_lanes_check(dev_fn, thetas, ll, (i_nan, i_exp), poison)
    return stats


def linear_likelihood_parity(n_draws=LINEAR_PARITY_DRAWS, seed=1793):
    """Phase 2 for the linear model: relative error over every finite lane
    (the likelihood is a smooth closed form), then a NaN lane and a
    zero-variance lane."""
    from smc_jax.params import ParamSpace
    from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                       generate_linear_data)
    data, X = generate_linear_data(seed=seed)
    ll_fn = make_linear_loglike(X)
    space = ParamSpace(linear_parameters())
    thetas = np.asarray(space.sample_prior(jax.random.PRNGKey(seed), n_draws))
    vm = jax.vmap(lambda th: ll_fn(th, data))
    dev_fn = jax.jit(vm)
    out = dev_fn(thetas)
    check(out.dtype == np.float64, f"device likelihood dtype {out.dtype}")
    ll = np.asarray(out)
    ref = _on_cpu(vm, thetas)
    fin = np.isfinite(ref)
    check(np.array_equal(np.isfinite(ll), fin), "finite/-inf pattern differs")
    rel = float(np.max(np.abs(ll[fin] - ref[fin]) / np.abs(ref[fin])))
    check(rel <= PARITY_RTOL, f"linear likelihood parity {rel:.3e}")

    def poison(th):
        th[0] = np.nan
        th[1, 2] = 0.0                    # sigma_1 = 0: degenerate
    poisoned_lanes_check(dev_fn, thetas, ll, (0, 1), poison)
    return dict(max_rel_err=rel, finite=int(fin.sum()))


# ---------------------------------------------------------------------------
# 3-5. estimations through smc()
# ---------------------------------------------------------------------------


def timed_smc(clock, *args, **kwargs):
    """smc(*args, **kwargs) -> (result, wall seconds, XLA compile seconds,
    stage log lines). The per-stage log smc() prints at its default
    verbosity is captured so only an excerpt reaches the output."""
    from smc_jax import smc
    buf = io.StringIO()
    with clock.measure(), contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        res = smc(*args, **kwargs)
        jax.block_until_ready(res.cloud.params)
        wall = time.perf_counter() - t0
    return res, wall, clock.total, buf.getvalue().splitlines()


def estimate_twice(clock, name, card, loglike, params, data, cfg, **kwargs):
    """Set-up call (seed 0) and timed run call (seed 1) of one estimation;
    prints phase 5's timing lines and returns both results."""
    res0, setup_s, setup_compile, log0 = timed_smc(
        clock, loglike, params, data, seed=0, **cfg, **kwargs)
    res1, run_s, run_compile, _ = timed_smc(
        clock, loglike, params, data, seed=1, **cfg, **kwargs)
    stages = len(res1.cloud.tempering_schedule) - 1
    excerpt = log0[:3] + ["..."] + log0[-2:] if len(log0) > 6 else log0
    for line in excerpt:
        print(f"  [{name} stage log] {line}")
    print(f"{name}: set-up {setup_s:.3f} s (XLA compile/cache load "
          f"{setup_compile:.3f} s), run {run_s:.3f} s (XLA compile/cache "
          f"load {run_compile:.3f} s), {stages} stages, "
          f"{run_s / stages * 1e3:.3f} ms/stage, "
          f"{cfg['n_parts'] * stages / run_s:.1f} particle-mutations/s, "
          f"log-MDD {res1.log_mdd:.4f} (set-up call {res0.log_mdd:.4f}) "
          f"[{card}]")
    return res0, res1


def linear_gate(res, data, X):
    from smc_jax.models.linear import exact_linear_posterior
    oracle = exact_linear_posterior(data, X)
    err = float(np.max(np.abs(res.posterior_mean() - oracle["mean"])))
    check(err < 0.5, f"linear posterior mean {err:.3f} from exact (gate 0.5)")
    check(np.isfinite(res.log_mdd), f"linear log-MDD {res.log_mdd}")
    return err, oracle["log_evidence"]


def as_gate(res, true_params):
    mu, sd = res.posterior_mean(), res.posterior_std()
    z = np.abs(mu - true_params) / np.maximum(sd, 1e-9)
    check(np.all(z < 4.0), f"AS z-scores {dict(zip(res.para_names, z))}")
    check(np.isfinite(res.log_mdd), f"AS log-MDD {res.log_mdd}")
    acc = res.cloud.accept_rate
    check(0.0 < acc < 1.0, f"AS acceptance rate {acc}")
    check(np.all(np.isfinite(np.asarray(res.cloud.loglh))),
          "non-finite loglh in the final AS cloud")
    return float(z.max())


def run_single(card, clock):
    from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                       generate_linear_data)
    from smc_jax.models.as_dsge import (an_schorfheide, TRUE_PARAMS,
                                        an_schorfheide_parameters,
                                        generate_as_data)
    t0 = time.perf_counter()
    st = as_likelihood_parity()
    print(f"AS likelihood parity: max rel err {st['max_rel_err']:.3e} over "
          f"{st['band']} lanes within {PARITY_BAND_NATS:g} nats of the best "
          f"of {AS_PARITY_DRAWS} draws (gate {PARITY_RTOL:g}); finite/-inf "
          f"mismatches in band {st['band_finite_mismatch']}, outside "
          f"{st['out_of_band_finite_mismatch']} (at most "
          f"{MAX_OUT_OF_BAND_FLIPS}); NaN and explosive lanes -> -inf, "
          f"other lanes bit-identical: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    st = linear_likelihood_parity()
    print(f"linear likelihood parity: max rel err {st['max_rel_err']:.3e} "
          f"over {st['finite']} finite lanes of {LINEAR_PARITY_DRAWS}; NaN "
          f"and zero-variance lanes -> -inf, other lanes bit-identical: ok "
          f"({time.perf_counter() - t0:.1f} s)")

    data, X = generate_linear_data(seed=1793)
    r0, r1 = estimate_twice(clock, "linear", card, make_linear_loglike(X),
                            linear_parameters(), data, LINEAR_CFG)
    for r in (r0, r1):
        err, log_ev = linear_gate(r, data, X)
    print(f"linear gate: max |posterior mean - exact| {err:.4f} < 0.5, "
          f"log-MDD {r1.log_mdd:.4f} (exact log evidence {log_ev:.4f}): ok")

    model = an_schorfheide()
    as_data = generate_as_data(T=80, seed=1793)
    r0, r1 = estimate_twice(clock, "AS", card, model.loglike_batched,
                            an_schorfheide_parameters(), as_data, AS_CFG,
                            batched=True)
    z = max(as_gate(r, TRUE_PARAMS) for r in (r0, r1))
    print(f"AS gate: max posterior z-score {z:.3f} < 4, log-MDD "
          f"{r1.log_mdd:.4f}, accept {r1.cloud.accept_rate:.3f}: ok")


def run_mesh4(card, clock):
    from smc_jax import smc
    from smc_jax.params import ParamSpace
    from smc_jax.parallel.mesh import particle_mesh
    from smc_jax.models.as_dsge import (an_schorfheide, TRUE_PARAMS,
                                        an_schorfheide_parameters,
                                        generate_as_data)
    from jax.sharding import NamedSharding, PartitionSpec as P
    devices = jax.devices()
    check(len(devices) == 4, f"--mesh4 needs 4 GPUs, found {len(devices)}")
    mesh = particle_mesh(devices)
    model = an_schorfheide()
    data = generate_as_data(T=80, seed=1793)
    space = ParamSpace(an_schorfheide_parameters())
    cfg = dict(AS_CFG, n_parts=MESH_N_PARTS)
    kw = dict(batched=True, verbose="none", seed=3)

    # short run: four cards against one
    short = dict(cfg, n_phi=MESH_SHORT_N_PHI)
    t0 = time.perf_counter()
    r1 = smc(model.loglike_batched, space, data, **short, **kw)
    t1 = time.perf_counter()
    r4 = smc(model.loglike_batched, space, data, mesh=mesh, **short, **kw)
    t4 = time.perf_counter()
    check(len(r1.cloud.params.sharding.device_set) == 1,
          "one-card run spread over several devices")
    check(len(r4.cloud.params.sharding.device_set) == 4,
          "sharded run is not on four devices")
    ll1, ll4 = np.asarray(r1.cloud.loglh), np.asarray(r4.cloud.loglh)
    rel = float(np.max(np.abs(ll4 - ll1) / np.abs(ll1)))
    mdd_rel = abs(r4.log_mdd - r1.log_mdd) / abs(r1.log_mdd)
    check(rel <= MESH_RTOL, f"sharded loglh differs by {rel:.3e}")
    check(mdd_rel <= MESH_RTOL, f"sharded log-MDD differs by {mdd_rel:.3e}")
    print(f"mesh4 short run ({MESH_N_PARTS} particles, n_phi="
          f"{MESH_SHORT_N_PHI}): loglh max rel diff {rel:.3e}, log-MDD "
          f"{r4.log_mdd:.6f} vs {r1.log_mdd:.6f} (rel {mdd_rel:.3e}, gate "
          f"{MESH_RTOL:g}); first calls incl. compile: one card "
          f"{t1 - t0:.3f} s, four cards {t4 - t1:.3f} s [{card}]")

    # the compiled likelihood keeps the particle axis partitioned
    thetas = jax.device_put(r4.cloud.params,
                            NamedSharding(mesh, P("parts", None)))
    hlo = jax.jit(lambda th: model.loglike_batched(th, data)).lower(
        thetas).compile().as_text()
    check("all-gather" not in hlo, "sharded likelihood has an all-gather")

    # full sharded estimation
    r0, r1 = estimate_twice(clock, "AS mesh4", card, model.loglike_batched,
                            space, data, cfg, mesh=mesh, batched=True)
    for r in (r0, r1):
        check(not r.cloud.params.sharding.is_fully_replicated
              and len(r.cloud.params.sharding.device_set) == 4,
              "AS cloud lost its sharding")
    z = max(as_gate(r, TRUE_PARAMS) for r in (r0, r1))
    print(f"AS mesh4 gate: cloud sharded over 4 devices, likelihood has no "
          f"all-gather, max posterior z-score {z:.3f} < 4, log-MDD "
          f"{r1.log_mdd:.4f}: ok")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the four-GPU sharded AS phase")
    args = ap.parse_args(argv)

    dev = require_gpu()
    from smc_jax.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    cards = card_description()
    card = cards[0]
    print(f"device: {dev.platform} {dev.device_kind}, "
          f"{len(jax.devices())} visible")
    for c in cards:
        print(f"nvidia-smi: {c}")
    print(f"jax {jax.__version__}, x64 {jax.config.jax_enable_x64}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
          f"compile cache {cache}")
    clock = CompileClock()
    t0 = time.perf_counter()
    (run_mesh4 if args.mesh4 else run_single)(card, clock)
    print(f"total {time.perf_counter() - t0:.1f} s [{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
