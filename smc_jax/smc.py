"""The SMC driver: correction → selection → mutation over a tempering
schedule (reference smc(), src/smc_main.jl:118-527).

Architecture (SURVEY.md §7): each stage body is ONE jitted program —
incremental weights, normalization, ESS, the resample decision (a
`lax.cond`), weighted mean/cov (two f64 matmuls), block permutation, and
the full blocked-RWMH mutation with the user's batched likelihood. By
default the whole stage loop also runs on the device (`make_fused_recursion`,
one `lax.while_loop`), so the host sees only each chunk's per-stage scalars
(phi, ESS, acceptance) and — optionally — the weight columns for the w/W
matrices.

Under a `jax.sharding.Mesh` the same program runs SPMD: reductions become
psums, the resampling gather becomes collective gathers, and every host
computes bit-identical phi/resampling decisions because the PRNG key is
shared (replacing the reference's master/worker Distributed.jl asymmetry,
SURVEY.md §2.8).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from smc_jax.cloud import Cloud
from smc_jax.params import ParamSpace
from smc_jax.ops.correction import correct
from smc_jax.ops.schedule import fixed_schedule, solve_adaptive_phi
from smc_jax.ops.resample import resample as resample_indices, VALID_METHODS
from smc_jax.ops.mutation import make_mutation_step
from smc_jax.ops.initialization import (initial_draw, initialize_likelihoods)
from smc_jax import io as smc_io
from smc_jax import diagnostics as diag


@dataclasses.dataclass
class SMCResult:
    """Estimation output. The reference returns nothing and writes to disk
    (src/smc_main.jl:513-527, consumed via get_cloud); we return the state
    directly and also write when save paths are given."""

    cloud: Cloud
    w: Optional[np.ndarray]       # incremental weights, [N, n_stages+1]
    W: Optional[np.ndarray]       # normalized weights,  [N, n_stages+1]
    log_mdd: float                # log marginal data density
    para_names: List[str]
    space: ParamSpace

    def posterior_mean(self):
        from smc_jax.cloud import weighted_mean
        return np.asarray(weighted_mean(self.cloud))

    def posterior_std(self):
        from smc_jax.cloud import weighted_std
        return np.asarray(weighted_std(self.cloud))


def marginal_data_density(w: np.ndarray, W: np.ndarray) -> float:
    """log-MDD from the saved weight matrices: sum_n log((1/N) sum_i
    W_{i,n-1} * w~_{i,n}). This is the quantity the reference saves w/W for
    (SURVEY.md §0; src/smc_main.jl:354-367, 419-420).

    Note: `w` holds the RAW incremental weights for reference-artifact
    parity; in extreme configs (coarse schedule x |loglh| in the thousands)
    they can underflow to 0 even though the estimation itself is computed
    stably in log space — in that case use `SMCResult.log_mdd`, which is
    accumulated from the shift-invariant per-stage increments."""
    n = w.shape[0]
    out = 0.0
    for s in range(1, w.shape[1]):
        out += np.log(np.sum(W[:, s - 1] * w[:, s]) / n)
    return float(out)


def _logistic_c_update(c: float, accept: float, target: float) -> float:
    """Adaptive step-size rule (reference src/smc_main.jl:453-455):
    c <- c * (0.95 + 0.10 e^{16(a-t)} / (1 + e^{16(a-t)}))."""
    x = 16.0 * (accept - target)
    # numerically-stable logistic
    sig = 1.0 / (1.0 + np.exp(-x)) if x >= 0 else np.exp(x) / (1.0 + np.exp(x))
    return c * (0.95 + 0.10 * sig)


def _logistic_c_update_jnp(c, accept, target):
    """Traced twin of _logistic_c_update for the device-side recursion."""
    sig = jax.nn.sigmoid(16.0 * (accept - target))
    return c * (0.95 + 0.10 * sig)


def make_superstep(space, loglike_batched, n_blocks, n_mh_steps, alpha,
                   resampling_method, threshold,
                   tempered_update_prior_weight=0.0, log_prob_old_data=0.0,
                   old_loglike_batched=None):
    """Build the jitted per-stage superstep: correction → selection →
    weighted moments → blocked-RWMH mutation, as ONE XLA program
    (reference stage body, src/smc_main.jl:396-484).

    Returned signature:
      superstep(key, params, loglh, logprior, old_loglh, weights,
                phi_n, phi_n1, c)
        -> (params, loglh, logprior, old_loglh, weights, accept,
            inc_w, W_col, ess, did_resample, accept_mean, mdd_inc)

    The resample decision is a `lax.cond` branch: the cumsum + searchsorted
    + row gathers only execute on stages whose ESS actually triggers a
    resample, and the program is still trace-once regardless of ESS.
    """
    stage_core = make_stage_core(
        space, loglike_batched, n_blocks, n_mh_steps, alpha,
        resampling_method, threshold, tempered_update_prior_weight,
        log_prob_old_data, old_loglike_batched)
    return jax.jit(stage_core)


def make_stage_core(space, loglike_batched, n_blocks, n_mh_steps, alpha,
                    resampling_method, threshold,
                    tempered_update_prior_weight=0.0, log_prob_old_data=0.0,
                    old_loglike_batched=None):
    """The un-jitted stage body shared by make_superstep (one stage per XLA
    dispatch, host loop) and make_fused_recursion (ALL stages inside one
    device-side lax.while_loop)."""
    mutation_step = make_mutation_step(
        space, loglike_batched, n_blocks, n_mh_steps, alpha,
        old_loglike_batched)
    free_inds = jnp.asarray(space.free_inds)
    n_free = space.n_free
    omega = tempered_update_prior_weight

    def superstep(skey, params, loglh, logprior, old_loglh, weights,
                  phi_n, phi_n1, c_scalar):
        n = params.shape[0]
        # -- Step 1: correction (src/smc_main.jl:400-420), computed in log
        # space relative to the cloud max so a coarse schedule meeting a
        # peaked likelihood (|loglh| ~ thousands) cannot uniformly underflow
        # the weights to 0/0 — the failure the reference NaN-aborts on --
        with jax.named_scope("correction"):
            inc_w, norm_w, ess, mdd_inc = correct(
                loglh, old_loglh, weights, phi_n, phi_n1, omega,
                log_prob_old_data)
        # -- Step 2: selection (src/smc_main.jl:426-446) --
        # lax.cond so the cumsum + searchsorted + 4-array gather only
        # executes on stages that actually resample (most stages of a sane
        # schedule skip). Chain-identical to the unconditional form: the resampled branch
        # consumes the same kr, and the skip branch was an identity gather.
        do_resample = ess < threshold
        kr, kp, km = jax.random.split(skey, 3)

        def _resample_branch(ops):
            p, l, lp, ol, nw = ops
            idx = resample_indices(kr, nw, method=resampling_method)
            return (jnp.take(p, idx, axis=0), jnp.take(l, idx),
                    jnp.take(lp, idx), jnp.take(ol, idx),
                    jnp.ones_like(nw))

        with jax.named_scope("resample"):
            (params, loglh, logprior, old_loglh,
             weights_out) = jax.lax.cond(
                do_resample, _resample_branch, lambda ops: ops,
                (params, loglh, logprior, old_loglh, norm_w))
        # -- Step 3: mutation (src/smc_main.jl:448-484) --
        with jax.named_scope("moments"):
            vals_free = params[:, free_inds]
            wsum = jnp.sum(weights_out)
            mu = (weights_out @ vals_free) / wsum
            dev = vals_free - mu
            cov = (dev.T * weights_out) @ dev / wsum
            cov = 0.5 * (cov + cov.T)  # symmetrize (src/smc_main.jl:462)
        perm = jax.random.permutation(kp, n_free)
        with jax.named_scope("mutation"):
            params, loglh, logprior, old_loglh, accept = mutation_step(
                km, params, loglh, logprior, old_loglh, mu, cov, perm,
                c_scalar, phi_n, phi_n1)
        accept_mean = jnp.mean(accept)
        W_col = weights_out
        return (params, loglh, logprior, old_loglh, weights_out, accept,
                inc_w, W_col, ess, do_resample, accept_mean, mdd_inc)

    return superstep


def make_fused_recursion(space, loglike_batched, n_blocks, n_mh_steps, alpha,
                         resampling_method, threshold, n_phi, sched,
                         use_fixed_schedule, tempering_target, target,
                         store_weight_matrices,
                         tempered_update_prior_weight=0.0,
                         log_prob_old_data=0.0, old_loglike_batched=None,
                         chunk_stages: Optional[int] = None):
    """Build ONE jitted program that runs the ENTIRE tempering recursion
    (reference while loop, src/smc_main.jl:377-508) device-side as a
    `lax.while_loop` over stages.

    Rationale: the host-loop driver pays, per stage, one dispatch plus
    blocking device->host fetches of the stage scalars (ESS, acceptance,
    resample flag, MDD increment), which for small models costs more than
    the stage's compute. Fusing moves the stage loop, the adaptive-phi
    bisection, the c-adaptation, and the w/W column writes into the XLA
    program, so a chunk of stages is a single dispatch with ZERO
    intermediate host syncs.

    The stage count is data-dependent: exactly n_phi - 1 for the fixed
    schedule, but UNBOUNDED for the adaptive schedule (the adaptive phi_n is
    bounded above by the fixed schedule per stage — reference
    src/helpers.jl:43-47 — so ESS-driven runs may take many more stages).
    Per-stage traces therefore live in preallocated [n_phi] buffers indexed
    by (global stage - s0); when the buffers fill, the program returns and
    the driver re-invokes the SAME compiled program with the carried state
    and fresh buffers (one host sync per n_phi stages, zero recompiles).

    Key discipline matches the host loop exactly (one split per stage, same
    order), so fused and host-loop recursions produce identical chains.

    Returns fused(key, params, loglh, logprior, old_loglh, weights, c0,
                  accept0, phi0, ess0, j0, phi_prop0, resampled_last0, s0)
      -> dict of carried state + stacked per-stage traces + global stage
         counter s (chunk stage count = s - s0).
    """
    stage_core = make_stage_core(
        space, loglike_batched, n_blocks, n_mh_steps, alpha,
        resampling_method, threshold, tempered_update_prior_weight,
        log_prob_old_data, old_loglike_batched)
    sched_dev = jnp.asarray(sched)
    # stages per dispatch: full fusion by default; bounded so the host can
    # print progress (and a long estimation is not one opaque dispatch)
    max_stages = int(chunk_stages) if chunk_stages else int(n_phi)

    @jax.jit
    def fused(key, params, loglh, logprior, old_loglh, weights,
              c0, accept0, phi0, ess0, j0, phi_prop0, resampled_last0,
              s0=0, stop_after=max_stages):
        # `stop_after` dynamically bounds the stages THIS dispatch may run
        # (<= the static max_stages that sizes the trace buffers): the
        # driver uses it to run a small FIRST chunk so per-stage output
        # appears within a few stages instead of after a full 25-stage
        # chunk — same compiled program for all chunks.
        n = params.shape[0]
        s0 = jnp.asarray(s0, jnp.int32)
        stop_after = jnp.minimum(jnp.asarray(stop_after, jnp.int32),
                                 max_stages)
        traces0 = {
            "phi": jnp.zeros(max_stages, jnp.float64),
            "ess": jnp.zeros(max_stages, jnp.float64),
            "c": jnp.zeros(max_stages, jnp.float64),
            "accept": jnp.zeros(max_stages, jnp.float64),
            "mdd_inc": jnp.zeros(max_stages, jnp.float64),
            "resampled": jnp.zeros(max_stages, jnp.bool_),
        }
        if store_weight_matrices:
            traces0["w"] = jnp.zeros((max_stages, n), jnp.float64)
            traces0["W"] = jnp.zeros((max_stages, n), jnp.float64)

        state0 = dict(
            key=key, params=params, loglh=loglh, logprior=logprior,
            old_loglh=old_loglh, weights=weights, accept=jnp.zeros(n),
            c=jnp.float64(c0), accept_rate=jnp.float64(accept0),
            phi=jnp.float64(phi0), ess_prev=jnp.float64(ess0),
            j=jnp.asarray(j0, jnp.int32),
            phi_prop=jnp.float64(phi_prop0),
            resampled_last=jnp.asarray(resampled_last0, jnp.bool_),
            s=s0, log_mdd=jnp.float64(0.0),
            resamples=jnp.int32(0), nan_ess=jnp.bool_(False),
            traces=traces0,
        )

        def cond(st):
            return ((st["phi"] < 1.0) & (st["s"] - s0 < stop_after)
                    & ~st["nan_ess"])

        def body(st):
            s = st["s"]
            phi_n1 = st["phi"]
            # phi selection (src/smc_main.jl:384-394)
            if use_fixed_schedule:
                phi_n = sched_dev[jnp.minimum(s + 1, n_phi - 1)]
                j, phi_prop = st["j"], st["phi_prop"]
            else:
                ess_bar = tempering_target * jnp.where(
                    st["resampled_last"], jnp.float64(n), st["ess_prev"])
                phi_n, j, phi_prop = solve_adaptive_phi(
                    st["loglh"], st["weights"], st["old_loglh"], phi_n1,
                    sched_dev, st["j"], st["phi_prop"], ess_bar)
            # adaptive c from last stage's acceptance (src/smc_main.jl:453-455)
            c = _logistic_c_update_jnp(st["c"], st["accept_rate"], target)
            key, skey = jax.random.split(st["key"])
            (params, loglh, logprior, old_loglh, weights, accept, inc_w,
             W_col, ess, did_resample, accept_mean, mdd_inc) = stage_core(
                skey, st["params"], st["loglh"], st["logprior"],
                st["old_loglh"], st["weights"], phi_n, phi_n1, c)

            k = s - s0  # buffer slot within this chunk
            tr = dict(st["traces"])
            tr["phi"] = tr["phi"].at[k].set(phi_n)
            tr["ess"] = tr["ess"].at[k].set(ess)
            tr["c"] = tr["c"].at[k].set(c)
            tr["accept"] = tr["accept"].at[k].set(accept_mean)
            tr["mdd_inc"] = tr["mdd_inc"].at[k].set(mdd_inc)
            tr["resampled"] = tr["resampled"].at[k].set(did_resample)
            if store_weight_matrices:
                tr["w"] = tr["w"].at[k].set(inc_w)
                tr["W"] = tr["W"].at[k].set(W_col)

            return dict(
                key=key, params=params, loglh=loglh, logprior=logprior,
                old_loglh=old_loglh, weights=weights, accept=accept,
                c=c, accept_rate=accept_mean, phi=phi_n, ess_prev=ess,
                j=j, phi_prop=phi_prop, resampled_last=did_resample,
                s=s + 1, log_mdd=st["log_mdd"] + mdd_inc,
                resamples=st["resamples"] + did_resample.astype(jnp.int32),
                nan_ess=jnp.isnan(ess), traces=tr,
            )

        return jax.lax.while_loop(cond, body, state0)

    return fused


def smc(loglikelihood: Callable,
        parameters,
        data=None,
        *,
        verbose: str = "low",
        n_parts: int = 5_000,
        n_blocks: int = 1,
        n_mh_steps: int = 1,
        lam: float = 2.1,
        n_phi: int = 300,
        resampling_method: str = "systematic",
        threshold_ratio: float = 0.5,
        c: float = 0.5,
        alpha: float = 1.0,
        target: float = 0.25,
        use_fixed_schedule: bool = True,
        tempering_target: float = 0.97,
        old_data=None,
        old_cloud: Optional[Cloud] = None,
        old_loglikelihood: Optional[Callable] = None,
        tempered_update_prior_weight: float = 0.0,
        log_prob_old_data: float = 0.0,
        regime_switching: bool = False,
        run_test: bool = False,
        loadpath: str = "",
        savepath: Optional[str] = None,
        particle_store_path: Optional[str] = None,
        save_intermediate: bool = False,
        intermediate_stage_increment: int = 10,
        continue_intermediate: bool = False,
        store_weight_matrices: bool = True,
        batched: bool = False,
        fused: Optional[bool] = None,
        fused_chunk_stages: Optional[int] = None,
        seed: int = 0,
        key=None,
        mesh=None,
        run_csminwel: bool = False,
        debug_assertion: bool = False,
        profile_dir: Optional[str] = None,
        # --- accepted for kwarg-surface parity with the reference
        #     (src/smc_main.jl:118-161); see docstring ---
        parallel: Optional[bool] = None,
        testing: bool = False,
        data_vintage: Optional[str] = None,
        old_vintage: str = "",
        smc_iteration: int = 1,
        filestring_addl=(),
        intermediate_stage_start: int = 0) -> SMCResult:
    """Estimate p(theta|Y) by adaptive-tempered SMC.

    Mirrors the reference's kwarg surface (src/smc_main.jl:118-161) with
    these deliberate differences:
      * `loglikelihood(theta, data) -> scalar` is a pure JAX function of a
        flat f64[P] vector (regime columns appended per ParamSpace); pass
        `batched=True` if it already maps f64[N, P] -> f64[N] (e.g. a
        `LinearDSGE.loglike_batched`). It must be *total*: return -inf/nan on
        failure instead of raising (SURVEY.md §7 "hard parts").
      * `parameters` is a list[Parameter] or a ParamSpace.
      * `parallel` is gone: the program is always data-parallel over
        particles; pass `mesh` (a 1-D jax.sharding.Mesh with axis "parts")
        to shard the cloud across devices/hosts.
      * results are returned (SMCResult) and only written to disk when
        `savepath`/`particle_store_path` are given.
      * `seed`/`key` control an explicit threaded PRNG; checkpoints are
        bit-reproducible on resume.
      * `lam`/`alpha`/`n_phi` are the reference's λ/α/n_Φ.

    `run_csminwel` is accepted for parity but, like the reference at this
    version (SURVEY.md §2.7 note), posterior-mode polish is not run.

    `resampling_method="metropolis"` uses the sort-free Metropolis
    resampler with its chain length chosen per-stage ON DEVICE from the
    Doeblin bound B = ceil(kappa ln(1/eps)), eps=0.01 (ops/resample.py) —
    the total-variation bias is bounded at whatever weight skew the
    resample stage actually has.

    Parity-only kwargs: `parallel` (always data-parallel here; pass `mesh`
    to span devices), `testing` (suppresses final disk writes, reference
    src/smc_main.jl:513), `data_vintage`/`old_vintage`/`smc_iteration`/
    `filestring_addl` (file-naming conventions the reference's Settings
    layer uses; our savepath is explicit), `intermediate_stage_start`
    (resume stage is read from the checkpoint itself).

    `profile_dir` writes a jax.profiler trace of the whole recursion for
    TensorBoard/XProf — the upgrade over the reference's wall-clock-only
    timing (SURVEY.md §5 "Tracing/profiling").

    Performance note — the FUSED fast path is the default: with
    `verbose="none"` the entire tempering recursion runs as ONE device-side
    `lax.while_loop` with zero per-stage host syncs
    (`make_fused_recursion`); with the default `verbose="low"` the same
    fused program runs in chunks of up to 25 stages per dispatch and
    per-stage lines are printed from each chunk's fetched traces — the
    dispatch+fetch cost of a per-stage host loop is paid once per chunk
    instead of once per stage. The host
    stage loop remains only for `verbose="high"` (per-parameter tables each
    stage), run_test, save_intermediate, and continue_intermediate.
    `fused_chunk_stages` overrides the stages-per-dispatch bound.

    Compilation: smc() sets no compile cache. Callers that want compiled
    programs reused across processes enable JAX's persistent cache, e.g.
    with `smc_jax.compile_cache.enable_compile_cache()`.
    """
    del parallel, data_vintage, old_vintage, smc_iteration, filestring_addl
    del intermediate_stage_start
    if resampling_method not in VALID_METHODS:
        raise ValueError(f"resampling_method must be one of {VALID_METHODS}")
    if not (0.0 <= tempered_update_prior_weight <= 1.0):
        raise ValueError(
            "The keyword tempered_update_prior_weight must be within [0, 1] "
            f"but is currently set to {tempered_update_prior_weight}")
    if run_csminwel:
        warnings.warn("run_csminwel is accepted for API parity but mode "
                      "polish is not implemented (matching the reference)")

    space = (parameters if isinstance(parameters, ParamSpace)
             else ParamSpace(parameters, regime_switching=regime_switching))
    if space.n_free == 0:
        raise ValueError("All model parameters are fixed!")

    # ---- batched likelihood(s) -------------------------------------------
    if batched:
        loglike_batched = lambda th: loglikelihood(th, data)
    else:
        loglike_batched = jax.vmap(lambda th: loglikelihood(th, data))

    tempered_update = old_data is not None
    old_ll_fn = old_loglikelihood if old_loglikelihood is not None else loglikelihood
    if tempered_update:
        if batched:
            old_loglike_batched = lambda th: old_ll_fn(th, old_data)
        else:
            old_loglike_batched = jax.vmap(lambda th: old_ll_fn(th, old_data))
    else:
        old_loglike_batched = None

    # ---- sharding ---------------------------------------------------------
    sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        axis = mesh.axis_names[0]
        if n_parts % int(np.prod(mesh.devices.shape)) != 0:
            raise ValueError("n_parts must be divisible by the mesh size")
        sharding = NamedSharding(mesh, P(axis))

    # ---- PRNG -------------------------------------------------------------
    if key is None:
        key = jax.random.PRNGKey(seed)

    threshold = threshold_ratio * n_parts
    sched = fixed_schedule(n_phi, lam)  # ((n-1)/(n_phi-1))^lam, src/smc_main.jl:349
    sched_dev = jnp.asarray(sched)

    # ---- initialization: 4 ways (reference src/smc_main.jl:244-345) -------
    i = 1
    j = 1          # 0-based index of next untried schedule entry (ref j=2, 1-based)
    phi_prop = 0.0
    log_mdd = 0.0
    resampled_last_period = False
    w_cols: List[np.ndarray] = []
    W_cols: List[np.ndarray] = []

    def _reinit_scalars(cloud, tempered):
        """initialize_cloud_settings! (reference src/initialization.jl:196-211)."""
        cloud.ESS = [cloud.ESS[-1]] if tempered else [float(n_parts)]
        cloud.stage_index = 1
        cloud.n_phi = n_phi
        cloud.resamples = 0
        cloud.c = c
        cloud.accept_rate = target
        cloud.total_sampling_time = 0.0
        cloud.tempering_schedule = [0.0]
        return cloud

    if tempered_update:
        if old_cloud is None or old_cloud.is_empty():
            if not loadpath:
                raise ValueError("tempered update requires old_cloud or loadpath")
            old_cloud = smc_io.get_cloud(loadpath)
        cloud = old_cloud
        old_n_parts = cloud.n_parts

        if tempered_update_prior_weight == 0.0 and old_n_parts == n_parts:
            cloud = _reinit_scalars(cloud, tempered=True)
            cloud = initialize_likelihoods(cloud, space, loglike_batched)
        else:
            # Bridge distribution (reference src/smc_main.jl:260-329):
            # (1-omega) N resampled old-posterior draws + omega N prior draws
            # whose loglh is evaluated on the OLD data, then everything
            # re-evaluated on the new data.
            omega = tempered_update_prior_weight
            n_to_resample = int(round((1.0 - omega) * n_parts))
            n_from_prior = n_parts - n_to_resample

            parts_list, loglh_list, logprior_list, oldll_list = [], [], [], []
            if n_to_resample > 0:
                key, kb = jax.random.split(key)
                idx = resample_indices(kb, cloud.weights,
                                       method=resampling_method,
                                       n_parts=n_to_resample)
                parts_list.append(jnp.take(cloud.params, idx, axis=0))
                loglh_list.append(jnp.take(cloud.loglh, idx))
                logprior_list.append(jnp.take(cloud.logprior, idx))
                oldll_list.append(jnp.take(cloud.old_loglh, idx))
            if n_from_prior > 0:
                key, kp = jax.random.split(key)
                prior_cloud = initial_draw(kp, space, old_loglike_batched,
                                           n_from_prior, sharding=None)
                parts_list.append(prior_cloud.params)
                loglh_list.append(prior_cloud.loglh)
                logprior_list.append(prior_cloud.logprior)
                oldll_list.append(prior_cloud.old_loglh)

            cloud = Cloud.create(space.n_para, n_parts, sharding=sharding)
            cloud.params = jnp.concatenate(parts_list, axis=0)
            cloud.loglh = jnp.concatenate(loglh_list)
            cloud.logprior = jnp.concatenate(logprior_list)
            cloud.old_loglh = jnp.concatenate(oldll_list)

            cloud = initialize_likelihoods(cloud, space, loglike_batched)
            cloud.zero_bad_loglh_weights()      # src/smc_main.jl:314
            norm_w = cloud.normalize_weights()
            key, kr = jax.random.split(key)
            idx = resample_indices(kr, norm_w, method=resampling_method)
            cloud = cloud.reindexed(idx)
            cloud.reset_weights()
            cloud.ESS.append(float(n_parts))     # src/smc_main.jl:325
            cloud = _reinit_scalars(cloud, tempered=True)
    elif continue_intermediate:
        if not loadpath:
            raise ValueError("continue_intermediate requires loadpath")
        (cloud, w_saved, W_saved, j, phi_prop, log_mdd,
         saved_key) = smc_io.load_checkpoint(loadpath)
        if saved_key is not None:
            key = jnp.asarray(saved_key)
        w_cols = [w_saved[:, k] for k in range(w_saved.shape[1])]
        W_cols = [W_saved[:, k] for k in range(W_saved.shape[1])]
        i = cloud.stage_index
        c = cloud.c
        if use_fixed_schedule:
            cloud.tempering_schedule = list(sched[:i])
        phi_prop = float(sched[min(j, n_phi - 1)])
    else:
        key, k0 = jax.random.split(key)
        cloud = initial_draw(k0, space, loglike_batched, n_parts,
                             sharding=sharding)
        cloud = _reinit_scalars(cloud, tempered=False)

    if sharding is not None:
        cloud.params = jax.device_put(cloud.params, sharding)
        for f in ("loglh", "logprior", "old_loglh", "accept", "weights"):
            setattr(cloud, f, jax.device_put(getattr(cloud, f), sharding))

    cloud.n_phi = n_phi
    if use_fixed_schedule and not continue_intermediate:
        cloud.tempering_schedule = [float(sched[0])]

    # w/W matrices for log-MDD (reference src/smc_main.jl:354-367): first
    # column of w is zeros; first column of W is ones (fresh) or the carried
    # weights (tempered update).
    if store_weight_matrices and not continue_intermediate:
        w_cols = [np.zeros(n_parts)]
        W_cols = [np.asarray(cloud.weights) if tempered_update
                  else np.ones(n_parts)]

    # ---- choose the recursion driver ---------------------------------------
    # Fused = the ENTIRE stage loop inside one jitted lax.while_loop (zero
    # per-stage host syncs/dispatches — see make_fused_recursion). It is the
    # DEFAULT for verbose "none" AND "low": at "low" the recursion runs in
    # chunks of up to 25 stages per dispatch and per-stage lines are printed
    # from each chunk's fetched traces (the host loop's per-stage
    # dispatch+fetch is paid once per chunk instead). The host loop remains for
    # paths that need genuine per-stage host actions: verbose="high"
    # per-parameter tables, periodic checkpoints, the 3-stage test break,
    # and checkpoint resume (whose stage offset the fused program doesn't
    # model).
    can_fuse = (not run_test and not save_intermediate
                and not continue_intermediate and verbose in ("none", "low"))
    use_fused = can_fuse if fused is None else fused
    if use_fused and not can_fuse:
        raise ValueError(
            "fused=True is incompatible with run_test/save_intermediate/"
            "continue_intermediate and requires verbose='none' or 'low'")
    if use_fused and fused_chunk_stages is None and verbose == "low":
        fused_chunk_stages = min(25, n_phi)

    para_names = list(space.names)
    diag.init_stage_print(cloud, para_names, verbose=verbose,
                          use_fixed_schedule=use_fixed_schedule)
    diag.vprint(verbose, "low", "SMC recursion starts...")

    if profile_dir:
        jax.profiler.start_trace(profile_dir)

    if use_fused:
        fused_fn = make_fused_recursion(
            space, loglike_batched, n_blocks, n_mh_steps, alpha,
            resampling_method, threshold, n_phi, sched,
            use_fixed_schedule, tempering_target, target,
            store_weight_matrices, tempered_update_prior_weight,
            log_prob_old_data, old_loglike_batched,
            chunk_stages=fused_chunk_stages)
        # Chunk loop: each invocation runs up to n_phi stages device-side.
        # Fixed schedules finish in one chunk; ESS-driven adaptive schedules
        # may need several (stage count unbounded) — same compiled program,
        # one host sync per chunk.
        phi_n = 0.0
        s_global = 0
        chunk_state = (c, float(cloud.accept_rate), 0.0,
                       float(cloud.ESS[-1]), j, phi_prop,
                       bool(resampled_last_period))
        chunk_timer = diag.StageTimer()
        # At verbose="low", the FIRST dispatch runs only a few stages so the
        # user sees per-stage output early (a full 25-stage chunk of an
        # expensive model can take minutes with no output); later dispatches run full chunks. Same compiled program: the
        # bound is a dynamic argument.
        full_chunk = fused_chunk_stages or n_phi
        stop_after = min(3, full_chunk) if verbose == "low" else full_chunk
        while phi_n < 1.0:
            st = fused_fn(key, cloud.params, cloud.loglh, cloud.logprior,
                          cloud.old_loglh, cloud.weights, *chunk_state,
                          s_global, stop_after)
            stop_after = full_chunk
            jax.block_until_ready(st["params"])
            chunk_dt = chunk_timer.lap()
            cloud.total_sampling_time += chunk_dt
            resamples_before = cloud.resamples
            stage_before = i + s_global
            n_in_chunk = int(st["s"]) - s_global
            if n_in_chunk == 0 and not bool(st["nan_ess"]):
                raise RuntimeError(
                    "fused recursion made no progress "
                    f"(phi={float(st['phi'])})")
            s_global = int(st["s"])
            cloud.params = st["params"]
            cloud.loglh = st["loglh"]
            cloud.logprior = st["logprior"]
            cloud.old_loglh = st["old_loglh"]
            cloud.weights = st["weights"]
            cloud.accept = st["accept"]
            key = st["key"]
            traces = jax.device_get(
                {k: v for k, v in st["traces"].items()
                 if k not in ("w", "W")})
            cloud.tempering_schedule += [
                float(p) for p in traces["phi"][:n_in_chunk]]
            cloud.ESS += [float(e) for e in traces["ess"][:n_in_chunk]]
            cloud.c = c = float(st["c"])
            cloud.accept_rate = float(st["accept_rate"])
            cloud.resamples += int(st["resamples"])
            log_mdd += float(st["log_mdd"])
            if store_weight_matrices:
                w_mat = np.asarray(st["traces"]["w"][:n_in_chunk])
                W_mat = np.asarray(st["traces"]["W"][:n_in_chunk])
                w_cols += [w_mat[s] for s in range(n_in_chunk)]
                W_cols += [W_mat[s] for s in range(n_in_chunk)]
            cloud.stage_index = i + s_global
            diag.chunk_stage_prints(
                traces, n_in_chunk, first_stage=stage_before + 1,
                total_stages=n_phi if use_fixed_schedule else None,
                chunk_time=chunk_dt, resamples_before=resamples_before,
                verbose=verbose)
            if bool(st["nan_ess"]):
                k_last = n_in_chunk - 1
                inc_last = (np.asarray(st["traces"]["w"][k_last])
                            if store_weight_matrices else
                            np.full(n_parts, np.nan))
                W_last = (np.asarray(st["traces"]["W"][k_last])
                          if store_weight_matrices else
                          np.full(n_parts, np.nan))
                diag.check_nan_ess(cloud, cloud.stage_index, inc_last,
                                   W_last, savepath or "smc_cloud.npz",
                                   debug_assertion)
            phi_n = float(cloud.tempering_schedule[-1])
            chunk_state = (c, cloud.accept_rate, phi_n, cloud.ESS[-1],
                           int(st["j"]), float(st["phi_prop"]),
                           bool(st["resampled_last"]))

    # ---- host-loop recursion (reference src/smc_main.jl:377-508) ----------
    if not use_fused:
        superstep = make_superstep(
            space, loglike_batched, n_blocks, n_mh_steps, alpha,
            resampling_method, threshold, tempered_update_prior_weight,
            log_prob_old_data, old_loglike_batched)
    phi_n = float(cloud.tempering_schedule[-1]) if (continue_intermediate
                                                    or use_fused) else 0.0
    timer = diag.StageTimer()
    while phi_n < 1.0:
        i += 1
        cloud.stage_index = i

        phi_n1 = float(cloud.tempering_schedule[-1])
        if use_fixed_schedule:
            phi_n = float(sched[i - 1])
        else:
            ess_bar = tempering_target * (
                float(n_parts) if resampled_last_period else cloud.ESS[-1])
            resampled_last_period = False
            phi_dev, j_dev, prop_dev = solve_adaptive_phi(
                cloud.loglh, cloud.weights, cloud.old_loglh,
                jnp.float64(phi_n1), sched_dev, jnp.int64(j),
                jnp.float64(phi_prop), jnp.float64(ess_bar))
            phi_n = float(phi_dev)
            j = int(j_dev)
            phi_prop = float(prop_dev)
        cloud.tempering_schedule.append(phi_n)

        # adaptive c BEFORE mutation, from last stage's acceptance
        # (src/smc_main.jl:453-455)
        c = _logistic_c_update(c, cloud.accept_rate, target)
        cloud.c = c

        key, skey = jax.random.split(key)
        (cloud.params, cloud.loglh, cloud.logprior, cloud.old_loglh,
         cloud.weights, cloud.accept, inc_w, W_col, ess, did_resample,
         accept_mean, mdd_inc) = superstep(
            skey, cloud.params, cloud.loglh, cloud.logprior,
            cloud.old_loglh, cloud.weights, jnp.float64(phi_n),
            jnp.float64(phi_n1), jnp.float64(c))

        # ONE batched device->host fetch for the stage scalars (and weight
        # columns when stored) instead of 4-6 blocking syncs.
        fetch = (ess, did_resample, accept_mean, mdd_inc)
        if store_weight_matrices:
            fetch += (inc_w, W_col)
        fetched = jax.device_get(fetch)
        ess_f = float(fetched[0])
        cloud.ESS.append(ess_f)
        if np.isnan(ess_f):
            diag.check_nan_ess(cloud, i, np.asarray(inc_w),
                               np.asarray(W_col), savepath or "smc_cloud.npz",
                               debug_assertion)
        if bool(fetched[1]):
            cloud.resamples += 1
            resampled_last_period = True
        cloud.accept_rate = float(fetched[2])
        log_mdd += float(fetched[3])

        if store_weight_matrices:
            w_cols.append(fetched[4])
            W_cols.append(fetched[5])

        dt = timer.lap()
        cloud.total_sampling_time += dt
        diag.end_stage_print(cloud, para_names, verbose=verbose,
                             use_fixed_schedule=use_fixed_schedule,
                             stage_time=dt)

        if run_test and i == 3:  # early break for tests (src/smc_main.jl:495-497)
            break

        if save_intermediate and savepath and \
                cloud.stage_index % intermediate_stage_increment == 0:
            wm = np.stack(w_cols, axis=1) if w_cols else np.zeros((n_parts, 0))
            Wm = np.stack(W_cols, axis=1) if W_cols else np.zeros((n_parts, 0))
            smc_io.save_checkpoint(savepath, cloud.stage_index, cloud, wm, Wm,
                                   j, phi_prop, log_mdd, key)

    if profile_dir:
        cloud.block_until_ready()
        jax.profiler.stop_trace()

    # ---- final artifacts (reference src/smc_main.jl:513-526) --------------
    w_matrix = np.stack(w_cols, axis=1) if store_weight_matrices else None
    W_matrix = np.stack(W_cols, axis=1) if store_weight_matrices else None
    if savepath and not testing:
        extra = {}
        if store_weight_matrices:
            extra = {"w": w_matrix, "W": W_matrix}
        extra["log_mdd"] = np.asarray(log_mdd)
        smc_io.save_cloud(savepath, cloud, extra=extra)
    if particle_store_path and not testing:
        smc_io.save_particle_store(particle_store_path, cloud)

    return SMCResult(cloud=cloud, w=w_matrix, W=W_matrix, log_mdd=log_mdd,
                     para_names=para_names, space=space)
