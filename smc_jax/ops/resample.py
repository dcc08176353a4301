"""Resampling kernels (reference src/resample.jl).

All three reference methods, as global device kernels:

  * systematic (default): one shared uniform offset, spoke thresholds
    (i-1+u)/N, sequential-scan-over-sorted-thresholds in the reference
    (src/resample.jl:45-71) — here a prefix sum + vectorized binary search
    (jnp.cumsum + searchsorted), the parallel formulation of the same map.
  * multinomial: N iid uniforms against the cumulative weights
    (src/resample.jl:26-44) — a batched searchsorted.
  * polyalgo: the reference delegates to StatsBase.sample's alias-table
    polyalgorithm (src/resample.jl:73-75), which is *distributionally*
    multinomial; the batched searchsorted is already the fast path, so
    :polyalgo is an alias for an independent multinomial draw.

Under a sharded cloud, cumsum lowers to a cross-shard scan and the row
gather to collective gathers — no host round-trip.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

VALID_METHODS = ("systematic", "multinomial", "polyalgo", "stratified",
                 "metropolis")


def metropolis_n_iter(weights, eps: float = 0.01) -> int:
    """Chain length for the Metropolis resampler with total-variation bias
    <= eps, from the Doeblin/minorization bound of Murray, Lee & Jacob
    (arXiv:1202.6163; see PAPERS.md).

    The chain proposes uniformly over indices and accepts with w_j / w_i, so
    every transition satisfies P(i -> j) >= w_j / (n * w_max): a Doeblin
    minorization with total mass mean(w) / max(w) = 1 / kappa, where
    kappa = w_max / w_bar is the weight skew. Hence after B steps, from ANY
    start, TV(chain, target) <= (1 - 1/kappa)^B <= exp(-B / kappa), and

        B = ceil(kappa * ln(1 / eps))

    guarantees TV <= eps. kappa is 1 for uniform weights (B ~ 5 at
    eps=0.01) and grows with degeneracy; right after an SMC correction step
    the normalized weights rarely exceed kappa ~ 10-100 at sane schedules,
    so B ~ 50-500. The bound is computed host-side (B must be static for
    jit); pass the result as resample(..., n_iter=B)."""
    import numpy as np
    w = np.asarray(weights, dtype=np.float64)
    kappa = float(w.max() / w.mean())
    return max(1, int(np.ceil(kappa * np.log(1.0 / eps))))


@partial(jax.jit, static_argnames=("method", "n_parts", "n_iter", "eps",
                                   "n_iter_max"))
def resample(key, weights, method: str = "systematic",
             n_parts: int | None = None, n_iter: int | None = None,
             eps: float = 0.01, n_iter_max: int = 10_000):
    """Resampled ancestor indices for `weights` (need not be normalized).

    Matches reference semantics: returned index i is the first j with
    cumweights[j] > threshold (strict), i.e. searchsorted side='right'.

    Args:
      key: PRNG key (the reference uses the global RNG; an explicit key keeps
        multi-host runs bit-identical, SURVEY.md §2.8).
      weights: f64[N] particle weights.
      method: "systematic" | "multinomial" | "polyalgo".
      n_parts: number of indices to draw (defaults to len(weights); the
        bridge-distribution path draws fewer, reference src/smc_main.jl:262-270).
      n_iter: Metropolis chain length (method="metropolis" only). Default
        None computes the Doeblin length B = ceil(kappa * ln(1/eps)) from
        the actual weights ON DEVICE (kappa = w_max/w_bar is one reduction)
        and runs B chain steps in a `lax.while_loop` — so the TV bias is
        <= eps for ANY weight skew, including the low-ESS stages where the
        driver actually resamples (a static default is only valid for
        kappa <~ 7, but kappa is largest exactly on resample stages). Pass
        an int to pin the length instead.
      eps: total-variation bias bound for the adaptive Metropolis length.
      n_iter_max: hard cap on the adaptive Metropolis chain length. The
        Doeblin length is unbounded in the weight skew (kappa can reach N:
        a degenerate stage at 32k particles would imply ~150k sequential
        O(N)-gather sweeps inside the jitted superstep — a multi-hour
        device-side stall).
        When the cap binds, the TV bias bound degrades to
        exp(-n_iter_max / kappa) and a debug warning is emitted; the
        default cap keeps bias <= eps for kappa up to ~2170.
    """
    if method not in VALID_METHODS:
        raise ValueError(
            f"Invalid resampler {method!r}. Options are 'systematic', "
            "'multinomial', or 'polyalgo' (plus the extensions 'stratified' "
            "and 'metropolis')")
    n_out = int(n_parts) if n_parts is not None else weights.shape[0]

    if method == "metropolis":
        if n_iter is None:
            return _metropolis_adaptive(key, weights, n_out, eps, n_iter_max)
        return _metropolis(key, weights, n_out, n_iter)

    w = weights / jnp.sum(weights)
    cw = jnp.cumsum(w)

    if method == "systematic":
        u = jax.random.uniform(key, (), dtype=jnp.float64)
        thresholds = (jnp.arange(n_out, dtype=jnp.float64) + u) / n_out
        idx = jnp.searchsorted(cw, thresholds, side="right")
    elif method == "stratified":
        # one iid uniform per stratum [(i-1)/N, i/N) — between systematic's
        # single offset and multinomial's full independence
        u = jax.random.uniform(key, (n_out,), dtype=jnp.float64)
        thresholds = (jnp.arange(n_out, dtype=jnp.float64) + u) / n_out
        idx = jnp.searchsorted(cw, thresholds, side="right")
    else:  # multinomial / polyalgo
        u = jax.random.uniform(key, (n_out,), dtype=jnp.float64)
        idx = jnp.searchsorted(cw, u, side="right")

    # cw[-1] can be < 1 by rounding; clamp like the reference's scan that
    # never returns an out-of-range index for u inside [0, 1).
    return jnp.clip(idx, 0, weights.shape[0] - 1)


def _metropolis(key, weights, n_out, n_iter: int = 32):
    """Metropolis resampler (Murray, Lee & Jacob, arXiv:1202.6163; see
    PAPERS.md): each output slot runs a short Metropolis chain over ancestor
    indices with acceptance w_k / w_j — no cumulative sum, no sort, just
    uniform index draws and gathers. Total-variation bias is bounded by
    (1 - 1/kappa)^n_iter with kappa = w_max / w_bar (Doeblin bound, see
    metropolis_n_iter); choose n_iter = ceil(kappa ln(1/eps)) for bias
    <= eps. Fully local in structure: the natural choice when the global
    prefix-sum of the standard resamplers becomes the bottleneck on a very
    large sharded cloud (cumsum is a cross-device scan; this needs only
    uniform index draws + gathers)."""
    n = weights.shape[0]
    kp, ku = jax.random.split(key)
    props = jax.random.randint(kp, (n_iter, n_out), 0, n)
    us = jax.random.uniform(ku, (n_iter, n_out), dtype=jnp.float64)

    def body(j, pu):
        prop, u = pu
        accept = u * weights[j] < weights[prop]
        return jnp.where(accept, prop, j), None

    init = jnp.arange(n_out) % n
    j, _ = jax.lax.scan(body, init, (props, us))
    return j


def _metropolis_adaptive(key, weights, n_out, eps: float, n_iter_max: int):
    """Metropolis resampling with the chain length chosen ON DEVICE from the
    Doeblin bound: B = ceil(kappa * ln(1/eps)), kappa = w_max / w_bar (see
    metropolis_n_iter). One reduction computes kappa, then a
    `lax.while_loop` runs exactly B accept/reject sweeps with per-step
    folded keys — jit-compatible despite the data-dependent trip count, so
    the driver's in-graph resample branch carries the eps bias bound at
    whatever weight skew the stage actually has. Work is O(B * n_out)
    gathers; B is clamped to n_iter_max (see `resample`) so a degenerate
    stage cannot stall the device for hours."""
    n = weights.shape[0]
    kappa = jnp.max(weights) / jnp.mean(weights)
    n_doeblin = jnp.maximum(jnp.ceil(kappa * jnp.log(1.0 / eps)), 1.0)
    n_steps = jnp.minimum(n_doeblin, float(n_iter_max)).astype(jnp.int32)
    jax.lax.cond(
        n_doeblin > float(n_iter_max),
        lambda: jax.debug.print(
            "smc_jax WARNING: metropolis resampler chain length capped at "
            "{cap} (Doeblin bound {b:.0f} at kappa={k:.1f}); TV bias bound "
            "degrades to exp(-cap/kappa)", cap=n_iter_max, b=n_doeblin,
            k=kappa),
        lambda: None)

    def body(carry):
        t, j = carry
        kt = jax.random.fold_in(key, t)
        kp, ku = jax.random.split(kt)
        prop = jax.random.randint(kp, (n_out,), 0, n)
        u = jax.random.uniform(ku, (n_out,), dtype=weights.dtype)
        accept = u * weights[j] < weights[prop]
        return t + 1, jnp.where(accept, prop, j)

    init = jnp.arange(n_out) % n
    _, j = jax.lax.while_loop(lambda c: c[0] < n_steps, body,
                              (jnp.int32(0), init))
    return j
