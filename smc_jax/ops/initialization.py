"""Initialization: prior draws with retry-until-valid, likelihood re-init.

Reference (src/initialization.jl):
  * one_draw / initial_draw!: rejection-sample prior draws until the
    likelihood and prior are finite (:23-63, :88-119). That per-particle
    retry loop is data-dependent control flow; the batched formulation is
    *masked redraw rounds*: draw all N, evaluate batched, redraw the invalid
    subset, repeat (SURVEY.md §7 "hard parts"). Each round is one jitted
    batched evaluation; the expected number of rounds matches the
    per-particle geometric retry of the reference.
  * initialize_likelihoods!: retire loglh -> old_loglh, re-evaluate on new
    data (:153-186) — one batched evaluation here.
  * initialize_cloud_settings!: scalar state reset (:196-211) — handled by
    the driver on the host-side Cloud fields.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from smc_jax.cloud import Cloud
from smc_jax.utils.misc import scrub_loglh


def _eval_batch(space, loglike_batched, draws):
    """Batched (loglh, logprior) with the reference's scrubbing: ANY
    non-finite loglh (nan, +inf, -inf) or logprior forces both to -inf
    (src/initialization.jl:43-54; the +inf channel has no Julia analogue
    because Julia throws there — see utils.misc.scrub_loglh)."""
    logprior = space.log_prior(draws)
    loglh = loglike_batched(draws)
    bad = ~jnp.isfinite(loglh) | ~jnp.isfinite(logprior)
    loglh = jnp.where(bad, -jnp.inf, loglh)
    logprior = jnp.where(bad, -jnp.inf, logprior)
    return loglh, logprior


def initial_draw(key, space, loglike_batched: Callable, n_parts: int,
                 max_rounds: int = 1000, sharding=None) -> Cloud:
    """Draw n_parts valid particles from the prior (reference initial_draw!,
    src/initialization.jl:88-119): loglh and logprior finite for every row.

    Masked redraw rounds run on the host (round count is data-dependent and
    small); each round is one batched prior-sample + likelihood evaluation.
    Raises if max_rounds rounds can't produce a fully-valid cloud.
    """
    # Everything is jitted into TWO programs (draw+eval, redraw-round) so
    # the whole initialization costs two XLA compiles regardless of round
    # count (the redraw-round program only compiles if a redraw is needed).
    out_shardings = None
    if sharding is not None:
        out_shardings = ((sharding, sharding, sharding), None)

    @partial(jax.jit, out_shardings=out_shardings)
    def first_draw(k):
        draws = space.sample_prior(k, n_parts)
        loglh, logprior = _eval_batch(space, loglike_batched, draws)
        n_bad = jnp.sum(~(jnp.isfinite(loglh) & jnp.isfinite(logprior)))
        return (draws, loglh, logprior), n_bad

    @partial(jax.jit, out_shardings=out_shardings)
    def redraw_round(k, draws, loglh, logprior):
        invalid = ~(jnp.isfinite(loglh) & jnp.isfinite(logprior))
        fresh = space.sample_prior(k, n_parts)
        draws = jnp.where(invalid[:, None], fresh, draws)
        new_loglh, new_logprior = _eval_batch(space, loglike_batched, draws)
        loglh = jnp.where(invalid, new_loglh, loglh)
        logprior = jnp.where(invalid, new_logprior, logprior)
        n_bad = jnp.sum(~(jnp.isfinite(loglh) & jnp.isfinite(logprior)))
        return (draws, loglh, logprior), n_bad

    key, k0 = jax.random.split(key)
    (draws, loglh, logprior), n_bad = first_draw(k0)
    rounds = 0
    n_bad = int(n_bad)
    while n_bad > 0:
        rounds += 1
        if rounds > max_rounds:
            raise RuntimeError(
                f"initial_draw: {n_bad}/{n_parts} particles still invalid "
                f"after {max_rounds} redraw rounds — the prior puts almost "
                "no mass where the likelihood is finite")
        key, kr = jax.random.split(key)
        (draws, loglh, logprior), n_bad = redraw_round(kr, draws, loglh,
                                                       logprior)
        n_bad = int(n_bad)

    cloud = Cloud.create(space.n_para, n_parts, sharding=sharding)
    cloud.params = draws
    cloud.loglh = loglh
    cloud.logprior = logprior
    # old_loglh <- 0, weights <- 1 (src/initialization.jl:114-118)
    return cloud


def one_draw(key, space, loglike_batched: Callable, max_rounds: int = 10000):
    """One valid prior draw: (draw [P], loglh, logprior) — reference one_draw
    (src/initialization.jl:23-63). A thin N=1 wrapper over the masked-redraw
    machinery; the batched `initial_draw` is the production path."""
    cloud = initial_draw(key, space, loglike_batched, 1, max_rounds=max_rounds)
    return cloud.params[0], cloud.loglh[0], cloud.logprior[0]


def initialize_likelihoods(cloud: Cloud, space, loglike_batched: Callable) -> Cloud:
    """Tempered-update setup (reference initialize_likelihoods!,
    src/initialization.jl:153-186): copy loglh -> old_loglh, then re-evaluate
    loglh/logprior on the NEW data for every particle. -inf on new data is
    handled upstream by zero_bad_loglh_weights (reference TODO at :175).
    One jitted program."""

    @jax.jit
    def reval(params):
        logprior = space.log_prior(params)
        loglh = scrub_loglh(loglike_batched(params))
        return loglh, logprior

    cloud.old_loglh = cloud.loglh
    cloud.loglh, cloud.logprior = reval(cloud.params)
    return cloud


def draw_likelihood(space, loglike_batched: Callable, draws):
    """(loglh, logprior) at given draws [N, P] (reference draw_likelihood,
    src/initialization.jl:129-139), without the invalid-scrub coupling."""
    logprior = space.log_prior(draws)
    loglh = scrub_loglh(loglike_batched(draws))
    return loglh, logprior
