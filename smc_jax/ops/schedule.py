"""Tempering schedule: fixed lambda-schedule and the adaptive-phi solver.

Reference math:
  * fixed schedule phi_n = ((n-1)/(n_phi-1))^lambda — src/smc_main.jl:348-352
  * solve_adaptive_phi — src/helpers.jl:9-56: advance a pointer j through the
    proposed fixed schedule until the ESS at phi_prop falls below the target,
    then root-find ESS(phi) = ESS_bar on [phi_n1, phi_prop].

The reference root-finds with Roots.fzero bisection at xtol=0 on the host
(src/helpers.jl:49), touching the full loglh vector each evaluation. Here the
whole solver — schedule advance and a 64-step bisection (machine precision
for f64 on [0,1]) — is ONE jitted program: `lax.while_loop` + `lax.fori_loop`
with the ESS reductions inside, so a sharded cloud needs zero host
round-trips and every host computes a bit-identical phi_n.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from smc_jax.ops.correction import compute_ess

_BISECT_ITERS = 64  # 2^-64 < eps(f64): equivalent to Roots.fzero xtol=0


def fixed_schedule(n_phi: int, lam: float) -> np.ndarray:
    """phi_n = ((n-1)/(n_phi-1))^lambda, n = 1..n_phi (src/smc_main.jl:349)."""
    return (np.arange(n_phi, dtype=np.float64) / (n_phi - 1)) ** lam


@jax.jit
def solve_adaptive_phi(loglh, weights, old_loglh, phi_n1, schedule, j,
                       phi_prop, ess_bar):
    """One adaptive-schedule step (reference solve_adaptive_phi,
    src/helpers.jl:9-56).

    Args:
      loglh, weights, old_loglh: cloud arrays (weights normalized to sum N).
      phi_n1: previous tempering parameter.
      schedule: proposed fixed schedule, f64[n_phi] (last entry 1.0).
      j: 0-based index of the next untried schedule entry (the reference's
         1-based j starts at 2 -> here starts at 1).
      phi_prop: current proposal upper bound.
      ess_bar: target ESS = tempering_target * (previous ESS, or N right
         after a resample — reference src/helpers.jl:14-20).

    Returns (phi_n, j, phi_prop) as device scalars.
    """
    n_phi = schedule.shape[0]

    def f(phi):
        return compute_ess(loglh, weights, phi, phi_n1, old_loglh) - ess_bar

    # -- advance phi_prop through the fixed schedule (src/helpers.jl:29-32) --
    def adv_cond(state):
        j, phi_prop = state
        return (f(phi_prop) >= 0) & (j < n_phi)

    def adv_body(state):
        j, _ = state
        return j + 1, schedule[j]

    j, phi_prop = jax.lax.while_loop(adv_cond, adv_body, (j, phi_prop))

    # -- bisect on [phi_n1, phi_prop] when the target is interior ------------
    # After the advance, f(phi_prop) < 0 unless phi_prop == 1 and even the
    # full posterior keeps ESS above target, in which case phi_n = 1
    # (src/helpers.jl:48-54).
    def bisect(_):
        def body(_, state):
            lo, hi = state
            mid = 0.5 * (lo + hi)
            go_right = f(mid) >= 0
            return jnp.where(go_right, mid, lo), jnp.where(go_right, hi, mid)

        lo, hi = jax.lax.fori_loop(0, _BISECT_ITERS, body, (phi_n1, phi_prop))
        return 0.5 * (lo + hi)

    phi_n = jax.lax.cond(f(phi_prop) < 0, bisect, lambda _: jnp.float64(1.0),
                         operand=None)
    return phi_n, j, phi_prop
