"""Correction-step math and the adaptive-phi solver."""

import numpy as np
import jax.numpy as jnp

from smc_jax.ops.correction import (compute_ess, incremental_weights,
                                    normalize_to_n, ess_from_normalized)
from smc_jax.ops.schedule import fixed_schedule, solve_adaptive_phi


def test_fixed_schedule_endpoints_and_shape():
    s = fixed_schedule(300, 2.1)
    assert s.shape == (300,)
    assert s[0] == 0.0 and s[-1] == 1.0
    assert np.all(np.diff(s) > 0)
    # phi_n = ((n-1)/(n_phi-1))^lam (src/smc_main.jl:349)
    np.testing.assert_allclose(s[10], (10 / 299) ** 2.1, rtol=1e-14)


def test_compute_ess_against_numpy():
    rng = np.random.default_rng(0)
    n = 500
    loglh = rng.normal(-100, 5, n)
    old = rng.normal(-120, 5, n)
    w = rng.exponential(size=n)
    w = n * w / w.sum()
    phi_n, phi_n1 = 0.3, 0.2
    inc = np.exp((phi_n1 - phi_n) * old + (phi_n - phi_n1) * loglh)
    new_w = w * inc
    norm = n * new_w / new_w.sum()
    expected = n ** 2 / np.sum(norm ** 2)
    got = float(compute_ess(jnp.asarray(loglh), jnp.asarray(w), phi_n, phi_n1,
                            jnp.asarray(old)))
    np.testing.assert_allclose(got, expected, rtol=1e-12)


def test_ess_bounds():
    n = 100
    loglh = jnp.zeros(n)
    w = jnp.ones(n)
    # equal weights: ESS = N
    assert abs(float(compute_ess(loglh, w, 0.5, 0.3)) - n) < 1e-9


def test_incremental_weights_variants():
    loglh = jnp.asarray([-10.0, -12.0])
    old = jnp.asarray([-11.0, -11.5])
    # omega = 0 (src/smc_main.jl:401-403)
    w0 = np.asarray(incremental_weights(loglh, old, 0.4, 0.3, 0.0))
    np.testing.assert_allclose(
        w0, np.exp(-0.1 * np.asarray(old) + 0.1 * np.asarray(loglh)), rtol=1e-12)
    # omega = 1 ignores old loglh (src/smc_main.jl:404-405)
    w1 = np.asarray(incremental_weights(loglh, old, 0.4, 0.3, 1.0))
    np.testing.assert_allclose(w1, np.exp(0.1 * np.asarray(loglh)), rtol=1e-12)
    # 0 < omega < 1 mixes prior mass (src/smc_main.jl:406-409)
    lp_old = -5.0
    wm = np.asarray(incremental_weights(loglh, old, 0.4, 0.3, 0.25, lp_old))
    mix = np.log(np.exp(np.asarray(old) - lp_old + np.log(0.75)) + 0.25)
    np.testing.assert_allclose(
        wm, np.exp(-0.1 * mix + 0.1 * np.asarray(loglh)), rtol=1e-12)


def test_normalize_and_ess_roundtrip():
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.exponential(size=64))
    norm = normalize_to_n(w)
    assert abs(float(jnp.sum(norm)) - 64) < 1e-9
    assert 1.0 <= float(ess_from_normalized(norm)) <= 64.0


def test_solve_adaptive_phi_hits_target():
    """The solved phi_n makes ESS fall by exactly the target fraction."""
    rng = np.random.default_rng(2)
    n = 2000
    loglh = jnp.asarray(rng.normal(-50, 3, n))
    old = jnp.zeros(n)
    w = jnp.ones(n)
    sched = jnp.asarray(fixed_schedule(100, 2.0))
    target = 0.95
    ess_bar = target * n
    phi_n, j, phi_prop = solve_adaptive_phi(
        loglh, w, old, jnp.float64(0.0), sched, jnp.int64(1),
        jnp.float64(0.0), jnp.float64(ess_bar))
    phi_n = float(phi_n)
    assert 0.0 < phi_n < 1.0
    got_ess = float(compute_ess(loglh, w, phi_n, 0.0, old))
    np.testing.assert_allclose(got_ess, ess_bar, rtol=1e-8)
    # bounded above by the fixed schedule entry it advanced to
    assert phi_n <= float(phi_prop) + 1e-15


def test_solve_adaptive_phi_saturates_at_one():
    """When even phi=1 keeps ESS above target, phi_n = 1 (src/helpers.jl:48-54)."""
    n = 100
    loglh = jnp.full(n, -10.0)  # identical loglh: ESS never drops
    old = jnp.zeros(n)
    w = jnp.ones(n)
    sched = jnp.asarray(fixed_schedule(10, 2.0))
    phi_n, j, phi_prop = solve_adaptive_phi(
        loglh, w, old, jnp.float64(0.0), sched, jnp.int64(1),
        jnp.float64(0.0), jnp.float64(0.95 * n))
    assert float(phi_n) == 1.0
