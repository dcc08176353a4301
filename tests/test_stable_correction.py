"""Log-space correction stability.

The reference exponentiates (phi_n - phi_n1)*loglh raw
(/root/reference/src/smc_main.jl:401-410) and NaN-ESS-aborts whenever a
coarse schedule meets a peaked likelihood: |loglh| in the thousands makes
every incremental weight underflow to exactly 0, so the normalized weights
are 0/0. This suite pins the behavior we promise instead: the chain-facing
quantities (normalized weights, ESS, log-MDD) are computed shift-invariantly
in log space, so a common offset of the log-likelihood — arbitrarily huge —
changes the log-MDD by exactly that offset and nothing else.

The crash config reproduced here is the one that took down HEAD in round 2:
examples/estimate_sw_dsge.py's smoke (64 particles, n_phi=8) had best
loglh = -6810 and Delta-phi_1 = 0.0168, i.e. max incremental weight ~2e-50
with later stages all-zero.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smc_jax import smc
from smc_jax.ops.correction import (correct, compute_ess,
                                    log_incremental_weights,
                                    incremental_weights)
from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                   generate_linear_data)

TRUE = np.array([1.0, 1.0, 1.0, 2.0, 2.0, 1.0, 3.0, 3.0, 1.0])
SHIFT = 1.0e5


@pytest.fixture(scope="module")
def fixture():
    data, X = generate_linear_data(seed=1793)
    return data, make_linear_loglike(X)


def test_compute_ess_huge_loglh_finite():
    """ESS stays finite and shift-invariant when every raw incremental
    weight underflows (loglh ~ -7000, Delta-phi = 0.0168 — the measured
    SW smoke numbers)."""
    rng = np.random.default_rng(0)
    loglh = jnp.asarray(-7000.0 + 40.0 * rng.standard_normal(64))
    w = jnp.ones(64)
    ess = float(compute_ess(loglh, w, 0.0168, 0.0))
    assert np.isfinite(ess) and 1.0 <= ess <= 64.0
    # shift invariance: identical to the well-scaled problem
    ess_shifted = float(compute_ess(loglh + 7000.0, w, 0.0168, 0.0))
    np.testing.assert_allclose(ess, ess_shifted, rtol=1e-12)
    # the raw reference formula would have underflowed every weight
    assert float(jnp.max(incremental_weights(loglh, jnp.zeros(64),
                                             0.5, 0.0))) == 0.0


def test_correct_matches_reference_formula_at_moderate_scale():
    """At representable scales the stable path equals the reference's raw
    formula (src/smc_main.jl:401-420) to fp rounding."""
    rng = np.random.default_rng(1)
    loglh = jnp.asarray(rng.standard_normal(128) * 3.0)
    old = jnp.asarray(rng.standard_normal(128))
    w = jnp.asarray(rng.uniform(0.5, 1.5, 128))
    w = 128.0 * w / jnp.sum(w)
    inc_w, norm_w, ess, mdd_inc = correct(loglh, old, w, 0.4, 0.3)
    inc_np = np.exp(-0.1 * np.asarray(old) + 0.1 * np.asarray(loglh))
    new_np = np.asarray(w) * inc_np
    norm_np = 128.0 * new_np / new_np.sum()
    np.testing.assert_allclose(np.asarray(inc_w), inc_np, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(norm_w), norm_np, rtol=1e-12)
    np.testing.assert_allclose(float(ess),
                               128.0 ** 2 / np.sum(norm_np ** 2), rtol=1e-12)
    np.testing.assert_allclose(float(mdd_inc),
                               np.log(new_np.sum() / 128.0), rtol=1e-12)


def test_correct_bridge_variant_log_space():
    """0 < omega < 1 bridge variant: log form equals the reference's level
    form where the level form is representable."""
    rng = np.random.default_rng(2)
    loglh = jnp.asarray(rng.standard_normal(64))
    old = jnp.asarray(rng.standard_normal(64))
    li = np.asarray(log_incremental_weights(loglh, old, 0.4, 0.3, 0.25, -1.3))
    w = 0.25
    mix = np.log(np.exp(np.asarray(old) + 1.3 + np.log1p(-w)) + w)
    expect = -0.1 * mix + 0.1 * np.asarray(loglh)
    np.testing.assert_allclose(li, expect, rtol=1e-12)


def test_genuinely_degenerate_cloud_still_nans():
    """All-zero weights (every loglh -inf) must STILL produce NaN ESS — the
    stability fix must not mask true degeneracy (check_nan_ess forensics,
    reference src/helpers.jl:270-305)."""
    loglh = jnp.full(32, -jnp.inf)
    w = jnp.ones(32)
    _, norm_w, ess, _ = correct(loglh, jnp.zeros(32), w, 0.5, 0.0)
    assert np.isnan(float(ess))


@pytest.mark.parametrize("n_phi", [10])
def test_end_to_end_huge_loglh_coarse_schedule(fixture, n_phi):
    """The round-2 crash config, generalized: a likelihood offset by -1e5
    with a coarse fixed schedule. Previously: stage-1 weights all underflow
    -> NaN ESS -> AssertionError. Now: runs to phi=1 with finite ESS at
    every stage, the same posterior as the unshifted problem, and a log-MDD
    offset by exactly -1e5."""
    data, ll = fixture
    ll_shifted = lambda th, d: ll(th, d) - SHIFT

    kw = dict(n_parts=800, n_phi=n_phi, lam=2.1, alpha=0.9,
              verbose="none", seed=42)
    base = smc(ll, linear_parameters(), data, **kw)
    shifted = smc(ll_shifted, linear_parameters(), data, **kw)

    ess = np.asarray(shifted.cloud.ESS)
    assert np.all(np.isfinite(ess)), f"non-finite ESS: {ess}"
    assert np.isfinite(shifted.log_mdd)
    # log-MDD shifts by exactly the likelihood offset (chains identical up
    # to fp rounding of the offset subtraction)
    np.testing.assert_allclose(shifted.log_mdd - base.log_mdd, -SHIFT,
                               atol=0.5)
    # same posterior
    np.testing.assert_allclose(shifted.posterior_mean(),
                               base.posterior_mean(), atol=0.3)


def test_fused_huge_loglh(fixture):
    """Same stability through the fused device-side recursion (shared
    stage core, but the NaN-ESS early-exit plumbing differs), and the fused
    chain stays bit-identical to the host loop under the extreme scale."""
    data, ll = fixture
    ll_shifted = lambda th, d: ll(th, d) - SHIFT
    kw = dict(n_parts=512, n_phi=10, lam=2.1, verbose="none", seed=7)
    res = smc(ll_shifted, linear_parameters(), data, fused=True, **kw)
    assert np.all(np.isfinite(np.asarray(res.cloud.ESS)))
    assert np.isfinite(res.log_mdd)
    host = smc(ll_shifted, linear_parameters(), data, fused=False, **kw)
    np.testing.assert_array_equal(np.asarray(res.cloud.params),
                                  np.asarray(host.cloud.params))
    np.testing.assert_allclose(res.log_mdd, host.log_mdd, rtol=1e-12)
