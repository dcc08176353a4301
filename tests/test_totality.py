"""Totality discipline: ANY non-finite log-likelihood (nan, +inf, -inf) must
be scrubbed to -inf at every evaluation site, so the sampler *rejects* bad
draws instead of NaN-ESS-aborting.

The reference's try/catch -> -Inf discipline (src/initialization.jl:46-54,
src/mutation.jl:112-121) has no +inf channel because Julia throws there; in
JAX a user likelihood can return +inf, which — before this fix — sailed
through mutation's nan-only scrub, was accepted with probability 1, and
detonated the next correction step (exp(dphi * inf) -> inf weights -> NaN
ESS -> check_nan_ess abort)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smc_jax import smc
from smc_jax.params import Parameter, ParamSpace
from smc_jax.distributions import Normal
from smc_jax.ops.initialization import initial_draw, initialize_likelihoods
from smc_jax.utils.misc import scrub_loglh


TRUE = np.array([1.0, -0.5])


def _make_adversarial_loglike(data):
    """Gaussian 2-param likelihood with non-finite booby traps by region:
    theta0 > 2.2  -> +inf   (the dangerous channel)
    theta0 < -0.5 -> nan
    theta1 > 0.9  -> -inf   (the ordinary rejection channel)
    """
    y, x = data

    def loglike(theta, _data):
        resid = y - theta[0] - theta[1] * x
        ll = -0.5 * jnp.sum(resid * resid) - 0.5 * y.shape[0] * jnp.log(2 * jnp.pi)
        ll = jnp.where(theta[0] > 2.2, jnp.inf, ll)
        ll = jnp.where(theta[0] < -0.5, jnp.nan, ll)
        ll = jnp.where(theta[1] > 0.9, -jnp.inf, ll)
        return ll

    return loglike


@pytest.fixture(scope="module")
def adversarial():
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(size=60))
    y = jnp.asarray(TRUE[0] + TRUE[1] * np.asarray(x) + rng.normal(size=60))
    data = (y, x)
    params = [
        Parameter("theta0", 1.0, prior=Normal(1.0, 2.0)),
        Parameter("theta1", 0.0, prior=Normal(0.0, 2.0)),
    ]
    return data, params


def test_scrub_loglh_maps_all_nonfinite_to_neginf():
    x = jnp.asarray([1.5, jnp.inf, -jnp.inf, jnp.nan, -3.0])
    out = np.asarray(scrub_loglh(x))
    np.testing.assert_array_equal(out, [1.5, -np.inf, -np.inf, -np.inf, -3.0])


def test_initial_draw_rejects_posinf_and_nan(adversarial):
    data, params = adversarial
    space = ParamSpace(params)
    ll = _make_adversarial_loglike(data)
    llb = jax.vmap(lambda th: ll(th, data))
    cloud = initial_draw(jax.random.PRNGKey(3), space, llb, 512)
    lh = np.asarray(cloud.loglh)
    th = np.asarray(cloud.params)
    assert np.all(np.isfinite(lh))
    assert np.all(th[:, 0] <= 2.2)
    assert np.all(th[:, 0] >= -0.5)
    assert np.all(th[:, 1] <= 0.9)


def test_initialize_likelihoods_scrubs_posinf(adversarial):
    data, params = adversarial
    space = ParamSpace(params)
    ll = _make_adversarial_loglike(data)
    llb = jax.vmap(lambda th: ll(th, data))
    cloud = initial_draw(jax.random.PRNGKey(3), space, llb, 64)
    # push some particles into the +inf region, then re-evaluate
    cloud.params = cloud.params.at[:8, 0].set(3.0)
    cloud = initialize_likelihoods(cloud, space, llb)
    lh = np.asarray(cloud.loglh)
    assert np.all(lh[:8] == -np.inf)
    assert not np.any(np.isposinf(lh))
    assert not np.any(np.isnan(lh))


def test_smc_survives_adversarial_likelihood(adversarial):
    """End-to-end: the sampler must complete (no NaN-ESS abort), keep every
    particle out of the booby-trapped regions, and still find the truth
    (which lies safely inside the finite region)."""
    data, params = adversarial
    ll = _make_adversarial_loglike(data)
    res = smc(ll, params, data, n_parts=512, n_phi=60, lam=2.0,
              verbose="none", seed=5)
    cloud = res.cloud
    lh = np.asarray(cloud.loglh)
    th = np.asarray(cloud.params)
    assert np.all(np.isfinite(lh))
    assert all(np.isfinite(e) for e in cloud.ESS)
    assert np.all(th[:, 0] <= 2.2)
    assert np.all(th[:, 1] <= 0.9)
    # the exact conjugate posterior (booby-trapped regions carry negligible
    # mass, so truncation doesn't move it): prior N([1,0], 4 I), sigma2 = 1
    y, x = map(np.asarray, data)
    X = np.column_stack([np.ones_like(x), x])
    prec = np.diag([0.25, 0.25]) + X.T @ X
    exact_mean = np.linalg.solve(prec, np.array([0.25, 0.0]) + X.T @ y)
    mu = res.posterior_mean()
    assert np.max(np.abs(mu - exact_mean)) < 0.05
    assert np.isfinite(res.log_mdd)
