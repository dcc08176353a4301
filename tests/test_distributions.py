"""Prior-family logpdf/sampling checks against scipy (the accuracy oracle the
reference gets from Distributions.jl)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy import stats as sps

from smc_jax import distributions as dist


@pytest.mark.parametrize("d,scipy_logpdf", [
    (dist.Normal(1.5, 2.0), lambda x: sps.norm.logpdf(x, 1.5, 2.0)),
    (dist.Uniform(-1.0, 3.0), lambda x: sps.uniform.logpdf(x, -1.0, 4.0)),
    (dist.Gamma(2.5, 1.7), lambda x: sps.gamma.logpdf(x, 2.5, scale=1.7)),
    (dist.Beta(2.0, 5.0), lambda x: sps.beta.logpdf(x, 2.0, 5.0)),
    (dist.InverseGamma(3.0, 2.0),
     lambda x: sps.invgamma.logpdf(x, 3.0, scale=2.0)),
])
def test_logpdf_matches_scipy(d, scipy_logpdf):
    xs = np.linspace(-2.0, 6.0, 41)
    ours = np.asarray(d.logpdf(jnp.asarray(xs)))
    theirs = scipy_logpdf(xs)
    both_finite = np.isfinite(ours) & np.isfinite(theirs)
    np.testing.assert_allclose(ours[both_finite], theirs[both_finite],
                               rtol=1e-7, atol=1e-8)
    # supports agree (-inf in the same places)
    np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(theirs))


def test_root_inverse_gamma_integrates_to_one():
    d = dist.RootInverseGamma(4.0, 0.5)
    xs = np.linspace(1e-4, 20.0, 100_000)
    pdf = np.exp(np.asarray(d.logpdf(jnp.asarray(xs))))
    assert abs(np.trapezoid(pdf, xs) - 1.0) < 1e-4


def test_root_inverse_gamma_sampling_matches_logpdf_moments():
    d = dist.RootInverseGamma(6.0, 1.5)
    key = jax.random.PRNGKey(0)
    draws = np.asarray(d.sample(key, (100_000,)))
    assert np.all(draws > 0)
    # compare sample mean to numeric-integral mean of the pdf
    xs = np.linspace(1e-4, 50.0, 100_000)
    pdf = np.exp(np.asarray(d.logpdf(jnp.asarray(xs))))
    mean_num = np.trapezoid(xs * pdf, xs)
    assert abs(draws.mean() - mean_num) < 0.01


@pytest.mark.parametrize("d,mean,std", [
    (dist.Normal(2.0, 3.0), 2.0, 3.0),
    (dist.Uniform(0.0, 10.0), 5.0, 10.0 / np.sqrt(12)),
    (dist.Gamma(4.0, 0.5), 2.0, 1.0),
    (dist.Beta(2.0, 2.0), 0.5, np.sqrt(1 / 20)),
    (dist.InverseGamma(5.0, 8.0), 2.0, np.sqrt(64 / (16 * 3))),
])
def test_sampling_moments(d, mean, std):
    key = jax.random.PRNGKey(42)
    draws = np.asarray(d.sample(key, (100_000,)))
    assert abs(draws.mean() - mean) < 5 * std / np.sqrt(len(draws)) * 2 + 1e-3
    assert abs(draws.std() - std) < 0.05 * std + 1e-3


def test_stacked_heterogeneous_columns():
    """One vectorized call evaluates different families per column."""
    code = jnp.asarray([dist.FAMILY_CODES["normal"],
                        dist.FAMILY_CODES["uniform"],
                        dist.FAMILY_CODES["gamma"]])
    a = jnp.asarray([0.0, 0.0, 2.0])
    b = jnp.asarray([1.0, 2.0, 1.0])
    x = jnp.asarray([0.5, 0.5, 0.5])
    lp = np.asarray(dist.logpdf_family(code, a, b, x))
    np.testing.assert_allclose(lp[0], sps.norm.logpdf(0.5), rtol=1e-12)
    np.testing.assert_allclose(lp[1], sps.uniform.logpdf(0.5, 0, 2), rtol=1e-12)
    np.testing.assert_allclose(lp[2], sps.gamma.logpdf(0.5, 2.0), rtol=1e-10)


def test_point_family_contributes_zero():
    assert float(dist.Point().logpdf(jnp.asarray(123.0))) == 0.0


def test_degenerate_mvnormal_full_rank_matches_scipy():
    from smc_jax.distributions import DegenerateMvNormal, get_cov
    from scipy.stats import multivariate_normal
    rng = np.random.default_rng(0)
    A = rng.normal(size=(4, 4))
    sigma = A @ A.T + 0.5 * np.eye(4)
    mu = rng.normal(size=4)
    d = DegenerateMvNormal(mu, sigma)
    x = rng.normal(size=(10, 4))
    np.testing.assert_allclose(np.asarray(d.logpdf(x)),
                               multivariate_normal(mu, sigma).logpdf(x),
                               rtol=1e-10)
    np.testing.assert_array_equal(np.asarray(get_cov(d)), sigma)


def test_degenerate_mvnormal_rank_deficient():
    """Pseudo-inverse density: zero-eigenvalue directions contribute nothing
    (reference DegenerateMvNormal semantics, SURVEY.md §2.9)."""
    from smc_jax.distributions import DegenerateMvNormal
    v = np.array([1.0, 1.0]) / np.sqrt(2.0)
    sigma = np.outer(v, v)  # rank 1
    d = DegenerateMvNormal(np.zeros(2), sigma)
    assert float(d.rank) == 1.0
    # density along the retained direction = 1-D standard normal
    x = 0.7 * v
    expected = -0.5 * (np.log(2 * np.pi) + 0.7 ** 2)
    np.testing.assert_allclose(float(d.logpdf(x)), expected, rtol=1e-10)
    # draws stay in the span of v
    draws = np.asarray(d.rand(jax.random.PRNGKey(1), (500,)))
    ortho = draws @ np.array([1.0, -1.0]) / np.sqrt(2.0)
    assert np.max(np.abs(ortho)) < 1e-12
