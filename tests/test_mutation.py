"""Mutation kernel: proposal densities vs scipy, mixture-draw moments,
block structure, MH invariance on a tractable target."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy import stats as sps

from smc_jax.params import ParamSpace, parameter
from smc_jax.distributions import Normal
from smc_jax.ops.mutation import (block_sizes, make_mutation_step,
                                  mvnormal_mixture_draw,
                                  compute_proposal_densities, _deg_factor,
                                  _deg_logpdf)


def test_block_sizes_ceiling_division():
    # reference generate_free_blocks: cld split, smaller last block
    assert block_sizes(9, 1) == [9]
    assert block_sizes(9, 2) == [5, 4]
    assert block_sizes(9, 3) == [3, 3, 3]
    assert block_sizes(10, 3) == [4, 4, 2]
    with pytest.raises(ValueError):
        block_sizes(4, 5)
    with pytest.raises(ValueError):
        block_sizes(6, 4)  # 2+2+2+0: empty last block


def test_deg_logpdf_matches_scipy_full_rank():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(4, 4))
    cov = A @ A.T + 0.5 * np.eye(4)
    mu = rng.normal(size=4)
    x = rng.normal(size=4)
    c = 0.7
    U, sqrt_lam, inv_lam, rank, logdet = _deg_factor(jnp.asarray(cov))
    got = float(_deg_logpdf(jnp.asarray(x - mu), U, inv_lam, rank, logdet, c))
    expected = sps.multivariate_normal.logpdf(x, mu, c * c * cov)
    np.testing.assert_allclose(got, expected, rtol=1e-7)


def test_deg_logpdf_rank_deficient():
    """Pseudo-inverse logpdf on a singular covariance (DegenerateMvNormal)."""
    v = np.array([1.0, 2.0, 0.5])
    cov = np.outer(v, v)  # rank 1
    U, sqrt_lam, inv_lam, rank, logdet = _deg_factor(jnp.asarray(cov))
    assert int(rank) == 1
    x = 0.3 * v  # in the support
    got = float(_deg_logpdf(jnp.asarray(x), U, inv_lam, rank, logdet, 1.0))
    # density of N(0, |v|^2) evaluated at 0.3|v| along the 1-D support
    s2 = v @ v
    expected = sps.norm.logpdf(0.3 * np.sqrt(s2), 0, np.sqrt(s2))
    np.testing.assert_allclose(got, expected, rtol=1e-7)


def test_proposal_densities_symmetric_when_alpha_1():
    rng = np.random.default_rng(1)
    cov = np.eye(3) * 2.0
    q0, q1 = compute_proposal_densities(
        rng.normal(size=3), rng.normal(size=3), rng.normal(size=3), cov,
        alpha=1.0, c=0.5)
    np.testing.assert_allclose(float(q0), float(q1), rtol=1e-12)


def test_proposal_densities_match_scipy_mixture():
    """q0/q1 equal the log mixture densities (src/helpers.jl:128-164)."""
    rng = np.random.default_rng(2)
    A = rng.normal(size=(3, 3))
    cov = A @ A.T + np.eye(3)
    draw, cur, mean = rng.normal(size=3), rng.normal(size=3), rng.normal(size=3)
    alpha, c = 0.9, 0.6
    c2 = c * c

    def mix_at(x, center):
        return (alpha * sps.multivariate_normal.pdf(x, center, c2 * cov)
                + (1 - alpha) / 2 * sps.multivariate_normal.pdf(
                    x, center, c2 * np.diag(np.diag(cov)))
                + (1 - alpha) / 2 * sps.multivariate_normal.pdf(
                    x, mean, c2 * cov))

    q0, q1 = compute_proposal_densities(draw, cur, mean, cov, alpha=alpha, c=c)
    np.testing.assert_allclose(float(q0), np.log(mix_at(cur, draw)), rtol=1e-9)
    np.testing.assert_allclose(float(q1), np.log(mix_at(draw, cur)), rtol=1e-9)


def test_mixture_draw_moments():
    """alpha=1 draws are N(theta_old, c^2 Sigma)."""
    cov = np.array([[2.0, 0.5], [0.5, 1.0]])
    theta = np.array([1.0, -1.0])
    c = 0.8
    keys = jax.random.split(jax.random.PRNGKey(0), 20_000)
    draws = np.asarray(jax.vmap(
        lambda k: mvnormal_mixture_draw(k, theta, np.zeros(2), cov, c=c,
                                        alpha=1.0))(keys))
    np.testing.assert_allclose(draws.mean(0), theta, atol=0.05)
    np.testing.assert_allclose(np.cov(draws.T), c * c * cov, rtol=0.08)


def _gauss_space(dim=3):
    return ParamSpace([
        parameter(f"x{i}", 0.0, (-50.0, 50.0), prior=Normal(0.0, 10.0))
        for i in range(dim)
    ])


def _target_loglike(theta):
    # N(mu_t, I) likelihood around mu_t = (1, 2, 3)
    mu = jnp.arange(1.0, theta.shape[-1] + 1.0)
    return -0.5 * jnp.sum((theta - mu) ** 2, axis=-1)


@pytest.mark.parametrize("n_blocks,n_mh_steps,alpha", [
    (1, 1, 1.0), (2, 1, 0.9), (1, 2, 1.0), (3, 2, 0.9),
])
def test_mutation_preserves_target(n_blocks, n_mh_steps, alpha):
    """MH invariance: starting from exact posterior samples at phi=1, the
    mutation leaves the (tractable Gaussian) posterior invariant."""
    dim = 3
    space = _gauss_space(dim)
    n = 4000
    # posterior at phi=1: prior N(0,100 I) x like N(mu,I) -> N(mu*100/101, (100/101) I)
    post_var = 100.0 / 101.0
    post_mu = np.arange(1.0, dim + 1.0) * post_var
    rng = np.random.default_rng(0)
    params = jnp.asarray(rng.normal(post_mu, np.sqrt(post_var), (n, dim)))

    ll = lambda th: _target_loglike(th)
    loglh = ll(params)
    logprior = space.log_prior(params)
    old = jnp.zeros(n)

    step = jax.jit(make_mutation_step(space, ll, n_blocks, n_mh_steps, alpha))
    mean_free = jnp.asarray(post_mu)
    cov_free = jnp.eye(dim) * post_var
    perm = jax.random.permutation(jax.random.PRNGKey(5), dim)
    out_params, out_loglh, out_logprior, out_old, accept = step(
        jax.random.PRNGKey(6), params, loglh, logprior, old, mean_free,
        cov_free, perm, 1.0, 1.0, 1.0)

    out = np.asarray(out_params)
    se = np.sqrt(post_var / n) * 4
    np.testing.assert_allclose(out.mean(0), post_mu, atol=4 * se + 0.05)
    np.testing.assert_allclose(out.var(0), post_var, rtol=0.12)
    a = np.asarray(accept)
    assert 0.05 < a.mean() < 1.0 * n_mh_steps
    # loglh/logprior fields consistent with params
    np.testing.assert_allclose(np.asarray(out_loglh),
                               np.asarray(ll(out_params)), rtol=1e-8)


def test_mutation_rejects_out_of_bounds():
    """Proposals outside valuebounds must never be accepted."""
    space = ParamSpace([parameter("x", 0.5, (0.0, 1.0), prior=Normal(0.5, 10.0))])
    n = 2000
    params = jnp.full((n, 1), 0.5)
    ll = lambda th: jnp.zeros(th.shape[0])
    step = jax.jit(make_mutation_step(space, ll, 1, 1, 1.0))
    out_params, *_ = step(
        jax.random.PRNGKey(0), params, ll(params), space.log_prior(params),
        jnp.zeros(n), jnp.asarray([0.5]), jnp.asarray([[100.0]]),
        jnp.asarray([0]), 1.0, 1.0, 0.9)
    out = np.asarray(out_params)
    assert out.min() >= 0.0 and out.max() <= 1.0
    assert (out != 0.5).any()  # some in-bounds proposals accepted


def test_mutation_fixed_columns_never_move():
    space = ParamSpace([
        parameter("a", 0.0, (-10, 10), prior=Normal(0, 1)),
        parameter("b", 3.3, (-10, 10), prior=Normal(0, 1), fixed=True),
    ])
    n = 100
    params = jnp.concatenate(
        [jnp.zeros((n, 1)), jnp.full((n, 1), 3.3)], axis=1)
    ll = lambda th: jnp.zeros(th.shape[0])
    step = jax.jit(make_mutation_step(space, ll, 1, 1, 1.0))
    out_params, *_ = step(
        jax.random.PRNGKey(1), params, ll(params), space.log_prior(params),
        jnp.zeros(n), jnp.zeros(1), jnp.ones((1, 1)), jnp.asarray([0]),
        0.5, 0.4, 0.5)
    np.testing.assert_array_equal(np.asarray(out_params)[:, 1], 3.3)
