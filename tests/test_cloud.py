"""Cloud data structure: weighted statistics vs numpy, split/join,
add_parameters_to_cloud (reference test/particle.jl, test/add_parameters_to_cloud.jl)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smc_jax.cloud import (Cloud, weighted_mean, weighted_cov, weighted_std,
                           weighted_quantile, split_cloud, join_cloud,
                           add_parameters_to_cloud)
from smc_jax.params import ParamSpace, parameter
from smc_jax.distributions import Normal, Uniform


def _cloud(n=200, p=4, seed=0):
    rng = np.random.default_rng(seed)
    c = Cloud.create(p, n)
    c.params = jnp.asarray(rng.normal(size=(n, p)))
    c.loglh = jnp.asarray(rng.normal(-50, 3, n))
    c.logprior = jnp.asarray(rng.normal(-5, 1, n))
    w = rng.exponential(size=n)
    c.weights = jnp.asarray(n * w / w.sum())
    return c


def test_create_defaults():
    c = Cloud.create(3, 10)
    assert c.n_parts == 10 and c.n_para == 3
    assert float(jnp.sum(c.weights)) == 10.0
    assert c.accept_rate == 0.25  # reference src/particle.jl:50-53


def test_weighted_moments_vs_numpy():
    c = _cloud()
    vals = np.asarray(c.params)
    w = np.asarray(c.weights)
    mu = (w @ vals) / w.sum()
    np.testing.assert_allclose(np.asarray(weighted_mean(c)), mu, rtol=1e-12)
    dev = vals - mu
    cov = (dev.T * w) @ dev / w.sum()
    np.testing.assert_allclose(np.asarray(weighted_cov(c)), cov, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(weighted_std(c)),
                               np.sqrt(np.diag(cov)), rtol=1e-10)


def test_weighted_quantile():
    c = _cloud(n=5000)
    q = np.asarray(weighted_quantile(c, qs=(0.05, 0.95)))
    assert q.shape == (2, 4)
    assert np.all(q[0] < q[1])
    # roughly the unweighted quantiles for near-uniform weights
    c.weights = jnp.ones(5000)
    q = np.asarray(weighted_quantile(c, qs=(0.5,)))
    np.testing.assert_allclose(q[0], np.median(np.asarray(c.params), axis=0),
                               atol=0.05)


def test_normalize_and_reset_weights():
    c = _cloud()
    c.weights = c.weights * 7.3
    norm = c.normalize_weights()
    assert abs(float(jnp.sum(norm)) - c.n_parts) < 1e-9
    c.reset_weights()
    assert float(jnp.sum(c.weights)) == c.n_parts


def test_zero_bad_loglh_weights():
    c = _cloud()
    c.loglh = c.loglh.at[3].set(-jnp.inf).at[7].set(jnp.nan)
    c.zero_bad_loglh_weights()
    w = np.asarray(c.weights)
    assert w[3] == 0.0 and w[7] == 0.0
    assert (w > 0).sum() == c.n_parts - 2


def test_logpost_and_mode_particles():
    c = _cloud()
    lp = np.asarray(c.loglh) + np.asarray(c.logprior)
    np.testing.assert_allclose(np.asarray(c.logpost), lp, rtol=1e-12)
    k = int(np.argmax(np.asarray(c.loglh)))
    np.testing.assert_array_equal(np.asarray(c.likeliest_particle_value()),
                                  np.asarray(c.params)[k])
    k = int(np.argmax(lp))
    np.testing.assert_array_equal(
        np.asarray(c.highest_posterior_particle_value()),
        np.asarray(c.params)[k])


def test_split_join_roundtrip():
    """reference test/particle.jl:7-26 split/join equality."""
    c = _cloud(n=120)
    pieces = split_cloud(c, 4)
    assert all(p.n_parts == 30 for p in pieces)
    back = join_cloud(pieces)
    np.testing.assert_array_equal(np.asarray(back.params), np.asarray(c.params))
    np.testing.assert_array_equal(np.asarray(back.weights), np.asarray(c.weights))
    np.testing.assert_array_equal(np.asarray(back.loglh), np.asarray(c.loglh))


def test_reindexed_gathers_all_fields():
    c = _cloud(n=50)
    idx = jnp.asarray(np.random.default_rng(1).integers(0, 50, 50))
    r = c.reindexed(idx)
    np.testing.assert_array_equal(np.asarray(r.params),
                                  np.asarray(c.params)[np.asarray(idx)])
    np.testing.assert_array_equal(np.asarray(r.loglh),
                                  np.asarray(c.loglh)[np.asarray(idx)])


def test_add_parameters_to_cloud():
    """reference test/add_parameters_to_cloud.jl:60-67: old columns kept,
    loglh/weights preserved, new params drawn from prior, logprior updated,
    old_loglh zeroed."""
    old_space = ParamSpace([
        parameter("a", 0.0, (-10, 10), prior=Normal(0, 1)),
        parameter("b", 0.0, (-10, 10), prior=Normal(0, 2)),
    ])
    new_space = ParamSpace([
        parameter("a", 0.0, (-10, 10), prior=Normal(0, 1)),
        parameter("b", 0.0, (-10, 10), prior=Normal(0, 2)),
        parameter("cnew", 0.5, (0, 1), prior=Uniform(0, 1)),
    ])
    c = _cloud(n=300, p=2)
    old_params = np.asarray(c.params)
    old_loglh = np.asarray(c.loglh)
    old_weights = np.asarray(c.weights)

    out = add_parameters_to_cloud(c, new_space, np.array([0, 1]),
                                  jax.random.PRNGKey(0))
    new = np.asarray(out.params)
    assert new.shape == (300, 3)
    np.testing.assert_array_equal(new[:, :2], old_params)
    assert np.all((new[:, 2] >= 0) & (new[:, 2] <= 1))
    np.testing.assert_array_equal(np.asarray(out.loglh), old_loglh)
    np.testing.assert_array_equal(np.asarray(out.weights), old_weights)
    np.testing.assert_array_equal(np.asarray(out.old_loglh), np.zeros(300))
    # logprior recomputed under extended prior
    expected_lp = np.asarray(jax.vmap(new_space.log_prior)(out.params))
    np.testing.assert_allclose(np.asarray(out.logprior), expected_lp, rtol=1e-12)


def test_add_parameters_to_cloud_from_file(tmp_path):
    """The reference's String overload (src/particle.jl:705-710): load the
    old cloud from a saved file."""
    from smc_jax import io as smc_io
    old_space = ParamSpace([
        parameter("a", 0.0, (-10, 10), prior=Normal(0, 1)),
        parameter("b", 0.0, (-10, 10), prior=Normal(0, 2)),
    ])
    new_space = ParamSpace([
        parameter("a", 0.0, (-10, 10), prior=Normal(0, 1)),
        parameter("b", 0.0, (-10, 10), prior=Normal(0, 2)),
        parameter("cnew", 0.5, (0, 1), prior=Uniform(0, 1)),
    ])
    c = _cloud(n=100, p=2)
    path = str(tmp_path / "old_cloud.npz")
    smc_io.save_cloud(path, c)
    # boolean-mask form of old_para_inds (the reference's BitVector)
    mask = np.array([True, True, False])
    out = add_parameters_to_cloud(path, new_space, mask,
                                  jax.random.PRNGKey(1))
    np.testing.assert_allclose(np.asarray(out.params)[:, :2],
                               np.asarray(c.params))
    assert out.stage_index == 1 and out.resamples == 0
    assert out.accept_rate == 0.25
    # mismatched mask length raises
    with pytest.raises(ValueError):
        add_parameters_to_cloud(c, new_space, np.array([True, False]),
                                jax.random.PRNGKey(1))


def test_add_parameters_to_cloud_regime_switching():
    """Regime-switching extension: the new space's regimes are flat columns
    (reference regime_switching kwarg -> n_parameters_regime_switching,
    src/particle.jl:717). Old flat columns preserved, new base+regime
    columns drawn from the prior."""
    from smc_jax.models.linear import rs_linear_parameters
    new_space = ParamSpace(rs_linear_parameters(), regime_switching=True)
    p_new = new_space.n_para
    assert p_new > 9  # regimes flattened into extra columns

    # old estimation had only the 9 base columns; sigma columns (2,5,8)
    # must be valid under the U(0,10) prior and (1e-5,1e5) bounds
    old_cols = np.arange(9)
    c = _cloud(n=50, p=9)
    sig = jnp.abs(c.params[:, 2::3]) + 0.1
    c.params = c.params.at[:, 2::3].set(jnp.clip(sig, 0.1, 9.0))
    out = add_parameters_to_cloud(c, new_space, old_cols,
                                  jax.random.PRNGKey(2),
                                  regime_switching=True)
    assert np.asarray(out.params).shape == (50, p_new)
    np.testing.assert_allclose(np.asarray(out.params)[:, :9],
                               np.asarray(c.params))
    assert np.all(np.isfinite(np.asarray(out.logprior)))


def test_parity_setters_and_orientation():
    """Reference setters accept both (N,P) and (P,N) orientations
    (src/particle.jl:284-330) and distinguish set vs multiply for weights."""
    c = _cloud(n=20, p=3)
    vals = np.random.default_rng(3).normal(size=(20, 3))
    c.update_draws(vals.T)  # (P, N) orientation
    np.testing.assert_array_equal(np.asarray(c.params), vals)
    np.testing.assert_array_equal(np.asarray(c.get_vals()), vals.T)
    np.testing.assert_array_equal(np.asarray(c.get_vals(transpose=False)), vals)

    c.set_weights(np.full(20, 2.0))
    c.update_weights(np.full(20, 3.0))  # multiplicative
    np.testing.assert_allclose(np.asarray(c.weights), np.full(20, 6.0))

    c.update_loglh(np.arange(20.0))
    c.update_logprior(-np.arange(20.0))
    c.update_old_loglh(np.ones(20))
    np.testing.assert_array_equal(np.asarray(c.logpost),
                                  np.arange(20.0) - np.arange(20.0))

    c.update_mutation(5, np.array([9.0, 9.0, 9.0]), 1.0, 2.0, 3.0, 0.5)
    np.testing.assert_array_equal(np.asarray(c.params[5]), [9.0, 9.0, 9.0])
    assert float(c.loglh[5]) == 1.0 and float(c.accept[5]) == 0.5

    c.update_val(2, np.array([7.0, 7.0, 7.0]))
    c.update_weight(2, 11.0)
    assert float(c.weights[2]) == 11.0

    c.update_cloud(vals, c.loglh, c.logprior, c.old_loglh, c.accept)
    np.testing.assert_array_equal(np.asarray(c.params), vals)

    c.update_acceptance_rate()
    np.testing.assert_allclose(c.accept_rate, float(np.mean(np.asarray(c.accept))))


def test_mode_extractors():
    c = _cloud(n=100, p=2)
    i_ll = int(np.argmax(np.asarray(c.loglh)))
    i_lp = int(np.argmax(np.asarray(c.loglh) + np.asarray(c.logprior)))
    np.testing.assert_array_equal(np.asarray(c.likeliest_particle_value()),
                                  np.asarray(c.params)[i_ll])
    np.testing.assert_array_equal(
        np.asarray(c.highest_posterior_particle_value()),
        np.asarray(c.params)[i_lp])
