"""Resampling kernels: unbiasedness and variance structure of all three
methods (reference test/resample.jl checks seeded goldens; RNG streams don't
transfer, so we check the defining statistical properties instead —
SURVEY.md §4 implication (1))."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from smc_jax.ops.resample import resample


def _weights(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.exponential(size=n)
    return jnp.asarray(w)


@pytest.mark.parametrize("method", ["systematic", "multinomial", "polyalgo",
                                    "stratified", "metropolis"])
def test_unbiased_counts(method):
    """E[#copies of i] = N * w_i for every method."""
    w = _weights(200)
    wn = np.asarray(w / w.sum())
    n = 200
    counts = np.zeros(n)
    reps = 400
    for r in range(reps):
        idx = np.asarray(resample(jax.random.PRNGKey(r), w, method=method))
        counts += np.bincount(idx, minlength=n)
    expected = reps * n * wn
    # Chi^2-ish check: relative error of total counts small
    err = np.abs(counts - expected) / np.maximum(expected, 1.0)
    assert np.median(err) < 0.25


def test_systematic_counts_within_floor_ceil():
    """Systematic resampling guarantees #copies in {floor(Nw), ceil(Nw)}."""
    w = _weights(64, seed=3)
    wn = np.asarray(w / w.sum())
    n = 64
    for r in range(20):
        idx = np.asarray(resample(jax.random.PRNGKey(r), w, method="systematic"))
        counts = np.bincount(idx, minlength=n)
        assert np.all(counts >= np.floor(n * wn) - 1e-9)
        assert np.all(counts <= np.ceil(n * wn) + 1e-9)


def test_degenerate_weight_selects_single_particle():
    w = jnp.asarray(np.r_[np.zeros(9), 1.0])
    for method in ("systematic", "multinomial", "polyalgo", "stratified"):
        idx = np.asarray(resample(jax.random.PRNGKey(0), w, method=method))
        assert np.all(idx == 9)


def test_n_parts_subsample():
    """Bridge path draws fewer indices (reference src/smc_main.jl:262-270)."""
    w = _weights(100)
    idx = np.asarray(resample(jax.random.PRNGKey(0), w, method="systematic",
                              n_parts=37))
    assert idx.shape == (37,)
    assert idx.min() >= 0 and idx.max() < 100


def test_invalid_method_raises():
    with pytest.raises(ValueError, match="Invalid resampler"):
        resample(jax.random.PRNGKey(0), _weights(10), method="bogus")


def test_uniform_weights_systematic_is_identity():
    """With exactly uniform weights and any offset, systematic resampling
    maps spoke i into cell i."""
    n = 50
    w = jnp.ones(n)
    idx = np.asarray(resample(jax.random.PRNGKey(0), w, method="systematic"))
    np.testing.assert_array_equal(idx, np.arange(n))


# ---------------------------------------------------------------------------
# Metropolis resampler bias: the Doeblin
# bound B = ceil(kappa ln(1/eps)) with kappa = w_max/w_bar must deliver
# total-variation bias <= eps; a short chain on a skewed fixture must not.
# ---------------------------------------------------------------------------


def _ancestor_tv(w, idx_counts):
    """TV distance between the empirical ancestor distribution and the
    target normalized weights."""
    p = np.asarray(w) / np.sum(w)
    q = idx_counts / idx_counts.sum()
    return 0.5 * np.abs(p - q).sum()


def _metropolis_counts(w, n_iter, n_draws=200_000, seed=0):
    n = w.shape[0]
    idx = np.asarray(resample(jax.random.PRNGKey(seed), jnp.asarray(w),
                              method="metropolis", n_parts=n_draws,
                              n_iter=n_iter))
    return np.bincount(idx, minlength=n).astype(np.float64)


def test_metropolis_n_iter_bound():
    from smc_jax.ops.resample import metropolis_n_iter
    # uniform weights: kappa = 1 -> B = ln(1/eps)
    assert metropolis_n_iter(np.ones(100), eps=0.01) == 5
    # skewed fixture
    rng = np.random.default_rng(7)
    w = np.exp(2.0 * rng.standard_normal(64))
    kappa = w.max() / w.mean()
    b = metropolis_n_iter(w, eps=0.01)
    assert b == int(np.ceil(kappa * np.log(100.0)))


def test_metropolis_bias_bounded_at_doeblin_length():
    """With B from the Doeblin bound the empirical ancestor distribution is
    within eps + MC error of the weights; a far-too-short chain on the same
    skewed fixture shows measurably larger bias."""
    from smc_jax.ops.resample import metropolis_n_iter
    rng = np.random.default_rng(11)
    n = 64
    w = np.exp(2.0 * rng.standard_normal(n))   # heavy skew
    kappa = w.max() / w.mean()
    assert kappa > 7.0                          # genuinely past the default-32 regime
    eps = 0.01
    b = metropolis_n_iter(w, eps=eps)

    n_draws = 200_000
    mc_err = n * np.sqrt(1.0 / (4.0 * n_draws))   # ~worst-case TV MC noise
    tv_good = _ancestor_tv(w, _metropolis_counts(w, b, n_draws))
    tv_short = _ancestor_tv(w, _metropolis_counts(w, 2, n_draws))
    assert tv_good < eps + mc_err
    assert tv_short > 3.0 * (eps + mc_err)
    # multinomial reference: pure MC noise
    idx = np.asarray(resample(jax.random.PRNGKey(3), jnp.asarray(w),
                              method="multinomial", n_parts=n_draws))
    tv_multi = _ancestor_tv(w, np.bincount(idx, minlength=n).astype(float))
    assert tv_good < tv_multi + eps + mc_err


def test_metropolis_adaptive_default_bias_bounded_high_kappa():
    """The DEFAULT metropolis path (n_iter=None) computes the Doeblin chain
    length on device, so smc(resampling_method='metropolis') carries the
    eps TV bound even at the weight skew of a genuine resample stage
    Fixture: a post-correction
    weight vector from a coarse schedule, kappa ~ 50 — far past the old
    static-32 validity regime (kappa <~ 7)."""
    rng = np.random.default_rng(5)
    n = 128
    loglh = rng.standard_normal(n) * 3.0
    w = np.exp(loglh - loglh.max())            # correction-step shape
    kappa = w.max() / w.mean()
    assert kappa > 20.0
    eps = 0.01
    n_draws = 200_000
    idx = np.asarray(resample(jax.random.PRNGKey(2), jnp.asarray(w),
                              method="metropolis", n_parts=n_draws))
    counts = np.bincount(idx, minlength=n).astype(np.float64)
    mc_err = n * np.sqrt(1.0 / (4.0 * n_draws))
    assert _ancestor_tv(w, counts) < eps + mc_err
