"""ParamSpace: flattening, bounds -> -inf, regime columns, prior sampling."""

import numpy as np
import jax
import jax.numpy as jnp
from scipy import stats as sps

from smc_jax.distributions import Normal, Uniform, TruncatedNormal
from smc_jax.params import ParamSpace, parameter, Untransformed
from smc_jax.models.linear import linear_parameters, rs_linear_parameters


def _space():
    return ParamSpace(linear_parameters())


def test_basic_layout():
    sp = _space()
    assert sp.n_para == 9
    assert sp.n_free == 9
    assert sp.names[0] == "alpha1" and sp.names[8] == "sigma3"


def test_log_prior_matches_scipy():
    sp = _space()
    theta = jnp.asarray([0.5, 1.0, 2.0, -1.0, 0.3, 0.7, 2.2, 0.0, 1.1])
    expected = (sum(sps.norm.logpdf(v, 0, 1000.0)
                    for v in [0.5, 1.0, -1.0, 0.3, 2.2, 0.0])
                + 3 * sps.uniform.logpdf(0.5, 0, 1000.0))
    np.testing.assert_allclose(float(sp.log_prior(theta)), expected, rtol=1e-10)


def test_log_prior_out_of_bounds_is_neg_inf():
    sp = _space()
    theta = np.ones(9)
    theta[2] = -1.0  # sigma1 below its (1e-5, 1e5) bound
    assert float(sp.log_prior(jnp.asarray(theta))) == -np.inf


def test_log_prior_batched():
    sp = _space()
    thetas = jnp.asarray(np.random.default_rng(0).uniform(0.1, 2.0, (7, 9)))
    batch = np.asarray(sp.log_prior(thetas))
    single = np.asarray([float(sp.log_prior(thetas[k])) for k in range(7)])
    np.testing.assert_allclose(batch, single, rtol=1e-12)


def test_sample_prior_respects_fixed():
    params = linear_parameters()
    params[0] = parameter("alpha1", 7.5, (-1e5, 1e5), prior=Normal(0, 1000.0),
                          fixed=True)
    sp = ParamSpace(params)
    draws = np.asarray(sp.sample_prior(jax.random.PRNGKey(0), 100))
    assert draws.shape == (100, 9)
    assert np.all(draws[:, 0] == 7.5)
    assert draws[:, 1].std() > 100  # Normal(0,1000) actually sampled


def test_sample_prior_distribution():
    sp = _space()
    draws = np.asarray(sp.sample_prior(jax.random.PRNGKey(1), 100_000))
    # Uniform(0, 1000) sigma columns
    for col in (2, 5, 8):
        assert abs(draws[:, col].mean() - 500.0) < 5.0
        assert draws[:, col].min() >= 0.0 and draws[:, col].max() <= 1000.0


def test_truncated_normal_sampling_and_logpdf():
    sp = ParamSpace([parameter("x", 0.5, (0.0, 1.0),
                               prior=TruncatedNormal(0.0, 1.0))])
    draws = np.asarray(sp.sample_prior(jax.random.PRNGKey(2), 50_000))
    assert draws.min() >= 0.0 and draws.max() <= 1.0
    # logpdf renormalized over [0, 1]
    lp = float(sp.log_prior(jnp.asarray([0.5])))
    expected = sps.truncnorm.logpdf(0.5, 0.0, 1.0, loc=0.0, scale=1.0)
    np.testing.assert_allclose(lp, expected, rtol=1e-8)


# ---- regime switching ------------------------------------------------------


def test_regime_flattening_layout():
    sp = ParamSpace(rs_linear_parameters(), regime_switching=True)
    # 9 base + (alpha1..3, beta1..3 each with 2 extra regimes) = 9 + 12 = 21
    assert sp.n_para == 21
    # appended order: per parameter, regimes 2..R (src/smc_main.jl:221-234)
    assert sp.names[9] == "alpha1_reg2"
    assert sp.names[10] == "alpha1_reg3"
    assert sp.names[11] == "beta1_reg2"
    # alpha3 fixed in all regimes
    fixed_names = [n for n, f in zip(sp.names, sp.fixed) if f]
    assert set(fixed_names) == {"alpha3", "alpha3_reg2", "alpha3_reg3"}
    # 21 - 3 fixed = 18 free
    assert sp.n_free == 18


def test_regime_matrix_gathers():
    sp = ParamSpace(rs_linear_parameters(), regime_switching=True)
    rm = sp.regime_matrix()
    assert rm.shape == (9, 3)
    # alpha1 (col 0): regime1 -> col 0, regime2 -> col 9, regime3 -> col 10
    np.testing.assert_array_equal(rm[0], [0, 9, 10])
    # sigma1 (col 2) has one regime: all map to col 2
    np.testing.assert_array_equal(rm[2], [2, 2, 2])


def test_regime_priors_differ():
    sp = ParamSpace(rs_linear_parameters(), regime_switching=True)
    # beta1 regime2 prior Normal(0, 12), regime3 Normal(0, 15)
    i2 = sp.names.index("beta1_reg2")
    i3 = sp.names.index("beta1_reg3")
    assert sp.prior_b[i2] == 12.0
    assert sp.prior_b[i3] == 15.0


def test_no_regime_columns_when_flag_off():
    sp = ParamSpace(rs_linear_parameters(), regime_switching=False)
    assert sp.n_para == 9
