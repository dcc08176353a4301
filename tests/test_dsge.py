"""DSGE stack: linear-time-iteration RE solver, Lyapunov doubling, Kalman
filter, and the An-Schorfheide model (solution sanity, determinacy
rejection, likelihood behavior)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy import linalg as sla

from smc_jax.models.dsge import (solve_linear_re, lyapunov_doubling,
                                 kalman_loglike, _spectral_radius_bound)
from smc_jax.models.as_dsge import (an_schorfheide, an_schorfheide_parameters,
                                    generate_as_data, TRUE_PARAMS,
                                    PARAM_NAMES, _system, _shock_cov,
                                    _measurement)
from smc_jax.params import ParamSpace


def test_spectral_radius_bound():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(6, 6))
    rho = np.max(np.abs(np.linalg.eigvals(M)))
    est = float(_spectral_radius_bound(jnp.asarray(M)))
    assert abs(est - rho) / rho < 0.05


def test_solve_simple_ar_system():
    """Backward-only system (C = 0): x_t = rho x_{t-1} + eps, solved exactly."""
    rho = 0.9
    A = jnp.asarray([[rho]])
    B = jnp.asarray([[-1.0]])
    C = jnp.zeros((1, 1))
    D = jnp.asarray([[1.0]])
    X, M, ok = solve_linear_re(A, B, C, D)
    assert bool(ok)
    np.testing.assert_allclose(float(X[0, 0]), rho, rtol=1e-12)
    np.testing.assert_allclose(float(M[0, 0]), 1.0, rtol=1e-12)


def test_solve_forward_looking_system():
    """Purely forward system x_t = a E[x_{t+1}] + eps with |a| < 1: unique
    stable solution is x_t = eps_t (X = 0, M = 1)."""
    a = 0.5
    A = jnp.zeros((1, 1))
    B = jnp.asarray([[-1.0]])
    C = jnp.asarray([[a]])
    D = jnp.asarray([[1.0]])
    X, M, ok = solve_linear_re(A, B, C, D)
    assert bool(ok)
    np.testing.assert_allclose(float(X[0, 0]), 0.0, atol=1e-12)
    np.testing.assert_allclose(float(M[0, 0]), 1.0, rtol=1e-12)


def test_explosive_system_rejected():
    A = jnp.asarray([[1.5]])   # x_t = 1.5 x_{t-1}: explosive
    B = jnp.asarray([[-1.0]])
    C = jnp.zeros((1, 1))
    D = jnp.asarray([[1.0]])
    _, _, ok = solve_linear_re(A, B, C, D)
    assert not bool(ok)


def test_lyapunov_doubling_matches_scipy():
    rng = np.random.default_rng(1)
    T = 0.9 * sla.orth(rng.normal(size=(4, 4)))  # spectral radius 0.9
    Q0 = rng.normal(size=(4, 4))
    Q = Q0 @ Q0.T
    P = np.asarray(lyapunov_doubling(jnp.asarray(T), jnp.asarray(Q)))
    expected = sla.solve_discrete_lyapunov(T, Q)
    np.testing.assert_allclose(P, expected, rtol=1e-8)


def test_kalman_loglike_matches_direct_gaussian():
    """For a 1-D AR(1) state observed directly, compare against the exact
    multivariate-normal likelihood of the data vector."""
    rho, q, h = 0.8, 0.5, 0.1
    T_mat = jnp.asarray([[rho]])
    R_mat = jnp.asarray([[1.0]])
    Q = jnp.asarray([[q]])
    Z = jnp.asarray([[1.0]])
    d = jnp.zeros(1)
    H = jnp.asarray([[h]])
    rng = np.random.default_rng(2)
    T_len = 50
    data = rng.normal(size=(1, T_len))

    got = float(kalman_loglike(T_mat, R_mat, Q, Z, d, H, jnp.asarray(data)))

    # exact: y ~ N(0, Sigma) with Sigma_ij = h 1{i=j} + q rho^|i-j| / (1-rho^2)
    idx = np.arange(T_len)
    Sigma = q * rho ** np.abs(idx[:, None] - idx[None, :]) / (1 - rho ** 2) \
        + h * np.eye(T_len)
    from scipy.stats import multivariate_normal
    expected = multivariate_normal.logpdf(data[0], mean=np.zeros(T_len),
                                          cov=Sigma)
    np.testing.assert_allclose(got, expected, rtol=1e-8)


# ---- An-Schorfheide ----


def test_as_solves_at_true_params():
    A, B, C, D = _system(jnp.asarray(TRUE_PARAMS))
    X, M, ok = solve_linear_re(A, B, C, D)
    assert bool(ok)
    # transition residual tiny
    resid = np.asarray(A + B @ X + C @ (X @ X))
    assert np.max(np.abs(resid)) < 1e-9
    # persistence of exogenous states shows up on the diagonal
    Xn = np.asarray(X)
    assert abs(Xn[3, 3] - 0.95) < 1e-9  # rho_g
    assert abs(Xn[4, 4] - 0.9) < 1e-9   # rho_z


def test_as_indeterminate_when_taylor_principle_violated():
    """psi1 < 1 (passive policy) makes the AS model indeterminate; the
    solver must reject the draw like gensys does."""
    theta = TRUE_PARAMS.copy()
    theta[2] = 0.5  # psi1
    A, B, C, D = _system(jnp.asarray(theta))
    _, _, ok = solve_linear_re(A, B, C, D)
    assert not bool(ok)


def test_as_loglike_finite_and_peaked_at_truth():
    model = an_schorfheide()
    data = generate_as_data(T=80, seed=1793)
    ll_true = float(model.loglike(jnp.asarray(TRUE_PARAMS), data))
    assert np.isfinite(ll_true)
    # perturbed params fit worse
    theta2 = TRUE_PARAMS.copy()
    theta2[0] = 3.5   # tau
    theta2[10] = 0.8  # sig_R
    ll_pert = float(model.loglike(jnp.asarray(theta2), data))
    assert np.isfinite(ll_pert)
    assert ll_true > ll_pert
    # indeterminate draw -> -inf
    theta3 = TRUE_PARAMS.copy()
    theta3[2] = 0.5
    assert float(model.loglike(jnp.asarray(theta3), data)) == -np.inf


def test_as_loglike_vmaps():
    model = an_schorfheide()
    data = generate_as_data(T=80, seed=1793)
    space = ParamSpace(an_schorfheide_parameters())
    draws = space.sample_prior(jax.random.PRNGKey(0), 32)
    lls = np.asarray(jax.jit(jax.vmap(lambda th: model.loglike(th, data)))(draws))
    assert lls.shape == (32,)
    # some prior draws solve, some don't; all total (no nan)
    assert not np.any(np.isnan(lls))
    assert np.any(np.isfinite(lls))


def test_as_prior_sampling_in_bounds():
    space = ParamSpace(an_schorfheide_parameters())
    draws = np.asarray(space.sample_prior(jax.random.PRNGKey(1), 5000))
    names = dict(zip(PARAM_NAMES, range(13)))
    assert draws[:, names["kappa"]].min() >= 0.0
    assert draws[:, names["kappa"]].max() <= 1.0
    assert draws[:, names["sig_R"]].min() > 0.0
    # Gamma(mean 2, std .5) prior on tau
    assert abs(draws[:, names["tau"]].mean() - 2.0) < 0.05


def test_chandrasekhar_matches_standard_kalman():
    """Chandrasekhar recursions (Morf-Sidhu-Kailath form, cf. Herbst 2015)
    must reproduce the standard filter's log-likelihood — reference fast path
    examples/dsge_models/small_dsge_model.jl:37-43.

    Adversarial sample size: 2,048 prior draws (the round-1 16-draw version
    missed a recursion bug that tail draws expose). The contract has three
    parts, because the recursion — unlike the self-correcting Riccati
    iteration — accumulates roundoff on numerically extreme prior-tail draws
    (true ll <= -7e5 nats, i.e. ~e^-700000 relative posterior mass):

      1. no false-finite: ch is -inf wherever the solver rejected;
      2. the statistically relevant region (ll within 1e4 nats of the best
         draw) agrees tightly — these draws carry ALL the SMC weight;
      3. safety: no draw ever *reports* a competitive likelihood it doesn't
         have (deep-tail draws may be inaccurate but must stay deep-tail,
         and the filter's divergence guard turns blow-ups into -inf) —
         the reference maps the same numerical failures to -Inf via
         try/catch PosDefException (src/initialization.jl:46-54)."""
    from smc_jax.models.dsge import kalman_loglike_chandrasekhar
    from smc_jax.models.as_dsge import an_schorfheide, generate_as_data
    from smc_jax.models.dsge import solve_linear_re
    from smc_jax.params import ParamSpace

    model = an_schorfheide()
    data = jnp.asarray(generate_as_data(T=80))
    space = ParamSpace(model.parameters)
    key = jax.random.PRNGKey(7)
    draws = space.sample_prior(key, 2048)

    def both(theta):
        A, B, C, D = model.system_fn(theta)
        X, M, ok = solve_linear_re(A, B, C, D)
        Q = model.shock_cov_fn(theta)
        d_obs, Z, H = model.measurement_fn(theta)
        std = kalman_loglike(X, M, Q, Z, d_obs, H, data)
        ch = kalman_loglike_chandrasekhar(X, M, Q, Z, d_obs, H, data)
        return jnp.where(ok, std, -jnp.inf), jnp.where(ok, ch, -jnp.inf)

    std, ch = jax.jit(jax.vmap(both))(draws)
    std, ch = np.asarray(std), np.asarray(ch)
    finite_s, finite_c = np.isfinite(std), np.isfinite(ch)
    assert finite_s.sum() > 500
    # (1) no false-finite where the RE solver rejected the draw
    assert not np.any(finite_c & ~finite_s)
    # (2) tight agreement on every draw in the statistically relevant region
    plausible = finite_s & (std > std[finite_s].max() - 1e4)
    assert plausible.sum() > 500
    assert finite_c[plausible].all()
    np.testing.assert_allclose(ch[plausible], std[plausible],
                               rtol=1e-8, atol=1e-4)
    # (3) deep-tail draws never report a competitive likelihood
    tail = finite_s & finite_c & ~plausible
    if tail.any():
        assert ch[tail].max() < std[finite_s].max() - 1e4


def test_chandrasekhar_divergence_guard_rejects_monster_draw():
    """Regression: this prior draw (found at 16,384 AS prior draws, bench
    seed 0) makes the Chandrasekhar recursion diverge POSITIVELY to
    +3.2e13 — finite, so the isfinite scrub passes it, and exp(dphi*ll)
    then overflows the first correction step to NaN ESS. Forensics: the
    innovation quad v'F^-1 v goes negative at t=13 (F loses definiteness;
    Gauss-Jordan's log|pivot| logdet cannot see the sign), diag(F) goes
    negative later, trace(F) explodes. The filter's divergence guards must
    keep it out of the running: -inf, or (the divergence path is chaotic in
    the last bits, so the guard's trigger step varies across devices) at
    worst an astronomically negative value — NEVER positive/competitive."""
    from smc_jax.models.as_dsge import an_schorfheide, generate_as_data

    theta = jnp.asarray([
        1.800259549185, 0.011782497078, 2.009463554221, 0.234229140884,
        0.600543060125, 6.020757238268, 0.428645989435, 0.813271250556,
        0.628567047724, 0.000230941121, 0.642572622015, 0.956991515353,
        0.439683103852])
    model = an_schorfheide()
    data = generate_as_data(T=80, seed=1793)
    ll = float(model.loglike(theta, data))
    assert ll < -1e6, ll  # unguarded round-1 code returned +3.2e13


def test_no_competitive_loglh_in_16k_prior_draws():
    """The round-1 2,048-draw battery missed the positive-divergence mode;
    at 16,384 draws (the bench's initialization) every draw must be
    either -inf or deep in the tail relative to plausible fits."""
    from smc_jax.models.as_dsge import an_schorfheide, generate_as_data
    from smc_jax.params import ParamSpace

    model = an_schorfheide()
    data = jnp.asarray(generate_as_data(T=80, seed=1793))
    space = ParamSpace(model.parameters)
    key, _ = jax.random.split(jax.random.PRNGKey(0))
    _, kd = jax.random.split(key)
    draws = space.sample_prior(kd, 16384)
    llb = jax.jit(jax.vmap(lambda th: model.loglike(th, data)))
    out = []
    for i in range(0, 16384, 4096):
        out.append(np.asarray(llb(draws[i:i + 4096])))
    lls = np.concatenate(out)
    assert not np.any(np.isnan(lls))
    assert not np.any(np.isposinf(lls))
    finite = np.isfinite(lls)
    assert finite.mean() > 0.9  # the guard must not mass-reject
    assert lls[finite].max() < 0.0


def test_chandrasekhar_matches_standard_kalman_sw():
    """Same agreement at Smets-Wouters scale (n_s ~ 50, n_obs = 7) where the
    low-rank covariance recursion actually pays."""
    from smc_jax.models.dsge import kalman_loglike_chandrasekhar, solve_linear_re
    from smc_jax.models.sw_dsge import smets_wouters, generate_sw_data, TRUE_PARAMS

    model = smets_wouters()
    data = jnp.asarray(generate_sw_data(T=80))
    theta = jnp.asarray(TRUE_PARAMS, jnp.float64)
    A, B, C, D = model.system_fn(theta)
    X, M, ok = solve_linear_re(A, B, C, D)
    assert bool(ok)
    Q = model.shock_cov_fn(theta)
    d_obs, Z, H = model.measurement_fn(theta)
    std = float(kalman_loglike(X, M, Q, Z, d_obs, H, data))
    ch = float(kalman_loglike_chandrasekhar(X, M, Q, Z, d_obs, H, data))
    assert np.isfinite(std)
    np.testing.assert_allclose(ch, std, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Batch-last likelihood path (round 3): loglike_batched must agree with the
# vmapped per-particle path — same RE solutions, same Kalman values, same
# -inf rejections — to float64 tolerance.
# ---------------------------------------------------------------------------


def test_batch_last_likelihood_matches_vmapped():
    from smc_jax.models.as_dsge import (an_schorfheide,
                                        an_schorfheide_parameters,
                                        generate_as_data)
    from smc_jax.params import ParamSpace
    model = an_schorfheide()
    data = generate_as_data(T=40, seed=5)
    space = ParamSpace(an_schorfheide_parameters())
    thetas = space.sample_prior(jax.random.PRNGKey(17), 128)
    ll_vmap = np.asarray(jax.vmap(lambda th: model.loglike(th, data))(thetas))
    ll_bl = np.asarray(model.loglike_batched(thetas, data))
    finite = np.isfinite(ll_vmap)
    # identical rejection pattern
    np.testing.assert_array_equal(finite, np.isfinite(ll_bl))
    assert finite.sum() > 20  # the fixture actually exercises the filter
    # deep prior-tail draws (|loglh| ~ 1e6) are reassociation-limited;
    # they carry zero weight in any correction step. Competitive draws
    # must agree to f64 accuracy.
    np.testing.assert_allclose(ll_bl[finite], ll_vmap[finite], rtol=2e-5)
    competitive = finite & (ll_vmap > ll_vmap[finite].max() - 200.0)
    assert competitive.sum() > 5
    np.testing.assert_allclose(ll_bl[competitive], ll_vmap[competitive],
                               rtol=1e-9, atol=1e-7)


@pytest.mark.parametrize("n", [1, 7, 130])
def test_batch_last_matches_vmapped_at_batch_size(n):
    """Batch sizes that are not powers of two (and a batch of one) through
    the batch-last path, against the vmapped per-particle reference on
    draws near the data-generating parameters (all finite)."""
    model = an_schorfheide()
    data = generate_as_data(T=20, seed=5)
    rng = np.random.default_rng(n)
    thetas = TRUE_PARAMS * (1.0 + 0.05 * rng.standard_normal((n, 13)))
    thetas[:, 7:10] = np.minimum(thetas[:, 7:10], 0.98)   # rho_R, g, z < 1
    ll_bl = np.asarray(jax.jit(
        lambda th: model.loglike_batched(th, data))(thetas))
    ll_vm = np.asarray(jax.jit(jax.vmap(
        lambda th: model.loglike(th, data)))(thetas))
    assert ll_bl.shape == (n,)
    assert np.all(np.isfinite(ll_vm))
    np.testing.assert_allclose(ll_bl, ll_vm, rtol=1e-9)


def _stable_backward_systems(n_lanes, seed, n_s=3):
    """n_lanes stable backward-looking systems B x_t = -A x_{t-1} - D eps,
    batch-last [n_s, n_s, N]."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n_s, n_s, n_lanes))
    B = np.zeros((n_s, n_s, n_lanes))
    C = np.zeros((n_s, n_s, n_lanes))
    D = np.zeros((n_s, 3, n_lanes))
    for k in range(n_lanes):
        B[..., k] = np.eye(n_s)
        A[..., k] = -np.diag(rng.uniform(0.2, 0.8, n_s))
        D[..., k] = -np.eye(n_s)
    return A, B, C, D


def test_kalman_nan_lane_does_not_poison_other_lanes():
    """A NaN transition matrix in ONE lane of the batch-last Kalman
    likelihood: that lane is -inf and every other lane is bit-identical
    to the clean run (no reduction across the particle axis)."""
    from smc_jax.models.dsge import (bl_solve_linear_re,
                                     bl_kalman_loglike_chandrasekhar)
    N = 64
    A, B, C, D = _stable_backward_systems(N, seed=11)
    X, M, ok = bl_solve_linear_re(*(jnp.asarray(v) for v in (A, B, C, D)),
                                  n_iter=4)
    Q = np.tile(np.eye(3)[:, :, None], (1, 1, N))
    Z = np.tile(np.eye(3)[:, :, None], (1, 1, N)) * 1.5
    d = np.zeros((3, N))
    H = np.tile((0.1 * np.eye(3))[:, :, None], (1, 1, N))
    data = np.random.default_rng(11).standard_normal((3, 5))
    kf = jax.jit(bl_kalman_loglike_chandrasekhar)
    ll_clean = np.asarray(kf(X, M, Q, Z, d, H, data))
    X_bad = np.asarray(X).copy()
    X_bad[..., 17] = np.nan
    ll_bad = np.asarray(kf(X_bad, M, Q, Z, d, H, data))
    assert np.all(np.isfinite(ll_clean))
    assert ll_bad[17] == -np.inf
    keep = np.arange(N) != 17
    np.testing.assert_array_equal(ll_bad[keep], ll_clean[keep])


def test_re_solve_nan_lane_does_not_poison_other_lanes():
    """Mirror for the batch-last RE solve: a NaN lane gets ok=False and the
    other lanes keep bit-identical solutions and determinacy decisions."""
    from smc_jax.models.dsge import bl_solve_linear_re
    N = 64
    A, B, C, D = _stable_backward_systems(N, seed=13)
    solve = jax.jit(lambda a, b, c, d: bl_solve_linear_re(a, b, c, d,
                                                          n_iter=6))
    Xc, Mc, okc = solve(A, B, C, D)
    A_bad = A.copy()
    A_bad[0, 0, 23] = np.nan
    Xb, Mb, okb = solve(A_bad, B, C, D)
    okb_, okc_ = np.asarray(okb), np.asarray(okc)
    assert okc_.all() and not okb_[23]
    keep = np.arange(N) != 23
    np.testing.assert_array_equal(okb_[keep], okc_[keep])
    np.testing.assert_array_equal(np.asarray(Xb)[..., keep],
                                  np.asarray(Xc)[..., keep])
    np.testing.assert_array_equal(np.asarray(Mb)[..., keep],
                                  np.asarray(Mc)[..., keep])


def test_batch_last_re_solver_matches():
    from smc_jax.models.dsge import bl_solve_linear_re
    from smc_jax.models.as_dsge import (an_schorfheide,
                                        an_schorfheide_parameters)
    from smc_jax.params import ParamSpace
    model = an_schorfheide()
    space = ParamSpace(an_schorfheide_parameters())
    thetas = space.sample_prior(jax.random.PRNGKey(3), 64)
    A, B, C, D = jax.vmap(model.system_fn)(thetas)
    Xv, Mv, okv = jax.vmap(solve_linear_re)(A, B, C, D)
    bl = lambda x: jnp.moveaxis(x, 0, -1)
    Xb, Mb, okb = bl_solve_linear_re(bl(A), bl(B), bl(C), bl(D))
    np.testing.assert_array_equal(np.asarray(okv), np.asarray(okb))
    np.testing.assert_allclose(np.moveaxis(np.asarray(Xb), -1, 0),
                               np.asarray(Xv), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.moveaxis(np.asarray(Mb), -1, 0),
                               np.asarray(Mv), rtol=1e-9, atol=1e-11)


def test_as_2obs_batched_matches_vmapped():
    """n_obs=2 AS variant: the batch-last likelihood must route the
    innovation solves through bl_chol_solve (the 3x3 cofactor closed form
    does not apply) and agree with the vmapped f64 reference path
    """
    from smc_jax.models.as_dsge import (an_schorfheide_2obs,
                                        an_schorfheide_parameters,
                                        generate_as_data)
    from smc_jax.params import ParamSpace
    model = an_schorfheide_2obs()
    data3 = generate_as_data(T=24, seed=5)
    data = data3[:2]                       # growth + inflation rows
    space = ParamSpace(an_schorfheide_parameters())
    thetas = space.sample_prior(jax.random.PRNGKey(2), 128)
    ll_bl = np.asarray(model.loglike_batched(thetas, data))
    ll_vm = np.asarray(jax.vmap(lambda th: model.loglike(th, data))(thetas))
    fin = np.isfinite(ll_bl) & np.isfinite(ll_vm)
    assert np.mean(np.isfinite(ll_bl) == np.isfinite(ll_vm)) > 0.99
    assert fin.sum() > 60
    np.testing.assert_allclose(ll_bl[fin], ll_vm[fin], rtol=1e-8)
