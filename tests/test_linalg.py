"""Batched small-matrix solves (ops/linalg.py) vs numpy."""

import numpy as np
import jax.numpy as jnp
import pytest

from smc_jax.ops.linalg import (gj_solve, gj_inv, small_psd_logdet_solve,
                                bl_gj_solve, bl_psd_fast_solve)


def test_gj_solve_matches_numpy():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(5, 7, 7))
    B = rng.normal(size=(5, 7, 3))
    X = np.asarray(gj_solve(jnp.asarray(A), jnp.asarray(B)))
    for i in range(5):
        np.testing.assert_allclose(X[i], np.linalg.solve(A[i], B[i]),
                                   rtol=1e-9, atol=1e-11)


def test_gj_solve_needs_pivoting():
    """Zero leading pivot: partial pivoting must handle it."""
    A = np.array([[0.0, 1.0], [1.0, 0.0]])
    B = np.array([[2.0], [3.0]])
    X = np.asarray(gj_solve(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(X, [[3.0], [2.0]], rtol=1e-12)


def test_gj_inv():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(3, 6, 6)) + 2 * np.eye(6)
    Ainv = np.asarray(gj_inv(jnp.asarray(A)))
    for i in range(3):
        np.testing.assert_allclose(Ainv[i] @ A[i], np.eye(6), atol=1e-9)


def test_gj_logabsdet():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(4, 5, 5))
    _, lad = gj_solve(jnp.asarray(A), jnp.asarray(np.zeros((4, 5, 1))),
                      return_logabsdet=True)
    expected = np.linalg.slogdet(A)[1]
    np.testing.assert_allclose(np.asarray(lad), expected, rtol=1e-9)


def test_small_psd_logdet_solve():
    rng = np.random.default_rng(3)
    M = rng.normal(size=(6, 6))
    F = M @ M.T + 3 * np.eye(6)
    b = rng.normal(size=(6, 2))
    X, logdet = small_psd_logdet_solve(jnp.asarray(F), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(X), np.linalg.solve(F, b),
                               rtol=1e-9)
    np.testing.assert_allclose(float(logdet), np.linalg.slogdet(F)[1],
                               rtol=1e-10)


def test_singular_yields_nonfinite():
    A = np.zeros((2, 2))
    X = np.asarray(gj_solve(jnp.asarray(A), jnp.asarray(np.ones((2, 1)))))
    assert not np.all(np.isfinite(X))


# ---------------------------------------------------------------------------
# Batch-last solves ([r, c, N], particles on the last axis): the unrolled
# Gauss-Jordan and the pivot-free PSD paths of the Kalman step.
# ---------------------------------------------------------------------------


def _bl(x):
    return jnp.asarray(np.moveaxis(x, 0, -1))


@pytest.mark.parametrize("n", [2, 3, 4, 6, 8])
def test_bl_gj_solve_matches_numpy(n):
    rng = np.random.default_rng(10 + n)
    N, m = 37, 3
    A = rng.normal(size=(N, n, n)) + 0.5 * np.eye(n)
    B = rng.normal(size=(N, n, m))
    X, lad = bl_gj_solve(_bl(A), _bl(B), return_logabsdet=True)
    np.testing.assert_allclose(np.moveaxis(np.asarray(X), -1, 0),
                               np.linalg.solve(A, B), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(lad), np.linalg.slogdet(A)[1],
                               rtol=1e-9)


def test_bl_gj_solve_needs_pivoting():
    """Zero leading pivot in every lane, and lanes that need different row
    swaps: partial pivoting must pick each lane's own pivot row."""
    A = np.array([[[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 2.0]],
                  [[0.0, 0.0, 1.0], [0.0, 3.0, 0.0], [1.0, 0.0, 0.0]]])
    B = np.array([[[2.0], [3.0], [4.0]], [[1.0], [6.0], [5.0]]])
    X = np.moveaxis(np.asarray(bl_gj_solve(_bl(A), _bl(B))), -1, 0)
    np.testing.assert_allclose(X[0, :, 0], [3.0, 2.0, 2.0], rtol=1e-12)
    np.testing.assert_allclose(X[1, :, 0], [5.0, 2.0, 1.0], rtol=1e-12)


@pytest.mark.parametrize("n_obs", [1, 2, 3, 4])
def test_bl_psd_fast_solve_matches_numpy(n_obs):
    """Cofactor closed form at n_obs=3, unrolled Cholesky otherwise: both
    give the solution and log det of a symmetric positive definite F."""
    rng = np.random.default_rng(20 + n_obs)
    N, m = 29, 4
    G = rng.normal(size=(N, n_obs, n_obs))
    F = G @ np.swapaxes(G, 1, 2) + 0.3 * np.eye(n_obs)
    B = rng.normal(size=(N, n_obs, m))
    X, logdet = bl_psd_fast_solve(_bl(F), _bl(B))
    np.testing.assert_allclose(np.moveaxis(np.asarray(X), -1, 0),
                               np.linalg.solve(F, B), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(logdet), np.linalg.slogdet(F)[1],
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n_obs", [2, 3])
def test_non_pd_innovation_gives_neg_inf(n_obs):
    """A non-PD innovation covariance: the fast solve's log det is not
    finite (Cholesky and cofactor paths), and the batch-last Kalman
    likelihood maps the lane to -inf while a PD lane stays finite."""
    from smc_jax.models.dsge import bl_kalman_loglike_chandrasekhar
    F = np.stack([np.eye(n_obs), -np.eye(n_obs)])
    _, logdet = bl_psd_fast_solve(_bl(F), _bl(np.ones((2, n_obs, 1))))
    assert np.isfinite(np.asarray(logdet)[0])
    assert not np.isfinite(np.asarray(logdet)[1])

    n_s, N = 2, 2
    T_mat = np.tile(0.5 * np.eye(n_s), (N, 1, 1))
    R = np.tile(np.eye(n_s), (N, 1, 1))
    Q = np.tile(np.eye(n_s), (N, 1, 1))
    Z = np.tile(np.ones((n_obs, n_s)), (N, 1, 1))
    H = np.stack([0.1 * np.eye(n_obs), -10.0 * np.eye(n_obs)])
    d = np.zeros((N, n_obs))
    data = np.random.default_rng(3).normal(size=(n_obs, 6))
    ll = np.asarray(bl_kalman_loglike_chandrasekhar(
        _bl(T_mat), _bl(R), _bl(Q), _bl(Z), _bl(d), _bl(H),
        jnp.asarray(data)))
    assert np.isfinite(ll[0])
    assert ll[1] == -np.inf
