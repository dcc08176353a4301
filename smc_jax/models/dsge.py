"""Linear DSGE model family: batched solver + Kalman-filter likelihood.

The reference delegates DSGE likelihoods to the external DSGE.jl package
(state-space solution by QZ/gensys + Kalman filter, reference
examples/dsge_models/small_dsge_model.jl:35-44). QZ (generalized Schur) has
no batched accelerator kernel, so a line-for-line port would run one
particle at a time on the host. This design instead solves the linear
rational-expectations system

    A x_{t-1} + B x_t + C E_t[x_{t+1}] + D eps_t = 0
    =>  x_t = X x_{t-1} + M eps_t,   X solving  A + B X + C X^2 = 0

by **cyclic reduction** (Bini & Meini) — a quadratically-convergent
fixed-iteration loop of small batched matmuls and mixed-precision solves
that vmaps across particles (ideal for SMC, where thousands of solves run
per stage). Determinacy is checked Rendahl-style: the solution is the
unique stable one iff rho(X) < 1 and rho(-(B + C X)^{-1} C) < 1; spectral
radii are estimated by log-spaced repeated squaring (matmuls only).
Failures (non-convergence, indeterminacy, explosiveness) yield -inf
log-likelihood, mirroring gensys' rejection of such draws.

The likelihood is the standard Kalman filter over the T observations as a
`lax.scan` (SURVEY.md §5 long-context note: the sequential axis here is
time, T ~ 80-200, inside each particle), with the initial covariance from a
doubling-iteration Lyapunov solve.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from smc_jax.ops.linalg import (gj_solve, gj_inv, small_psd_logdet_solve,
                                bl_matmul, bl_transpose, bl_gj_solve,
                                bl_psd_fast_solve)

_LOG_2PI = 1.8378770664093453


def _bl_matvec(A, x):
    """[i,j,N] @ [j,N] -> [i,N] as unrolled FMAs (see bl_matmul)."""
    j = A.shape[1]
    acc = A[:, 0, :] * x[None, 0, :]
    for jj in range(1, j):
        acc = acc + A[:, jj, :] * x[None, jj, :]
    return acc


def _bl_sym(A):
    return 0.5 * (A + bl_transpose(A))


# ---------------------------------------------------------------------------
# Solver: cyclic reduction + determinacy checks
# ---------------------------------------------------------------------------


def _spectral_radius_bound(M, n_squarings: int = 12):
    """rho(M) upper estimate via ||M^(2^k)||_F^(1/2^k): repeated squaring
    with renormalization; matmul-only, so it vmaps.
    ||M^k||^(1/k) >= rho always, converging from above — so `estimate < 1`
    never passes an explosive matrix, and 2^12 powers shrink the non-normal
    transient factor C^(1/4096) close enough to 1 for production systems
    (SW-scale transients C ~ 1e6 inflate the estimate by ~0.3%)."""
    def body(_, carry):
        M, log_scale = carry
        nrm = jnp.sqrt(jnp.sum(M * M)) + 1e-300
        M = M / nrm
        return M @ M, 2.0 * (log_scale + jnp.log(nrm))

    # After k squarings of the normalized matrix, accumulated log||.|| tracks
    # log ||M^(2^k)|| ; divide by 2^k for the radius bound.
    n = M.shape[0]
    M0 = M
    log_scale = jnp.float64(0.0)
    Mk, log_scale = jax.lax.fori_loop(0, n_squarings, body, (M0, log_scale))
    nrm_last = jnp.sqrt(jnp.sum(Mk * Mk)) + 1e-300
    total = log_scale + jnp.log(nrm_last)
    return jnp.exp(total / (2.0 ** n_squarings))


def solve_linear_re(A, B, C, D, n_iter: int = 16, tol: float = 1e-8):
    """Solve A x_{t-1} + B x_t + C E_t x_{t+1} + D eps = 0 for the unique
    stable solution x_t = X x_{t-1} + M eps_t by **cyclic reduction**
    (Bini & Meini) on the quadratic C X^2 + B X + A = 0 — quadratically
    convergent (machine precision in ~9 steps on Smets-Wouters vs ~400 for
    plain linear time iteration), built from batched matmuls/solves only.

    Determinacy is verified Rendahl-style after the fact: residual small,
    rho(X) < 1, and rho(-(B + C X)^{-1} C) < 1 (uniqueness). Any failure —
    non-convergence, instability, indeterminacy, singular pivots (nans) —
    returns ok=False with zeroed outputs; the likelihood maps that to -inf,
    mirroring gensys' rejection of such draws."""

    def cr_body(_, carry):
        A0, A1, A2, Ah = carry
        # one Gauss-Jordan elimination for both right-hand sides
        SA = gj_solve(A1, jnp.concatenate([A0, A2], axis=-1))
        n = A0.shape[-1]
        SA0, SA2 = SA[..., :n], SA[..., n:]
        A2SA0 = A2 @ SA0
        Ah = Ah - A2SA0
        A1n = A1 - A0 @ SA2 - A2SA0
        return -A0 @ SA0, A1n, -A2 @ SA2, Ah

    _, _, _, Ah = jax.lax.fori_loop(0, n_iter, cr_body, (A, B, C, B))
    X = -gj_solve(Ah, A)
    lhs = B + C @ X
    M = -gj_solve(lhs, D)

    resid = A + B @ X + C @ (X @ X)
    scale = jnp.maximum(jnp.max(jnp.abs(A)), 1.0)
    converged = jnp.max(jnp.abs(resid)) < tol * scale
    stable = _spectral_radius_bound(X) < 1.0
    # uniqueness: forward operator F = -(B + C X)^{-1} C must be stable too
    F = -gj_solve(lhs, C)
    unique = _spectral_radius_bound(F) < 1.0
    finite = jnp.all(jnp.isfinite(X)) & jnp.all(jnp.isfinite(M))
    ok = converged & stable & unique & finite
    X = jnp.where(ok, X, jnp.zeros_like(X))
    M = jnp.where(ok, M, jnp.zeros_like(M))
    return X, M, ok


def lyapunov_doubling(T, Q, n_iter: int = 30):
    """Solve P = T P T' + Q by doubling: P_{k+1} = P_k + A_k P_k A_k',
    A_{k+1} = A_k A_k. Converges quadratically for stable T."""
    def body(_, carry):
        Ak, Pk = carry
        return Ak @ Ak, Pk + Ak @ Pk @ Ak.T

    _, P = jax.lax.fori_loop(0, n_iter, body, (T, Q))
    return P


# ---------------------------------------------------------------------------
# Kalman filter likelihood (lax.scan over time)
# ---------------------------------------------------------------------------


def kalman_loglike(T_mat, R_mat, Q, Z, d_obs, H, data, P0=None):
    """Gaussian log-likelihood of `data` [n_obs, T] under the state space
        s_t = T s_{t-1} + R eta_t,  eta ~ N(0, Q)
        y_t = d + Z s_t + u_t,      u ~ N(0, H)
    Total: returns -inf on any non-finite intermediate instead of raising
    (the reference catches PosDefException etc. — src/initialization.jl:46-54)."""
    n_s = T_mat.shape[0]
    RQR = R_mat @ Q @ R_mat.T
    if P0 is None:
        P0 = lyapunov_doubling(T_mat, RQR)
    s0 = jnp.zeros(n_s)

    ys = data.T  # [T, n_obs]

    def step(carry, y):
        s, P, bad = carry
        s_pred = T_mat @ s
        P_pred = T_mat @ P @ T_mat.T + RQR
        y_pred = d_obs + Z @ s_pred
        v = y - y_pred
        F = Z @ P_pred @ Z.T + H
        F = 0.5 * (F + F.T)
        # one batched Gauss-Jordan gives innovation solve, gain solve, and
        # the log-determinant — no custom calls (ops/linalg.py rationale)
        rhs = jnp.concatenate([v[:, None], Z], axis=1)
        sol, logdet = small_psd_logdet_solve(F, rhs)
        alpha = sol[:, 0]
        quad = v @ alpha
        ll = -0.5 * (y.shape[0] * _LOG_2PI + logdet + quad)
        K = P_pred @ sol[:, 1:].T
        s_new = s_pred + K @ v
        P_new = P_pred - K @ (Z @ P_pred)
        P_new = 0.5 * (P_new + P_new.T)
        # v'F^-1 v < 0 means F lost definiteness (GJ's log|pivot| cannot
        # see the sign) and the step's ll is inflated — reject the draw
        bad = bad | (quad < 0.0)
        return (s_new, P_new, bad), ll

    (_, _, bad), lls = jax.lax.scan(step, (s0, P0, jnp.bool_(False)), ys)
    total = jnp.sum(lls)
    return jnp.where(jnp.isfinite(total) & ~bad, total, -jnp.inf)


def kalman_loglike_chandrasekhar(T_mat, R_mat, Q, Z, d_obs, H, data, P0=None):
    """Kalman-filter log-likelihood via the **Chandrasekhar recursions**
    (Herbst 2015) — the fast path the reference's DSGE examples select with
    `use_chand_recursion=true` (reference examples/dsge_models/
    small_dsge_model.jl:37-43).

    Instead of propagating the n_s x n_s predicted covariance P_t (O(n_s^3)
    per step), propagate its *increment* in factored form
    P_{t+1|t} - P_{t|t-1} = W_t M_t W_t' with W_t [n_s, n_obs] and
    M_t [n_obs, n_obs]:

        F_{t+1} = F_t + Z W_t M_t W_t' Z'
        K_{t+1} = K_t + T W_t M_t W_t' Z'
        W_{t+1} = (T - K_t F_t^{-1} Z) W_t
        M_{t+1} = M_t - M_t W_t' Z' F_{t+1}^{-1} Z W_t M_t

    (the Morf-Sidhu-Kailath form: note the minus sign and that the M-update
    uses the *updated* innovation covariance F_{t+1} — verified to machine
    precision against the exact Riccati iteration; the t-indexed plus-sign
    variant drifts from the true covariance increment immediately).

    initialized from the stationary covariance P1 = Lyapunov(T, RQR'):
    K_1 = T P1 Z', F_1 = Z P1 Z' + H, W_1 = K_1, M_1 = -F_1^{-1} (so that
    W_1 M_1 W_1' = P_{2|1} - P_{1|0}). Per-step cost is O(n_s^2 n_obs) —
    with n_obs << n_s (SW: 7 vs ~50) the covariance-update matmuls shrink by
    ~n_s/n_obs. Requires stationarity (it is: solve_linear_re rejects
    explosive draws). Valid only with time-invariant system matrices and the
    unconditional P0, both true here. Total like `kalman_loglike`: any
    non-finite intermediate yields -inf rather than raising."""
    n_s = T_mat.shape[0]
    n_o = Z.shape[0]
    RQR = R_mat @ Q @ R_mat.T
    if P0 is None:
        P0 = lyapunov_doubling(T_mat, RQR)

    F1 = Z @ P0 @ Z.T + H
    F1 = 0.5 * (F1 + F1.T)
    K1 = T_mat @ (P0 @ Z.T)
    M1 = -gj_inv(F1)
    M1 = 0.5 * (M1 + M1.T)
    s0 = jnp.zeros(n_s)

    ys = data.T  # [T, n_obs]
    tr_F1 = jnp.trace(F1)

    def step(carry, y):
        s, K, F, W, M, bad = carry
        v = y - d_obs - Z @ s
        # one elimination gives F^{-1}v, F^{-1}(ZW), and log|F|
        rhs = jnp.concatenate([v[:, None], Z @ W], axis=1)
        sol, logdet = small_psd_logdet_solve(F, rhs)
        Finv_v = sol[:, 0]
        Finv_ZW = sol[:, 1:]
        quad = v @ Finv_v
        ll = -0.5 * (n_o * _LOG_2PI + logdet + quad)
        s_new = T_mat @ s + K @ Finv_v

        ZW = Z @ W                               # [n_o, n_o]
        MWtZt = M @ ZW.T                         # M W'Z'    [n_o, n_o]
        WMWtZt = W @ MWtZt                       # W M W'Z'  [n_s, n_o]
        F_new = F + Z @ WMWtZt
        F_new = 0.5 * (F_new + F_new.T)
        K_new = K + T_mat @ WMWtZt
        W_new = T_mat @ W - K @ Finv_ZW
        # M-update needs F_{t+1}^{-1}: one more small PSD solve (n_o x n_o)
        Fnew_inv_ZW, _ = small_psd_logdet_solve(F_new, ZW)
        M_new = M - MWtZt @ Fnew_inv_ZW @ M
        M_new = 0.5 * (M_new + M_new.T)
        # Divergence guards. In exact arithmetic M_t is negative
        # semidefinite, so F_t is monotone non-increasing from F_1, stays
        # PSD, and every innovation quad v'F^-1 v is >= 0. Unlike the
        # Riccati iteration the Chandrasekhar recursion is NOT
        # self-correcting: on numerically extreme prior-tail draws roundoff
        # flips M's definiteness and the filter silently returns garbage —
        # measured failure signature (forensics on a +3e13-loglh draw):
        # quad goes negative at the divergence onset, then diag(F) goes
        # negative, then trace(F) explodes. Each is a cheap exact witness;
        # flagged draws yield -inf, mirroring the reference's
        # PosDefException -> -Inf discipline (src/initialization.jl:46-54).
        bad = (bad
               | (quad < 0.0)                                  # F lost PSD
               | jnp.any(jnp.diag(F_new) <= 0.0)               # F collapsed
               | (jnp.trace(F_new) > tr_F1 * (1.0 + 1e-6) + 1e-12))  # F grew
        return (s_new, K_new, F_new, W_new, M_new, bad), ll

    carry0 = (s0, K1, F1, K1, M1, jnp.bool_(False))
    (_, _, _, _, _, bad), lls = jax.lax.scan(step, carry0, ys)
    total = jnp.sum(lls)
    return jnp.where(jnp.isfinite(total) & ~bad, total, -jnp.inf)


# ---------------------------------------------------------------------------
# Batch-LAST likelihood path: the whole particle batch as the minor
# (contiguous) axis of every intermediate.
#
# The vmapped path stores per-particle matrices as [N, r, c], so one
# element (i, j) of every particle's matrix is strided r*c apart. The SAME
# math over [r, c, N] arrays makes every elementwise op a contiguous,
# coalesced sweep over the particle axis. See ops/linalg.py bl_* for the
# layout contract. Each stage is wrapped in a jax.named_scope so profiler
# traces attribute device time to re_solve / lyapunov / kalman_scan.
# ---------------------------------------------------------------------------


def bl_spectral_radius_bound(M, n_squarings: int = 12):
    """Batch-last twin of _spectral_radius_bound: M [n,n,N] -> rho bound [N]."""
    def body(_, carry):
        M, log_scale = carry
        nrm = jnp.sqrt(jnp.sum(M * M, axis=(0, 1))) + 1e-300
        M = M / nrm
        return bl_matmul(M, M), 2.0 * (log_scale + jnp.log(nrm))

    log_scale = jnp.zeros(M.shape[-1], M.dtype)
    Mk, log_scale = jax.lax.fori_loop(0, n_squarings, body, (M, log_scale))
    nrm_last = jnp.sqrt(jnp.sum(Mk * Mk, axis=(0, 1))) + 1e-300
    total = log_scale + jnp.log(nrm_last)
    return jnp.exp(total / (2.0 ** n_squarings))


def bl_solve_linear_re(A, B, C, D, n_iter: int = 16, tol: float = 1e-8):
    """Batch-last cyclic reduction: A/B/C [n,n,N], D [n,k,N] ->
    (X [n,n,N], M [n,k,N], ok [N]). Same algorithm and guards as
    solve_linear_re."""
    n = A.shape[0]

    def cr_body(_, carry):
        A0, A1, A2, Ah = carry
        SA = bl_gj_solve(A1, jnp.concatenate([A0, A2], axis=1))
        SA0, SA2 = SA[:, :n, :], SA[:, n:, :]
        A2SA0 = bl_matmul(A2, SA0)
        Ah = Ah - A2SA0
        A1n = A1 - bl_matmul(A0, SA2) - A2SA0
        return -bl_matmul(A0, SA0), A1n, -bl_matmul(A2, SA2), Ah

    _, _, _, Ah = jax.lax.fori_loop(0, n_iter, cr_body, (A, B, C, B))
    X = -bl_gj_solve(Ah, A)
    lhs = B + bl_matmul(C, X)
    M = -bl_gj_solve(lhs, D)

    resid = A + bl_matmul(B, X) + bl_matmul(C, bl_matmul(X, X))
    scale = jnp.maximum(jnp.max(jnp.abs(A), axis=(0, 1)), 1.0)
    converged = jnp.max(jnp.abs(resid), axis=(0, 1)) < tol * scale
    stable = bl_spectral_radius_bound(X) < 1.0
    F = -bl_gj_solve(lhs, C)
    unique = bl_spectral_radius_bound(F) < 1.0
    finite = (jnp.all(jnp.isfinite(X), axis=(0, 1))
              & jnp.all(jnp.isfinite(M), axis=(0, 1)))
    ok = converged & stable & unique & finite
    X = jnp.where(ok[None, None, :], X, 0.0)
    M = jnp.where(ok[None, None, :], M, 0.0)
    return X, M, ok


def bl_lyapunov_doubling(T, Q, n_iter: int = 30):
    """Batch-last doubling for P = T P T' + Q, all [n,n,N]."""
    def body(_, carry):
        Ak, Pk = carry
        return (bl_matmul(Ak, Ak),
                Pk + bl_matmul(Ak, bl_matmul(Pk, bl_transpose(Ak))))

    _, P = jax.lax.fori_loop(0, n_iter, body, (T, Q))
    return P


def bl_kalman_loglike_chandrasekhar(T_mat, R_mat, Q, Z, d_obs, H, data):
    """Batch-last Chandrasekhar Kalman likelihood: system matrices [.,.,N],
    d_obs [n_o,N], shared data [n_o,T] -> loglh [N]. Identical recursions
    and divergence guards as kalman_loglike_chandrasekhar.

    The innovation-covariance solves use the pivot-free PSD fast path
    (ops/linalg.py bl_psd_fast_solve: cofactor closed form at n_obs=3,
    unrolled Cholesky otherwise): every system solved inside the step is
    symmetric positive definite, so pivoting is unnecessary. Non-PD F
    yields nan/-inf logdet which the existing totality guards map to -inf,
    same rejection discipline."""
    n_s = T_mat.shape[0]
    n_o = Z.shape[0]
    nb = T_mat.shape[-1]
    RQR = bl_matmul(R_mat, bl_matmul(Q, bl_transpose(R_mat)))
    with jax.named_scope("lyapunov"):
        P0 = bl_lyapunov_doubling(T_mat, RQR)

    F1 = _bl_sym(bl_matmul(Z, bl_matmul(P0, bl_transpose(Z))) + H)
    K1 = bl_matmul(T_mat, bl_matmul(P0, bl_transpose(Z)))
    eye_o = jnp.broadcast_to(jnp.eye(n_o, dtype=F1.dtype)[:, :, None],
                             (n_o, n_o, nb))
    M1_neg, _ = bl_psd_fast_solve(F1, eye_o)
    M1 = _bl_sym(-M1_neg)
    s0 = jnp.zeros((n_s, nb), F1.dtype)

    ys = jnp.asarray(data).T  # [T, n_o] shared across the batch
    tr_F1 = jnp.trace(F1, axis1=0, axis2=1)

    def step(carry, y):
        s, K, F, W, M, bad = carry
        v = y[:, None] - d_obs - _bl_matvec(Z, s)          # [n_o, N]
        rhs = jnp.concatenate([v[:, None, :], bl_matmul(Z, W)], axis=1)
        sol, logdet = bl_psd_fast_solve(F, rhs)
        Finv_v = sol[:, 0, :]
        Finv_ZW = sol[:, 1:, :]
        quad = jnp.sum(v * Finv_v, axis=0)
        ll = -0.5 * (n_o * _LOG_2PI + logdet + quad)
        s_new = _bl_matvec(T_mat, s) + _bl_matvec(K, Finv_v)

        ZW = bl_matmul(Z, W)
        MWtZt = bl_matmul(M, bl_transpose(ZW))
        WMWtZt = bl_matmul(W, MWtZt)
        F_new = _bl_sym(F + bl_matmul(Z, WMWtZt))
        K_new = K + bl_matmul(T_mat, WMWtZt)
        W_new = bl_matmul(T_mat, W) - bl_matmul(K, Finv_ZW)
        Fnew_inv_ZW, _ = bl_psd_fast_solve(F_new, ZW)
        M_new = _bl_sym(M - bl_matmul(MWtZt, bl_matmul(Fnew_inv_ZW, M)))
        diag_F = jnp.diagonal(F_new, axis1=0, axis2=1)     # [N, n_o]
        bad = (bad
               | (quad < 0.0)
               | jnp.any(diag_F <= 0.0, axis=1)
               | (jnp.trace(F_new, axis1=0, axis2=1)
                  > tr_F1 * (1.0 + 1e-6) + 1e-12))
        return (s_new, K_new, F_new, W_new, M_new, bad), ll

    carry0 = (s0, K1, F1, K1, M1, jnp.zeros(nb, bool))
    with jax.named_scope("kalman_scan"):
        (_, _, _, _, _, bad), lls = jax.lax.scan(step, carry0, ys)
    total = jnp.sum(lls, axis=0)
    return jnp.where(jnp.isfinite(total) & ~bad, total, -jnp.inf)


# ---------------------------------------------------------------------------
# LinearDSGE: generic model container
# ---------------------------------------------------------------------------


class LinearDSGE:
    """A linear-RE DSGE defined by theta -> (A, B, C, D) structural matrices
    plus a measurement equation theta -> (d, Z, H). The likelihood composes
    solve_linear_re -> kalman_loglike, is total (bad draws -> -inf), and
    vmaps across particles into batched linear algebra."""

    def __init__(self, parameters: List, system_fn: Callable,
                 measurement_fn: Callable, n_shocks: int,
                 shock_cov_fn: Callable, use_chand_recursion: bool = True):
        self.parameters = parameters
        self.system_fn = system_fn
        self.measurement_fn = measurement_fn
        self.shock_cov_fn = shock_cov_fn
        self.n_shocks = n_shocks
        # Chandrasekhar recursions are the reference's DSGE fast path
        # (examples/dsge_models/small_dsge_model.jl:37-43); valid here
        # because the system is time-invariant with stationary P0.
        self.use_chand_recursion = use_chand_recursion

    def loglike(self, theta, data):
        A, B, C, D = self.system_fn(theta)
        X, M, ok = solve_linear_re(A, B, C, D)
        Q = self.shock_cov_fn(theta)
        d_obs, Z, H = self.measurement_fn(theta)
        kf = (kalman_loglike_chandrasekhar if self.use_chand_recursion
              else kalman_loglike)
        ll = kf(X, M, Q, Z, d_obs, H, jnp.asarray(data))
        return jnp.where(ok, ll, -jnp.inf)

    def loglike_batched(self, thetas, data):
        """Whole-cloud likelihood [N, P] -> [N] in the batch-LAST layout
        (bl_* functions above). Pass to smc() with batched=True. Same
        math, same -inf totality discipline as vmapping `loglike`, which
        is its plain reference; agrees with it to ~1e-10
        (tests/test_dsge.py)."""
        thetas = jnp.asarray(thetas, jnp.float64)
        if not self.use_chand_recursion:
            # plain-filter configs keep the vmapped path (accuracy parity
            # is what matters there, not throughput)
            return jax.vmap(lambda th: self.loglike(th, data))(thetas)
        A, B, C, D = jax.vmap(self.system_fn)(thetas)       # [N, r, c]
        Q = jax.vmap(self.shock_cov_fn)(thetas)
        d_obs, Z, H = jax.vmap(self.measurement_fn)(thetas)
        bl = lambda x: jnp.moveaxis(x, 0, -1)
        with jax.named_scope("re_solve"):
            X, M, ok = bl_solve_linear_re(bl(A), bl(B), bl(C), bl(D))
        ll = bl_kalman_loglike_chandrasekhar(
            X, M, bl(Q), bl(Z), jnp.moveaxis(d_obs, 0, -1), bl(H),
            jnp.asarray(data))
        return jnp.where(ok, ll, -jnp.inf)

    def simulate(self, theta, T: int, key, burn: int = 100):
        """Simulate observables [n_obs, T] from the model at theta."""
        A, B, C, D = self.system_fn(theta)
        X, M, ok = solve_linear_re(A, B, C, D)
        Q = self.shock_cov_fn(theta)
        d_obs, Z, H = self.measurement_fn(theta)
        chol_Q = jnp.linalg.cholesky(Q)
        eps = jax.random.normal(key, (T + burn, self.n_shocks),
                                dtype=jnp.float64) @ chol_Q.T

        def step(s, e):
            s_new = X @ s + M @ e
            return s_new, s_new

        _, states = jax.lax.scan(step, jnp.zeros(X.shape[0]), eps)
        obs = d_obs[:, None] + Z @ states[burn:].T
        return obs
