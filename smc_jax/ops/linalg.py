"""Batched small-matrix linear algebra without custom calls.

SMC over DSGE models solves ~10^4 particles x (n x n) systems per stage
with n <= ~40. For small static n the formulation here is an **unrolled
Gauss-Jordan elimination with partial pivoting**: n fused steps of batched
elementwise ops and rank-1 updates that vectorize over the particle batch
in f64, with no library call per matrix. Pivot selection and row swaps
are masked selects; singular systems yield inf/nan that downstream
validity checks catch (the framework's -inf totality discipline).
Whether a library batched solver beats these on a given device is an
open measurement (ROADMAP).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gj_solve(A, B, return_logabsdet: bool = False):
    """Solve A X = B by Gauss-Jordan with partial pivoting, batched over any
    leading dims. A: [..., n, n], B: [..., n, m]. n must be static.

    With return_logabsdet=True also returns log|det A| (sum of log|pivots|)
    — free from the elimination, used for Gaussian likelihoods.
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    n = A.shape[-1]
    M = jnp.concatenate([A, B.astype(A.dtype)], axis=-1)  # [..., n, n+m]
    batch = M.shape[:-2]
    rows = jnp.arange(n)
    logabsdet = jnp.zeros(batch, A.dtype)

    for k in range(n):
        # partial pivot: largest |entry| in column k at/below row k
        col = jnp.abs(M[..., :, k])
        col = jnp.where(rows >= k, col, -jnp.inf)
        p = jnp.argmax(col, axis=-1)                      # [...]
        # swap rows k <-> p WITHOUT a gather: per-batch row extraction as a
        # masked reduction over the (tiny) row axis plus elementwise
        # selects, at O(n) extra elementwise work.
        onehot_p = (rows == p[..., None])                   # [..., n]
        # select-then-reduce (not multiply): 0 * inf would turn a non-finite
        # entry anywhere in the column into NaN for the whole batch
        # element; where keeps row p exactly.
        row_p = jnp.sum(jnp.where(onehot_p[..., None], M, 0.0), axis=-2)
        row_k = M[..., k, :]
        is_k = (rows == k)[..., None]                       # [n, 1] mask
        is_p = onehot_p[..., None]
        M = jnp.where(is_k, row_p[..., None, :],
                      jnp.where(is_p, row_k[..., None, :], M))

        pivot = M[..., k, k]
        logabsdet = logabsdet + jnp.log(jnp.abs(pivot))
        # eliminate column k everywhere except row k (Jordan step), then
        # normalize row k — two fused batched elementwise updates
        factor = M[..., :, k] / pivot[..., None]
        factor = factor.at[..., k].set(0.0)
        M = M - factor[..., None] * M[..., k:k + 1, :]
        M = M.at[..., k, :].set(M[..., k, :] / pivot[..., None])

    X = M[..., :, n:]
    if return_logabsdet:
        return X, logabsdet
    return X


def gj_inv(A):
    """Batched inverse via gj_solve against the identity."""
    n = A.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)
    return gj_solve(A, eye)


# ---------------------------------------------------------------------------
# Batch-LAST variants: matrices stored [r, c, N] with the particle batch on
# the minor (contiguous) axis.
#
# Each matrix element (i, j) of every particle is then one contiguous
# [N] vector, so elementwise work sweeps memory contiguously and
# per-particle matmuls become sums of broadcast multiply-adds over the tiny
# static contraction axis.
# ---------------------------------------------------------------------------


def bl_matmul(A, B):
    """[i,j,N] @ [j,k,N] -> [i,k,N] per-particle matmul, as a statically
    unrolled sum of rank-broadcast multiply-adds over the tiny j axis —
    elementwise work that XLA fuses — rather than a batched dot_general
    of thousands of tiny matrices."""
    j = A.shape[1]
    acc = A[:, 0, None, :] * B[None, 0, :, :]
    for jj in range(1, j):
        acc = acc + A[:, jj, None, :] * B[None, jj, :, :]
    return acc


def bl_transpose(A):
    """[i,j,N] -> [j,i,N]."""
    return jnp.swapaxes(A, 0, 1)


def bl_gj_solve(A, B, return_logabsdet: bool = False):
    """Batch-last Gauss-Jordan with partial pivoting: A [n,n,N], B [n,m,N]
    -> X [n,m,N] (and optionally log|det A| [N]). Same elimination as
    gj_solve, with the pivot swap as mask-selects over the tiny row axis —
    no gathers, every op a [rows, cols, N] elementwise/reduce."""
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    n = A.shape[0]
    M = jnp.concatenate([A, B.astype(A.dtype)], axis=1)   # [n, n+m, N]
    nb = A.shape[-1]
    rows = jnp.arange(n)
    logabsdet = jnp.zeros((nb,), A.dtype)

    for k in range(n):
        col = jnp.abs(M[:, k, :])                          # [n, N]
        col = jnp.where(rows[:, None] >= k, col, -jnp.inf)
        p = jnp.argmax(col, axis=0)                        # [N]
        onehot_p = (rows[:, None] == p[None, :])           # [n, N]
        # select-then-reduce, not multiply-sum: see gj_solve (0 * inf -> NaN)
        row_p = jnp.sum(jnp.where(onehot_p[:, None, :], M, 0.0), axis=0)
        row_k = M[k]                                       # [n+m, N]
        is_k = (rows == k)[:, None, None]
        is_p = onehot_p[:, None, :]
        M = jnp.where(is_k, row_p[None],
                      jnp.where(is_p, row_k[None], M))

        pivot = M[k, k, :]                                 # [N]
        logabsdet = logabsdet + jnp.log(jnp.abs(pivot))
        factor = M[:, k, :] / pivot[None, :]               # [n, N]
        factor = factor.at[k].set(0.0)
        M = M - factor[:, None, :] * M[k:k + 1, :, :]
        M = M.at[k].set(M[k] / pivot[None, :])

    X = M[:, n:, :]
    if return_logabsdet:
        return X, logabsdet
    return X


def bl_psd_logdet_solve(F, B):
    """(X, logdet) batch-last twin of small_psd_logdet_solve — same caveat:
    logdet is log|det| from |pivots|; callers guard definiteness."""
    return bl_gj_solve(F, B, return_logabsdet=True)


# ---------------------------------------------------------------------------
# Pivot-free PSD fast paths.
#
# The Gauss-Jordan pivot chain (argmax over the row axis + one-hot compare
# + two where-selects per elimination step) is a serial chain inside every
# Kalman step. For symmetric positive-definite systems — every solve
# inside the Kalman step — pivoting is unnecessary:
#   * n == 3 (An-Schorfheide n_obs): closed-form cofactor/adjugate solve.
#     9 cofactors + det as pure FMAs and ONE reciprocal per particle, with
#     no argmax/select at all.
#   * general n (Smets-Wouters n_obs=7): statically unrolled Cholesky +
#     unrolled forward/back substitution. Unpivoted is numerically CORRECT
#     for PSD matrices (growth factor 1); n sqrts + n reciprocals replace
#     the pivot chains and n*(n+m) division rows of GJ.
# Non-PSD inputs surface as log(det<=0) = nan/-inf or sqrt(neg) = nan,
# which the callers' totality guards already map to -inf loglh — the same
# rejection discipline as the GJ path's quad/diag/trace witnesses.
# ---------------------------------------------------------------------------


def bl_psd_cofactor_solve3(F, B):
    """(X, logdet) for symmetric PD F [3,3,N], B [3,m,N] by the adjugate:
    X = adj(F) B / det(F). Exactly one division per particle; logdet =
    log(det) is nan for det <= 0 (caller guards catch it)."""
    a, b, c = F[0, 0], F[0, 1], F[0, 2]
    d, e = F[1, 1], F[1, 2]
    f = F[2, 2]
    # cofactors of the symmetric matrix (adjugate is symmetric)
    C00 = d * f - e * e
    C01 = c * e - b * f
    C02 = b * e - c * d
    C11 = a * f - c * c
    C12 = b * c - a * e
    C22 = a * d - b * b
    det = a * C00 + b * C01 + c * C02
    inv_det = 1.0 / det
    logdet = jnp.log(det)
    B0, B1, B2 = B[0], B[1], B[2]                      # [m, N]
    X0 = (C00 * B0 + C01 * B1 + C02 * B2) * inv_det
    X1 = (C01 * B0 + C11 * B1 + C12 * B2) * inv_det
    X2 = (C02 * B0 + C12 * B1 + C22 * B2) * inv_det
    return jnp.stack([X0, X1, X2], axis=0), logdet


def bl_chol_solve(F, B):
    """(X, logdet) for symmetric PD F [n,n,N], B [n,m,N] by statically
    unrolled Cholesky + substitution. n must be small and static."""
    n = F.shape[0]
    L = [[None] * n for _ in range(n)]
    inv_diag = [None] * n
    logdet = 0.0
    for j in range(n):
        s = F[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = jnp.sqrt(s)
        inv_diag[j] = 1.0 / Ljj
        logdet = logdet + jnp.log(s)
        L[j][j] = Ljj
        for i in range(j + 1, n):
            t = F[i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_diag[j]
    # forward: L y = B   (y rows are [m, N])
    y = [None] * n
    for i in range(n):
        t = B[i]
        for k in range(i):
            t = t - L[i][k] * y[k]
        y[i] = t * inv_diag[i]
    # backward: L' x = y
    x = [None] * n
    for i in range(n - 1, -1, -1):
        t = y[i]
        for k in range(i + 1, n):
            t = t - L[k][i] * x[k]
        x[i] = t * inv_diag[i]
    return jnp.stack(x, axis=0), logdet


def bl_psd_fast_solve(F, B):
    """Pivot-free PSD (X, logdet): cofactor closed form at n=3, unrolled
    Cholesky otherwise. Drop-in for bl_psd_logdet_solve on PSD systems."""
    if F.shape[0] == 3:
        return bl_psd_cofactor_solve3(F, B)
    return bl_chol_solve(F, B)


def small_psd_logdet_solve(F, B, jitter: float = 0.0):
    """(X, logdet) for symmetric positive-definite F: Gauss-Jordan solve and
    log-determinant in one elimination. CAVEAT: the logdet is log|det| (the
    elimination accumulates log|pivot|), so a non-PD F with positive |det|
    returns a finite, silently-wrong Gaussian normalizer — callers that may
    feed non-PD matrices must guard definiteness themselves (the Kalman
    filters check the innovation quad v'F^-1 v >= 0, models/dsge.py)."""
    if jitter:
        n = F.shape[-1]
        F = F + jitter * jnp.eye(n, dtype=F.dtype)
    return gj_solve(F, B, return_logabsdet=True)
