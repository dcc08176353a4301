"""Blocked random-walk Metropolis-Hastings mutation — the dominant hot loop.

Reference semantics (src/mutation.jl:56-138, src/helpers.jl:87-164):
per particle, for each of n_mh_steps x n_blocks, draw a proposal for the
block's free parameters from a 3-component mixture of normals built from the
cloud's weighted mean/cov,

    alpha     * N(theta_old_b, c^2 Sigma_b)
  + (1-a)/2   * N(theta_old_b, c^2 diag(Sigma_b))
  + (1-a)/2   * N(theta_bar_b, c^2 Sigma_b)

compute the forward/reverse mixture densities (needed because the third
component makes the proposal asymmetric when alpha < 1), evaluate prior and
likelihood, and accept with probability

  eta = exp[ phi_n (l_new - l_init) + (1-phi_n)(l_old_new - l_old_prev)
             + (prior_new - prior_init) + (q_rev - q_fwd) ]

where the (1-phi_n) old-data term implements generalized tempering
(src/mutation.jl:123-124). The per-particle `accept` field counts the
fraction of *parameters* moved (src/mutation.jl:126-136).

Design:
  * the whole cloud mutates in ONE jitted program: per-block shared math
    (weighted-cov sub-block eigendecomposition — the DegenerateMvNormal
    pseudo-inverse factor, rank-deficiency tolerant) is computed once, and
    particle-level work (proposal draw, densities, accept) is batched over
    [N, ...] arrays, with the user's log-likelihood batched over the cloud;
  * random parameter blocks are a device-side *permutation* of the free
    ordinals plus static equal-split boundaries (ceiling division, exactly
    generate_free_blocks, src/helpers.jl:215-231) — the block pattern changes
    every stage as data, so nothing recompiles;
  * rejection of invalid proposals is dataflow (-inf log-densities propagate
    to eta and the nan-safe `log u < log eta` comparison rejects), replacing
    the reference's try/catch (src/mutation.jl:112-121).

The reference draws one uniform before the loop and redraws after each
accept test (src/mutation.jl:66,133); every test therefore consumes an
independent uniform, which is what the batched fresh-per-test draw does.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from smc_jax.utils.misc import scrub_loglh

_LOG_2PI = 1.8378770664093453


def block_sizes(n_free: int, n_blocks: int) -> List[int]:
    """Equal-split block sizes by ceiling division; the last block absorbs the
    remainder (reference generate_free_blocks, src/helpers.jl:218-219)."""
    if n_blocks < 1 or n_blocks > n_free:
        raise ValueError(f"n_blocks={n_blocks} must be in [1, n_free={n_free}]")
    subset = -(-n_free // n_blocks)
    last = n_free - subset * (n_blocks - 1)
    if last <= 0:
        raise ValueError(
            f"n_blocks={n_blocks} leaves an empty last block for "
            f"n_free={n_free}; use fewer blocks")
    return [subset] * (n_blocks - 1) + [last]


def _deg_factor(cov, tol=1e-12):
    """Eigendecomposition factor of a PSD (possibly rank-deficient) matrix:
    the batched equivalent of DegenerateMvNormal's SVD/pseudo-inverse
    (reference src/helpers.jl:135-155 uses its logpdf). Returns
    (U, sqrt_lam, inv_lam, rank, logdet_plus)."""
    lam, U = jnp.linalg.eigh(cov)
    lam_max = jnp.maximum(jnp.max(lam), 0.0)
    keep = lam > tol * jnp.maximum(lam_max, 1e-300)
    safe = jnp.where(keep, lam, 1.0)
    sqrt_lam = jnp.where(keep, jnp.sqrt(safe), 0.0)
    inv_lam = jnp.where(keep, 1.0 / safe, 0.0)
    rank = jnp.sum(keep).astype(jnp.float64)
    logdet = jnp.sum(jnp.where(keep, jnp.log(safe), 0.0))
    return U, sqrt_lam, inv_lam, rank, logdet


def _bmat(x, M):
    """x [..., k] @ M [k, m] as a broadcast multiply-reduce instead of an
    f64 `dot_general`: at these tiny contraction sizes (k, m <= ~40) the
    broadcast form fuses into the surrounding elementwise work."""
    return jnp.sum(x[..., :, None] * M, axis=-2)


def _deg_logpdf(diff, U, inv_lam, rank, logdet, c):
    """log N(x; mu, c^2 Sigma) via the pseudo-inverse factor; diff = x - mu,
    batched over leading dims."""
    z = _bmat(diff, U)  # [..., k] projected onto eigenbasis
    quad = jnp.sum(z * z * inv_lam, axis=-1) / (c * c)
    return -0.5 * (rank * (_LOG_2PI + 2.0 * jnp.log(c)) + logdet + quad)


def _diag_logpdf(diff, diag_sd, c):
    """Sum of 1-D normal logpdfs with per-coordinate sd c*sqrt(Sigma_ii)
    (the reference's explicit product, src/helpers.jl:145-149)."""
    sd = c * jnp.maximum(diag_sd, 1e-150)
    z = diff / sd
    return jnp.sum(-0.5 * (_LOG_2PI + z * z) - jnp.log(sd), axis=-1)


def make_mutation_step(
    space,
    loglike_batched: Callable,
    n_blocks: int,
    n_mh_steps: int,
    alpha: float,
    old_loglike_batched: Optional[Callable] = None,
):
    """Build the jittable whole-cloud mutation kernel.

    Args:
      space: ParamSpace (free/fixed structure, vectorized log_prior).
      loglike_batched: thetas [N, P] -> loglh [N] on current data.
      n_blocks, n_mh_steps: static loop structure (src/smc_main.jl:124-127).
      alpha: mixture proportion (static; alpha == 1 short-circuits the
        proposal-density correction to 0 exactly as q0 == q1 then).
      old_loglike_batched: thetas [N, P] -> loglh [N] on OLD data, for
        generalized tempering (src/mutation.jl:106); None outside bridging.

    Returns mutation_step(key, params, loglh, logprior, old_loglh,
                          mean_free, cov_free, perm, c, phi_n, phi_n1)
      -> (params, loglh, logprior, old_loglh, accept_frac)
    """
    n_free = space.n_free
    sizes = block_sizes(n_free, n_blocks)
    offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    free_inds = jnp.asarray(space.free_inds, jnp.int32)
    log_alpha = np.log(alpha) if alpha > 0 else -np.inf
    log_half_rest = np.log((1.0 - alpha) / 2.0) if alpha < 1 else -np.inf
    bridging = old_loglike_batched is not None

    # All-equal block sizes let the block loop run as ONE lax.scan body
    # instead of n_blocks unrolled copies — the XLA program (and its
    # compile time, the round-2 bottleneck at 222 s for the fused
    # recursion) stops growing with n_blocks. Every production config
    # (1 block; SW's 3x12; the linear fixture's 3x3) is equal-split;
    # unequal splits keep the unrolled path. Bit-identical to the unroll:
    # same key-split order, same shapes per block.
    scan_blocks = len(set(sizes)) == 1 and n_blocks > 1

    def mutation_step(key, params, loglh, logprior, old_loglh,
                      mean_free, cov_free, perm, c, phi_n, phi_n1):
        n_parts = params.shape[0]
        accept_count = jnp.zeros(n_parts, jnp.float64)

        def block_body(carry, idx_f):
            key, params, loglh, logprior, old_loglh, accept_count = carry
            key, kcomp, keps, ku = jax.random.split(key, 4)
            k = idx_f.shape[0]
            idx_full = free_inds[idx_f]
            mu_b = mean_free[idx_f]
            cov_b = cov_free[idx_f][:, idx_f]
            U, sqrt_lam, inv_lam, rank, logdet = _deg_factor(cov_b)
            diag_sd = jnp.sqrt(jnp.clip(jnp.diag(cov_b), 0.0))

            # Block columns are read/written through a one-hot [k, P] mask
            # instead of dynamic-index gather/scatter: idx_full is traced
            # (the random block permutation is data). The mask forms are
            # bit-exact (each output element is one nonzero term plus
            # exact zero additions) and fuse into elementwise work.
            onehot = (idx_full[:, None] ==
                      jnp.arange(params.shape[1])).astype(params.dtype)
            theta_b = jnp.sum(params[:, None, :] * onehot, axis=-1)  # [N, k]

            # ---- mixture proposal draw (src/helpers.jl:87-100) --------
            eps = jax.random.normal(keps, (n_parts, k), dtype=jnp.float64)
            full_step = c * _bmat(eps * sqrt_lam, U.T)    # c * Sigma^1/2 eps
            diag_step = c * eps * diag_sd
            if alpha >= 1.0:
                prop = theta_b + full_step
            else:
                comp = jax.random.choice(
                    kcomp, 3, (n_parts,),
                    p=jnp.array([alpha, (1 - alpha) / 2, (1 - alpha) / 2]))
                center = jnp.where((comp == 2)[:, None], mu_b, theta_b)
                stepv = jnp.where((comp == 1)[:, None], diag_step, full_step)
                prop = center + stepv

            # ---- proposal-density correction q_rev - q_fwd ------------
            # (src/helpers.jl:128-164; compute_proposal_densities returns
            # q0 = density of the mixture *at the current point* given the
            # proposal and q1 = at the proposal given the current point;
            # only the theta_bar-centered component is asymmetric.)
            if alpha >= 1.0:
                log_q_diff = jnp.zeros(n_parts, jnp.float64)
            else:
                diff = prop - theta_b
                lp_sym = _deg_logpdf(diff, U, inv_lam, rank, logdet, c)
                lp_diag = _diag_logpdf(diff, diag_sd, c)
                lp_bar_cur = _deg_logpdf(theta_b - mu_b, U, inv_lam, rank,
                                         logdet, c)
                lp_bar_prop = _deg_logpdf(prop - mu_b, U, inv_lam, rank,
                                          logdet, c)
                # Both mixtures share their first two components, so one
                # COMMON max lets the shared exp(lp_sym)/exp(lp_diag) be
                # computed once — 4 f64 exps per particle instead of 6.
                a_sym = log_alpha + lp_sym
                a_diag = log_half_rest + lp_diag
                a_cur = log_half_rest + lp_bar_cur
                a_prop = log_half_rest + lp_bar_prop
                m = jnp.maximum(jnp.maximum(a_sym, a_diag),
                                jnp.maximum(a_cur, a_prop))
                ms = jnp.where(jnp.isfinite(m), m, 0.0)
                e_sym = jnp.exp(a_sym - ms)
                e_diag = jnp.exp(a_diag - ms)
                q0 = ms + jnp.log(e_sym + e_diag + jnp.exp(a_cur - ms))
                q1 = ms + jnp.log(e_sym + e_diag + jnp.exp(a_prop - ms))
                # Inf/Inf guard (src/helpers.jl:160-162)
                both_inf = jnp.isposinf(q0) & jnp.isposinf(q1)
                q0 = jnp.where(both_inf, 0.0, q0)
                log_q_diff = q0 - q1

            # ---- evaluate prior & likelihood of proposals -------------
            # Mask write-back (bit-exact; see the one-hot note above).
            prop_cols = jnp.sum(prop[:, :, None] * onehot, axis=1)  # [N, P]
            in_block = jnp.sum(onehot, axis=0) > 0                  # [P]
            params_new = jnp.where(in_block, prop_cols, params)
            prior_new = space.log_prior(params_new)
            like_new = loglike_batched(params_new)
            # ANY non-finite loglh (nan OR +inf) -> -inf: a +inf would be
            # accepted w.p. 1 and blow up the next correction step
            like_new = scrub_loglh(like_new)
            # like_new == -inf forces prior_new = -inf (src/mutation.jl:102-104)
            prior_new = jnp.where(jnp.isneginf(like_new), -jnp.inf, prior_new)
            if bridging:
                like_old_new = scrub_loglh(old_loglike_batched(params_new))
            else:
                like_old_new = jnp.zeros(n_parts, jnp.float64)

            # ---- accept/reject (src/mutation.jl:123-133) --------------
            log_eta = (phi_n * (like_new - loglh)
                       + (1.0 - phi_n) * (like_old_new - old_loglh)
                       + (prior_new - logprior)
                       + log_q_diff)
            log_u = jnp.log(jax.random.uniform(ku, (n_parts,),
                                               dtype=jnp.float64))
            acc = log_u < log_eta  # nan log_eta -> reject, as in reference

            params = jnp.where(acc[:, None], params_new, params)
            loglh = jnp.where(acc, like_new, loglh)
            logprior = jnp.where(acc, prior_new, logprior)
            old_loglh = jnp.where(acc, like_old_new, old_loglh)
            accept_count = accept_count + acc * float(k)

            return (key, params, loglh, logprior, old_loglh,
                    accept_count), None

        carry = (key, params, loglh, logprior, old_loglh, accept_count)
        if scan_blocks:
            idx_stack = perm[:sizes[0] * n_blocks].reshape(n_blocks, sizes[0])
            for step in range(n_mh_steps):
                carry, _ = jax.lax.scan(block_body, carry, idx_stack)
        else:
            for step in range(n_mh_steps):
                for b in range(n_blocks):
                    idx_f = jax.lax.dynamic_slice(
                        perm, (int(offsets[b]),), (sizes[b],))
                    carry, _ = block_body(carry, idx_f)
        (key, params, loglh, logprior, old_loglh, accept_count) = carry

        # Divided by n_free only — NOT by n_mh_steps — matching the reference
        # (src/mutation.jl:136), where accept can exceed 1 for n_mh_steps > 1.
        accept_frac = accept_count / float(n_free)
        return params, loglh, logprior, old_loglh, accept_frac

    return mutation_step


# ---------------------------------------------------------------------------
# Single-particle / standalone API parity helpers
# ---------------------------------------------------------------------------


def generate_free_blocks(key, n_free_para: int, n_blocks: int):
    """Random partition of the free-parameter ordinals into ~equal blocks
    (reference generate_free_blocks, src/helpers.jl:215-231). Returns a list
    of index arrays. The mutation kernel consumes the same structure as
    (permutation, static sizes); this explicit form is for API parity and
    inspection."""
    perm = jax.random.permutation(key, n_free_para)
    sizes = block_sizes(n_free_para, n_blocks)
    offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    return [perm[int(o):int(o) + s] for o, s in zip(offsets, sizes)]


def generate_all_blocks(blocks_free, free_para_inds):
    """Map free-ordinal blocks to full-parameter indices (reference
    generate_all_blocks, src/helpers.jl:244-260)."""
    free_para_inds = jnp.asarray(free_para_inds)
    return [free_para_inds[b] for b in blocks_free]


def generate_param_blocks(key, n_params: int, n_blocks: int):
    """Random ~equal partition of 0..n_params-1, each block sorted
    (reference generate_param_blocks, src/helpers.jl:183-204)."""
    if n_blocks == 1:
        return [jnp.arange(n_params)]
    return [jnp.sort(b) for b in generate_free_blocks(key, n_params, n_blocks)]


def mvnormal_mixture_draw(key, theta_old, mean, cov, c: float = 1.0,
                          alpha: float = 1.0):
    """One draw from the 3-component mixture proposal (reference
    mvnormal_mixture_draw, src/helpers.jl:87-100)."""
    theta_old = jnp.asarray(theta_old, jnp.float64)
    k = theta_old.shape[0]
    kcomp, keps = jax.random.split(key)
    U, sqrt_lam, _, _, _ = _deg_factor(jnp.asarray(cov, jnp.float64))
    diag_sd = jnp.sqrt(jnp.clip(jnp.diag(jnp.asarray(cov, jnp.float64)), 0.0))
    eps = jax.random.normal(keps, (k,), dtype=jnp.float64)
    full_step = c * (eps * sqrt_lam) @ U.T
    diag_step = c * eps * diag_sd
    comp = jax.random.choice(
        kcomp, 3, (), p=jnp.array([alpha, (1 - alpha) / 2, (1 - alpha) / 2]))
    center = jnp.where(comp == 2, jnp.asarray(mean, jnp.float64), theta_old)
    stepv = jnp.where(comp == 1, diag_step, full_step)
    return center + stepv


def compute_proposal_densities(para_draw, para_subset, mean, cov,
                               alpha: float = 1.0, c: float = 1.0,
                               catch_near_zeros: bool = False,
                               tol: float = 1e-6):
    """(q0, q1) log proposal densities for the mixture (reference
    compute_proposal_densities, src/helpers.jl:128-164; the reference works
    in levels and logs at the end — same math, done stably in log space).

    `catch_near_zeros`/`tol` mirror the reference's option of clamping tiny
    negative covariance-diagonal entries to 0 (src/helpers.jl:140-144).
    Here the clamp is subsumed by the DegenerateMvNormal eigen-factor,
    which already truncates eigenvalues below tol*lam_max to rank-reduce
    (the diagonal component separately clips negative diagonals to 0), so
    with catch_near_zeros=True only the truncation threshold changes —
    behaviorally a superset of the reference's fix-up."""
    para_draw = jnp.asarray(para_draw, jnp.float64)
    para_subset = jnp.asarray(para_subset, jnp.float64)
    mean = jnp.asarray(mean, jnp.float64)
    cov = jnp.asarray(cov, jnp.float64)
    if catch_near_zeros:
        diag = jnp.diag(cov)
        fixed = jnp.where((diag < 0) & (diag > -tol), 0.0, diag)
        cov = cov - jnp.diag(diag) + jnp.diag(fixed)
    U, _, inv_lam, rank, logdet = _deg_factor(cov)
    diag_sd = jnp.sqrt(jnp.clip(jnp.diag(cov), 0.0))
    log_alpha = np.log(alpha) if alpha > 0 else -np.inf
    log_rest = np.log((1 - alpha) / 2) if alpha < 1 else -np.inf

    lp_sym = _deg_logpdf(para_draw - para_subset, U, inv_lam, rank, logdet, c)
    lp_diag = _diag_logpdf(para_draw - para_subset, diag_sd, c)
    lp_bar_cur = _deg_logpdf(para_subset - mean, U, inv_lam, rank, logdet, c)
    lp_bar_prop = _deg_logpdf(para_draw - mean, U, inv_lam, rank, logdet, c)

    q0 = jax.scipy.special.logsumexp(
        jnp.stack([log_alpha + lp_sym, log_rest + lp_diag, log_rest + lp_bar_cur]))
    q1 = jax.scipy.special.logsumexp(
        jnp.stack([log_alpha + lp_sym, log_rest + lp_diag, log_rest + lp_bar_prop]))
    both_inf = jnp.isposinf(q0) & jnp.isposinf(q1)
    q0 = jnp.where(both_inf, 0.0, q0)
    return q0, q1


def mutation(key, space, loglike, data, particle_params, particle_loglh,
             particle_logprior, particle_old_loglh, mean_free, cov_free,
             perm, c, alpha, n_mh_steps, n_blocks, phi_n, phi_n1,
             old_loglike=None, old_data=None):
    """Single-particle mutation for API parity with the reference `mutation`
    export (src/mutation.jl:56). Wraps the batched kernel with N=1."""
    ll = lambda th: jax.vmap(lambda t: loglike(t, data))(th)
    oll = None
    if old_loglike is not None and old_data is not None:
        oll = lambda th: jax.vmap(lambda t: old_loglike(t, old_data))(th)
    step = make_mutation_step(space, ll, n_blocks, n_mh_steps, alpha, oll)
    p, l, lp, ol, af = step(
        key, particle_params[None, :], jnp.atleast_1d(particle_loglh),
        jnp.atleast_1d(particle_logprior), jnp.atleast_1d(particle_old_loglh),
        mean_free, cov_free, perm, c, phi_n, phi_n1)
    return p[0], l[0], lp[0], ol[0], af[0]
