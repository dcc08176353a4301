"""Particle cloud: the central SMC data structure (≈ reference src/particle.jl).

The reference stores one dense (n_parts, n_para+5) Float64 matrix whose last
five columns are per-particle metadata (src/particle.jl:31-63). The layout
here is a struct-of-arrays instead: separate device arrays for params and
each metadata field, so that

* the params matrix stays a clean [N, P] operand for the batched likelihood
  and the weighted-covariance matmul (no interleaved metadata);
* every array shards over the particle axis of a `jax.sharding.Mesh`
  independently;
* weight/loglh updates touch only the arrays they need (HBM-bandwidth
  friendly).

Scalar algorithm state (stage index, schedule, ESS history, step size c,
acceptance, resample count, timing — src/particle.jl:31-41) lives host-side
on the same object; the jitted kernels are pure functions over the arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp


@dataclasses.dataclass
class Cloud:
    """Particle cloud = device arrays + host-side scalar state.

    Array fields (device, f64, leading dim N — shardable over "parts"):
      params   [N, P] parameter draws
      loglh    [N]    log-likelihood at current data
      logprior [N]    log prior density
      old_loglh[N]    log-likelihood at old data (generalized tempering)
      accept   [N]    per-particle fraction of parameters moved last mutation
      weights  [N]    normalized to sum to N (reference src/particle.jl:362-369)

    Scalar fields mirror reference src/particle.jl:31-41.
    """

    params: jnp.ndarray
    loglh: jnp.ndarray
    logprior: jnp.ndarray
    old_loglh: jnp.ndarray
    accept: jnp.ndarray
    weights: jnp.ndarray

    tempering_schedule: List[float] = dataclasses.field(default_factory=lambda: [0.0])
    ESS: List[float] = dataclasses.field(default_factory=lambda: [0.0])
    stage_index: int = 1
    n_phi: int = 1
    resamples: int = 0
    c: float = 0.5
    accept_rate: float = 0.25  # cloud-level mean acceptance (reference `accept`)
    total_sampling_time: float = 0.0

    # ------------------------------------------------------------------ init

    @classmethod
    def create(cls, n_para: int, n_parts: int, sharding=None) -> "Cloud":
        """Fresh empty cloud (reference Cloud(n_params, n_parts),
        src/particle.jl:50-53; initializes accept=0.25)."""
        def dev(x):
            return jax.device_put(x, sharding) if sharding is not None else x

        return cls(
            params=dev(jnp.zeros((n_parts, n_para), jnp.float64)),
            loglh=dev(jnp.zeros(n_parts, jnp.float64)),
            logprior=dev(jnp.zeros(n_parts, jnp.float64)),
            old_loglh=dev(jnp.zeros(n_parts, jnp.float64)),
            accept=dev(jnp.zeros(n_parts, jnp.float64)),
            weights=dev(jnp.ones(n_parts, jnp.float64)),
        )

    # ------------------------------------------------------------ properties

    @property
    def n_parts(self) -> int:
        return int(self.params.shape[0])

    @property
    def n_para(self) -> int:
        return int(self.params.shape[1])

    def __len__(self) -> int:
        return self.n_parts

    def is_empty(self) -> bool:
        return self.n_parts == 0

    @property
    def logpost(self):
        """Log posterior kernel = loglh + logprior (reference get_logpost,
        src/particle.jl:160-168)."""
        return self.loglh + self.logprior

    # ------------------------------------------------------------- "mode" ops

    def likeliest_particle_value(self):
        """Particle with max loglh (reference src/particle.jl:199-207)."""
        return self.params[jnp.argmax(self.loglh)]

    def highest_posterior_particle_value(self):
        """Particle with max loglh+logprior (reference src/particle.jl:210-218)."""
        return self.params[jnp.argmax(self.loglh + self.logprior)]

    # ------------------------------------------------------------ weight ops

    def normalize_weights(self) -> jnp.ndarray:
        """Normalize weights to sum to N (NOT 1 — reference
        src/particle.jl:362-369) in place; returns the normalized weights."""
        self.weights = _normalize_to_n(self.weights)
        return self.weights

    def reset_weights(self) -> None:
        """All weights <- 1.0 after resampling (reference src/particle.jl:378-383)."""
        self.weights = jnp.ones_like(self.weights)

    def update_weights(self, incremental) -> None:
        """Multiplicative correction-step update (reference src/particle.jl:250-262)."""
        self.weights = self.weights * incremental

    def zero_bad_loglh_weights(self) -> None:
        """weight <- 0 where loglh is -inf or nan — bridge-distribution cleanup
        (reference src/particle.jl:392-399)."""
        bad = ~jnp.isfinite(self.loglh)
        self.weights = jnp.where(bad, 0.0, self.weights)

    def update_acceptance_rate(self) -> None:
        """cloud.accept <- mean per-particle accept (reference src/particle.jl:461-468)."""
        self.accept_rate = float(jnp.mean(self.accept))

    # ------------------------------------------------- parity setters/getters
    #
    # The reference exposes ~15 update_*!/get_* accessors on Cloud
    # (src/particle.jl:71-190, 226-330, 410-468). Most call sites here touch
    # the arrays directly; these methods keep the one-for-one surface for
    # users porting reference scripts. Setters accept both (N, P) and (P, N)
    # orientations like the reference (src/particle.jl:284-330).

    def get_vals(self, transpose: bool = True):
        """Parameter draws; transposed to (P, N) by default exactly like the
        reference's get_vals (src/particle.jl:107-115)."""
        return self.params.T if transpose else self.params

    def _oriented(self, draws):
        draws = jnp.asarray(draws, jnp.float64)
        if draws.shape == (self.n_parts, self.n_para):
            return draws
        if draws.shape == (self.n_para, self.n_parts):
            return draws.T
        raise ValueError(f"draws shape {draws.shape} matches neither "
                         f"(N={self.n_parts}, P={self.n_para}) orientation")

    def update_draws(self, draws) -> None:
        """(src/particle.jl:226-241)"""
        self.params = self._oriented(draws)

    def update_loglh(self, loglh) -> None:
        self.loglh = jnp.asarray(loglh, jnp.float64)

    def update_logprior(self, logprior) -> None:
        self.logprior = jnp.asarray(logprior, jnp.float64)

    def update_old_loglh(self, old_loglh) -> None:
        self.old_loglh = jnp.asarray(old_loglh, jnp.float64)

    def set_weights(self, weights) -> None:
        """Assign (not multiply — that's update_weights; reference
        src/particle.jl:250-274 draws the same distinction)."""
        self.weights = jnp.asarray(weights, jnp.float64)

    def update_cloud(self, params, loglh, logprior, old_loglh, accept) -> None:
        """Write back a full mutation result (reference update_cloud!,
        src/particle.jl:426-437)."""
        self.params = self._oriented(params)
        self.loglh = jnp.asarray(loglh, jnp.float64)
        self.logprior = jnp.asarray(logprior, jnp.float64)
        self.old_loglh = jnp.asarray(old_loglh, jnp.float64)
        self.accept = jnp.asarray(accept, jnp.float64)

    def update_mutation(self, i: int, para, loglh, logprior, old_loglh,
                        accept) -> None:
        """Write one particle's post-MH state (reference update_mutation!,
        src/particle.jl:410-418). O(1) functional row updates; the batched
        kernel never uses this — it exists for parity/tests."""
        self.params = self.params.at[i].set(para)
        self.loglh = self.loglh.at[i].set(loglh)
        self.logprior = self.logprior.at[i].set(logprior)
        self.old_loglh = self.old_loglh.at[i].set(old_loglh)
        self.accept = self.accept.at[i].set(accept)

    def update_val(self, i: int, para) -> None:
        self.params = self.params.at[i].set(para)

    def update_weight(self, i: int, weight) -> None:
        self.weights = self.weights.at[i].set(weight)

    # -------------------------------------------------------------- reindex

    def reindexed(self, idx) -> "Cloud":
        """Gather particle rows by `idx` (resampling). Under a sharded mesh
        this lowers to XLA collective gathers across shards. Returns a new
        Cloud sharing scalar state."""
        new = dataclasses.replace(
            self,
            params=jnp.take(self.params, idx, axis=0),
            loglh=jnp.take(self.loglh, idx),
            logprior=jnp.take(self.logprior, idx),
            old_loglh=jnp.take(self.old_loglh, idx),
            accept=jnp.take(self.accept, idx),
            weights=jnp.take(self.weights, idx),
        )
        return new

    def block_until_ready(self) -> "Cloud":
        jax.block_until_ready(self.params)
        return self


def _normalize_to_n(w):
    n = w.shape[0]
    return n * w / jnp.sum(w)


# ----------------------------------------------------------------- statistics
#
# Weighted cloud statistics (reference src/particle.jl:481-532). The weighted
# covariance is deliberately a single [P, N] @ [N, P] matmul, which under a
# sharded mesh XLA turns into local products plus a psum over the particle
# axis.


def weighted_mean(cloud_or_vals, weights=None):
    """vals' W / sum(W) -> [P] (reference src/particle.jl:481-486)."""
    vals, w = _vals_weights(cloud_or_vals, weights)
    return (w @ vals) / jnp.sum(w)


def weighted_cov(cloud_or_vals, weights=None):
    """Weighted, uncorrected covariance [P, P] — feeds the MH proposal
    (reference src/particle.jl:526-532)."""
    vals, w = _vals_weights(cloud_or_vals, weights)
    mu = (w @ vals) / jnp.sum(w)
    dev = vals - mu
    return (dev.T * w) @ dev / jnp.sum(w)


def weighted_std(cloud_or_vals, weights=None):
    """Sqrt of the weighted covariance diagonal (reference src/particle.jl:512-517)."""
    return jnp.sqrt(jnp.diag(weighted_cov(cloud_or_vals, weights)))


def weighted_quantile(cloud_or_vals, weights=None, qs=(0.05, 0.95)):
    """Weighted quantiles per parameter (reference src/particle.jl:495-503;
    the reference hardcodes 5%/95%). Implemented via sorted cumulative
    weights — an O(P N log N) device sort."""
    vals, w = _vals_weights(cloud_or_vals, weights)
    wn = w / jnp.sum(w)
    qs_arr = jnp.asarray(qs, jnp.float64)

    def one_col(col):
        order = jnp.argsort(col)
        sv = col[order]
        cw = jnp.cumsum(wn[order])
        return sv[jnp.searchsorted(cw, qs_arr)]  # one batched searchsorted

    return jax.vmap(one_col, in_axes=1, out_axes=1)(vals)


def _vals_weights(cloud_or_vals, weights):
    if isinstance(cloud_or_vals, Cloud):
        return cloud_or_vals.params, cloud_or_vals.weights
    return jnp.asarray(cloud_or_vals), jnp.asarray(weights)


# ------------------------------------------------------------------ split/join


def split_cloud(cloud: Cloud, n_pieces: int) -> List[Cloud]:
    """Shard a cloud into equal row-slices; scalar state copied to every piece
    (reference src/particle.jl:542-648 splits saved files for GitHub's 100MB
    limit; here the split works on in-memory clouds, and io.save_cloud can
    write each piece)."""
    n = cloud.n_parts
    if n % n_pieces != 0:
        raise ValueError(f"n_parts={n} not divisible by n_pieces={n_pieces}")
    k = n // n_pieces
    out = []
    for i in range(n_pieces):
        sl = slice(i * k, (i + 1) * k)
        out.append(dataclasses.replace(
            cloud,
            params=cloud.params[sl],
            loglh=cloud.loglh[sl],
            logprior=cloud.logprior[sl],
            old_loglh=cloud.old_loglh[sl],
            accept=cloud.accept[sl],
            weights=cloud.weights[sl],
            tempering_schedule=list(cloud.tempering_schedule),
            ESS=list(cloud.ESS),
        ))
    return out


def join_cloud(pieces: List[Cloud]) -> Cloud:
    """Concatenate row-slices back into one cloud (reference join_cloud,
    src/particle.jl:600-648). Scalar state taken from the first piece."""
    first = pieces[0]
    return dataclasses.replace(
        first,
        params=jnp.concatenate([p.params for p in pieces], axis=0),
        loglh=jnp.concatenate([p.loglh for p in pieces]),
        logprior=jnp.concatenate([p.logprior for p in pieces]),
        old_loglh=jnp.concatenate([p.old_loglh for p in pieces]),
        accept=jnp.concatenate([p.accept for p in pieces]),
        weights=jnp.concatenate([p.weights for p in pieces]),
    )


def add_parameters_to_cloud(cloud_or_file, new_space, old_para_inds,
                            key, regime_switching: bool = False) -> Cloud:
    """Model-extension bridge (reference src/particle.jl:705-760): build a
    cloud over an extended parameter vector by keeping the old posterior draws
    for old parameters and drawing the new parameters from their prior.

    Valid when (a) the old likelihood doesn't depend on the new parameters and
    (b) priors are independent across old/new blocks (math at reference
    src/particle.jl:650-703). loglh, accept and weights are preserved;
    logprior is recomputed under the extended prior; old_loglh is zeroed and
    the scalar loop state reset as for a fresh cloud (reference
    src/particle.jl:760 rebuilds the Cloud with stage 1, c=0, accept=.25).

    Args:
      cloud_or_file: cloud from the old estimation (P_old columns), or a path
        to a saved cloud file (reference's String overload,
        src/particle.jl:705-710).
      new_space: ParamSpace of the extended model (P_new flat columns). For
        regime-switching models pass a ParamSpace built with
        regime_switching=True — regimes are flat columns here, exactly the
        layout the reference's `regime_switching` kwarg selects via
        n_parameters_regime_switching (src/particle.jl:717).
      old_para_inds: boolean or integer index array marking which of the new
        space's FLAT columns correspond to the old parameters, in old column
        order (reference semantics: get_values(old_para) ==
        get_values(para)[old_para_inds]).
      key: PRNG key for the prior draws of the new parameters.
      regime_switching: parity kwarg; must agree with how new_space was
        built. The flat-column layout makes it informational only.
    """
    if isinstance(cloud_or_file, (str, bytes)):
        from smc_jax import io as smc_io
        cloud = smc_io.get_cloud(cloud_or_file)
    else:
        cloud = cloud_or_file
    expected = new_space.n_para
    if regime_switching != new_space.regime_switching:
        raise ValueError(
            f"regime_switching={regime_switching} disagrees with new_space "
            f"(built with regime_switching={new_space.regime_switching}); "
            "the flat-column layout the cloud is extended into comes from "
            "the space, so the flags must agree (reference "
            "src/particle.jl:717 keys the layout on this kwarg)")
    old_para_inds = np.asarray(old_para_inds)
    if old_para_inds.dtype == bool:
        if old_para_inds.shape[0] != expected:
            raise ValueError(
                f"old_para_inds has {old_para_inds.shape[0]} entries but the "
                f"new space has {expected} flat columns")
        old_cols = np.nonzero(old_para_inds)[0]
    else:
        old_cols = old_para_inds
    if len(old_cols) != cloud.params.shape[1]:
        raise ValueError(
            f"old_para_inds marks {len(old_cols)} columns but the old cloud "
            f"has {cloud.params.shape[1]} parameters")
    n = cloud.n_parts

    draws = new_space.sample_prior(key, n)  # [N, P_new]
    draws = draws.at[:, old_cols].set(cloud.params)
    logprior = new_space.log_prior(draws)

    out = dataclasses.replace(
        cloud,
        params=draws,
        logprior=logprior,
        old_loglh=jnp.zeros_like(cloud.old_loglh),
        tempering_schedule=[0.0],
        ESS=list(cloud.ESS),
    )
    out.stage_index = 1
    out.resamples = 0
    out.c = 0.0
    out.accept_rate = 0.25
    out.total_sampling_time = 0.0
    return out
