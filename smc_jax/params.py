"""Parameter-vector layer: the JAX replacement for ModelConstructors.jl.

The reference consumes ModelConstructors.jl for parameter specs with
priors/bounds/transforms and regime-switching values (SURVEY.md §2.9). Here a
model's parameters are declared as a list of :class:`Parameter` and compiled
into a :class:`ParamSpace` — a flat, fully-vectorized description of the
P-dimensional sampling space:

* one column per parameter, plus one extra column per non-first regime value
  (exactly the flattening the reference performs at src/smc_main.jl:206-234,
  with synthetic names ``"<key>_reg<i>"``);
* stacked prior family codes/parameters so ``log_prior`` and ``sample_prior``
  are a handful of masked vector ops — vmappable, jittable, no Python loops;
* bounds violations return ``-inf`` instead of throwing — the functional
  equivalent of the reference's catch-ParamBoundsError→-Inf discipline
  (src/initialization.jl:46-54, src/mutation.jl:112-121).

The SMC sampler operates in the *model* (untransformed) space, as SMC.jl
does; the transform tags (Untransformed/SquareRoot/Exponential) are carried
for API parity and for users who want to run gradient-based polish in
unconstrained space.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.stats import norm as _jnorm

from smc_jax.distributions import Distribution, Point, FAMILY_CODES, logpdf_family, sample_family


# --- Transform tags (API parity with ModelConstructors' transforms) --------

class Untransformed:
    """Identity map between model space and unconstrained space."""

    def to_real(self, x, lo, hi):
        return x

    def from_real(self, y, lo, hi):
        return y


class SquareRoot:
    """ModelConstructors' SquareRoot transform for interval-bounded params:
    real = c * z / sqrt(1 - z^2) with z = (x - (a+b)/2) / ((b-a)/2), c = 1.
    """

    def to_real(self, x, lo, hi):
        z = (x - (lo + hi) / 2.0) / ((hi - lo) / 2.0)
        return z / jnp.sqrt(1.0 - z * z)

    def from_real(self, y, lo, hi):
        z = y / jnp.sqrt(1.0 + y * y)
        return (lo + hi) / 2.0 + (hi - lo) / 2.0 * z


class Exponential:
    """real = log(x - lo); model = lo + exp(real). For lower-bounded params."""

    def to_real(self, x, lo, hi):
        return jnp.log(x - lo)

    def from_real(self, y, lo, hi):
        return lo + jnp.exp(y)


@dataclasses.dataclass
class Parameter:
    """One model parameter (≈ ModelConstructors.parameter, SURVEY.md §2.9).

    regimes: optional per-regime overrides, e.g.
        regimes={"value": {1: 0.2, 2: -0.1, 3: 0.1},
                 "prior": {2: Normal(0, 12.0)},
                 "fixed": {1: False, 2: False, 3: False}}
    Regime 1 lives in the parameter's own column; regimes 2..R get appended
    columns (flattening per reference src/smc_main.jl:206-234).
    """

    name: str
    value: float
    valuebounds: Tuple[float, float] = (-np.inf, np.inf)
    transform_bounds: Tuple[float, float] = (-np.inf, np.inf)
    transform: object = dataclasses.field(default_factory=Untransformed)
    prior: Optional[Distribution] = None
    fixed: bool = False
    regimes: Optional[Dict[str, Dict[int, object]]] = None

    def n_regimes(self) -> int:
        if not self.regimes or "value" not in self.regimes:
            return 1
        return max(self.regimes["value"].keys())

    def regime_attr(self, attr: str, regime: int, default):
        if self.regimes and attr in self.regimes and regime in self.regimes[attr]:
            return self.regimes[attr][regime]
        return default


def parameter(name, value, valuebounds=(-np.inf, np.inf),
              transform_bounds=None, transform=None, prior=None,
              fixed=False, regimes=None) -> Parameter:
    """Convenience constructor mirroring ModelConstructors' `parameter(...)`."""
    return Parameter(
        name=name,
        value=float(value),
        valuebounds=tuple(valuebounds),
        transform_bounds=tuple(transform_bounds) if transform_bounds else tuple(valuebounds),
        transform=transform if transform is not None else Untransformed(),
        prior=prior,
        fixed=fixed,
        regimes=regimes,
    )


class ParamSpace:
    """Flat, vectorized sampling space for a list of Parameters.

    Columns 0..len(params)-1 hold each parameter's regime-1 value; appended
    columns hold regime 2..R values in parameter order, named "<key>_reg<i>"
    (reference src/smc_main.jl:221-234). All metadata is stored as numpy
    arrays that become compile-time constants inside jitted closures.
    """

    def __init__(self, params: Sequence[Parameter], regime_switching: bool = False):
        self.parameters: List[Parameter] = list(params)
        self.regime_switching = bool(regime_switching)

        names: List[str] = []
        values: List[float] = []
        lo: List[float] = []
        hi: List[float] = []
        fixed: List[bool] = []
        fam: List[int] = []
        pa: List[float] = []
        pb: List[float] = []

        def _push(name, value, bounds, fx, pr):
            names.append(name)
            values.append(float(value))
            lo.append(float(bounds[0]))
            hi.append(float(bounds[1]))
            fixed.append(bool(fx))
            d = pr if pr is not None else Point()
            if fx:
                d = Point()
            fam.append(d.code)
            pa.append(float(d.a))
            pb.append(float(d.b))

        # Base columns: regime-1 values.
        for p in params:
            v = p.regime_attr("value", 1, p.value)
            b = p.regime_attr("valuebounds", 1, p.valuebounds)
            fx = p.regime_attr("fixed", 1, p.fixed)
            pr = p.regime_attr("prior", 1, p.prior)
            _push(p.name, v, b, fx, pr)

        # Appended regime columns (only when regime_switching is on —
        # mirrors the reference's n_para counting at src/smc_main.jl:206-216).
        if regime_switching:
            for p in params:
                for r in range(2, p.n_regimes() + 1):
                    v = p.regime_attr("value", r, p.value)
                    b = p.regime_attr("valuebounds", r, p.valuebounds)
                    fx = p.regime_attr("fixed", r, p.fixed)
                    pr = p.regime_attr("prior", r, p.prior)
                    _push(f"{p.name}_reg{r}", v, b, fx, pr)

        self.names = names
        self.values = np.asarray(values, np.float64)
        self.lo = np.asarray(lo, np.float64)
        self.hi = np.asarray(hi, np.float64)
        self.fixed = np.asarray(fixed, bool)
        self.prior_family = np.asarray(fam, np.int32)
        self.prior_a = np.asarray(pa, np.float64)
        self.prior_b = np.asarray(pb, np.float64)

        self.n_para = len(names)
        self.free_inds = np.nonzero(~self.fixed)[0]
        self.fixed_inds = np.nonzero(self.fixed)[0]
        self.n_free = len(self.free_inds)

        # Truncated-normal renormalization constants (per column, zero for
        # other families): log(Phi((hi-mu)/sig) - Phi((lo-mu)/sig)).
        tn = self.prior_family == FAMILY_CODES["truncated_normal"]
        logz = np.zeros(self.n_para)
        if tn.any():
            from scipy.stats import norm as _snorm  # host-side, setup only
            mu, sig = self.prior_a[tn], self.prior_b[tn]
            zhi = _snorm.cdf((self.hi[tn] - mu) / sig)
            zlo = _snorm.cdf((self.lo[tn] - mu) / sig)
            logz[tn] = np.log(np.maximum(zhi - zlo, 1e-300))
        self._tn_logz = logz

    # -- core vectorized ops ------------------------------------------------

    def log_prior(self, theta):
        """Sum of free-parameter prior log-densities at theta [..., P].

        Total: -inf when any free coordinate is outside its valuebounds
        (replaces ParamBoundsError-throwing `update!`; reference
        src/mutation.jl:93-95 + :112-121). Fixed columns contribute 0
        (ModelConstructors' `prior` sums over free parameters).
        """
        theta = jnp.asarray(theta, jnp.float64)
        free = jnp.asarray(~self.fixed)
        lp_cols = logpdf_family(jnp.asarray(self.prior_family),
                                jnp.asarray(self.prior_a),
                                jnp.asarray(self.prior_b), theta)
        lp_cols = lp_cols - jnp.asarray(self._tn_logz)
        lp_cols = jnp.where(free, lp_cols, 0.0)
        in_bounds = (theta >= jnp.asarray(self.lo)) & (theta <= jnp.asarray(self.hi))
        ok = jnp.all(in_bounds | ~free, axis=-1)
        total = jnp.sum(jnp.where(free, lp_cols, 0.0), axis=-1)
        return jnp.where(ok & jnp.isfinite(total), total, -jnp.inf)

    def sample_prior(self, key, n: int):
        """n draws from the prior, shape [n, P]; fixed columns at their value.

        Out-of-support draws are possible for unbounded-prior/bounded-param
        combos — exactly as in the reference, where `rand(parameters)` can
        produce draws that `update!` rejects; the initialization layer
        redraws until the full particle is valid (src/initialization.jl:31-61).
        Truncated normals are sampled exactly via inverse-CDF.
        """
        draws = sample_family(jnp.asarray(self.prior_family),
                              jnp.asarray(self.prior_a),
                              jnp.asarray(self.prior_b), key, (n,))
        tn_mask = jnp.asarray(self.prior_family == FAMILY_CODES["truncated_normal"])
        if bool(np.any(self.prior_family == FAMILY_CODES["truncated_normal"])):
            ktn = jax.random.fold_in(key, 1315423911)
            mu, sig = jnp.asarray(self.prior_a), jnp.asarray(self.prior_b)
            zlo = _jnorm.cdf((jnp.asarray(self.lo) - mu) / jnp.maximum(sig, 1e-300))
            zhi = _jnorm.cdf((jnp.asarray(self.hi) - mu) / jnp.maximum(sig, 1e-300))
            u = jax.random.uniform(ktn, (n, self.n_para), dtype=jnp.float64)
            q = zlo + u * (zhi - zlo)
            q = jnp.clip(q, 1e-15, 1.0 - 1e-15)
            tn_draws = mu + sig * _jnorm.ppf(q)
            draws = jnp.where(tn_mask, tn_draws, draws)
        fixed = jnp.asarray(self.fixed)
        return jnp.where(fixed, jnp.asarray(self.values), draws)

    # -- transform utilities (unused by the sampler itself) -----------------

    def to_real(self, theta):
        cols = []
        specs = self._column_specs()
        for j, (tr, lo, hi) in enumerate(specs):
            cols.append(tr.to_real(theta[..., j], lo, hi))
        return jnp.stack(cols, axis=-1)

    def from_real(self, y):
        cols = []
        specs = self._column_specs()
        for j, (tr, lo, hi) in enumerate(specs):
            cols.append(tr.from_real(y[..., j], lo, hi))
        return jnp.stack(cols, axis=-1)

    def _column_specs(self):
        specs = []
        for p in self.parameters:
            specs.append((p.transform, p.transform_bounds[0], p.transform_bounds[1]))
        if self.regime_switching:
            for p in self.parameters:
                for _ in range(2, p.n_regimes() + 1):
                    specs.append((p.transform, p.transform_bounds[0], p.transform_bounds[1]))
        return specs

    # -- regime helpers -----------------------------------------------------

    def regime_matrix(self) -> np.ndarray:
        """[n_base_params, max_regimes] column-index map: entry (i, r-1) is the
        flat column holding parameter i's regime-r value (regime 1 -> i).
        Lets likelihoods pick per-regime parameter values with one gather.
        """
        n_base = len(self.parameters)
        max_r = max(p.n_regimes() for p in self.parameters)
        out = np.zeros((n_base, max_r), np.int32)
        col = n_base
        for i, p in enumerate(self.parameters):
            out[i, :] = i
            for r in range(2, p.n_regimes() + 1):
                if self.regime_switching:
                    out[i, r - 1] = col
                    col += 1
        return out

    def __len__(self) -> int:
        return self.n_para

    def __repr__(self) -> str:
        return (f"ParamSpace(n_para={self.n_para}, n_free={self.n_free}, "
                f"regime_switching={self.regime_switching})")
