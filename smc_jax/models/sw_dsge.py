"""Smets-Wouters (2007) medium-scale DSGE — the reference's production-scale
model (examples/dsge_models/dsge_model.jl estimates SmetsWoutersOrig through
DSGE.jl with n_parts up to 12000, 3 blocks, alpha=0.9).

Log-linearized equations of Smets & Wouters, "Shocks and Frictions in US
Business Cycles" (AER 2007): the sticky price-wage economy, its
flexible-price counterpart (for the output gap in the policy rule), seven
structural shocks (two with MA(1) components), and seven observables
(output/consumption/investment/wage growth, hours, inflation, policy rate).
36 estimated parameters with the paper's priors; 5 fixed parameters
(depreciation, wage markup, government share, Kimball curvatures).

Cast in the framework's linear-RE form  A x_{t-1} + B x_t + C E_t x_{t+1}
+ D eps_t = 0  and solved by linear time iteration (smc_jax.models.dsge) —
39 states, so each likelihood evaluation is a chain of 39x39 batched solves
plus a Kalman scan, batched across particles.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import jax
import jax.numpy as jnp

from smc_jax.distributions import (Normal, Beta, Gamma, InverseGamma,
                                   RootInverseGamma, Uniform)
from smc_jax.params import Parameter, parameter
from smc_jax.models.dsge import LinearDSGE

# ---------------------------------------------------------------------------
# Parameter order (36 estimated, SW2007 Table 1 notation in comments)
# ---------------------------------------------------------------------------

PARAM_NAMES = [
    "csadjcost",   # phi: investment adjustment cost
    "csigma",      # sigma_c: risk aversion / IES inverse
    "chabb",       # lambda: habit
    "cprobw",      # xi_w: Calvo wages
    "csigl",       # sigma_l: labor supply elasticity inverse
    "cprobp",      # xi_p: Calvo prices
    "cindw",       # iota_w: wage indexation
    "cindp",       # iota_p: price indexation
    "czcap",       # psi: capacity utilization cost
    "cfc",         # Phi: fixed cost share (= 1 + price markup)
    "crpi",        # r_pi: Taylor inflation response
    "crr",         # rho: policy smoothing
    "cry",         # r_y: output gap response
    "crdy",        # r_dy: output gap growth response
    "constepinf",  # pi_bar: SS inflation (quarterly %)
    "constebeta",  # 100(beta^-1 - 1)
    "constelab",   # l_bar: SS hours (normalization)
    "ctrend",      # gamma_bar: trend growth (quarterly %)
    "cgy",         # rho_ga: spending response to TFP shock
    "calfa",       # alpha: capital share
    "crhoa", "crhob", "crhog", "crhoqs", "crhoms", "crhopinf", "crhow",
    "cmap",        # mu_p: price markup MA
    "cmaw",        # mu_w: wage markup MA
    "sig_a", "sig_b", "sig_g", "sig_qs", "sig_m", "sig_pinf", "sig_w",
]

# SW2007 posterior-mode values (Table 1), used as the simulation DGP.
TRUE_PARAMS = np.array([
    5.74, 1.38, 0.71, 0.70, 1.83, 0.66, 0.58, 0.24, 0.54, 1.60,
    2.04, 0.81, 0.08, 0.22, 0.78, 0.16, 0.53, 0.43, 0.52, 0.19,
    0.95, 0.22, 0.97, 0.71, 0.15, 0.89, 0.96,
    0.69, 0.84,
    0.45, 0.23, 0.53, 0.45, 0.24, 0.14, 0.24,
])

# Fixed parameters (SW2007; Dynare usmodel.mod fixed block)
CTOU = 0.025     # depreciation
CLANDAW = 1.5    # SS wage markup
CG = 0.18        # exogenous spending share
CURVP = 10.0     # Kimball curvature, goods
CURVW = 10.0     # Kimball curvature, labor


def _beta_ms(mean, std):
    nu = mean * (1 - mean) / (std * std) - 1.0
    return Beta(mean * nu, (1 - mean) * nu)


def _gamma_ms(mean, std):
    shape = (mean / std) ** 2
    return Gamma(shape, std * std / mean)


def sw_parameters() -> List[Parameter]:
    """SW2007 priors and bounds (Dynare usmodel.mod estimated_params block)."""
    P = parameter
    ps = [
        P("csadjcost", 5.74, (2.0, 15.0), prior=Normal(4.0, 1.5)),
        P("csigma", 1.38, (0.25, 3.0), prior=Normal(1.5, 0.375)),
        P("chabb", 0.71, (0.001, 0.99), prior=_beta_ms(0.7, 0.1)),
        P("cprobw", 0.70, (0.3, 0.95), prior=_beta_ms(0.5, 0.1)),
        P("csigl", 1.83, (0.25, 10.0), prior=Normal(2.0, 0.75)),
        P("cprobp", 0.66, (0.5, 0.95), prior=_beta_ms(0.5, 0.10)),
        P("cindw", 0.58, (0.01, 0.99), prior=_beta_ms(0.5, 0.15)),
        P("cindp", 0.24, (0.01, 0.99), prior=_beta_ms(0.5, 0.15)),
        P("czcap", 0.54, (0.01, 1.0), prior=_beta_ms(0.5, 0.15)),
        P("cfc", 1.60, (1.0, 3.0), prior=Normal(1.25, 0.125)),
        P("crpi", 2.04, (1.0, 3.0), prior=Normal(1.5, 0.25)),
        P("crr", 0.81, (0.5, 0.975), prior=_beta_ms(0.75, 0.10)),
        P("cry", 0.08, (0.001, 0.5), prior=Normal(0.125, 0.05)),
        P("crdy", 0.22, (0.001, 0.5), prior=Normal(0.125, 0.05)),
        P("constepinf", 0.78, (0.1, 2.0), prior=_gamma_ms(0.625, 0.1)),
        P("constebeta", 0.16, (0.01, 2.0), prior=_gamma_ms(0.25, 0.1)),
        P("constelab", 0.53, (-10.0, 10.0), prior=Normal(0.0, 2.0)),
        P("ctrend", 0.43, (0.1, 0.8), prior=Normal(0.4, 0.10)),
        P("cgy", 0.52, (0.01, 2.0), prior=Normal(0.5, 0.25)),
        P("calfa", 0.19, (0.01, 1.0), prior=Normal(0.3, 0.05)),
    ]
    for name, mode in [("crhoa", 0.95), ("crhob", 0.22), ("crhog", 0.97),
                       ("crhoqs", 0.71), ("crhoms", 0.15), ("crhopinf", 0.89),
                       ("crhow", 0.96)]:
        ps.append(P(name, mode, (0.001, 0.9999), prior=_beta_ms(0.5, 0.2)))
    ps.append(P("cmap", 0.69, (0.001, 0.9999), prior=_beta_ms(0.5, 0.2)))
    ps.append(P("cmaw", 0.84, (0.001, 0.9999), prior=_beta_ms(0.5, 0.2)))
    for name, mode in [("sig_a", 0.45), ("sig_b", 0.23), ("sig_g", 0.53),
                       ("sig_qs", 0.45), ("sig_m", 0.24), ("sig_pinf", 0.14),
                       ("sig_w", 0.24)]:
        ps.append(P(name, mode, (0.01, 3.0), prior=RootInverseGamma(2.0, 0.1)))
    return ps


# ---------------------------------------------------------------------------
# State indexing
# ---------------------------------------------------------------------------

# sticky economy (13) + flexible economy (11) + shocks (7) + MA aux (2)
# + observation lags (4) + labobs lag not needed = 37; plus kp/kpf handled in
# the endo lists. Full list:
_STICKY = ["y", "c", "inve", "pk", "k", "kp", "zcap", "rk", "mc", "pinf",
           "w", "r", "lab"]
_FLEX = ["yf", "cf", "invef", "pkf", "kf", "kpf", "zcapf", "rkf", "wf",
         "labf", "rrf"]
_SHOCKS = ["a", "b", "g", "qs", "ms", "spinf", "sw"]
_MA_AUX = ["epinfma", "ewma"]
_LAGS = ["ylag", "clag", "ivlag", "wlag"]

STATE_NAMES = _STICKY + _FLEX + _SHOCKS + _MA_AUX + _LAGS
_IDX: Dict[str, int] = {n: i for i, n in enumerate(STATE_NAMES)}
N_STATE = len(STATE_NAMES)          # 37
SHOCK_NAMES = ["ea", "eb", "eg", "eqs", "em", "epinf", "ew"]
_EIDX = {n: i for i, n in enumerate(SHOCK_NAMES)}
N_SHOCK = len(SHOCK_NAMES)          # 7

OBS_NAMES = ["dy", "dc", "dinve", "dw", "pinfobs", "robs", "labobs"]
N_OBS = 7


def _system(theta):
    """theta -> (A, B, C, D): SW2007 equations in A x_{t-1} + B x_t
    + C E x_{t+1} + D eps = 0 form. Row layout follows the equation list in
    the module docstring; coefficients are the paper's, with steady-state
    ratios computed from theta."""
    (csadjcost, csigma, chabb, cprobw, csigl, cprobp, cindw, cindp, czcap,
     cfc, crpi, crr, cry, crdy, constepinf, constebeta, constelab, ctrend,
     cgy, calfa) = [theta[i] for i in range(20)]
    crhoa, crhob, crhog, crhoqs, crhoms, crhopinf, crhow = \
        [theta[20 + i] for i in range(7)]
    cmap, cmaw = theta[27], theta[28]

    # steady-state relationships (usmodel.mod steady-state block)
    cgamma = 1.0 + ctrend / 100.0
    cbeta = 1.0 / (1.0 + constebeta / 100.0)
    clandap = cfc
    cbetabar = cbeta * cgamma ** (-csigma)
    crk = (1.0 / cbeta) * cgamma ** csigma - (1.0 - CTOU)
    cw = (calfa ** calfa * (1 - calfa) ** (1 - calfa)
          / (clandap * crk ** calfa)) ** (1.0 / (1 - calfa))
    cikbar = 1.0 - (1.0 - CTOU) / cgamma
    cik = cikbar * cgamma
    clk = ((1 - calfa) / calfa) * (crk / cw)
    cky = cfc * clk ** (calfa - 1.0)
    ciy = cik * cky
    ccy = 1.0 - CG - ciy
    crkky = crk * cky
    cwhlc = (1.0 / CLANDAW) * (1 - calfa) / calfa * crk * cky / ccy

    A = jnp.zeros((N_STATE, N_STATE), jnp.float64)
    B = jnp.zeros((N_STATE, N_STATE), jnp.float64)
    C = jnp.zeros((N_STATE, N_STATE), jnp.float64)
    D = jnp.zeros((N_STATE, N_SHOCK), jnp.float64)
    I = _IDX
    E = _EIDX
    row = [0]

    def eq(a=(), b=(), c=(), d=()):
        nonlocal A, B, C, D
        r = row[0]
        for name, coef in a:
            A = A.at[r, I[name]].add(coef)
        for name, coef in b:
            B = B.at[r, I[name]].add(coef)
        for name, coef in c:
            C = C.at[r, I[name]].add(coef)
        for name, coef in d:
            D = D.at[r, E[name]].add(coef)
        row[0] += 1

    hg = chabb / cgamma
    c1 = hg / (1 + hg)                     # consumption lag coef
    c2 = 1.0 / (1 + hg)                    # consumption lead coef
    c3 = (csigma - 1.0) * cwhlc / (csigma * (1 + hg))
    c4 = (1 - hg) / (csigma * (1 + hg))
    i1 = 1.0 / (1 + cbetabar * cgamma)     # investment lag coef
    i2 = i1 / (cgamma * cgamma * csadjcost)
    pk1 = crk / (crk + 1 - CTOU)
    pk2 = (1 - CTOU) / (crk + 1 - CTOU)
    zc = (1 - czcap) / czcap               # zcap response to rk
    kb = cfc                               # production fixed-cost multiplier
    # NKPC slope and wage rigidity terms
    pinf_den = 1.0 + cbetabar * cgamma * cindp
    kappa_p = ((1 - cprobp) * (1 - cbetabar * cgamma * cprobp) / cprobp
               / ((cfc - 1.0) * CURVP + 1.0))
    w_den = 1.0 + cbetabar * cgamma
    kappa_w = ((1 - cprobw) * (1 - cbetabar * cgamma * cprobw)
               / (w_den * cprobw) / ((CLANDAW - 1.0) * CURVW + 1.0))

    # ---------------- flexible economy (price/wage flexible, no markup
    # shocks; real rate rrf replaces r - E pinf) ----------------
    # 1. marginal cost = 0: calfa*rkf + (1-calfa)*wf - a = 0
    eq(b=[("rkf", calfa), ("wf", 1 - calfa), ("a", -1.0)])
    # 2. zcapf = zc * rkf
    eq(b=[("zcapf", -1.0), ("rkf", zc)])
    # 3. rkf = wf + labf - kf
    eq(b=[("rkf", -1.0), ("wf", 1.0), ("labf", 1.0), ("kf", -1.0)])
    # 4. kf = kpf(-1) + zcapf
    eq(a=[("kpf", 1.0)], b=[("kf", -1.0), ("zcapf", 1.0)])
    # 5. invef = i1*invef(-1) + i1*cbetabar*cgamma*invef(+1) + i2*pkf + qs
    eq(a=[("invef", i1)], b=[("invef", -1.0), ("pkf", i2), ("qs", 1.0)],
       c=[("invef", i1 * cbetabar * cgamma)])
    # 6. pkf = -rrf + (1/c4)*b + pk1*rkf(+1) + pk2*pkf(+1)
    eq(b=[("pkf", -1.0), ("rrf", -1.0), ("b", 1.0 / c4)],
       c=[("rkf", pk1), ("pkf", pk2)])
    # 7. cf = c1*cf(-1) + c2*cf(+1) + c3*(labf - labf(+1)) - c4*rrf + b
    eq(a=[("cf", c1)],
       b=[("cf", -1.0), ("labf", c3), ("rrf", -c4), ("b", 1.0)],
       c=[("cf", c2), ("labf", -c3)])
    # 8. yf = ccy*cf + ciy*invef + g + crkky*zcapf
    eq(b=[("yf", -1.0), ("cf", ccy), ("invef", ciy), ("g", 1.0),
          ("zcapf", crkky)])
    # 9. yf = cfc*(calfa*kf + (1-calfa)*labf + a)
    eq(b=[("yf", -1.0), ("kf", kb * calfa), ("labf", kb * (1 - calfa)),
          ("a", kb)])
    # 10. wf = csigl*labf + (1/(1-hg))*cf - (hg/(1-hg))*cf(-1)
    eq(a=[("cf", -hg / (1 - hg))],
       b=[("wf", -1.0), ("labf", csigl), ("cf", 1.0 / (1 - hg))])
    # 11. kpf = (1-cikbar)*kpf(-1) + cikbar*invef + cikbar*cgamma^2*csadjcost*qs
    eq(a=[("kpf", 1 - cikbar)],
       b=[("kpf", -1.0), ("invef", cikbar),
          ("qs", cikbar * cgamma * cgamma * csadjcost)])

    # ---------------- sticky economy ----------------
    # 12. mc = calfa*rk + (1-calfa)*w - a
    eq(b=[("mc", -1.0), ("rk", calfa), ("w", 1 - calfa), ("a", -1.0)])
    # 13. zcap = zc*rk
    eq(b=[("zcap", -1.0), ("rk", zc)])
    # 14. rk = w + lab - k
    eq(b=[("rk", -1.0), ("w", 1.0), ("lab", 1.0), ("k", -1.0)])
    # 15. k = kp(-1) + zcap
    eq(a=[("kp", 1.0)], b=[("k", -1.0), ("zcap", 1.0)])
    # 16. inve = i1*inve(-1) + i1*cbetabar*cgamma*inve(+1) + i2*pk + qs
    eq(a=[("inve", i1)], b=[("inve", -1.0), ("pk", i2), ("qs", 1.0)],
       c=[("inve", i1 * cbetabar * cgamma)])
    # 17. pk = -r + pinf(+1) + (1/c4)*b + pk1*rk(+1) + pk2*pk(+1)
    eq(b=[("pk", -1.0), ("r", -1.0), ("b", 1.0 / c4)],
       c=[("pinf", 1.0), ("rk", pk1), ("pk", pk2)])
    # 18. c = c1*c(-1) + c2*c(+1) + c3*(lab - lab(+1)) - c4*(r - pinf(+1)) + b
    eq(a=[("c", c1)],
       b=[("c", -1.0), ("lab", c3), ("r", -c4), ("b", 1.0)],
       c=[("c", c2), ("lab", -c3), ("pinf", c4)])
    # 19. y = ccy*c + ciy*inve + g + crkky*zcap
    eq(b=[("y", -1.0), ("c", ccy), ("inve", ciy), ("g", 1.0),
          ("zcap", crkky)])
    # 20. y = cfc*(calfa*k + (1-calfa)*lab + a)
    eq(b=[("y", -1.0), ("k", kb * calfa), ("lab", kb * (1 - calfa)),
          ("a", kb)])
    # 21. NKPC: pinf = (1/pinf_den)*(cbetabar*cgamma*pinf(+1)
    #      + cindp*pinf(-1) + kappa_p*mc) + spinf
    eq(a=[("pinf", cindp / pinf_den)],
       b=[("pinf", -1.0), ("mc", kappa_p / pinf_den), ("spinf", 1.0)],
       c=[("pinf", cbetabar * cgamma / pinf_den)])
    # 22. wage Phillips curve:
    # w = (1/w_den)*w(-1) + (cbetabar*cgamma/w_den)*w(+1)
    #     + (cindw/w_den)*pinf(-1) - ((1+cbetabar*cgamma*cindw)/w_den)*pinf
    #     + (cbetabar*cgamma/w_den)*pinf(+1)
    #     + kappa_w*(csigl*lab + (1/(1-hg))*c - (hg/(1-hg))*c(-1) - w) + sw
    eq(a=[("w", 1.0 / w_den), ("pinf", cindw / w_den),
          ("c", -kappa_w * hg / (1 - hg))],
       b=[("w", -1.0 - kappa_w),
          ("pinf", -(1 + cbetabar * cgamma * cindw) / w_den),
          ("lab", kappa_w * csigl), ("c", kappa_w / (1 - hg)),
          ("sw", 1.0)],
       c=[("w", cbetabar * cgamma / w_den),
          ("pinf", cbetabar * cgamma / w_den)])
    # 23. policy rule: r = crpi*(1-crr)*pinf + cry*(1-crr)*(y-yf)
    #      + crdy*(y - yf - y(-1) + yf(-1)) + crr*r(-1) + ms
    eq(a=[("r", crr), ("y", -crdy), ("yf", crdy)],
       b=[("r", -1.0), ("pinf", crpi * (1 - crr)),
          ("y", cry * (1 - crr) + crdy), ("yf", -cry * (1 - crr) - crdy),
          ("ms", 1.0)])
    # 24. kp = (1-cikbar)*kp(-1) + cikbar*inve + cikbar*cgamma^2*csadjcost*qs
    eq(a=[("kp", 1 - cikbar)],
       b=[("kp", -1.0), ("inve", cikbar),
          ("qs", cikbar * cgamma * cgamma * csadjcost)])

    # ---------------- shock processes ----------------
    # 25. a = crhoa*a(-1) + ea
    eq(a=[("a", crhoa)], b=[("a", -1.0)], d=[("ea", 1.0)])
    # 26. b = crhob*b(-1) + eb
    eq(a=[("b", crhob)], b=[("b", -1.0)], d=[("eb", 1.0)])
    # 27. g = crhog*g(-1) + eg + cgy*ea
    eq(a=[("g", crhog)], b=[("g", -1.0)], d=[("eg", 1.0), ("ea", cgy)])
    # 28. qs = crhoqs*qs(-1) + eqs
    eq(a=[("qs", crhoqs)], b=[("qs", -1.0)], d=[("eqs", 1.0)])
    # 29. ms = crhoms*ms(-1) + em
    eq(a=[("ms", crhoms)], b=[("ms", -1.0)], d=[("em", 1.0)])
    # 30. spinf = crhopinf*spinf(-1) + epinf - cmap*epinfma(-1)
    eq(a=[("spinf", crhopinf), ("epinfma", -cmap)], b=[("spinf", -1.0)],
       d=[("epinf", 1.0)])
    # 31. epinfma = epinf (MA bookkeeping)
    eq(b=[("epinfma", -1.0)], d=[("epinf", 1.0)])
    # 32. sw = crhow*sw(-1) + ew - cmaw*ewma(-1)
    eq(a=[("sw", crhow), ("ewma", -cmaw)], b=[("sw", -1.0)],
       d=[("ew", 1.0)])
    # 33. ewma = ew
    eq(b=[("ewma", -1.0)], d=[("ew", 1.0)])

    # ---------------- observation lags ----------------
    for lag, cur in [("ylag", "y"), ("clag", "c"), ("ivlag", "inve"),
                     ("wlag", "w")]:
        eq(a=[(cur, 1.0)], b=[(lag, -1.0)])

    assert row[0] == N_STATE, f"wrote {row[0]} equations for {N_STATE} states"
    return A, B, C, D


def _measurement(theta):
    constepinf, constebeta = theta[14], theta[15]
    constelab, ctrend, csigma = theta[16], theta[17], theta[1]
    cgamma = 1.0 + ctrend / 100.0
    cbeta = 1.0 / (1.0 + constebeta / 100.0)
    cpie = 1.0 + constepinf / 100.0
    cr = cpie / (cbeta * cgamma ** (-csigma))
    conster = (cr - 1.0) * 100.0

    I = _IDX
    Z = jnp.zeros((N_OBS, N_STATE), jnp.float64)
    for r, (cur, lag) in enumerate([("y", "ylag"), ("c", "clag"),
                                    ("inve", "ivlag"), ("w", "wlag")]):
        Z = Z.at[r, I[cur]].set(1.0).at[r, I[lag]].set(-1.0)
    Z = Z.at[4, I["pinf"]].set(1.0)
    Z = Z.at[5, I["r"]].set(1.0)
    Z = Z.at[6, I["lab"]].set(1.0)
    d = jnp.stack([ctrend, ctrend, ctrend, ctrend,
                   constepinf, conster, constelab])
    H = 1e-10 * jnp.eye(N_OBS, dtype=jnp.float64)
    return d, Z, H


def _shock_cov(theta):
    sig = theta[29:36]
    return jnp.diag(sig * sig)


def smets_wouters() -> LinearDSGE:
    return LinearDSGE(sw_parameters(), _system, _measurement, N_SHOCK,
                      _shock_cov)


def generate_sw_data(T: int = 156, seed: int = 1793,
                     theta: np.ndarray = TRUE_PARAMS) -> np.ndarray:
    """Simulate the 7 observables [7, T] at `theta` (the reference loads US
    data through DSGE.jl; SW2007 used 1966-2004 ~ 156 quarters)."""
    model = smets_wouters()
    key = jax.random.PRNGKey(seed)
    obs = model.simulate(jnp.asarray(theta, jnp.float64), T, key)
    return np.asarray(obs)


def load_reference_sw_data(
        path: str = "/root/reference/examples/data/sw_orig_smc.h5",
        demean_hours: bool = True) -> np.ndarray:
    """The reference's SHIPPED US dataset for the Smets-Wouters example
    (examples/data/sw_orig_smc.h5, used by examples/dsge_models/
    dsge_model.jl): 7 observables x 197 quarters.

    The file stores columns in the order (dy, dc, dinve, dw, labobs,
    pinfobs, robs) — identified by their magnitudes: growth rates ~0.4%%
    quarterly, hours a large negative level, inflation/rate small positive —
    and is remapped here to this module's OBS_NAMES order. The shipped
    labobs is a raw log-hours level (~-46), whereas the SW2007 measurement
    labobs = constelab + lab_t expects the demeaned series the published
    usmodel dataset uses; demean_hours=True (default) demeans it so
    constelab's N(0,2) prior covers the level, exactly as the original
    dataset is constructed. Returns [7, T] in OBS_NAMES order."""
    import h5py
    with h5py.File(path, "r") as f:
        d = f["data"][()]            # stored (197, 7) -> Julia (7, 197)
    d = np.ascontiguousarray(d.T)    # file order: dy dc dinve dw lab pinf r
    # Loud signature check of the assumed column order (shipped file: growth
    # rates ~0.37-0.44%% mean / std < 3; log-hours level ~-46; inflation and
    # rate small positive with robs strictly nonneg-ish). A differently
    # ordered or rescaled file must fail HERE, not silently mis-map.
    means = d.mean(axis=1)
    if not (np.all(np.abs(means[:4]) < 2.0)
            and np.all(d[:4].std(axis=1) < 5.0)):
        raise ValueError(
            f"columns 0-3 of {path} do not look like quarterly growth rates "
            f"(means {means[:4]}); observable order differs from the "
            "expected (dy, dc, dinve, dw, labobs, pinfobs, robs)")
    if not means[4] < -10.0:
        raise ValueError(
            f"column 4 of {path} (mean {means[4]:.2f}) is not a raw "
            "log-hours level; observable order differs from expectation")
    if not (0.0 < means[5] < 5.0 and 0.0 < means[6] < 5.0
            and d[6].min() > -1.0):
        raise ValueError(
            f"columns 5-6 of {path} (means {means[5]:.2f}, {means[6]:.2f}) "
            "do not look like inflation / policy-rate observables")
    order = [0, 1, 2, 3, 5, 6, 4]    # -> dy dc dinve dw pinfobs robs labobs
    out = d[order]
    if demean_hours:
        out[6] = out[6] - out[6].mean()
    return out
