"""Observability: verbosity-gated stage printing and degenerate-weight
forensics (reference L6: src/util.jl:117-180, src/helpers.jl:262-305)."""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

# Reference VERBOSITY dict (src/SMC.jl:19)
VERBOSITY = {"none": 0, "low": 1, "high": 2}


def vprint(verbose: str, level: str, msg: str) -> None:
    if VERBOSITY.get(verbose, 1) >= VERBOSITY[level]:
        print(msg, flush=True)


def init_stage_print(cloud, para_names, verbose="low",
                     use_fixed_schedule=True) -> None:
    """Initialization report (reference init_stage_print, src/util.jl:117-146)."""
    if VERBOSITY.get(verbose, 1) < 1:
        return
    total = "--------------------------"
    print(total)
    print(f"SMC stage: {cloud.stage_index} of "
          f"{'' if use_fixed_schedule else '?'}{cloud.n_phi if use_fixed_schedule else ''}")
    print(f"  phi_n = {cloud.tempering_schedule[-1]:.6f}")
    print(f"  c = {cloud.c:.4f}, accept = {cloud.accept_rate:.4f}, "
          f"ESS = {cloud.ESS[-1]:.1f} ({cloud.resamples} total resamples)")
    if VERBOSITY.get(verbose, 1) >= 2:
        _param_table(cloud, para_names)
    print(total, flush=True)


def end_stage_print(cloud, para_names, verbose="low", use_fixed_schedule=True,
                    stage_time: Optional[float] = None) -> None:
    """Per-stage report with elapsed/ETA (reference end_stage_print,
    src/util.jl:147-180)."""
    if VERBOSITY.get(verbose, 1) < 1:
        return
    i = cloud.stage_index
    total_stages = cloud.n_phi if use_fixed_schedule else None
    avg = cloud.total_sampling_time / max(i - 1, 1)
    line = (f"stage {i}" + (f"/{total_stages}" if total_stages else "")
            + f": phi={cloud.tempering_schedule[-1]:.6f}"
            + f" c={cloud.c:.4f} accept={cloud.accept_rate:.3f}"
            + f" ESS={cloud.ESS[-1]:.1f} resamples={cloud.resamples}")
    if stage_time is not None:
        line += f" t={stage_time:.2f}s"
    if total_stages:
        eta = avg * max(total_stages - i, 0)
        line += f" ETA={eta:.0f}s"
    print(line, flush=True)
    if VERBOSITY.get(verbose, 1) >= 2:
        _param_table(cloud, para_names)


def chunk_stage_prints(traces, n_in_chunk: int, first_stage: int,
                       total_stages: Optional[int], chunk_time: float,
                       resamples_before: int, verbose: str = "low") -> None:
    """Per-stage lines reconstructed from a fused chunk's fetched traces (so
    the fused fast path can print live per chunk instead of forcing the
    host loop for verbose='low'). Stage time is
    the chunk average — individual stages inside one device dispatch are
    not separately timed."""
    if VERBOSITY.get(verbose, 1) < 1:
        return
    per = chunk_time / max(n_in_chunk, 1)
    res_count = resamples_before
    for k in range(n_in_chunk):
        stage = first_stage + k
        res_count += int(traces["resampled"][k])
        line = (f"stage {stage}"
                + (f"/{total_stages}" if total_stages else "")
                + f": phi={float(traces['phi'][k]):.6f}"
                + f" c={float(traces['c'][k]):.4f}"
                + f" accept={float(traces['accept'][k]):.3f}"
                + f" ESS={float(traces['ess'][k]):.1f}"
                + f" resamples={res_count}"
                + f" t~{per:.2f}s")
        if total_stages:
            eta = per * max(total_stages - stage, 0)
            line += f" ETA={eta:.0f}s"
        print(line, flush=True)


def _param_table(cloud, para_names) -> None:
    from smc_jax.cloud import weighted_mean, weighted_std
    mu = np.asarray(weighted_mean(cloud))
    sd = np.asarray(weighted_std(cloud))
    for name, m, s in zip(para_names, mu, sd):
        print(f"    {name:>16s}: mean = {m: .6f}  std = {s: .6f}")


def check_nan_ess(cloud, stage: int, incremental_weights, normalized_weights,
                  savepath: str = "", debug_assertion: bool = False) -> None:
    """Degenerate-weight forensics (reference check_nan_ess,
    src/helpers.jl:270-305): if the stage ESS is NaN, compose a cause
    analysis, optionally dump debug state, then raise."""
    if not np.isnan(cloud.ESS[stage - 1] if stage - 1 < len(cloud.ESS)
                    else cloud.ESS[-1]):
        return
    inc = np.asarray(incremental_weights)
    norm = np.asarray(normalized_weights)
    msg = "No particles have non-zero weight."
    if np.isinf(inc).any():
        msg += " Some particles have approximately infinite log-likelihoods."
    if np.isnan(inc).any():
        msg += " Some particles have approximately NaN log-likelihoods."
    ssq = np.sum(norm ** 2)
    if ssq <= np.finfo(np.float64).eps:
        msg += " The squared sum of the normalized weights is at machine-error."
    if np.isnan(ssq):
        msg += " The squared sum of the normalized weights is returning a NaN."
        if np.isnan(norm).any():
            msg += " Part of the reason is that one of the normalized weights is a NaN."
    if debug_assertion and savepath:
        import numpy as _np
        debug_path = savepath.replace(".npz", "") + "_debug_assertion.npz"
        _np.savez(debug_path,
                  incremental_weights=inc, normalized_weights=norm,
                  params=np.asarray(cloud.params),
                  loglh=np.asarray(cloud.loglh),
                  weights=np.asarray(cloud.weights))
        msg += f" Debug state dumped to {debug_path}."
    raise AssertionError(msg)


class StageTimer:
    """Wall-clock per stage, accumulated into cloud.total_sampling_time
    (reference src/smc_main.jl:378, 489-491)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        return dt
