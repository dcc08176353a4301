"""Fixed-seed self-golden chain regression.

The reference pins every kernel to golden files regenerated under a seed
(reference test/smc.jl:59-87, test/resample.jl:10-36, versioned by Julia
RNG stream) so a silent change to the chain — e.g. a key-order refactor
that shifts every posterior while statistics still pass — is impossible.
Our statistical gates and host-vs-fused relative checks can't catch a
change that moves both sides; this test can.

One small linear chain (512 particles, n_phi=40, 3 blocks, alpha=0.9,
seed 42) is run on the CPU backend and compared EXACTLY (bitwise on the
f64 arrays) against the committed golden `tests/goldens/linear_chain.npz`.

Regeneration (after an *intentional* chain change — say why in the commit):
    SMC_WRITE_GOLDENS=1 python -m pytest tests/test_golden_chain.py

Scope: the golden is pinned to the CPU backend (accelerator float semantics
differ)
and to the JAX Threefry PRNG stream, which is bit-deterministic across
platforms and versions by design.
"""

import os

import numpy as np
import pytest

from smc_jax import smc
from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                   generate_linear_data)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "linear_chain.npz")

CONFIG = dict(n_parts=512, n_phi=40, lam=2.1, n_blocks=3, n_mh_steps=1,
              alpha=0.9, resampling_method="systematic", verbose="none",
              seed=42)


def _run_chain():
    data, X = generate_linear_data(seed=1793)
    ll = make_linear_loglike(X)
    res = smc(ll, linear_parameters(), data, **CONFIG)
    return {
        "params": np.asarray(res.cloud.params),
        "loglh": np.asarray(res.cloud.loglh),
        "logprior": np.asarray(res.cloud.logprior),
        "weights": np.asarray(res.cloud.weights),
        "schedule": np.asarray(res.cloud.tempering_schedule),
        "ess": np.asarray(res.cloud.ESS),
        "log_mdd": np.float64(res.log_mdd),
        "c": np.float64(res.cloud.c),
        "accept_rate": np.float64(res.cloud.accept_rate),
        "resamples": np.int64(res.cloud.resamples),
    }


def test_golden_chain_exact():
    got = _run_chain()
    if os.environ.get("SMC_WRITE_GOLDENS"):
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        np.savez_compressed(GOLDEN, **got)
        pytest.skip(f"golden regenerated at {GOLDEN}")
    assert os.path.exists(GOLDEN), (
        "missing golden; regenerate with SMC_WRITE_GOLDENS=1")
    want = np.load(GOLDEN)
    for k in got:
        np.testing.assert_array_equal(
            got[k], want[k],
            err_msg=(f"golden-chain field '{k}' changed. If the chain "
                     "change is intentional, regenerate with "
                     "SMC_WRITE_GOLDENS=1 and explain in the commit."))


def test_golden_chain_statistics_sane():
    """Guard against regenerating a golden from a silently-broken chain:
    the committed golden itself must satisfy the reference's posterior gate
    (test/smc.jl:53-57) loosely (coarse config) and basic invariants."""
    if not os.path.exists(GOLDEN):
        pytest.skip("golden not yet generated")
    want = np.load(GOLDEN)
    sched = want["schedule"]
    assert sched[0] == 0.0 and sched[-1] == 1.0 and np.all(np.diff(sched) > 0)
    assert np.all(np.isfinite(want["ess"]))
    assert np.isfinite(want["log_mdd"])
    w = want["weights"]
    mu = (w @ want["params"]) / w.sum()
    true = np.array([1.0, 1.0, 1.0, 2.0, 2.0, 1.0, 3.0, 3.0, 1.0])
    assert np.max(np.abs(mu - true)) < 1.0, mu
