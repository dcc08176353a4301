"""Sharded execution over the 8-virtual-device CPU mesh: the multi-chip
program must compile, run, and agree with the single-device program."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from smc_jax import smc
from smc_jax.parallel.mesh import particle_mesh, particle_sharding
from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                   generate_linear_data)

TRUE = np.array([1.0, 1.0, 1.0, 2.0, 2.0, 1.0, 3.0, 3.0, 1.0])


def test_eight_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_smc_on_mesh_matches_accuracy_gate():
    data, X = generate_linear_data(seed=1793)
    ll = make_linear_loglike(X)
    mesh = particle_mesh()
    res = smc(ll, linear_parameters(), data,
              n_parts=5000, n_phi=120, lam=2.1, alpha=0.9,
              resampling_method="polyalgo", verbose="none", seed=42,
              mesh=mesh)
    mu = res.posterior_mean()
    assert np.max(np.abs(mu - TRUE)) < 0.5
    # cloud stayed sharded over the particle axis
    assert not res.cloud.params.sharding.is_fully_replicated


def test_sharded_matches_unsharded():
    """Same seed, with and without the mesh: equal results up to
    reduction-order float error (the SPMD program is semantically the
    single-device program; cross-shard psums reassociate sums)."""
    data, X = generate_linear_data(seed=1793)
    ll = make_linear_loglike(X)
    kw = dict(n_parts=64, n_phi=25, lam=2.0, verbose="none", seed=5)
    r1 = smc(ll, linear_parameters(), data, **kw)
    r2 = smc(ll, linear_parameters(), data, mesh=particle_mesh(), **kw)
    np.testing.assert_allclose(np.asarray(r1.cloud.params),
                               np.asarray(r2.cloud.params), rtol=1e-7)
    np.testing.assert_allclose(r1.log_mdd, r2.log_mdd, rtol=1e-7)


def test_indivisible_n_parts_raises():
    data, X = generate_linear_data(seed=1793)
    ll = make_linear_loglike(X)
    with pytest.raises(ValueError, match="divisible"):
        smc(ll, linear_parameters(), data, n_parts=401, n_phi=10,
            mesh=particle_mesh(), verbose="none")


def test_dryrun_multichip():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


# ---------------------------------------------------------------------------
# Production DSGE path under a mesh: the batch-last likelihood keeps the particle axis sharded even though it is
# the LAST axis of every intermediate ([r, c, N] layout, models/dsge.py),
# and the full driver agrees with the unsharded run.
# ---------------------------------------------------------------------------


def _small_as(T=12):
    from smc_jax.models.as_dsge import (an_schorfheide,
                                        an_schorfheide_parameters,
                                        generate_as_data)
    from smc_jax.params import ParamSpace
    model = an_schorfheide()
    data = generate_as_data(T=T, seed=1793)
    space = ParamSpace(an_schorfheide_parameters())
    return model, data, space


def test_as_batched_likelihood_sharded_no_allgather():
    """The compiled sharded batch-last likelihood must keep N partitioned:
    no all-gather of a particle-sized operand may appear at the moveaxis
    boundary (models/dsge.py bl layout)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    model, data, space = _small_as()
    mesh = particle_mesh()
    n = 16 * 8
    thetas = space.sample_prior(jax.random.PRNGKey(0), n)
    thetas = jax.device_put(thetas, NamedSharding(mesh, P("parts", None)))
    f = jax.jit(lambda th: model.loglike_batched(th, data))
    ll = f(thetas)
    jax.block_until_ready(ll)
    # output stays sharded over the particle axis
    assert not ll.sharding.is_fully_replicated
    hlo = f.lower(thetas).compile().as_text()
    assert "all-gather" not in hlo, "sharding propagation inserted all-gathers"
    # and agrees with the unsharded run
    ll_ref = jax.jit(lambda th: model.loglike_batched(th, data))(
        np.asarray(thetas))
    fin = np.isfinite(np.asarray(ll_ref))
    np.testing.assert_allclose(np.asarray(ll)[fin], np.asarray(ll_ref)[fin],
                               rtol=1e-10)


def test_as_batched_smc_sharded_matches_unsharded():
    """Full driver on the AS model with batched=True over the 8-device mesh
    vs single-device: same chain up to reduction-order float error."""
    model, data, space = _small_as()
    llb = lambda th, d: model.loglike_batched(th, d)
    kw = dict(n_parts=64, n_phi=8, lam=2.0, verbose="none", seed=3,
              batched=True)
    r1 = smc(llb, space, data, **kw)
    r2 = smc(llb, space, data, mesh=particle_mesh(), **kw)
    assert not r2.cloud.params.sharding.is_fully_replicated
    np.testing.assert_allclose(np.asarray(r1.cloud.loglh),
                               np.asarray(r2.cloud.loglh), rtol=1e-9)
    np.testing.assert_allclose(r1.log_mdd, r2.log_mdd, rtol=1e-9)
