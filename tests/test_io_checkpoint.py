"""Persistence: cloud save/load roundtrip, checkpoint/resume equivalence
(reference src/smc_main.jl:334-361, 499-507 — our resume is additionally
bit-reproducible because the PRNG key is checkpointed)."""

import numpy as np
import jax.numpy as jnp
import pytest

from smc_jax import smc, save_cloud, load_cloud, get_cloud
from smc_jax.cloud import Cloud
from smc_jax import io as smc_io
from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                   generate_linear_data)


@pytest.fixture(scope="module")
def fixture():
    data, X = generate_linear_data(seed=1793)
    return data, make_linear_loglike(X)


def test_cloud_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    c = Cloud.create(4, 50)
    c.params = jnp.asarray(rng.normal(size=(50, 4)))
    c.loglh = jnp.asarray(rng.normal(size=50))
    c.tempering_schedule = [0.0, 0.1, 0.5]
    c.ESS = [50.0, 44.2]
    c.stage_index = 3
    c.c = 0.37
    path = str(tmp_path / "cloud.npz")
    save_cloud(path, c, extra={"w": np.ones((50, 2))})
    back, extra = load_cloud(path)
    np.testing.assert_array_equal(np.asarray(back.params), np.asarray(c.params))
    np.testing.assert_array_equal(np.asarray(back.loglh), np.asarray(c.loglh))
    assert back.tempering_schedule == c.tempering_schedule
    assert back.ESS == c.ESS
    assert back.stage_index == 3 and back.c == 0.37
    np.testing.assert_array_equal(extra["w"], np.ones((50, 2)))
    # get_cloud parity helper
    assert get_cloud(path).stage_index == 3


def test_final_save_and_particle_store(fixture, tmp_path):
    data, ll = fixture
    savepath = str(tmp_path / "smc_cloud.npz")
    store = str(tmp_path / "smcsave.npy")
    res = smc(ll, linear_parameters(), data,
              n_parts=100, n_phi=30, lam=2.0, verbose="none", seed=1,
              savepath=savepath, particle_store_path=store)
    cloud, extra = load_cloud(savepath)
    np.testing.assert_array_equal(np.asarray(cloud.params),
                                  np.asarray(res.cloud.params))
    assert "w" in extra and "W" in extra
    params = np.load(store)
    np.testing.assert_array_equal(params, np.asarray(res.cloud.params))


def test_checkpoint_resume_bit_identical(fixture, tmp_path):
    """A run interrupted at a checkpoint and resumed must match the
    uninterrupted run exactly."""
    data, ll = fixture
    kw = dict(n_parts=100, n_phi=40, lam=2.0, verbose="none", seed=9)
    full = smc(ll, linear_parameters(), data, **kw)

    savepath = str(tmp_path / "ckpt.npz")
    smc(ll, linear_parameters(), data, **kw, savepath=savepath,
        save_intermediate=True, intermediate_stage_increment=10)
    # pick an intermediate checkpoint and resume from it
    ckpt = smc_io.intermediate_path(savepath, 20)
    resumed = smc(ll, linear_parameters(), data, **kw,
                  continue_intermediate=True, loadpath=ckpt)

    np.testing.assert_array_equal(np.asarray(resumed.cloud.params),
                                  np.asarray(full.cloud.params))
    np.testing.assert_allclose(resumed.log_mdd, full.log_mdd, rtol=1e-12)
    assert resumed.cloud.tempering_schedule == full.cloud.tempering_schedule


def test_split_join_cloud_files(tmp_path):
    """File-level split/join parity (reference src/particle.jl:542-648)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    c = Cloud.create(3, 40)
    c.params = jnp.asarray(rng.normal(size=(40, 3)))
    c.loglh = jnp.asarray(rng.normal(size=40))
    path = str(tmp_path / "big_cloud.npz")
    save_cloud(path, c, extra={"w": np.ones((40, 2))})
    pieces = smc_io.split_cloud_file(path, 4)
    assert len(pieces) == 4
    import os
    os.remove(path)
    smc_io.join_cloud_file(path, 4)
    back, extra = load_cloud(path)
    np.testing.assert_array_equal(np.asarray(back.params), np.asarray(c.params))
    np.testing.assert_array_equal(extra["w"], np.ones((40, 2)))


def test_parity_kwargs_accepted_and_testing_suppresses_writes(fixture, tmp_path):
    data, ll = fixture
    savepath = str(tmp_path / "nope.npz")
    from smc_jax.models.linear import linear_parameters
    res = smc(ll, linear_parameters(), data,
              n_parts=100, n_phi=20, lam=2.0, verbose="none", seed=2,
              parallel=True, testing=True, data_vintage="200707",
              smc_iteration=0, savepath=savepath)
    import os
    assert not os.path.exists(savepath)  # testing=True suppresses writes
    assert np.isfinite(res.log_mdd)
