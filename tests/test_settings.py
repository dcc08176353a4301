"""Settings/GenericModel convenience layer (reference ModelConstructors
GenericModel + Setting + rawpath conventions, SURVEY.md §2.9, §5)."""

import numpy as np

import smc_jax
from smc_jax import GenericModel, Setting, smc_settings_kwargs, rawpath, dataroot
from smc_jax.params import parameter
from smc_jax.distributions import Normal


def _model():
    m = GenericModel("linear", "ss0")
    m <= parameter("a", 0.0, (-10, 10), prior=Normal(0, 1))
    m <= Setting("n_particles", 400)
    m <= Setting("n_phi", 100)
    m <= Setting("lambda", 2.0)
    m <= Setting("n_smc_blocks", 3)
    m <= Setting("resampler_smc", "polyalgo")
    m <= Setting("mixture_proportion", 0.9)
    m <= Setting("data_vintage", "200707")
    return m

def test_le_operator_adds():
    m = _model()
    assert len(m.parameters) == 1
    assert m["n_particles"] == 400


def test_settings_to_kwargs():
    kw = smc_settings_kwargs(_model())
    assert kw == {"n_parts": 400, "n_phi": 100, "lam": 2.0, "n_blocks": 3,
                  "resampling_method": "polyalgo", "alpha": 0.9}


def test_rawpath_vintage_stamped():
    m = _model()
    m.set("saveroot", "/tmp/save")
    p = rawpath(m, "estimate", "smc_cloud.npz", ["iter=1"])
    assert p == ("/tmp/save/output_data/linear/ss0/estimate/raw/"
                 "smc_cloud_vint=200707_iter=1.npz")
    assert dataroot(m) == "data"


def test_param_space_from_model():
    sp = _model().param_space()
    assert sp.n_para == 1 and sp.n_free == 1


def test_block_generation_helpers():
    """generate_free_blocks / generate_all_blocks parity
    (reference src/helpers.jl:215-260)."""
    import jax
    blocks = smc_jax.generate_free_blocks(jax.random.PRNGKey(0), 10, 3)
    sizes = [len(b) for b in blocks]
    assert sizes == [4, 4, 2]
    flat = np.sort(np.concatenate([np.asarray(b) for b in blocks]))
    np.testing.assert_array_equal(flat, np.arange(10))
    free_inds = np.array([0, 2, 3, 5, 6, 7, 8, 11, 12, 14])
    all_blocks = smc_jax.generate_all_blocks(blocks, free_inds)
    for bf, ba in zip(blocks, all_blocks):
        np.testing.assert_array_equal(np.asarray(ba),
                                      free_inds[np.asarray(bf)])
    pblocks = smc_jax.generate_param_blocks(jax.random.PRNGKey(1), 9, 2)
    assert [len(b) for b in pblocks] == [5, 4]
    for b in pblocks:  # sorted within block (reference :202)
        assert np.all(np.diff(np.asarray(b)) > 0)
