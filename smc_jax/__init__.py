"""smc_jax — a Sequential Monte Carlo inference engine in JAX.

A from-scratch JAX/XLA implementation of adaptive-tempered and
generalized-tempering SMC with the capabilities of FRBNY-DSGE/SMC.jl
(reference surveyed in SURVEY.md). The particle cloud lives as (optionally
sharded) JAX arrays; correction, ESS, the adaptive-phi bisection, weighted
moments, resampling, and the blocked random-walk Metropolis-Hastings mutation
are all batched XLA programs that scale over a ``jax.sharding.Mesh``.

Public surface (mirrors SMC.jl's exports, reference src/SMC.jl:14-17):
    smc, Cloud, get_cloud, mutation, resample, mvnormal_mixture_draw,
    initial_draw, split_cloud, join_cloud, add_parameters_to_cloud
plus the parameter-spec layer that replaces ModelConstructors.jl.
"""

import jax as _jax

# The reference carries weights/log-likelihoods in Float64 throughout; log-MDD
# accuracy demands it (SURVEY.md §7). The SMC state is
# matmul-light so f64 costs little; model likelihoods are free to use
# f32/bf16 internally.
_jax.config.update("jax_enable_x64", True)

from smc_jax import distributions
from smc_jax.params import (
    Parameter,
    ParamSpace,
    Untransformed,
    SquareRoot,
    Exponential,
)
from smc_jax.cloud import (
    Cloud,
    weighted_mean,
    weighted_cov,
    weighted_std,
    weighted_quantile,
    split_cloud,
    join_cloud,
    add_parameters_to_cloud,
)
from smc_jax.ops.resample import resample
from smc_jax.ops.correction import (compute_ess, incremental_weights,
    log_incremental_weights)
from smc_jax.ops.mutation import (mutation, mvnormal_mixture_draw,
    compute_proposal_densities, generate_free_blocks, generate_all_blocks,
    generate_param_blocks)
from smc_jax.ops.initialization import (initial_draw, initialize_likelihoods,
    one_draw, draw_likelihood)
from smc_jax.distributions import DegenerateMvNormal, get_cov
from smc_jax.io import (get_cloud, save_cloud, load_cloud,
    split_cloud_file, join_cloud_file)
from smc_jax.settings import (GenericModel, Setting, smc_settings_kwargs,
    rawpath, dataroot, DATE_FORMAT)
from smc_jax.ops.schedule import solve_adaptive_phi, fixed_schedule
from smc_jax.diagnostics import VERBOSITY, check_nan_ess
from smc_jax.smc import smc, SMCResult, marginal_data_density

__version__ = "0.1.0"

__all__ = [
    "smc",
    "SMCResult",
    "Cloud",
    "Parameter",
    "ParamSpace",
    "distributions",
    "resample",
    "mutation",
    "mvnormal_mixture_draw",
    "initial_draw",
    "initialize_likelihoods",
    "one_draw",
    "draw_likelihood",
    "DegenerateMvNormal",
    "get_cov",
    "compute_ess",
    "incremental_weights",
    "log_incremental_weights",
    "weighted_mean",
    "weighted_cov",
    "weighted_std",
    "weighted_quantile",
    "split_cloud",
    "join_cloud",
    "add_parameters_to_cloud",
    "get_cloud",
    "save_cloud",
    "load_cloud",
    "marginal_data_density",
    "Untransformed",
    "SquareRoot",
    "Exponential",
    "compute_proposal_densities",
    "generate_free_blocks",
    "generate_all_blocks",
    "generate_param_blocks",
    "split_cloud_file",
    "join_cloud_file",
    "GenericModel",
    "Setting",
    "smc_settings_kwargs",
    "rawpath",
    "dataroot",
    "DATE_FORMAT",
    "solve_adaptive_phi",
    "fixed_schedule",
    "VERBOSITY",
    "check_nan_ess",
]
