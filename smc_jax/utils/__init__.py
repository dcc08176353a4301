"""Small shared utilities (reference src/util.jl's non-runtime pieces)."""

from smc_jax.utils.misc import ceil_div, real_sort_key

__all__ = ["ceil_div", "real_sort_key"]
