"""Parallel runtime: device meshes, sharding, multi-host SPMD setup —
the replacement for the reference's Distributed.jl layer (SURVEY.md §2.8)."""

from smc_jax.parallel.mesh import (
    particle_mesh,
    particle_sharding,
    shard_cloud,
    initialize_multihost,
)

__all__ = ["particle_mesh", "particle_sharding", "shard_cloud",
           "initialize_multihost"]
