"""Device mesh & sharding for the particle axis.

The reference's only parallelism is data-parallelism over particles through
Julia's Distributed stdlib: broadcast closures, scatter index ranges, gather
results to a master that does all weight/covariance/resampling math serially
(reference src/util.jl:93-111, SURVEY.md §2.8, §2.10).

The equivalent here is SPMD over a 1-D mesh whose single axis is the
particle dimension N:

  * cloud arrays carry NamedSharding(mesh, P("parts")) on their leading axis;
  * reductions (weight sums, ESS, weighted mean/cov, the adaptive-phi
    bisection's inner reductions) lower to all-reduces between devices;
  * resampling's row gather lowers to collective gathers (all-to-all-ish);
  * there is no master: every process runs the same program with the same
    PRNG key, so phi choices and resampling indices are bit-identical
    everywhere.

Weighted mean/cov stay exact global quantities — they are matmuls against
the sharded [N, P] params with an implicit psum: one all-reduce of a P x P
matrix (P <~ 100: a few KB on the wire per stage).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

PARTICLE_AXIS = "parts"


def particle_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or given) devices with axis name "parts"."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (PARTICLE_AXIS,))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for arrays whose leading axis is the particle dimension."""
    return NamedSharding(mesh, PartitionSpec(PARTICLE_AXIS))


def shard_cloud(cloud, mesh: Mesh):
    """Device_put every cloud array with the particle sharding."""
    sh = particle_sharding(mesh)
    for f in ("params", "loglh", "logprior", "old_loglh", "accept", "weights"):
        setattr(cloud, f, jax.device_put(getattr(cloud, f), sh))
    return cloud


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Multi-host SPMD bring-up: `jax.distributed.initialize`. Pass the
    coordinator address, process count and process id; only some cluster
    managers let JAX detect them. After this, `particle_mesh()` spans every
    process's devices (SURVEY.md §2.8)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
