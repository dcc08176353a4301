"""Persistence: cloud save/load, intermediate checkpoints, final artifacts.

Reference L5 (SURVEY.md §1): jld2 cloud + w/W matrices (src/smc_main.jl:
513-526), intermediate per-stage checkpoints (:499-507), `get_cloud`
(src/util.jl:113-115), and an h5 params-only store.

Here the container is npz (numpy archive): arrays stored natively, scalar
state as an embedded JSON string. Unlike the reference, checkpoints include
the PRNG key, so a resumed run is bit-identical to an uninterrupted one
(the reference's resume is explicitly not bit-reproducible — SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from smc_jax.cloud import Cloud

_ARRAY_FIELDS = ("params", "loglh", "logprior", "old_loglh", "accept", "weights")
_SCALAR_FIELDS = ("tempering_schedule", "ESS", "stage_index", "n_phi",
                  "resamples", "c", "accept_rate", "total_sampling_time")


def save_cloud(path: str, cloud: Cloud, extra: Optional[dict] = None) -> None:
    """Write a cloud (arrays + scalar state [+ extra arrays]) to one npz."""
    payload = {f: np.asarray(getattr(cloud, f)) for f in _ARRAY_FIELDS}
    meta = {f: getattr(cloud, f) for f in _SCALAR_FIELDS}
    payload["_meta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    if extra:
        for k, v in extra.items():
            payload["extra_" + k] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic: a crash mid-write can't corrupt a checkpoint


def load_cloud(path: str) -> Tuple[Cloud, dict]:
    """Read a cloud written by save_cloud. Returns (cloud, extra_dict)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta"].tobytes()).decode("utf-8"))
        cloud = Cloud(
            params=jnp.asarray(z["params"]),
            loglh=jnp.asarray(z["loglh"]),
            logprior=jnp.asarray(z["logprior"]),
            old_loglh=jnp.asarray(z["old_loglh"]),
            accept=jnp.asarray(z["accept"]),
            weights=jnp.asarray(z["weights"]),
            tempering_schedule=list(meta["tempering_schedule"]),
            ESS=list(meta["ESS"]),
            stage_index=int(meta["stage_index"]),
            n_phi=int(meta["n_phi"]),
            resamples=int(meta["resamples"]),
            c=float(meta["c"]),
            accept_rate=float(meta["accept_rate"]),
            total_sampling_time=float(meta["total_sampling_time"]),
        )
        extra = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
    return cloud, extra


def get_cloud(path: str) -> Cloud:
    """Load just the cloud (reference get_cloud, src/util.jl:113-115)."""
    return load_cloud(path)[0]


def save_particle_store(path: str, cloud: Cloud) -> None:
    """Params-only store (reference h5 'smcparams', src/smc_main.jl:513-520).
    Written as HDF5 when h5py is importable and the path ends in .h5/.hdf5,
    else as .npy next to the requested path."""
    params = np.asarray(cloud.params)
    if path.endswith((".h5", ".hdf5")):
        try:
            import h5py
            with h5py.File(path, "w") as f:
                f.create_dataset("smcparams", data=params)
            return
        except ImportError:
            path = path + ".npy"
    np.save(path if path.endswith(".npy") else path + ".npy", params)


def split_cloud_file(path: str, n_pieces: int) -> list:
    """Split a saved cloud into n_pieces row-slice files
    `<path>_part{i}.npz` (reference split_cloud, src/particle.jl:542-598 —
    its workaround for GitHub's 100MB limit). Returns the piece paths."""
    from smc_jax.cloud import split_cloud as _split
    cloud, extra = load_cloud(path)
    base = path[:-4] if path.endswith(".npz") else path
    out = []
    for i, piece in enumerate(_split(cloud, n_pieces), start=1):
        p = f"{base}_part{i}.npz"
        save_cloud(p, piece, extra=extra if i == 1 else None)
        out.append(p)
    return out


def join_cloud_file(path: str, n_pieces: int) -> str:
    """Rejoin `<path>_part{i}.npz` pieces into `<path>` (reference
    join_cloud, src/particle.jl:600-648). Returns the joined path."""
    from smc_jax.cloud import join_cloud as _join
    base = path[:-4] if path.endswith(".npz") else path
    pieces, extra = [], {}
    for i in range(1, n_pieces + 1):
        c, e = load_cloud(f"{base}_part{i}.npz")
        pieces.append(c)
        if e:
            extra = e
    joined = _join(pieces)
    save_cloud(path if path.endswith(".npz") else path + ".npz", joined,
               extra=extra or None)
    return path


def intermediate_path(savepath: str, stage: int) -> str:
    """Per-stage checkpoint path (reference `_stage=K` suffixing,
    src/smc_main.jl:500)."""
    base = savepath[:-4] if savepath.endswith(".npz") else savepath
    return f"{base}_stage={stage}.npz"


def save_checkpoint(savepath: str, stage: int, cloud: Cloud, w_matrix,
                    W_matrix, j: int, phi_prop: float, log_mdd: float,
                    rng_key) -> None:
    """Intermediate checkpoint with full loop state (reference
    src/smc_main.jl:499-507 saves {cloud, w, W, j}); we add phi_prop, the
    running log-MDD, and the PRNG key for bit-reproducible resume."""
    save_cloud(intermediate_path(savepath, stage), cloud, extra={
        "w": w_matrix,
        "W": W_matrix,
        "j": np.asarray(j),
        "phi_prop": np.asarray(phi_prop),
        "log_mdd": np.asarray(log_mdd),
        "rng_key": np.asarray(rng_key),
    })


def load_checkpoint(path: str):
    """Restore (cloud, w, W, j, phi_prop, log_mdd, rng_key)."""
    cloud, extra = load_cloud(path)
    return (cloud, extra["w"], extra["W"], int(extra["j"]),
            float(extra["phi_prop"]), float(extra.get("log_mdd", 0.0)),
            extra.get("rng_key"))
