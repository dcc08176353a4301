"""True multi-process SPMD: two coordinated processes (4 virtual CPU devices
each) run the SAME smc() program over an 8-device global mesh and must
produce bit-identical results — the multi-host discipline that replaces the
reference's master/worker asymmetry (SURVEY.md §2.8: jax.distributed +
shared PRNG key)."""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r'''
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from smc_jax.parallel.mesh import initialize_multihost, particle_mesh
initialize_multihost(coordinator_address=f"localhost:{{port}}",
                     num_processes=nproc, process_id=pid)
import numpy as np
import smc_jax
from smc_jax.models.linear import (linear_parameters, make_linear_loglike,
                                   generate_linear_data)
data, X = generate_linear_data(seed=1793)
ll = make_linear_loglike(X)
res = smc_jax.smc(ll, linear_parameters(), data,
                  n_parts=512, n_phi=20, lam=2.0, verbose="none", seed=42,
                  mesh=particle_mesh(), store_weight_matrices=False)
print("RESULT", repr(float(res.log_mdd)),
      repr([float(v) for v in res.posterior_mean()]))
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_smc_bit_identical(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=repo))
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=540)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert lines, out
        outs.append(lines[-1])
    assert outs[0] == outs[1], f"processes disagree:\n{outs[0]}\n{outs[1]}"
