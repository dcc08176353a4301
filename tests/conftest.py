"""Test configuration: run all tests on CPU with 8 virtual devices so
sharding/collective paths are exercised without accelerator hardware
(SURVEY.md §4 "multi-host behavior testable with
xla_force_host_platform_device_count").

The platform is forced through jax.config as well as JAX_PLATFORMS, so an
environment that pre-imports jax with another platform still runs here on
the CPU. XLA_FLAGS works because backends initialize lazily."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compile cache: makes re-runs of the suite much faster.
from smc_jax.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
