"""Test harness: the CPU backend with an 8-device virtual mesh.

Every test runs on the CPU, also on a machine with a GPU: multi-device
sharding is validated on one host via
``xla_force_host_platform_device_count`` (SURVEY.md §4), and the GPU is
exercised by ``chip_smoke.py`` instead.  ``jax_platforms`` is also set
through jax.config (before any backend initializes), in case something
set it before this file ran.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
