"""Test config: run JAX on a virtual 8-device CPU mesh.

JAX reads ``JAX_PLATFORMS`` and ``XLA_FLAGS`` when its backend first
initializes, so both are set here, before any test module imports jax.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
