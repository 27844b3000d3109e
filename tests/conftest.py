"""Test configuration: JAX on a virtual 8-device CPU mesh by default.

The suite runs on the CPU, where 8 virtual devices stand in for a
multi-card mesh, unless ``JAX_PLATFORMS`` is set explicitly.  The
``gpu``-marked tests need a card and skip without one; run them on a GPU
host with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
