"""Test env: hermetic CPU JAX with 8 virtual devices for sharding tests.

The CPU is selected with ``jax.config.update`` before first backend use,
which holds even if jax was imported before the environment was read
(SURVEY.md s4 item 4: tests must be CPU-hermetic).  Tests marked ``gpu``
need the card; they skip here, and ``python chip_smoke.py`` runs their
content on the GPU.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
