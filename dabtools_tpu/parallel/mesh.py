"""Device-mesh construction and multihost bring-up (N16).

The reference is a single Linux process (SURVEY.md s5.8); here the runtime
substrate is a `jax.sharding.Mesh` whose axes the receiver pipelines shard
over: ``channels`` (independent ensembles, DP-like) x ``time`` (time blocks
of one stream, SP-like).  The mesh only reshapes ``jax.devices()``: the
cards of one host reach each other all to all (NVLink), so the axes follow
the algorithm, not a topology.  Collectives are XLA's (NCCL on GPUs), not
a custom transport.
"""

from __future__ import annotations

import jax
import numpy as np


def make_receiver_mesh(n_channels: int | None = None,
                       n_time: int | None = None,
                       devices=None) -> jax.sharding.Mesh:
    """Build a (channels, time) mesh over the available devices.

    Defaults: all devices on the ``channels`` axis (the embarrassingly
    parallel direction), ``time=1``.  Pass explicit sizes for mixed
    sharding; their product must equal the device count.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n_channels is None and n_time is None:
        n_channels, n_time = n, 1
    elif n_channels is None:
        n_channels = n // n_time
    elif n_time is None:
        n_time = n // n_channels
    if n_channels * n_time != n:
        raise ValueError(
            f"mesh {n_channels}x{n_time} != {n} devices")
    return jax.sharding.Mesh(devices.reshape(n_channels, n_time),
                             ("channels", "time"))


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """`jax.distributed.initialize` wrapper for multi-process runs.

    With one process this is a no-op; otherwise call it before any
    backend use (every process), then build the mesh over
    ``jax.devices()`` (which spans processes).  Halo exchange between
    shards in different processes then goes through XLA's collectives.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
