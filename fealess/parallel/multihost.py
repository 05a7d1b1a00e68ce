"""Multi-host process model: bootstrap + per-host frame feeding.

The reference is strictly single-process (CadReco/obj_reco_lmicp.cpp:
86-204 runs one core); scaling Recognition past one host (BASELINE.json
config 5, "N >= 2 hosts") needs the JAX multi-controller model: every
host runs the same program, ``jax.distributed.initialize`` wires the
processes into one runtime, meshes span all hosts' devices, and each
host feeds only its local shard of the frame batch
(``jax.make_array_from_process_local_data``) — the per-host data
pipeline of SURVEY.md §2.6.  Collectives ride ICI within a slice and DCN
across hosts; the steady-state batch-recon path is pure data parallelism
(no collectives), so scaling is limited only by the per-host feed.

Tested with a real 2-process CPU launch (tests/test_multihost.py) — the
standard JAX substitute for a multi-host pod.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import jax

from fealess.utils.logging import get_logger


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Join this process into the multi-host runtime.

    Arguments fall back to the standard environment variables
    (``FEALESS_COORDINATOR`` / ``FEALESS_NUM_PROCESSES`` /
    ``FEALESS_PROCESS_ID``, then JAX's own cluster autodetection where
    a cluster manager provides it).  Safe to call once per process,
    before any device use.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "FEALESS_COORDINATOR")
    if num_processes is None and "FEALESS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["FEALESS_NUM_PROCESSES"])
    if process_id is None and "FEALESS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["FEALESS_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids)
    get_logger().info(
        "multihost: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count())


def global_mesh(axis: str = "d") -> jax.sharding.Mesh:
    """One-axis mesh over ALL processes' devices (frame/data axis)."""
    return jax.sharding.Mesh(np.asarray(jax.devices()), (axis,))


def feed_local_batch(mesh: jax.sharding.Mesh, local_arrays, axis: str = "d"):
    """Assemble a globally-sharded batch from THIS host's local frames.

    ``local_arrays`` is a pytree of numpy arrays whose leading axis is
    this host's local batch; the returned jax.Arrays have global leading
    axis ``local * process_count`` sharded over ``axis`` with every
    shard resident on the host that produced it (no cross-host copy).
    """
    spec = jax.sharding.PartitionSpec(axis)
    sharding = jax.sharding.NamedSharding(mesh, spec)

    def put(x):
        return jax.make_array_from_process_local_data(sharding, x)

    return jax.tree.map(put, local_arrays)


def replicate(mesh: jax.sharding.Mesh, tree):
    """Replicate a pytree (bank, model depths, tables) over the mesh."""
    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            repl, np.asarray(x)), tree)
