"""Device-mesh helpers: the framework's communication backend.

The reference is single-process/single-core (SURVEY.md §2.6); this
build's parallel axes are:

- ``t`` — template-bank sharding (TP-analog): the matchClass template loop
  (linemod/linemod.cpp:1458) splits by template slot; scores reduce via
  top-k merge after an all_gather.
- ``d`` — data parallelism over frames / candidate detections.
- ``p`` — point sharding inside ICP reductions (SP-analog): partial
  covariance / centroid sums + psum (ICP/ICP.cpp:730-735).

Meshes are plain ``jax.sharding.Mesh`` objects built from ``jax.devices()``;
collectives are emitted by ``shard_map``-decorated functions in the sibling
modules and compiled by XLA (NCCL between GPUs).  GPUs of one host are
joined all to all, so a mesh follows the algorithm, not a topology.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axes: Sequence[Tuple[str, int]],
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh from (axis_name, size) pairs, e.g. [("d", 2), ("t", 4)].

    Sizes must multiply to the device count (use -1 once to infer).
    """
    devices = list(devices if devices is not None else jax.devices())
    names = [a for a, _ in axes]
    sizes = [s for _, s in axes]
    if sizes.count(-1) == 1:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(devices) // known
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(f"mesh {list(zip(names, sizes))} != {len(devices)} devices")
    arr = np.asarray(devices).reshape(sizes)
    return Mesh(arr, tuple(names))


def template_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D template-sharding mesh over all (or the first n) devices."""
    devs = jax.devices() if n_devices is None else jax.devices()[:n_devices]
    return make_mesh([("t", len(devs))], devs)


def shard_bank(bank, mesh: Mesh, axis: str = "t"):
    """Place a TemplateBank with the template axis sharded over ``axis``.

    The capacity must divide by the axis size (pad the bank accordingly).
    """
    spec = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, spec), bank)


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
