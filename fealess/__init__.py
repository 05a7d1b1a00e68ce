"""fealess: an RGB-D 6DoF object-pose engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
rlvc/FEALESS reference (LINE-MOD template matching + ICP pose refinement +
KCF tracking) for an accelerator:

- dense, statically-shaped tensor formulations instead of pointer-chased
  "linear memories" (reference: linemod/linemod.cpp:1060-1117),
- brute-force fused nearest-neighbour ICP instead of FLANN kd-trees
  (reference: ICP/ICP.cpp:114-279),
- `shard_map` template/candidate sharding over a `jax.sharding.Mesh` with
  psum/argmax collectives instead of a single-core SIMD loop.

Public API lives in :mod:`fealess.engine` (the ``ObjReco`` facade,
mirroring CadReco/obj_reco_temp.h:6-30) and the per-stage modules below.
"""

__version__ = "0.1.0"

from fealess import config  # noqa: F401

__all__ = ["config", "__version__"]
