"""Template-bank checkpointing: sharded array checkpoint + YAML interop.

The reference's only persistent state is the YAML template database
(linemod/linemod_if.cpp:36-63, Detector::writeClass linemod.cpp:1764-1794)
— a single-file host-side format.  Here the packed ``TemplateBank`` (a
pytree of device arrays, possibly sharded over a mesh axis) checkpoints
natively via orbax, preserving shardings, with:

- :func:`save_bank` / :func:`load_bank` — orbax checkpoint of the bank
  pytree + a JSON sidecar of detector config and class names;
- :func:`export_yaml` / :func:`import_yaml` — lossless round-trip to the
  reference's ``linemod_templates.yml`` schema (fealess.io.
  linemod_yaml), so banks trained here load in the C++ reference and
  vice versa.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np

from fealess import config as cfg
from fealess.bank import TemplateBank, pack_bank, unpack_bank
from fealess.io import linemod_yaml

_META = "bank_meta.json"
_ARRAYS = "arrays"


def _det_to_dict(det: cfg.DetectorConfig) -> dict:
    d = dataclasses.asdict(det)
    d["t_at_level"] = list(det.t_at_level)
    return d


def _det_from_dict(d: dict) -> cfg.DetectorConfig:
    d = dict(d)
    cg = cfg.ColorGradientConfig(**d.pop("color_gradient"))
    dn = cfg.DepthNormalConfig(**d.pop("depth_normal"))
    d["t_at_level"] = tuple(d["t_at_level"])
    if "modalities" in d:
        d["modalities"] = tuple(d["modalities"])
    return cfg.DetectorConfig(color_gradient=cg, depth_normal=dn, **d)


def save_bank(directory: str, bank: TemplateBank,
              det: Optional[cfg.DetectorConfig] = None) -> None:
    """Checkpoint a packed bank (orbax; preserves shardings)."""
    import jax
    import orbax.checkpoint as ocp

    os.makedirs(directory, exist_ok=True)
    arrays = {f.name: getattr(bank, f.name)
              for f in dataclasses.fields(bank)
              if not f.metadata.get("static")}
    ckptr = ocp.StandardCheckpointer()
    path = os.path.abspath(os.path.join(directory, _ARRAYS))
    ckptr.save(path, arrays, force=True)
    ckptr.wait_until_finished()
    meta = {"class_names": list(bank.class_names),
            "max_span": bank.max_span,
            "detector": _det_to_dict(det) if det else None,
            "format_version": 1}
    with open(os.path.join(directory, _META), "w") as fh:
        json.dump(meta, fh, indent=1)
    del jax


def load_bank(directory: str
              ) -> Tuple[TemplateBank, Optional[cfg.DetectorConfig]]:
    """Restore a bank checkpoint (single-host restore; re-shard with
    jax.device_put(bank, sharding) as needed)."""
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    with open(os.path.join(directory, _META)) as fh:
        meta = json.load(fh)
    ckptr = ocp.StandardCheckpointer()
    arrays = ckptr.restore(os.path.abspath(
        os.path.join(directory, _ARRAYS)))
    bank = TemplateBank(class_names=tuple(meta["class_names"]),
                        max_span=int(meta.get("max_span", 0)),
                        **{k: jnp.asarray(v) for k, v in arrays.items()})
    det = _det_from_dict(meta["detector"]) if meta["detector"] else None
    return bank, det


def export_yaml(path: str, bank: TemplateBank,
                det: cfg.DetectorConfig) -> None:
    """Write the bank in the reference ``linemod_templates.yml`` schema."""
    linemod_yaml.save_linemod(path, det, unpack_bank(bank))


def import_yaml(path: str, capacity: Optional[int] = None,
                max_features: int = 63
                ) -> Tuple[TemplateBank, cfg.DetectorConfig]:
    """Load a reference YAML database into a packed bank."""
    det, classes = linemod_yaml.load_linemod(path)
    n = sum(len(v) for v in classes.values())
    bank = pack_bank(classes, levels=det.pyramid_levels,
                     capacity=capacity or max(n, 1),
                     max_features=max_features)
    return bank, det
