"""Serialized serving artifact — the analog of ``libObjRecoLmICP.so``.

The reference ships its engine as a prebuilt Android shared object
(/root/reference/android/Android.mk:1-37, readme.txt:1-9): deployment
loads a binary artifact, not sources.  The analog here packages the FUSED
Recognition step (pipeline.recognize_top1 — match + top-1 + ICP refine as
one program) plus all engine state into one directory:

- ``recognition.jaxexport`` — the step exported with ``jax.export``.  A
  fresh process loads it and calls it WITHOUT re-tracing/lowering the
  Python pipeline (the dominant cold-start cost; XLA backend compilation
  is additionally absorbed by the persistent compilation cache both paths
  share).  Two formats: ``Exported.serialize`` where the ``flatbuffers``
  package is installed (``fealess-artifact-1``), else the serialized
  StableHLO module with its calling signature (trees, shapes, platforms)
  in ``meta.json``, from which the loader rebuilds the ``Exported``
  (``fealess-artifact-2``; tests/test_export.py pins the rebuild against
  ``jax.export.deserialize``);
- ``state.npz`` — packed bank arrays, pre-cropped model-depth stack,
  crop origins, and the per-level score tables (everything ``add_obj``
  computes from the YAML + depth pngs);
- ``meta.json`` — the engine config, the bank's static fields and the JAX
  version that wrote the artifact.

On a CUDA device the step holds the Triton coarse-score kernel
(fealess.ops.score_pallas), a custom call that ``jax.export`` does not
promise to keep stable across JAX versions.  The export therefore disables
that one safety check, and the loader refuses an artifact that records
another JAX version (which also covers the ``Exported`` fields rebuilt
for the second format).

``ObjReco.export_artifact`` writes it; :class:`ServingArtifact` serves
from it (same host pre/post as the engine: PrepareInputData resize/pad,
result decode).  Round-trip equality and the measured cold-start drop are
pinned by tests/test_export.py.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

_EXPORT_FILE = "recognition.jaxexport"
_STATE_FILE = "state.npz"
_META_FILE = "meta.json"
_TRITON_CALL = "__gpu$xla.gpu.triton"
_SERIALIZED = "fealess-artifact-1"       # Exported.serialize()
_MODULE = "fealess-artifact-2"           # StableHLO module + meta.json


def _serialized(exported) -> Optional[bytes]:
    """``jax.export``'s own serialization, or None without flatbuffers."""
    try:
        return bytes(exported.serialize())
    except ImportError:
        return None


def _exported_to_meta(exp) -> dict:
    """The calling signature of a single-device, effect-free export."""
    if (any(s is not None for s in exp.in_shardings_hlo
            + exp.out_shardings_hlo)
            or exp.ordered_effects or exp.unordered_effects):
        raise ValueError("only single-device, effect-free steps export")

    def tree(t):
        return base64.b64encode(t.serialize_using_proto()).decode()

    return {
        "fun_name": exp.fun_name,
        "in_tree": tree(exp.in_tree),
        "out_tree": tree(exp.out_tree),
        "in_avals": [[list(a.shape), str(a.dtype)] for a in exp.in_avals],
        "out_avals": [[list(a.shape), str(a.dtype)] for a in exp.out_avals],
        "nr_devices": exp.nr_devices,
        "platforms": list(exp.platforms),
        "calling_convention_version": exp.calling_convention_version,
        "module_kept_var_idx": list(exp.module_kept_var_idx),
        "uses_global_constants": exp.uses_global_constants,
    }


def _exported_from_meta(meta: dict, module: bytes):
    import jax
    from jax import export as jexport
    from jax import tree_util

    def tree(b):
        return tree_util.PyTreeDef.deserialize_using_proto(
            tree_util.default_registry, base64.b64decode(b))

    def avals(specs):
        return tuple(jax.core.ShapedArray(tuple(shape), np.dtype(dtype))
                     for shape, dtype in specs)

    n_in, n_out = len(meta["in_avals"]), len(meta["out_avals"])
    return jexport.Exported(
        fun_name=meta["fun_name"], in_tree=tree(meta["in_tree"]),
        in_avals=avals(meta["in_avals"]), out_tree=tree(meta["out_tree"]),
        out_avals=avals(meta["out_avals"]), _has_named_shardings=False,
        _in_named_shardings=(None,) * n_in,
        _out_named_shardings=(None,) * n_out,
        in_shardings_hlo=(None,) * n_in, out_shardings_hlo=(None,) * n_out,
        nr_devices=meta["nr_devices"], platforms=tuple(meta["platforms"]),
        ordered_effects=(), unordered_effects=(),
        disabled_safety_checks=(
            jexport.DisabledSafetyCheck.custom_call(_TRITON_CALL),),
        mlir_module_serialized=module,
        calling_convention_version=meta["calling_convention_version"],
        module_kept_var_idx=tuple(meta["module_kept_var_idx"]),
        uses_global_constants=meta["uses_global_constants"], _get_vjp=None)


def _engine_cfg_to_dict(ecfg) -> dict:
    return dataclasses.asdict(ecfg)


def _engine_cfg_from_dict(d: dict):
    from fealess import config as cfg

    det = d.pop("detector")
    icp = d.pop("icp")
    cg = det.pop("color_gradient")
    dn = det.pop("depth_normal")
    det["t_at_level"] = tuple(det["t_at_level"])
    det["modalities"] = tuple(det["modalities"])
    return cfg.EngineConfig(
        detector=cfg.DetectorConfig(color_gradient=cfg.ColorGradientConfig(
            **cg), depth_normal=cfg.DepthNormalConfig(**dn), **det),
        icp=cfg.IcpConfig(**icp), **d)


def _state_arrays(eng) -> dict:
    bank = eng.bank
    out = {f"bank_{f}": np.asarray(getattr(bank, f))
           for f in ("feat_x", "feat_y", "feat_label", "feat_valid",
                     "width", "height", "offset_x", "offset_y", "pose",
                     "class_idx", "template_idx", "valid")}
    out["model_depth"] = np.asarray(eng._model_depth_dev)
    out["origins"] = np.asarray(eng._origins_dev)
    for l, tab in enumerate(eng._kernels):
        if tab is None:
            continue
        for key, arr in tab.items():
            out[f"table_{l}_{key}"] = np.asarray(arr)
    return out


def export_artifact(eng, path: str) -> None:
    """Serialize the engine's fused Recognition step + state to ``path``
    (a directory).  The export is keyed on the loaded bank's shapes and
    the engine config — exactly what ``add_obj`` pins."""
    import jax
    import jax.numpy as jnp
    from jax import export as jexport

    from fealess import pipeline

    if eng.bank is None:
        raise RuntimeError("add_obj not called; nothing to export")
    os.makedirs(path, exist_ok=True)
    ecfg = eng.cfg
    d = ecfg.detector
    class_names = eng.bank.class_names
    max_span = eng.bank.max_span

    # The exported signature uses ONLY standard containers (jax.export
    # cannot serialize custom pytree types); the bank/result structs are
    # (re)assembled inside the step / on the host.
    def step(state, bgr, depth, scene_k):
        from fealess.bank import TemplateBank

        bank = TemplateBank(**state["bank"], class_names=class_names,
                            max_span=max_span)
        out = pipeline.recognize_top1(bank, state["md"], state["org"],
                                      bgr, depth, scene_k, ecfg,
                                      kernels=state["tables"])
        return {"pose": out.pose, "valid": out.valid,
                "similarity": out.similarity, "class_idx": out.class_idx,
                "template_slot": out.template_slot,
                "match_x": out.match_x, "match_y": out.match_y,
                "icp_dist": out.refine.icp.dist_mean,
                "inlier_ratio": out.refine.icp.inlier_ratio}

    state = {
        "bank": {f: getattr(eng.bank, f)
                 for f in ("feat_x", "feat_y", "feat_label", "feat_valid",
                           "width", "height", "offset_x", "offset_y",
                           "pose", "class_idx", "template_idx", "valid")},
        "md": eng._model_depth_dev,
        "org": eng._origins_dev,
        "tables": eng._kernels,
    }
    spec = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.asarray(a).dtype),
        (state,
         jnp.zeros((d.image_height, d.image_width, 3), jnp.uint8),
         jnp.zeros((d.image_height, d.image_width), jnp.uint16),
         jnp.zeros((3, 3), jnp.float32)))
    exported = jexport.export(
        jax.jit(step),
        disabled_checks=[jexport.DisabledSafetyCheck.custom_call(
            _TRITON_CALL)])(*spec)
    blob = _serialized(exported)
    with open(os.path.join(path, _EXPORT_FILE), "wb") as f:
        f.write(exported.mlir_module_serialized if blob is None else blob)
    np.savez_compressed(os.path.join(path, _STATE_FILE),
                        **_state_arrays(eng))
    meta = {
        "engine_config": _engine_cfg_to_dict(ecfg),
        "class_names": list(eng.bank.class_names),
        "max_span": int(eng.bank.max_span),
        "levels": int(eng.bank.levels),
        "version": _SERIALIZED if blob is not None else _MODULE,
        "jax_version": jax.__version__,
    }
    if blob is None:
        meta["exported"] = _exported_to_meta(exported)
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f)


class ServingArtifact:
    """Deployment-side engine: load + serve without the Python pipeline.

    ``recognition(bgr, depth, cam)`` matches ``ObjReco.recognition``'s
    contract and results (tested); only the traced step differs — it is
    the deserialized export, so a cold process never re-traces the match/
    refine pipeline.
    """

    def __init__(self, path: str):
        import jax
        import jax.numpy as jnp

        from fealess.bank import TemplateBank

        with open(os.path.join(path, _META_FILE)) as f:
            meta = json.load(f)
        version = meta.get("version")
        if version not in (_SERIALIZED, _MODULE):
            raise IOError(f"unknown artifact version in {path}")
        # Artifacts that predate the Triton kernel record no JAX version;
        # jax.export's own compatibility rules cover them.
        if (version == _MODULE or "jax_version" in meta) \
                and meta.get("jax_version") != jax.__version__:
            raise IOError(
                f"artifact {path} was written by JAX "
                f"{meta.get('jax_version')}; this process runs JAX "
                f"{jax.__version__} (its Triton kernel call is not stable "
                f"across versions): re-export it")
        self.cfg = _engine_cfg_from_dict(meta["engine_config"])
        state = np.load(os.path.join(path, _STATE_FILE))
        self.bank = TemplateBank(
            **{f: jnp.asarray(state[f"bank_{f}"])
               for f in ("feat_x", "feat_y", "feat_label", "feat_valid",
                         "width", "height", "offset_x", "offset_y",
                         "pose", "class_idx", "template_idx", "valid")},
            class_names=tuple(meta["class_names"]),
            max_span=meta["max_span"])
        self._model_depth_dev = jnp.asarray(state["model_depth"])
        self._origins_dev = jnp.asarray(state["origins"])
        kernels = []
        for l in range(meta["levels"]):
            keys = [k for k in state.files if k.startswith(f"table_{l}_")]
            if not keys:
                kernels.append(None)
                continue
            kernels.append({k.split("_", 2)[2]: jnp.asarray(state[k])
                            for k in keys})
        self._kernels = tuple(kernels)
        with open(os.path.join(path, _EXPORT_FILE), "rb") as f:
            blob = f.read()
        if version == _SERIALIZED:
            from jax import export as jexport

            self._call = jexport.deserialize(bytearray(blob)).call
        else:
            self._call = _exported_from_meta(meta["exported"], blob).call

    def recognition(self, rgb_bgr: np.ndarray, depth_u16: np.ndarray,
                    cam) -> List:
        """ObjReco.recognition over the deserialized step (top-1 path)."""
        import jax
        import jax.numpy as jnp

        from fealess.engine import ObjReco, RecoResult

        rgb_bgr, depth_u16, scene_k = ObjReco._prepare_frame(
            self, rgb_bgr, depth_u16, cam)
        state = {
            "bank": {f: getattr(self.bank, f)
                     for f in ("feat_x", "feat_y", "feat_label",
                               "feat_valid", "width", "height",
                               "offset_x", "offset_y", "pose",
                               "class_idx", "template_idx", "valid")},
            "md": self._model_depth_dev,
            "org": self._origins_dev,
            "tables": self._kernels,
        }
        host = jax.device_get(self._call(
            state, jnp.asarray(rgb_bgr), jnp.asarray(depth_u16), scene_k))
        if not bool(host["valid"]):
            return []
        slot = int(host["template_slot"])
        return [RecoResult(
            obj_tag=self.bank.class_names[int(host["class_idx"])],
            world2cam=np.asarray(host["pose"]),
            similarity=float(host["similarity"]),
            icp_dist=float(host["icp_dist"]),
            inlier_ratio=float(host["inlier_ratio"]),
            match_rect=(float(host["match_x"]), float(host["match_y"]),
                        float(np.asarray(self.bank.width)[slot, 0]),
                        float(np.asarray(self.bank.height)[slot, 0])))]
