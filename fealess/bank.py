"""The packed template bank: the statically-shaped TemplatesMap.

The reference stores templates as ``class_id -> vector<TemplatePyramid>``
with heap-allocated feature lists (linemod/linemod.hpp:370-374).  Here the
whole bank is a statically-shaped pytree of arrays — features padded to a
fixed ``F`` per (level, modality) with a validity mask — so the entire
match path jits once and shards by splitting the leading template axis
across devices.

Array layout (N = template capacity, L = pyramid levels, M = modalities,
F = max features per modality):

- ``feat_x/feat_y/feat_label``: (N, L, M, F) int32, post-crop coordinates
  (relative to the template bbox at that level, linemod.cpp:88-92).
- ``feat_valid``: (N, L, M, F) bool — padding gate.
- ``width/height/offset_x/offset_y``: (N, L) int32 — common bbox per level
  (cropTemplates assigns identical bboxes to all modalities of a view,
  linemod.cpp:79-92).
- ``pose``: (N, 13) float32 — 3x4 world2cam row-major + view distance
  (Detector::addPoseInfo, linemod.cpp:1617-1622).
- ``class_idx``: (N,) int32 into the static ``class_names`` tuple.
- ``template_idx``: (N,) int32 — per-class template id (readClass order).
- ``valid``: (N,) bool — occupied slots.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TemplateBank:
    feat_x: Any
    feat_y: Any
    feat_label: Any
    feat_valid: Any
    width: Any
    height: Any
    offset_x: Any
    offset_y: Any
    pose: Any
    class_idx: Any
    template_idx: Any
    valid: Any
    class_names: Tuple[str, ...] = dataclasses.field(
        default=(), metadata=dict(static=True))
    # Max level-0 template bbox side + 1 (px), static: sizes the one-hot
    # conv kernels of the dense scorer (fealess.detector).  0 means
    # unknown; the scorer then falls back to the full decimated grid.
    max_span: int = dataclasses.field(
        default=0, metadata=dict(static=True))

    @property
    def capacity(self) -> int:
        return self.feat_x.shape[0]

    @property
    def levels(self) -> int:
        return self.feat_x.shape[1]

    @property
    def modalities(self) -> int:
        return self.feat_x.shape[2]

    @property
    def num_templates(self) -> int:
        return int(np.asarray(self.valid).sum())

    def num_features(self):
        """(N, L) int32: total valid features across modalities per level
        (the ``num_features`` of matchClass, linemod.cpp:1471-1475)."""
        return jnp.sum(self.feat_valid.astype(jnp.int32), axis=(2, 3))


# ---------------------------------------------------------------------------
# Host-side intermediate representation (training + serialization)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TemplateView:
    """One template pyramid (a single object view), host-side.

    ``features[l][m]`` is an (n_feat, 3) int array of (x, y, label);
    ``width[l]``/... are per-level ints; ``pose`` is 13 floats.
    Mirrors TemplatePyramid + TemplatePoseInfo (linemod.hpp:370-376).
    """
    features: List[List[np.ndarray]]
    width: List[int]
    height: List[int]
    offset_x: List[int]
    offset_y: List[int]
    pose: np.ndarray


def pack_bank(classes: Dict[str, List[TemplateView]],
              levels: int,
              modalities: int = 2,
              capacity: int | None = None,
              max_features: int = 63) -> TemplateBank:
    """Pack host-side template views into a TemplateBank."""
    views = [(ci, ti, v)
             for ci, (_, vs) in enumerate(sorted(classes.items()))
             for ti, v in enumerate(vs)]
    n_real = len(views)
    n = capacity or max(n_real, 1)
    if n_real > n:
        raise ValueError(f"{n_real} templates exceed capacity {n}")
    f = max_features

    fx = np.zeros((n, levels, modalities, f), np.int32)
    fy = np.zeros_like(fx)
    fl = np.zeros_like(fx)
    fv = np.zeros((n, levels, modalities, f), bool)
    width = np.zeros((n, levels), np.int32)
    height = np.zeros((n, levels), np.int32)
    off_x = np.zeros((n, levels), np.int32)
    off_y = np.zeros((n, levels), np.int32)
    pose = np.zeros((n, 13), np.float32)
    class_idx = np.zeros((n,), np.int32)
    template_idx = np.zeros((n,), np.int32)
    valid = np.zeros((n,), bool)

    for slot, (ci, ti, v) in enumerate(views):
        for l in range(levels):
            for m in range(modalities):
                feats = np.asarray(v.features[l][m], np.int32).reshape(-1, 3)
                k = min(len(feats), f)
                fx[slot, l, m, :k] = feats[:k, 0]
                fy[slot, l, m, :k] = feats[:k, 1]
                fl[slot, l, m, :k] = feats[:k, 2]
                fv[slot, l, m, :k] = True
            width[slot, l] = v.width[l]
            height[slot, l] = v.height[l]
            off_x[slot, l] = v.offset_x[l]
            off_y[slot, l] = v.offset_y[l]
        pose[slot] = np.asarray(v.pose, np.float32)
        class_idx[slot] = ci
        template_idx[slot] = ti
        valid[slot] = True

    return TemplateBank(
        feat_x=jnp.asarray(fx), feat_y=jnp.asarray(fy),
        feat_label=jnp.asarray(fl), feat_valid=jnp.asarray(fv),
        width=jnp.asarray(width), height=jnp.asarray(height),
        offset_x=jnp.asarray(off_x), offset_y=jnp.asarray(off_y),
        pose=jnp.asarray(pose), class_idx=jnp.asarray(class_idx),
        template_idx=jnp.asarray(template_idx), valid=jnp.asarray(valid),
        class_names=tuple(sorted(classes.keys())),
        max_span=int(max([max(v.width[0], v.height[0]) + 1
                          for _, _, v in views], default=1)))


def class_slot_mask(bank: TemplateBank,
                    class_ids: Sequence[str]) -> np.ndarray:
    """(capacity,) bool mask selecting the slots of the given classes —
    the class_ids restriction of ``Detector::match``
    (linemod/linemod.hpp:317-325).  Unknown names raise (the reference
    silently skips them; a typo'd filter matching nothing is a bug)."""
    unknown = [c for c in class_ids if c not in bank.class_names]
    if unknown:
        raise KeyError(f"unknown class_ids {unknown}; "
                       f"bank has {list(bank.class_names)}")
    wanted = np.array([bank.class_names.index(c) for c in class_ids],
                      np.int32)
    return np.isin(np.asarray(bank.class_idx), wanted)


def view_from_features(features: Sequence[Sequence[np.ndarray]],
                       width: Sequence[int], height: Sequence[int],
                       offset_x: Sequence[int], offset_y: Sequence[int],
                       pose: np.ndarray) -> TemplateView:
    """Build a TemplateView from externally-computed features — the
    ``addSyntheticTemplate`` entry point (linemod.hpp:349,
    linemod.cpp:1636-1642): synthetic rendering pipelines that quantize
    and select features themselves can inject templates without going
    through :func:`fealess.training.add_template`.

    ``features[l][m]`` is an (n, 3) int array of post-crop (x, y, label)
    with 0 <= label < 8; per-level bbox/offset and the 13-float pose
    follow the bank layout.  Validates ranges so a malformed synthetic
    template fails here, not as an out-of-range index inside the jitted
    scorer.
    """
    levels = len(features)
    if not (len(width) == len(height) == len(offset_x) == len(offset_y)
            == levels):
        raise ValueError("per-level lists must have equal length")
    feats = [[np.asarray(fm, np.int32).reshape(-1, 3) for fm in fl]
             for fl in features]
    for l, fl in enumerate(feats):
        for m, fm in enumerate(fl):
            if len(fm) == 0:
                continue
            if (fm[:, 2] < 0).any() or (fm[:, 2] >= 8).any():
                raise ValueError(f"label out of [0, 8) at level {l} "
                                 f"modality {m}")
            if ((fm[:, 0] < 0).any() or (fm[:, 0] > width[l]).any()
                    or (fm[:, 1] < 0).any() or (fm[:, 1] > height[l]).any()):
                raise ValueError(f"feature outside bbox at level {l} "
                                 f"modality {m}")
    pose = np.asarray(pose, np.float32).reshape(13)
    return TemplateView(features=feats,
                        width=[int(w) for w in width],
                        height=[int(h) for h in height],
                        offset_x=[int(x) for x in offset_x],
                        offset_y=[int(y) for y in offset_y],
                        pose=pose)


def unpack_bank(bank: TemplateBank) -> Dict[str, List[TemplateView]]:
    """Inverse of :func:`pack_bank` (for serialization round-trips)."""
    out: Dict[str, List[TemplateView]] = {c: [] for c in bank.class_names}
    fx = np.asarray(bank.feat_x)
    fy = np.asarray(bank.feat_y)
    fl = np.asarray(bank.feat_label)
    fv = np.asarray(bank.feat_valid)
    for slot in range(bank.capacity):
        if not bool(np.asarray(bank.valid)[slot]):
            continue
        feats = [[np.stack([fx[slot, l, m, fv[slot, l, m]],
                            fy[slot, l, m, fv[slot, l, m]],
                            fl[slot, l, m, fv[slot, l, m]]], axis=-1)
                  for m in range(bank.modalities)]
                 for l in range(bank.levels)]
        view = TemplateView(
            features=feats,
            width=list(np.asarray(bank.width)[slot]),
            height=list(np.asarray(bank.height)[slot]),
            offset_x=list(np.asarray(bank.offset_x)[slot]),
            offset_y=list(np.asarray(bank.offset_y)[slot]),
            pose=np.asarray(bank.pose)[slot].copy())
        out[bank.class_names[int(np.asarray(bank.class_idx)[slot])]].append(view)
    return out
