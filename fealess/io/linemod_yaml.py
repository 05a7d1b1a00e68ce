"""Reference-compatible template database I/O.

Reads and writes the ``linemod_templates.yml`` schema produced by the
reference's ``writeLinemod`` (linemod/linemod_if.cpp:49-63) /
``Detector::writeClass`` (linemod/linemod.cpp:1764-1794), through the
OpenCV-YAML subset of fealess.io.opencv_yaml, so reference-trained
banks load unchanged and banks trained here load in the reference.

Schema (OpenCV YAML):
  pyramid_levels: L
  T: [T0, T1, ...]
  modalities: [{type: ColorGradient, weak_threshold, num_features,
                strong_threshold},
               {type: DepthNormal, distance_threshold, difference_threshold,
                num_features, extract_threshold}]
  classes:
    - class_id, modalities: [names], pyramid_levels,
      template_pyramids:
        - template_id, template_pose: [13 floats],
          templates: [{width, height, offset_x, offset_y, pyramid_level,
                       features: [[x, y, label], ...]}, ...]   # order l*M+m
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from fealess import config as cfg
from fealess.bank import TemplateView
from fealess.io import opencv_yaml

CG_NAME = "ColorGradient"
DN_NAME = "DepthNormal"


def load_linemod(path: str) -> Tuple[cfg.DetectorConfig,
                                     Dict[str, List[TemplateView]]]:
    """Load a reference template database -> (detector config, classes)."""
    try:
        root = opencv_yaml.load(path)
    except OSError as e:
        raise IOError(f"cannot open {path}") from e
    levels = int(root["pyramid_levels"])
    t_at_level = tuple(int(t) for t in root["T"])
    assert len(t_at_level) == levels

    cg = cfg.ColorGradientConfig()
    dn = cfg.DepthNormalConfig()
    mod_names = []
    for m in root["modalities"]:
        mtype = m["type"]
        mod_names.append(mtype)
        if mtype == CG_NAME:
            cg = cfg.ColorGradientConfig(
                weak_threshold=float(m["weak_threshold"]),
                num_features=int(m["num_features"]),
                strong_threshold=float(m["strong_threshold"]))
        elif mtype == DN_NAME:
            dn = cfg.DepthNormalConfig(
                distance_threshold=int(m["distance_threshold"]),
                difference_threshold=int(m["difference_threshold"]),
                num_features=int(m["num_features"]),
                extract_threshold=int(m["extract_threshold"]))
        else:
            raise ValueError(f"unknown modality {mtype!r}")
    n_mod = len(mod_names)

    classes: Dict[str, List[TemplateView]] = {}
    for node in root.get("classes") or []:
        class_id, views = _read_class_node(node, levels, n_mod)
        classes[class_id] = views

    name_map = {CG_NAME: "color_gradient", DN_NAME: "depth_normal"}
    det = cfg.DetectorConfig(t_at_level=t_at_level, color_gradient=cg,
                             depth_normal=dn,
                             modalities=tuple(name_map[m]
                                              for m in mod_names))
    return det, classes


def _read_class_node(c: dict, levels: int, n_mod: int):
    """One class map -> (class_id, views) (Detector::readClass,
    linemod.cpp:1711-1762)."""
    class_id = str(c["class_id"])
    assert int(c["pyramid_levels"]) == levels
    views: List[TemplateView] = []
    for ti, tp in enumerate(c.get("template_pyramids") or []):
        assert int(tp["template_id"]) == ti
        pose = np.asarray(tp["template_pose"], np.float32)
        templates = tp["templates"]
        assert len(templates) == levels * n_mod
        feats = [[None] * n_mod for _ in range(levels)]
        width = [0] * levels
        height = [0] * levels
        off_x = [0] * levels
        off_y = [0] * levels
        for j, t in enumerate(templates):
            l = int(t["pyramid_level"])
            m = j % n_mod
            assert j // n_mod == l, "unexpected template order"
            feats[l][m] = np.asarray(t["features"] or [], np.int32
                                     ).reshape(-1, 3)
            width[l] = int(t["width"])
            height[l] = int(t["height"])
            off_x[l] = int(t["offset_x"])
            off_y[l] = int(t["offset_y"])
        views.append(TemplateView(features=feats, width=width,
                                  height=height, offset_x=off_x,
                                  offset_y=off_y, pose=pose))
    return class_id, views


def _header(det: cfg.DetectorConfig) -> dict:
    mods = []
    if "color_gradient" in det.modalities:
        mods.append({
            "type": CG_NAME,
            "weak_threshold": float(det.color_gradient.weak_threshold),
            "num_features": int(det.color_gradient.num_features),
            "strong_threshold": float(det.color_gradient.strong_threshold)})
    if "depth_normal" in det.modalities:
        mods.append({
            "type": DN_NAME,
            "distance_threshold": int(det.depth_normal.distance_threshold),
            "difference_threshold":
                int(det.depth_normal.difference_threshold),
            "num_features": int(det.depth_normal.num_features),
            "extract_threshold": int(det.depth_normal.extract_threshold)})
    return {"pyramid_levels": det.pyramid_levels,
            "T": [int(t) for t in det.t_at_level],
            "modalities": mods}


def save_linemod(path: str, det: cfg.DetectorConfig,
                 classes: Dict[str, List[TemplateView]]) -> None:
    """Write a template database in the reference schema."""
    root = _header(det)
    root["classes"] = [_class_fields(class_id, det, classes[class_id])
                       for class_id in sorted(classes.keys())]
    opencv_yaml.dump(path, root)


def _class_fields(class_id: str, det: cfg.DetectorConfig,
                  views: List[TemplateView]) -> dict:
    """Class fields (Detector::writeClass, linemod.cpp:1764-1794)."""
    names = [n for key, n in (("color_gradient", CG_NAME),
                              ("depth_normal", DN_NAME))
             if key in det.modalities]
    pyramids = []
    for ti, v in enumerate(views):
        templates = []
        for l in range(det.pyramid_levels):
            for m in range(len(det.modalities)):
                templates.append({
                    "width": int(v.width[l]),
                    "height": int(v.height[l]),
                    "offset_x": int(v.offset_x[l]),
                    "offset_y": int(v.offset_y[l]),
                    "pyramid_level": l,
                    "features": np.asarray(v.features[l][m], np.int64
                                           ).reshape(-1, 3).tolist()})
        pyramids.append({
            "template_id": ti,
            "template_pose": [float(p) for p in
                              np.asarray(v.pose, np.float64)],
            "templates": templates})
    return {"class_id": class_id, "modalities": names,
            "pyramid_levels": det.pyramid_levels,
            "template_pyramids": pyramids}


def save_classes(fmt: str, det: cfg.DetectorConfig,
                 classes: Dict[str, List[TemplateView]]) -> None:
    """Per-class files (Detector::writeClasses, linemod.cpp:1808-1818):
    ``fmt`` is a %s-format path, e.g. ``dir/templates_%s.yml.gz``."""
    for class_id in sorted(classes.keys()):
        opencv_yaml.dump(fmt % class_id,
                         _class_fields(class_id, det, classes[class_id]))


def load_classes(fmt: str, class_ids: List[str], levels: int = 2,
                 n_mod: int = 2) -> Dict[str, List[TemplateView]]:
    """Per-class files (Detector::readClasses, linemod.cpp:1796-1806)."""
    out: Dict[str, List[TemplateView]] = {}
    for cid in class_ids:
        try:
            root = opencv_yaml.load(fmt % cid)
        except OSError as e:
            raise IOError(f"cannot open {fmt % cid}") from e
        class_id, views = _read_class_node(root, levels, n_mod)
        out[class_id] = views
    return out
