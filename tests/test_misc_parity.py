"""Parity odds-and-ends: per-class multi-file YAML, EPNP pose path,
advanced params, image-series reader, visualization overlays."""

import os

import cv2
import numpy as np
import pytest

from fealess import config as cfg
from fealess.engine import CamIntrinsics, ObjReco
from fealess.io import linemod_yaml, series
from tests.test_match_e2e import H, W, det_cfg, scene, trained  # noqa: F401


def test_per_class_yaml_roundtrip(tmp_path, trained, det_cfg):  # noqa: F811
    fmt = str(tmp_path / "templates_%s.yml.gz")
    classes = {"obj_a": [trained], "obj_b": [trained]}
    linemod_yaml.save_classes(fmt, det_cfg, classes)
    assert os.path.exists(str(tmp_path / "templates_obj_a.yml.gz"))
    back = linemod_yaml.load_classes(fmt, ["obj_a", "obj_b"],
                                     levels=det_cfg.pyramid_levels)
    assert set(back) == {"obj_a", "obj_b"}
    v0 = back["obj_a"][0]
    np.testing.assert_array_equal(v0.features[0][0],
                                  trained.features[0][0])
    np.testing.assert_array_equal(v0.pose, trained.pose)
    assert v0.width == trained.width


def test_advanced_params():
    eng = ObjReco.create("LmICP")
    assert eng.get_advanced_param("matching_threshold") == 75.0
    eng.set_advanced_param("matching_threshold", 80.0)
    eng.set_advanced_param("icp_iterations", 5)
    eng.set_advanced_param("icp_mode", "point_to_plane")
    assert eng.get_advanced_param("matching_threshold") == 80.0
    assert eng.cfg.icp.max_iterations == 5
    assert eng.cfg.icp.mode == "point_to_plane"
    with pytest.raises(KeyError):
        eng.set_advanced_param("nope", 1)


def test_epnp_pose_recovers_identity():
    """Model depth rendered at pose ~identity: EPNP from the same pixels
    must recover ~that pose (the dormant ComputePose path)."""
    eng = ObjReco.create("LmICP")
    cam = CamIntrinsics(fx=608.0, fy=608.0, cx=120.0, cy=80.0,
                        width=240, height=160)
    # synthetic model depth: plane at 700mm in a box, background 1200mm
    raw = np.full((160, 240), 12000, np.uint16)   # 0.1mm units
    yy, xx = np.mgrid[40:120, 60:180]
    raw[40:120, 60:180] = (7000 + 4 * (xx - 60) + 2 * (yy - 40)).astype(
        np.uint16)
    pose_init = np.eye(4, dtype=np.float32)
    pose = eng.compute_pose_epnp(raw, 0, 0, pose_init, cam)
    assert pose is not None
    np.testing.assert_allclose(pose[:3, :3], np.eye(3), atol=1e-2)
    assert np.linalg.norm(pose[:3, 3]) < 5.0


def test_image_series_reader_dir(tmp_path):
    rng = np.random.default_rng(0)
    imgs = []
    for i in range(3):
        img = rng.integers(0, 255, size=(16, 20, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / f"{i}.png"), img)
        imgs.append(img)
    rd = series.ImageSeriesReader(str(tmp_path))
    got = list(rd)
    assert len(got) == 3
    np.testing.assert_array_equal(got[1], imgs[1])
    rd2 = series.ImageSeriesReader([str(tmp_path / "2.png")],
                                   target_wh=(10, 8))
    assert list(rd2)[0].shape == (8, 10, 3)


def test_visualize_overlays(trained, det_cfg):  # noqa: F811
    from fealess.apps import visualize
    from fealess.bank import pack_bank

    bank = pack_bank({"obj": [trained]}, levels=det_cfg.pyramid_levels,
                     capacity=2)
    img = np.zeros((H, W, 3), np.uint8)
    visualize.draw_response(img, bank, 0, (10, 10), t=5)
    assert img.any()                      # circles drawn
    base = np.zeros((H, W), np.uint8)
    tpl = np.full((20, 20), 200, np.uint8)
    visualize.blit_template(base, tpl, (W - 10, H - 10))   # clipped blit
    assert base[H - 10:, W - 10:].max() == 200
    assert base[:H - 10, :].max() == 0


def test_line_gradient_only_detector(scene, trained):  # noqa: F811
    """getDefaultLINE parity: gradient-only modality trains and matches
    (linemod.cpp:1822-1827)."""
    import jax.numpy as jnp

    from fealess import detector, training
    from fealess.bank import pack_bank

    line_cfg = cfg.default_line()
    line_cfg = cfg.dataclasses.replace(line_cfg, image_width=W,
                                       image_height=H, max_candidates=8)
    bgr, depth, mask = scene
    pose = np.arange(13, dtype=np.float32)
    view = training.add_template(bgr, depth, mask, pose, line_cfg)
    assert view is not None
    assert len(view.features[0]) == 1           # one modality
    bank = pack_bank({"obj": [view]}, levels=line_cfg.pyramid_levels,
                     modalities=1, capacity=2)
    m = detector.match_bank_jit(bank, jnp.asarray(bgr), jnp.asarray(depth),
                                75.0, line_cfg)
    v = np.asarray(m.valid)
    assert v[0], "LINE detector must find its own training view"
    assert float(np.asarray(m.similarity)[0]) >= 95.0
