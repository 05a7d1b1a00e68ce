"""Two-class engine test: per-class model-depth keying.

Regression for the r2 bug where ``_load_model_depths`` keyed depth pngs
by per-class template id (``depth/<tid>.png``): with two classes in one
feature dir, class A's template 0 and class B's template 0 both read
``depth/0.png`` and one class silently refined against the other's
cloud.  Multi-class banks now require ``depth/<class>/<tid>.png`` (the
analog of the reference's one-dir-per-object contract,
obj_reco_lmicp.cpp:67-74)."""

import os

import cv2
import numpy as np
import pytest

from fealess import config as cfg
from fealess import training
from fealess.engine import CamIntrinsics, ObjReco
from fealess.io import linemod_yaml
from tests.test_match_e2e import H, W, make_scene

FX = FY = 608.0
CX, CY = W / 2.0, H / 2.0


def make_scene_b(rng):
    """A second, visually distinct object at a different depth/location."""
    bgr = np.full((H, W, 3), 40, np.uint8)
    bgr += rng.integers(0, 12, size=bgr.shape, dtype=np.uint8)
    ys, xs = slice(24, 88), slice(32, 128)
    yy, xx = np.mgrid[24:88, 32:128]
    tex = (128 + 90 * np.cos(xx / 4.0) * np.sin(yy / 7.0)).astype(np.uint8)
    bgr[ys, xs, 0] = 255 - tex
    bgr[ys, xs, 1] = tex
    bgr[ys, xs, 2] = 60

    depth = np.full((H, W), 1200, np.uint16)
    yy2, xx2 = np.mgrid[0:64, 0:96].astype(np.float32)
    depth[ys, xs] = (560 + 0.4 * xx2 + 0.9 * yy2).astype(np.uint16)
    mask = np.zeros((H, W), bool)
    mask[ys, xs] = True
    return bgr, depth, mask


@pytest.fixture(scope="module")
def two_class_dir(tmp_path_factory):
    rng = np.random.default_rng(11)
    det_cfg = cfg.DetectorConfig(image_width=W, image_height=H,
                                 max_candidates=16)
    pose = np.zeros(13, np.float32)
    pose[0] = pose[5] = pose[10] = 1.0
    pose[12] = 650.0

    scenes = {"a": make_scene(np.random.default_rng(7)),
              "b": make_scene_b(rng)}
    views = {}
    for name, (bgr, depth, mask) in scenes.items():
        v = training.add_template(bgr, depth, mask, pose, det_cfg)
        assert v is not None, name
        views[name] = [v]

    d = tmp_path_factory.mktemp("features2")
    linemod_yaml.save_linemod(str(d / "linemod_templates.yml"), det_cfg,
                              views)
    for name, (bgr, depth, mask) in scenes.items():
        os.makedirs(d / "depth" / name, exist_ok=True)
        cv2.imwrite(str(d / "depth" / name / "0.png"),
                    (depth.astype(np.uint32) * 10).astype(np.uint16))
    return str(d), scenes


def _engine(path):
    ecfg = cfg.EngineConfig(
        detector=cfg.DetectorConfig(image_width=W, image_height=H,
                                    max_candidates=16),
        template_fx=FX, template_fy=FY, template_cx=CX, template_cy=CY,
        refine_crop=128)
    eng = ObjReco.create("LmICP", ecfg)
    eng.add_obj(path)
    return eng


def test_two_class_recognition_correct_pose(two_class_dir):
    """Each class recognized on its own training frame must use its OWN
    model depth: pose = identity (ICP starts aligned)."""
    path, scenes = two_class_dir
    eng = _engine(path)
    cam = CamIntrinsics(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H)
    for name, (bgr, depth, mask) in scenes.items():
        results = eng.recognition(bgr, depth, cam)
        assert results, name
        r = results[0]
        assert r.obj_tag == name
        np.testing.assert_allclose(r.world2cam[:3, :3], np.eye(3),
                                   atol=0.05, err_msg=name)
        assert np.linalg.norm(r.world2cam[:3, 3]) < 10.0, (name,
                                                           r.world2cam)


def test_class_filtered_recognition(two_class_dir):
    """class_ids restricts the search (Detector::match's class filter,
    linemod.hpp:317-325): on class a's frame, filtering to b must find
    nothing, filtering to a must equal the unfiltered result."""
    path, scenes = two_class_dir
    eng = _engine(path)
    cam = CamIntrinsics(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H)
    bgr, depth, _ = scenes["a"]

    unfiltered = eng.recognition(bgr, depth, cam)
    assert unfiltered and unfiltered[0].obj_tag == "a"

    only_b = eng.recognition(bgr, depth, cam, class_ids=["b"])
    assert all(r.obj_tag == "b" for r in only_b)
    assert not only_b, [r.similarity for r in only_b]

    only_a = eng.recognition(bgr, depth, cam, class_ids=["a"])
    assert only_a and only_a[0].obj_tag == "a"
    np.testing.assert_allclose(only_a[0].world2cam,
                               unfiltered[0].world2cam, atol=1e-5)

    multi_b = eng.recognition_multi(bgr, depth, cam, class_ids=["b"])
    assert all(r.obj_tag == "b" for r in multi_b)

    with pytest.raises(KeyError):
        eng.recognition(bgr, depth, cam, class_ids=["typo"])


def test_multiclass_missing_depth_errors(two_class_dir, tmp_path):
    """A multi-class dir without per-class depth pngs must fail add_obj
    loudly instead of refining against empty clouds."""
    import shutil

    path, _ = two_class_dir
    broken = tmp_path / "broken"
    shutil.copytree(path, broken)
    shutil.rmtree(broken / "depth" / "b")
    with pytest.raises(IOError):
        _engine(str(broken))
