"""The committed serving fixtures under benchmarks/reference/out.

- the 640x480 fixture: ``scene_bgr.png`` / ``scene_depth.png`` /
  ``cam.txt`` and the 1024-template bank in ``features/``;
- the 1280x960 wide fixture in ``wide/``: the 640x480 scene upscaled 2x
  (same physical geometry, 2x intrinsics) with one template trained at the
  wide processing scale.  It is committed; :func:`wide_fixture` rebuilds it
  only when it is missing (that needs OpenCV for the resize and writes).
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "reference", "out")
WIDE = os.path.join(FIXTURE, "wide")


def fixture_frame():
    """(bgr u8 (480, 640, 3), depth u16 (480, 640)) of the 640x480 scene."""
    from fealess.io import png

    return (png.read_png(os.path.join(FIXTURE, "scene_bgr.png")),
            png.read_png(os.path.join(FIXTURE, "scene_depth.png")))


def fixture_intrinsics():
    """(fx, fy, cx, cy) of the 640x480 scene."""
    return tuple(float(v) for v in np.loadtxt(os.path.join(FIXTURE,
                                                           "cam.txt")))


def _build_wide():
    import cv2

    from fealess import config as cfg
    from fealess import training
    from fealess.io import linemod_yaml

    bgr, depth = fixture_frame()
    # fixture object = valid-depth region nearer than the background
    mask = ((depth > 0) & (depth < 900)).astype(np.uint8)
    big_bgr = cv2.resize(bgr, (1280, 960))
    big_depth = cv2.resize(depth, (1280, 960),
                           interpolation=cv2.INTER_NEAREST)
    big_mask = cv2.resize(mask, (1280, 960),
                          interpolation=cv2.INTER_NEAREST).astype(bool)
    det_w = cfg.DetectorConfig(image_width=1280, image_height=960,
                               max_candidates=16)
    pose = np.zeros(13, np.float32)
    pose[0] = pose[5] = pose[10] = 1.0
    pose[12] = 650.0
    view = training.add_template(big_bgr, big_depth, big_mask, pose, det_w)
    assert view is not None, "wide template extraction failed"
    os.makedirs(os.path.join(WIDE, "features", "depth"), exist_ok=True)
    linemod_yaml.save_linemod(
        os.path.join(WIDE, "features", "linemod_templates.yml"), det_w,
        {"obj": [view]})
    cv2.imwrite(os.path.join(WIDE, "features", "depth", "0.png"),
                (big_depth.astype(np.uint32) * 10).astype(np.uint16))
    cv2.imwrite(os.path.join(WIDE, "scene_bgr.png"), big_bgr)
    cv2.imwrite(os.path.join(WIDE, "scene_depth.png"), big_depth)


def wide_fixture():
    """(feature dir, bgr (960, 1280, 3), depth (960, 1280)) of the wide
    fixture."""
    from fealess.io import png

    if not os.path.exists(os.path.join(WIDE, "features",
                                       "linemod_templates.yml")):
        _build_wide()
    return (os.path.join(WIDE, "features"),
            png.read_png(os.path.join(WIDE, "scene_bgr.png")),
            png.read_png(os.path.join(WIDE, "scene_depth.png")))


def wide_engine_config(max_candidates: int = 16):
    """EngineConfig of the wide fixture: 1280x960 processing, 2x
    intrinsics for the template back-projection."""
    from fealess import config as cfg

    fx, fy, cx, cy = fixture_intrinsics()
    return cfg.EngineConfig(
        detector=cfg.DetectorConfig(image_width=1280, image_height=960,
                                    max_candidates=max_candidates),
        template_fx=2 * fx, template_fy=2 * fy,
        template_cx=2 * cx, template_cy=2 * cy)


def wide_camera():
    """CamIntrinsics of the wide frame."""
    from fealess.engine import CamIntrinsics

    fx, fy, cx, cy = fixture_intrinsics()
    return CamIntrinsics(fx=2 * fx, fy=2 * fy, cx=2 * cx, cy=2 * cy,
                         width=1280, height=960)
