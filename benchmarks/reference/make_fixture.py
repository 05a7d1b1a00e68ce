"""Build the shared fixture for the reference-baseline measurement.

Produces, under --out:
  features/linemod_templates.yml   trained bank in the reference YAML schema
  features/depth/<tid>.png         model depth renders, 0.1mm units (u16)
  scene_bgr.png, scene_depth.png   the 640x480 RGB-D test frame (depth: mm)
  cam.txt                          "fx fy cx cy"

The template bank holds --templates copies of one trained view (per-class
template ids 0..N-1), so the reference match loop pays the full N-template
similarity cost at the intended operating point (640x480, 2 levels, T={5,8},
<=63 features/modality — SURVEY.md §6) while recognition is guaranteed to
fire.  The same fixture is consumed by the unmodified C++ pipeline
(ref_bench.cpp -> CObjRecoCAD::Recognition) and by fealess
(run_baseline.py), so fps AND pose parity come from identical inputs.
"""

import argparse
import os

import numpy as np

FX = FY = 608.0   # == the reference's hardcoded template K (common.cpp:358)
CX, CY = 320.0, 240.0
W, H = 640, 480


def make_scene(rng):
    """A textured box on a flat background, 640x480 (test_match_e2e.make_scene
    scaled to the reference operating point)."""
    import cv2

    bgr = np.full((H, W, 3), 40, np.uint8)
    bgr += rng.integers(0, 12, size=bgr.shape, dtype=np.uint8)
    ys, xs = slice(160, 320), slice(240, 432)
    yy, xx = np.mgrid[160:320, 240:432]
    tex = (128 + 90 * np.sin(xx / 6.0) * np.cos(yy / 5.0)).astype(np.uint8)
    bgr[ys, xs, 0] = tex
    bgr[ys, xs, 1] = 255 - tex
    bgr[ys, xs, 2] = 200
    bgr = cv2.GaussianBlur(bgr, (3, 3), 0)

    depth = np.full((H, W), 1200, np.uint16)
    yy2, xx2 = np.mgrid[0:160, 0:192].astype(np.float32)
    depth[ys, xs] = (700 + 0.4 * xx2 + 0.3 * yy2).astype(np.uint16)

    mask = np.zeros((H, W), bool)
    mask[ys, xs] = True
    return bgr, depth, mask


def build(out_dir: str, n_templates: int, seed: int = 7) -> None:
    import jax

    if jax.config.jax_platforms != "cpu":      # offline build: host CPU only
        jax.config.update("jax_platforms", "cpu")
    import cv2

    from fealess import config as cfg
    from fealess import training
    from fealess.io import linemod_yaml

    rng = np.random.default_rng(seed)
    bgr, depth, mask = make_scene(rng)
    det_cfg = cfg.DetectorConfig()             # 640x480 operating point
    pose = np.zeros(13, np.float32)
    pose[0] = pose[5] = pose[10] = 1.0         # R = I, t = 0
    pose[12] = 800.0                           # view distance (mm)
    view = training.add_template(bgr, depth, mask, pose, det_cfg)
    assert view is not None, "template extraction failed"

    feat = os.path.join(out_dir, "features")
    os.makedirs(os.path.join(feat, "depth"), exist_ok=True)
    linemod_yaml.save_linemod(os.path.join(feat, "linemod_templates.yml"),
                              det_cfg, {"obj": [view] * n_templates})
    model_depth = (depth.astype(np.uint32) * 10).astype(np.uint16)  # 0.1mm
    for tid in range(n_templates):
        cv2.imwrite(os.path.join(feat, "depth", f"{tid}.png"), model_depth)

    cv2.imwrite(os.path.join(out_dir, "scene_bgr.png"), bgr)
    cv2.imwrite(os.path.join(out_dir, "scene_depth.png"), depth)
    with open(os.path.join(out_dir, "cam.txt"), "w") as f:
        f.write(f"{FX} {FY} {CX} {CY}\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "out"))
    ap.add_argument("--templates", type=int, default=128)
    args = ap.parse_args()
    build(args.out, args.templates)
    print(f"fixture written to {args.out}")


if __name__ == "__main__":
    main()
