"""Rendered multi-view RGB-D sequence for ADD pass-rate parity.

Synthesizes a textured 3D relief object (point-cloud model), renders it
with a z-buffer splatter at known world2cam poses, and produces:

  <out>/features/linemod_templates.yml   multi-view bank (reference YAML)
  <out>/features/depth/<tid>.png         per-template model depth (0.1mm)
  <out>/frames/color_%03d.png            test frames (640x480 BGR)
  <out>/frames/depth_%03d.png            test depth (u16 mm)
  <out>/frames/gt_poses.npy              (F, 4, 4) ground-truth world2cam
  <out>/model_points.npy                 (P, 3) model-frame points (mm)
  <out>/cam.txt                          "fx fy cx cy"

Training views sweep in-plane rotation x out-of-plane tilt around the
frontal pose (the multi-view template store of linemod_train,
test/linemod_train.cpp:30-91); test frames draw poses inside the trained
envelope with translation jitter, so matching is exercised across
templates and ICP must correct the residual.  Both engines consume the
identical bank + frames (ref_series.cpp / run_parity.py), and ADD is
computed against the ground truth with tau = 0.1 * model diameter
(BASELINE.json accuracy metric).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

FX = FY = 608.0
CX, CY = 320.0, 240.0
W, H = 640, 480
BG_MM = 1200


def model_cloud():
    """Textured relief: (P, 3) mm points + (P, 3) u8 BGR colors."""
    xs = np.arange(-60, 60, 0.4, dtype=np.float32)
    ys = np.arange(-50, 50, 0.4, dtype=np.float32)
    xx, yy = np.meshgrid(xs, ys)
    zz = (-18.0 * np.cos(xx / 17.0) * np.cos(yy / 13.0)
          - 7.0 * np.sin(xx / 6.0 + yy / 8.0))
    pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    tex = (128 + 90 * np.sin(xx / 5.0) * np.cos(yy / 4.0)).astype(np.uint8)
    tex2 = (128 + 90 * np.cos(xx / 9.0 + yy / 6.0)).astype(np.uint8)
    bgr = np.stack([tex, 255 - tex2, np.full_like(tex, 190)],
                   axis=-1).reshape(-1, 3)
    return pts.astype(np.float32), bgr


def rot_zyx(rz_deg, ry_deg, rx_deg):
    rz, ry, rx = np.radians([rz_deg, ry_deg, rx_deg])
    cz, sz = np.cos(rz), np.sin(rz)
    cy, sy = np.cos(ry), np.sin(ry)
    cx, sx = np.cos(rx), np.sin(rx)
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return (mz @ my @ mx).astype(np.float32)


def render(pts, colors, r, t, rng):
    """Z-buffer splat of the model at world2cam (r, t); returns
    (bgr u8, depth u16 mm, mask bool)."""
    p = pts @ r.T + t
    z = p[:, 2]
    u = np.rint(FX * p[:, 0] / z + CX).astype(np.int64)
    v = np.rint(FY * p[:, 1] / z + CY).astype(np.int64)
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 1)
    u, v, z = u[ok], v[ok], z[ok]
    col = colors[ok]
    flat = v * W + u
    zbuf = np.full(H * W, np.inf, np.float32)
    np.minimum.at(zbuf, flat, z)
    won = z <= zbuf[flat] + 1e-4

    bgr = np.full((H, W, 3), 40, np.uint8)
    bgr += rng.integers(0, 10, size=bgr.shape, dtype=np.uint8)
    depth = np.full(H * W, BG_MM, np.float32)
    depth[flat[won]] = zbuf[flat[won]]
    img = bgr.reshape(-1, 3)
    img[flat[won]] = col[won]
    mask = np.zeros(H * W, bool)
    mask[flat[won]] = True
    return (img.reshape(H, W, 3),
            np.rint(depth).astype(np.uint16).reshape(H, W),
            mask.reshape(H, W))


def training_poses():
    out = []
    for rz in (-20, -12, -4, 4, 12, 20):
        for (ry, rx) in ((0, 0), (8, 0), (-8, 0), (0, 8), (0, -8)):
            out.append((rot_zyx(rz, ry, rx),
                        np.array([0.0, 0.0, 700.0], np.float32)))
    return out


def test_poses(n, rng):
    out = []
    for _ in range(n):
        r = rot_zyx(rng.uniform(-18, 18), rng.uniform(-6, 6),
                    rng.uniform(-6, 6))
        t = np.array([rng.uniform(-30, 30), rng.uniform(-25, 25),
                      rng.uniform(680, 760)], np.float32)
        out.append((r, t))
    return out


def build(out_dir: str, n_frames: int = 32, seed: int = 5) -> None:
    import jax

    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
    import cv2

    from fealess import config as cfg
    from fealess import training
    from fealess.io import linemod_yaml

    rng = np.random.default_rng(seed)
    pts, colors = model_cloud()
    det_cfg = cfg.DetectorConfig()

    feat = os.path.join(out_dir, "features")
    frames = os.path.join(out_dir, "frames")
    os.makedirs(os.path.join(feat, "depth"), exist_ok=True)
    os.makedirs(frames, exist_ok=True)

    views = []
    model_depths = []
    for (r, t) in training_poses():
        bgr, depth, mask = render(pts, colors, r, t, rng)
        pose13 = np.zeros(13, np.float32)
        pose13[:12] = np.concatenate([r, t[:, None]], axis=1).reshape(-1)
        pose13[12] = float(np.linalg.norm(t))
        v = training.add_template(bgr, depth, mask, pose13, det_cfg)
        if v is None:
            continue
        views.append(v)
        model_depths.append(depth)
    assert len(views) >= 20, f"only {len(views)} training views extracted"

    linemod_yaml.save_linemod(os.path.join(feat, "linemod_templates.yml"),
                              det_cfg, {"obj": views})
    for tid, depth in enumerate(model_depths):
        cv2.imwrite(os.path.join(feat, "depth", f"{tid}.png"),
                    (depth.astype(np.uint32) * 10).astype(np.uint16))

    gts = []
    for i, (r, t) in enumerate(test_poses(n_frames, rng)):
        bgr, depth, _ = render(pts, colors, r, t, rng)
        cv2.imwrite(os.path.join(frames, f"color_{i:03d}.png"), bgr)
        cv2.imwrite(os.path.join(frames, f"depth_{i:03d}.png"), depth)
        g = np.eye(4, dtype=np.float32)
        g[:3, :3] = r
        g[:3, 3] = t
        gts.append(g)
    np.save(os.path.join(frames, "gt_poses.npy"), np.stack(gts))

    sub = pts[:: max(1, len(pts) // 2000)]
    np.save(os.path.join(out_dir, "model_points.npy"), sub)
    with open(os.path.join(out_dir, "cam.txt"), "w") as f:
        f.write(f"{FX} {FY} {CX} {CY}\n")
    print(f"sequence: {len(views)} training views, {n_frames} test frames"
          f" -> {out_dir}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "seq"))
    ap.add_argument("--frames", type=int, default=32)
    args = ap.parse_args()
    build(args.out, args.frames)


if __name__ == "__main__":
    main()
