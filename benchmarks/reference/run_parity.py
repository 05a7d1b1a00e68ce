"""ADD pass-rate parity on the rendered multi-view sequence.

Runs BOTH engines — the unmodified C++ reference (ref_series) and
fealess's ObjReco — over the identical multi-view bank and 32-frame
test sequence (make_sequence.py), computes the ADD metric per frame
against the rendered ground-truth poses, and writes PARITY_r05.json at
the repo root:

  ADD(R^, t^) = mean_p || (R^ p + t^) - (R p + t) ||   over model points
  pass iff ADD < tau = 0.1 * model diameter  (BASELINE.json target:
  pass rates within 5 points)

Usage: python benchmarks/reference/run_parity.py [--frames 32] [--fresh]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
BUILD = os.path.join(REPO, "build", "ref_bench")
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)


def build_ref() -> str:
    gen = ["-G", "Ninja"] if shutil.which("ninja") else []
    subprocess.run(["cmake", "-S", HERE, "-B", BUILD,
                    "-DCMAKE_BUILD_TYPE=Release", *gen],
                   check=True, capture_output=True, text=True)
    subprocess.run(["cmake", "--build", BUILD], check=True,
                   capture_output=True, text=True)
    return os.path.join(BUILD, "ref_series")


def add_error(pose_est, pose_gt, pts):
    a = pts @ pose_est[:3, :3].T + pose_est[:3, 3]
    b = pts @ pose_gt[:3, :3].T + pose_gt[:3, 3]
    return float(np.linalg.norm(a - b, axis=1).mean())


def run_reference(exe, seq, n):
    fx, fy, cx, cy = np.loadtxt(os.path.join(seq, "cam.txt"))
    out = subprocess.run(
        [exe, os.path.join(seq, "features"), os.path.join(seq, "frames"),
         str(fx), str(fy), str(cx), str(cy), str(n)],
        check=True, capture_output=True, text=True).stdout
    poses = {}
    ms = []
    for line in out.strip().splitlines():
        rec = json.loads(line)
        if rec["ok"]:
            poses[rec["frame"]] = np.asarray(
                rec["pose"], np.float32).reshape(4, 4)
        ms.append(rec["ms"])
    return poses, float(np.mean(ms))


def run_fealess(seq, n, icp_mode="point_to_point"):
    import jax

    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
    import cv2

    from fealess.engine import CamIntrinsics, ObjReco

    fx, fy, cx, cy = np.loadtxt(os.path.join(seq, "cam.txt"))
    eng = ObjReco.create("LmICP")
    eng.add_obj(os.path.join(seq, "features"))
    eng.set_advanced_param("icp_mode", icp_mode)
    cam = CamIntrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=640, height=480)
    poses = {}
    for i in range(n):
        bgr = cv2.imread(os.path.join(seq, "frames", f"color_{i:03d}.png"))
        depth = cv2.imread(os.path.join(seq, "frames", f"depth_{i:03d}.png"),
                           cv2.IMREAD_UNCHANGED)
        res = eng.recognition(bgr, depth, cam)
        if res:
            poses[i] = res[0].world2cam.astype(np.float32)
        print(f"  fealess[{icp_mode}] frame {i}: "
              f"{'ok' if res else 'no detection'}", flush=True)
    return poses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--seq", default=os.path.join(HERE, "seq"))
    args = ap.parse_args()

    if args.fresh or not os.path.exists(
            os.path.join(args.seq, "frames", "gt_poses.npy")):
        from make_sequence import build
        build(args.seq, args.frames)

    gts = np.load(os.path.join(args.seq, "frames", "gt_poses.npy"))
    pts = np.load(os.path.join(args.seq, "model_points.npy"))
    ext = pts.max(0) - pts.min(0)
    tau = 0.1 * float(np.linalg.norm(ext))
    n = min(args.frames, len(gts))

    exe = build_ref()
    ref_poses, ref_ms = run_reference(exe, args.seq, n)
    pt_poses = run_fealess(args.seq, n)
    plane_poses = run_fealess(args.seq, n, icp_mode="point_to_plane")

    def stats(poses):
        errs = {i: add_error(poses[i], gts[i], pts) for i in poses}
        passed = sum(1 for e in errs.values() if e < tau)
        return passed / n, errs

    ref_rate, ref_errs = stats(ref_poses)
    pt_rate, pt_errs = stats(pt_poses)
    pl_rate, pl_errs = stats(plane_poses)

    summary = {
        "frames": n,
        "tau_mm": round(tau, 2),
        "ref_pass_rate": round(ref_rate, 4),
        "fealess_pass_rate": round(pt_rate, 4),
        "delta_points": round(abs(ref_rate - pt_rate) * 100, 2),
        "ref_detections": len(ref_poses),
        "fealess_detections": len(pt_poses),
        "ref_mean_add_mm": round(float(np.mean(list(ref_errs.values()))), 3)
        if ref_errs else None,
        "fealess_mean_add_mm": round(
            float(np.mean(list(pt_errs.values()))), 3) if pt_errs else None,
        "ref_ms_per_frame": round(ref_ms, 2),
        # point-to-plane (the production default; no reference counterpart)
        "plane_pass_rate": round(pl_rate, 4),
        "plane_detections": len(plane_poses),
        "plane_mean_add_mm": round(
            float(np.mean(list(pl_errs.values()))), 3) if pl_errs else None,
    }
    out = os.path.join(REPO, "PARITY_r05.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    print(f"-> {out}")


if __name__ == "__main__":
    main()
