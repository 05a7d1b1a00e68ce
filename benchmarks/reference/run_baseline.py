"""Measure the C++ reference baseline and pose parity vs fealess.

BASELINE.md requires the baseline be established by measurement (the
reference publishes no numbers).  This driver:

  1. builds the fixture (make_fixture.py) — one synthetic 640x480 RGB-D
     frame + an N-template bank in the reference YAML schema;
  2. builds ref_bench (CMake, links the unmodified reference sources) and
     runs it single-core -> reference ms/frame, fps, final pose;
  3. runs fealess's ObjReco.recognition on the identical inputs (CPU,
     just for the pose) -> rotation/translation parity vs the reference.

Prints a JSON summary.  Runs on the host CPU; the engine's device fps
comes from bench.py on a GPU.

Usage: python benchmarks/reference/run_baseline.py [--templates 128]
       [--iters 20] [--fresh]
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


def build_ref_bench() -> str:
    exe = os.path.join(BUILD, "ref_bench")
    gen = ["-G", "Ninja"] if shutil.which("ninja") else []
    subprocess.run(["cmake", "-S", HERE, "-B", BUILD,
                    "-DCMAKE_BUILD_TYPE=Release", *gen],
                   check=True, capture_output=True, text=True)
    subprocess.run(["cmake", "--build", BUILD], check=True,
                   capture_output=True, text=True)
    return exe


def pose_errors(a: np.ndarray, b: np.ndarray):
    """(rotation deg, translation mm) between two 4x4 world2cam poses."""
    ra, rb = a[:3, :3], b[:3, :3]
    c = (np.trace(ra.T @ rb) - 1.0) / 2.0
    rot = float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
    trans = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
    return rot, trans


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--templates", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--out", default=os.path.join(HERE, "out"))
    args = ap.parse_args()

    fixture_tag = os.path.join(args.out, f".n{args.templates}")
    if args.fresh or not os.path.exists(fixture_tag):
        if os.path.exists(args.out):
            shutil.rmtree(args.out)
        from make_fixture import build
        build(args.out, args.templates)
        open(fixture_tag, "w").close()

    exe = build_ref_bench()
    fx, fy, cx, cy = np.loadtxt(os.path.join(args.out, "cam.txt"))
    cmd = [exe, os.path.join(args.out, "features"),
           os.path.join(args.out, "scene_bgr.png"),
           os.path.join(args.out, "scene_depth.png"),
           str(fx), str(fy), str(cx), str(cy), str(args.iters)]
    ref = json.loads(subprocess.run(cmd, check=True, capture_output=True,
                                    text=True).stdout.strip())
    ref_pose = np.asarray(ref["pose"], np.float32).reshape(4, 4)

    # our engine on the identical inputs (CPU; pose parity only)
    import jax

    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
    import cv2

    from fealess import config as cfg
    from fealess.engine import CamIntrinsics, ObjReco

    eng = ObjReco.create("LmICP", cfg.EngineConfig())
    eng.add_obj(os.path.join(args.out, "features"))
    bgr = cv2.imread(os.path.join(args.out, "scene_bgr.png"))
    depth = cv2.imread(os.path.join(args.out, "scene_depth.png"),
                       cv2.IMREAD_UNCHANGED)
    cam = CamIntrinsics(fx=fx, fy=fy, cx=cx, cy=cy,
                        width=bgr.shape[1], height=bgr.shape[0])
    ours = eng.recognition(bgr, depth, cam)
    assert ours, "fealess found no object on the fixture scene"
    our_pose = ours[0].world2cam
    rot_deg, trans_mm = pose_errors(ref_pose, our_pose)

    print(json.dumps({
        "templates": args.templates,
        "reference_ms_per_frame": round(ref["ms_per_frame"], 2),
        "reference_fps_single_core": round(ref["fps"], 2),
        "parity_rot_deg": round(rot_deg, 4),
        "parity_trans_mm": round(trans_mm, 3),
        "our_similarity": round(float(ours[0].similarity), 2),
        "reference_obj": ref["obj"],
        "our_obj": ours[0].obj_tag,
    }))


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.path.insert(0, REPO)
    main()
