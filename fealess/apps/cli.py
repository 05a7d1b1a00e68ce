"""The ``fealess`` command-line driver.

Replaces the reference's self-registering command map (test/main.cpp:14-76,
``FEALESS <action> <config_dir>``) with argparse subcommands over the same
data layouts:

- ``train``     — linemod_train (test/linemod_train.cpp:30-91): scan
                  package -> linemod_templates.yml.
- ``recon``     — linemod_recon (test/linemod_recon.cpp:10-114): image
                  series -> per-frame poses (optional wireframe overlays).
- ``track``     — the KCF-gated pipeline (linemod_acq.cpp:103-196 demo).
- ``eval``      — ADD/rotation/translation metrics against ground-truth
                  poses (no reference equivalent; SURVEY.md §4c).
- ``bench``     — the single-chip throughput benchmark (bench.py).
- ``acq``       — capture/dump frames into the scan-package layout
                  (linemod_acq.cpp:10-102, minus the RealSense hardware:
                  sources are camera index / video / image dir via
                  apps.acquire).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np


def _series_paths(directory: str, color_sub: str = "gray",
                  depth_sub: str = "depth"):
    """Numerically ordered (color, depth) png path pairs."""
    def _key(p):
        stem = os.path.splitext(os.path.basename(p))[0]
        return (0, int(stem)) if stem.isdigit() else (1, stem)

    colors = sorted(glob.glob(os.path.join(directory, color_sub, "*.png")),
                    key=_key)
    pairs = []
    for c in colors:
        d = os.path.join(directory, depth_sub, os.path.basename(c))
        if os.path.exists(d):
            pairs.append((c, d))
    return pairs


def _camera(args, width: int, height: int):
    from fealess.engine import CamIntrinsics
    return CamIntrinsics(fx=args.fx, fy=args.fy,
                         cx=args.cx if args.cx >= 0 else width / 2.0,
                         cy=args.cy if args.cy >= 0 else height / 2.0,
                         width=width, height=height)


def _add_camera_args(p: argparse.ArgumentParser):
    # default K mirrors the reference's hardcoded fallback
    # (ICP/common.cpp:336-358; test/linemod_recon.cpp:27)
    p.add_argument("--fx", type=float, default=608.0)
    p.add_argument("--fy", type=float, default=608.0)
    p.add_argument("--cx", type=float, default=-1.0,
                   help="principal x (default: width/2)")
    p.add_argument("--cy", type=float, default=-1.0,
                   help="principal y (default: height/2)")


def _engine_for(args, width: int, height: int):
    import dataclasses

    from fealess import config as cfg
    from fealess.engine import ObjReco

    det = cfg.DetectorConfig(image_width=width, image_height=height)
    cam = _camera(args, width, height)
    # Template-rendering intrinsics default to the camera K (a training
    # package is captured with the recognition camera); the reference
    # instead hardcodes 608/320/240 for its 640x480 renders
    # (ICP/common.cpp:326-372) — pass --template-* to reproduce that.
    ecfg = cfg.EngineConfig(
        detector=det,
        icp=dataclasses.replace(
            cfg.IcpConfig(),
            max_points=args.icp_max_points,
            **({"mode": args.icp_mode} if args.icp_mode else {})),
        matching_threshold=args.threshold,
        refine_crop=min(args.refine_crop, height, width),
        template_fx=args.template_fx if args.template_fx > 0 else cam.fx,
        template_fy=args.template_fy if args.template_fy > 0 else cam.fy,
        template_cx=args.template_cx if args.template_cx >= 0 else cam.cx,
        template_cy=args.template_cy if args.template_cy >= 0 else cam.cy)
    eng = ObjReco.create("LmICP", ecfg)
    eng.add_obj(args.dir)
    return eng


def cmd_train(args) -> int:
    from fealess import config as cfg
    from fealess.apps import scan_package

    det = cfg.DetectorConfig()
    added, seen = scan_package.train_package(
        args.dir, det, class_id=args.class_id, progress=True)
    print(f"Training: {added}/{seen} frames -> "
          f"{os.path.join(args.dir, 'linemod_templates.yml')}")
    return 0 if added else 1


def _profile_stages(eng, bgr, depth, cam, iters: int = 15):
    """Per-stage device breakdown of one Recognition frame — the
    printTimeOfICP analog (ICP/ICP.cpp:283-311), measured with the
    chain-slope protocol (utils.profiling.chain_slope).  Stage rows are
    cumulative pipeline prefixes; a stage's own cost is the delta from
    the previous row."""
    import jax.numpy as jnp

    from fealess import detector as det_mod
    from fealess import pipeline
    from fealess.utils.profiling import chain_slope

    bgr_p, depth_p, scene_k = eng._prepare_frame(bgr, depth, cam)
    d = eng.cfg.detector
    dep_j = jnp.asarray(depth_p)
    kern = eng._kernels

    def dep(b, x):
        return b + (x.astype(jnp.float32).sum()
                    > jnp.float32(1e30)).astype(jnp.uint8)

    def front(b):
        levels = det_mod.quantized_pyramid(b, dep_j, d)
        planes = det_mod.response_planes(levels, d)
        return dep(b, sum(p.sum() for p, _ in planes))

    def match(b):
        m = det_mod.match_bank(eng.bank, b, dep_j,
                               eng.cfg.matching_threshold, d, kernels=kern)
        return b + ((m.similarity[0] + m.x[0].astype(jnp.float32))
                    < -1e30).astype(jnp.uint8)

    def full(b):
        step = pipeline.recognize_top1(
            eng.bank, eng._model_depth_dev, eng._origins_dev, b, dep_j,
            scene_k, eng.cfg, kernels=kern)
        return b + ((step.pose.sum() + step.similarity)
                    < -1e30).astype(jnp.uint8)

    x0 = jnp.asarray(bgr_p)
    rows = [("frontend(quant+planes)", chain_slope(front, x0, iters)),
            ("match(front+score+topk+refine16)", chain_slope(match, x0,
                                                             iters)),
            ("full(match+icp_refine)", chain_slope(full, x0, iters))]
    return rows


def cmd_recon(args) -> int:
    import cv2

    from fealess.io.native import FrameLoader
    from fealess.utils.profiling import StageTimer

    series = args.series or args.dir
    pairs = _series_paths(series, color_sub=args.color_sub)
    if not pairs:
        print(f"no frames under {series}", file=sys.stderr)
        return 1
    first = cv2.imread(pairs[0][0])
    h, w = first.shape[:2]
    if getattr(args, "artifact", None):
        from fealess.io.export import ServingArtifact
        eng = ServingArtifact(args.artifact)
        if args.multi:
            print("--artifact serves the top-1 path only",
                  file=sys.stderr)
            return 1
    else:
        eng = _engine_for(args, w, h)
    cam = _camera(args, w, h)

    mesh = None
    if args.overlay_dir:
        from fealess.apps import model_mesh
        objs = glob.glob(os.path.join(args.dir, "*.obj"))
        if objs:
            mesh = model_mesh.load_obj(objs[0], model_scale=args.model_scale)
        os.makedirs(args.overlay_dir, exist_ok=True)

    loader = FrameLoader([p[0] for p in pairs], [p[1] for p in pairs],
                         target_wh=(w, h))
    timer = StageTimer()
    last_frame = None
    n = 0
    t0 = time.perf_counter()
    it = iter(loader)
    while True:
        t_io = time.perf_counter()
        try:
            idx, bgr, depth = next(it)
        except StopIteration:
            break
        timer.add("host-io(decode+wait)", time.perf_counter() - t_io)
        if args.depth_scale != 1.0:
            depth = np.clip(np.rint(depth.astype(np.float64)
                                    * args.depth_scale),
                            0, 65535).astype(np.uint16)
        t_e = time.perf_counter()
        if args.multi:
            results = eng.recognition_multi(bgr, depth, cam)
        else:
            results = eng.recognition(bgr, depth, cam)
        timer.add("recognition(+fetch)", time.perf_counter() - t_e)
        last_frame = (bgr, depth)
        n += 1
        out = {"frame": idx,
               "results": [{"obj": r.obj_tag,
                            "similarity": r.similarity,
                            "icp_dist": r.icp_dist,
                            "pose": np.asarray(r.world2cam).tolist()}
                           for r in results]}
        print(json.dumps(out))
        if mesh is not None and results:
            k = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy],
                          [0, 0, 1]])
            img = bgr.copy()
            model_mesh.draw_wireframe(img, mesh, k, results[0].world2cam)
            cv2.imwrite(os.path.join(args.overlay_dir, f"{idx}.png"), img)
    dt = time.perf_counter() - t0
    print(f"# {n} frames in {dt:.2f}s ({n / dt:.2f} fps)", file=sys.stderr)
    if (getattr(args, "profile", False) and last_frame is not None
            and not getattr(args, "artifact", None)):
        print("# host wall-clock per frame:", file=sys.stderr)
        print("\n".join("# " + ln for ln in timer.report().splitlines()),
              file=sys.stderr)
        print("# device stages (chain-slope, cumulative prefixes):",
              file=sys.stderr)
        for name, secs in _profile_stages(eng, last_frame[0],
                                          last_frame[1], cam):
            print(f"# {name:<36}{secs * 1e3:>10.3f} ms/frame",
                  file=sys.stderr)
    return 0


def cmd_export(args) -> int:
    eng = _engine_for(args, args.width, args.height)
    eng.export_artifact(args.out)
    print(f"artifact -> {args.out}")
    return 0


def cmd_track(args) -> int:
    import cv2

    from fealess.apps.track import TrackedRecognizer
    from fealess.io.native import FrameLoader

    series = args.series or args.dir
    pairs = _series_paths(series, color_sub=args.color_sub)
    if not pairs:
        print(f"no frames under {series}", file=sys.stderr)
        return 1
    first = cv2.imread(pairs[0][0])
    h, w = first.shape[:2]
    eng = _engine_for(args, w, h)
    cam = _camera(args, w, h)
    tracker = TrackedRecognizer(eng, max_lost=args.max_lost)
    from fealess.utils.profiling import StageTimer
    timer = StageTimer()
    last_frame = None

    loader = FrameLoader([p[0] for p in pairs], [p[1] for p in pairs],
                         target_wh=(w, h))
    for idx, bgr, depth in loader:
        if args.depth_scale != 1.0:
            depth = np.clip(np.rint(depth.astype(np.float64)
                                    * args.depth_scale),
                            0, 65535).astype(np.uint16)
        t_s = time.perf_counter()
        step = tracker.step(bgr, depth, cam)
        timer.add("track_step(kcf+match+refine)",
                  time.perf_counter() - t_s)
        last_frame = (bgr, depth)
        out = {"frame": idx, "redetected": step.redetected,
               "tracking": step.tracking,
               "roi": list(step.roi) if step.roi else None,
               "results": [{"obj": r.obj_tag, "similarity": r.similarity,
                            "pose": np.asarray(r.world2cam).tolist()}
                           for r in step.results]}
        print(json.dumps(out))
    if (getattr(args, "profile", False) and last_frame is not None
            and not getattr(args, "artifact", None)):
        print("# host wall-clock per frame:", file=sys.stderr)
        print("\n".join("# " + ln for ln in timer.report().splitlines()),
              file=sys.stderr)
        print("# device stages (chain-slope, cumulative prefixes):",
              file=sys.stderr)
        for name, secs in _profile_stages(eng, last_frame[0],
                                          last_frame[1], cam):
            print(f"# {name:<36}{secs * 1e3:>10.3f} ms/frame",
                  file=sys.stderr)
    return 0


def cmd_eval(args) -> int:
    """Compare recon JSONL output against ground-truth pose txt files."""
    from fealess.apps import metrics, model_mesh

    poses_est: List[Optional[np.ndarray]] = []
    poses_gt: List[np.ndarray] = []
    with open(args.results) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rec = json.loads(line)
            gt_path = os.path.join(args.dir, "pose",
                                   f"{rec['frame']}.txt")
            with open(gt_path) as gf:
                vals = [float(v) for v in gf.readline().split()[:12]]
            gt = np.eye(4, dtype=np.float32)
            gt[:3, :4] = np.asarray(vals, np.float32).reshape(3, 4)
            poses_gt.append(gt)
            if rec["results"]:
                poses_est.append(np.asarray(rec["results"][0]["pose"]))
            else:
                poses_est.append(None)

    objs = glob.glob(os.path.join(args.dir, "*.obj"))
    if not objs:
        print("no .obj model for ADD evaluation", file=sys.stderr)
        return 1
    mesh = model_mesh.load_obj(objs[0], model_scale=args.model_scale)
    summary = metrics.evaluate(poses_est, poses_gt, mesh.vertices,
                               add_tau=args.add_tau)
    print(json.dumps({
        "n_frames": summary.n_frames,
        "detection_rate": summary.detection_rate,
        "add_pass_rate": summary.add_pass_rate,
        "mean_add": summary.mean_add,
        "mean_rot_deg": summary.mean_rot_deg,
        "mean_trans_mm": summary.mean_trans_mm}))
    return 0


def cmd_bench(args) -> int:
    import bench
    bench.main()
    return 0


def cmd_acq(args) -> int:
    from fealess.apps.acquire import acquire_series
    source = int(args.source) if args.source.isdigit() else args.source
    acquire_series(source, args.out_dir, depth_dir=args.depth_dir,
                   fx=args.fx, fy=args.fy,
                   cx=args.cx if args.cx >= 0 else 320.0,
                   cy=args.cy if args.cy >= 0 else 240.0,
                   max_frames=args.max_frames, save_clouds=args.clouds)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fealess",
        description="RGB-D 6DoF object recognition engine")
    sub = p.add_subparsers(dest="action", required=True)

    t = sub.add_parser("train", help="train templates from a scan package")
    t.add_argument("dir")
    t.add_argument("--class-id", default="obj")
    t.set_defaults(fn=cmd_train)

    def _recon_like(r):
        r.add_argument("dir", help="feature dir (linemod_templates.yml)")
        r.add_argument("--series", default=None,
                       help="frame series dir (default: feature dir)")
        r.add_argument("--color-sub", default="gray")
        r.add_argument("--threshold", type=float, default=75.0)
        r.add_argument("--icp-mode", default=None,
                       choices=["point_to_point", "point_to_plane"],
                       help="default: IcpConfig default (point_to_plane, "
                            "the production path; point_to_point = "
                            "reference parity mode)")
        r.add_argument("--profile", action="store_true",
                       help="print per-stage timing (the printTimeOfICP "
                            "analog): host wall segments per frame plus "
                            "the chain-slope device-stage table")
        r.add_argument("--refine-crop", type=int, default=256)
        r.add_argument("--icp-max-points", type=int, default=16384)
        r.add_argument("--depth-scale", type=float, default=0.1,
                       help="series depth png -> mm factor (package pngs "
                            "are 0.1mm units; RealSense mm series use 1)")
        r.add_argument("--template-fx", type=float, default=-1.0,
                       help="template render K (default: camera K)")
        r.add_argument("--template-fy", type=float, default=-1.0)
        r.add_argument("--template-cx", type=float, default=-1.0)
        r.add_argument("--template-cy", type=float, default=-1.0)
        _add_camera_args(r)

    r = sub.add_parser("recon", help="recognize over an image series")
    _recon_like(r)
    r.add_argument("--multi", action="store_true",
                   help="multi-object NMS path")
    r.add_argument("--overlay-dir", default=None,
                   help="write wireframe overlay pngs here")
    r.add_argument("--model-scale", type=float, default=0.1,
                   help="OBJ vertex divisor (RENDERING_MODEL_SCALE)")
    r.add_argument("--artifact", default=None,
                   help="serve from a serialized artifact dir (see the "
                        "export subcommand) instead of loading the YAML "
                        "bank — no jit re-trace on cold start")
    r.set_defaults(fn=cmd_recon)

    k = sub.add_parser("track", help="KCF-gated recognition over a series")
    _recon_like(k)
    k.add_argument("--max-lost", type=int, default=2)
    k.set_defaults(fn=cmd_track)

    x = sub.add_parser("export", help="write the serialized serving "
                       "artifact (the libObjRecoLmICP.so analog)")
    _recon_like(x)
    x.add_argument("out", help="artifact output directory")
    x.add_argument("--width", type=int, default=640,
                   help="processing width baked into the artifact")
    x.add_argument("--height", type=int, default=480)
    x.set_defaults(fn=cmd_export)

    e = sub.add_parser("eval", help="ADD metrics from recon output")
    e.add_argument("dir", help="package dir with pose/<i>.txt + model.obj")
    e.add_argument("results", help="recon JSONL output file")
    e.add_argument("--add-tau", type=float, default=0.1)
    e.add_argument("--model-scale", type=float, default=0.1)
    e.set_defaults(fn=cmd_eval)

    b = sub.add_parser("bench", help="single-chip throughput benchmark")
    b.set_defaults(fn=cmd_bench)

    a = sub.add_parser("acq", help="capture frames into scan-package layout")
    a.add_argument("source", help="camera index, video file, or image dir")
    a.add_argument("out_dir")
    a.add_argument("--depth-dir", default=None,
                   help="paired u16 depth png series (mm)")
    a.add_argument("--max-frames", type=int, default=None)
    a.add_argument("--clouds", action="store_true",
                   help="also dump cloud/<i>.txt point lists (mm)")
    _add_camera_args(a)
    a.set_defaults(fn=cmd_acq)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
