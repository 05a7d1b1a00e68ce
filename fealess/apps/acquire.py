"""Frame acquisition and ROI selection tools.

Reimplements the two remaining interactive pieces of the reference's demo
layer for a headless accelerator workflow:

- ``acquire_series``: the capture/dump tool ``linemod_acq``
  (test/linemod_acq.cpp:10-102).  The reference pulls 640x480 aligned
  RGB-D frames from a RealSense pipeline and writes ``gray/<i>.png``,
  ``depth/<i>.png`` plus a ``cloud/<i>.txt`` point dump (x1000 -> mm) per
  saved frame, printing the stream intrinsics.  Here the frame source is
  anything :class:`fealess.io.series.ImageSeriesReader` accepts (camera
  index, video file, image directory) paired with an optional depth
  directory — there is no RealSense hardware in a headless deployment, but the
  on-disk artifact layout (consumed by ``train``/``recon``/``track``) is
  identical.

- ``BoxExtractor``: the interactive ROI picker
  (kcf_tracker/BoxExtractor.{h,cpp}).  The reference draws a rubber-band
  rectangle with highgui mouse callbacks; :meth:`BoxExtractor.extract`
  delegates to ``cv2.selectROI`` when a display is available and otherwise
  raises, while :func:`roi_from_mask` and :func:`roi_from_depth` provide the
  programmatic equivalents used by the headless tracking pipeline (seed the
  KCF tracker from an object mask / nearest connected depth blob instead of
  a mouse).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

Roi = Tuple[float, float, float, float]          # x, y, w, h


def roi_from_mask(mask: np.ndarray, pad: int = 0) -> Optional[Roi]:
    """Tight bounding box of the nonzero pixels of ``mask`` (+``pad`` px).

    The programmatic stand-in for BoxExtractor's mouse rectangle: training
    packages carry an object mask (scan_package mask sentinel,
    test/linemod_train.cpp:59-67), whose bbox seeds the tracker.
    Returns None when the mask is empty.
    """
    ys, xs = np.nonzero(np.asarray(mask))
    if len(xs) == 0:
        return None
    h, w = mask.shape[:2]
    x0 = max(int(xs.min()) - pad, 0)
    y0 = max(int(ys.min()) - pad, 0)
    x1 = min(int(xs.max()) + pad, w - 1)
    y1 = min(int(ys.max()) + pad, h - 1)
    return (float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1))


def roi_from_depth(depth_mm: np.ndarray, max_depth_mm: float = 900.0,
                   pad: int = 8) -> Optional[Roi]:
    """ROI of the nearest depth blob: pixels valid and within
    ``max_depth_mm`` (the is_vec3f_valid cap, ICP/common.cpp:261-266).

    Headless seed for the KCF-gated pipeline when no mask exists.
    """
    d = np.asarray(depth_mm)
    return roi_from_mask((d > 0) & (d <= max_depth_mm), pad=pad)


class BoxExtractor:
    """Interactive ROI selection (kcf_tracker/BoxExtractor.h:21-37).

    ``extract`` opens an OpenCV window and returns the dragged rectangle;
    it requires a display (raises RuntimeError otherwise — use
    :func:`roi_from_mask` / :func:`roi_from_depth` headless).
    """

    def extract(self, window_name: str, image: np.ndarray) -> Roi:
        import sys
        has_display = (os.environ.get("DISPLAY")
                       or os.environ.get("WAYLAND_DISPLAY")
                       or os.name == "nt" or sys.platform == "darwin")
        if not has_display:
            raise RuntimeError(
                "BoxExtractor.extract needs a display; use roi_from_mask / "
                "roi_from_depth for headless ROI selection")
        import cv2
        try:
            x, y, w, h = cv2.selectROI(window_name, image,
                                       showCrosshair=True)
        except cv2.error as e:
            raise RuntimeError(
                "BoxExtractor.extract could not open a window "
                f"({e}); use roi_from_mask / roi_from_depth for headless "
                "ROI selection") from e
        cv2.destroyWindow(window_name)
        return (float(x), float(y), float(w), float(h))


def write_cloud_txt(path: str, points_m: np.ndarray,
                    valid: Optional[np.ndarray] = None) -> int:
    """Dump a point cloud as whitespace ``x y z`` rows in millimetres
    (the x1000 scaling of linemod_acq.cpp's cloud txt dump).  Returns the
    number of points written."""
    pts = np.asarray(points_m, np.float32).reshape(-1, 3)
    if valid is not None:
        pts = pts[np.asarray(valid).reshape(-1)]
    pts = pts[np.isfinite(pts).all(axis=1)] * 1000.0
    with open(path, "w") as f:
        for p in pts:
            f.write(f"{p[0]:.3f} {p[1]:.3f} {p[2]:.3f}\n")
    return len(pts)


def acquire_series(color_source, out_dir: str,
                   depth_dir: Optional[str] = None,
                   fx: float = 608.0, fy: float = 608.0,
                   cx: float = 320.0, cy: float = 240.0,
                   max_frames: Optional[int] = None,
                   save_clouds: bool = False,
                   target_wh: Tuple[int, int] = (640, 480)) -> int:
    """Capture frames into the scan-package layout (linemod_acq.cpp:10-102).

    Writes ``gray/<i>.png`` (color), ``depth/<i>.png`` (u16 mm, when a
    depth series is given) and optionally ``cloud/<i>.txt`` (mm) under
    ``out_dir``; prints the intrinsics like the reference prints the
    RealSense stream profile.  Returns the number of frames saved.
    """
    from fealess.io.series import ImageSeriesReader

    os.makedirs(os.path.join(out_dir, "gray"), exist_ok=True)
    # Depth frames pair with color frames by basename STEM (gray/7.png <->
    # depth/7.png), with numeric-stem ordering as the fallback for nameless
    # (video/camera) sources — matching ImageSeriesReader's own sort.
    # Lexicographic sorting or positional pairing both corrupt packages:
    # ">= 10 unpadded numeric names" reorders (1, 10, 2, ...) and a single
    # unreadable color png shifts every later pair.
    depth_by_stem: dict = {}
    depth_list: list = []
    if depth_dir:
        import glob
        os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)

        def _key(p):
            stem = os.path.splitext(os.path.basename(p))[0]
            return (0, int(stem)) if stem.isdigit() else (1, stem)
        depth_list = sorted(glob.glob(os.path.join(depth_dir, "*.png")),
                            key=_key)
        depth_by_stem = {
            os.path.splitext(os.path.basename(p))[0]: p for p in depth_list}
    if save_clouds:
        os.makedirs(os.path.join(out_dir, "cloud"), exist_ok=True)

    print(f"intrinsics: fx={fx} fy={fy} cx={cx} cy={cy} "
          f"size={target_wh[0]}x{target_wh[1]}")

    import cv2
    reader = ImageSeriesReader(color_source, target_wh=target_wh)
    n = 0
    for i, (stem, frame) in enumerate(reader.iter_named()):
        if max_frames is not None and n >= max_frames:
            break
        cv2.imwrite(os.path.join(out_dir, "gray", f"{i}.png"), frame)
        if stem is not None and stem in depth_by_stem:
            depth_path = depth_by_stem[stem]
        elif stem is None and i < len(depth_list):
            depth_path = depth_list[i]
        else:
            depth_path = None
        if depth_path is not None:
            d = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED)
            if d is not None:
                d = d.astype(np.uint16)
                cv2.imwrite(os.path.join(out_dir, "depth", f"{i}.png"), d)
                if save_clouds:
                    from fealess.geometry import depth as gd
                    import jax.numpy as jnp
                    k = gd.intrinsics_matrix(fx, fy, cx, cy)
                    pts = np.asarray(gd.depth_to_3d(jnp.asarray(d), k))
                    write_cloud_txt(
                        os.path.join(out_dir, "cloud", f"{i}.txt"), pts)
        n += 1
    print(f"saved {n} frames to {out_dir}")
    return n
