"""Match visualization: feature circles and template blit overlays.

Reimplements the two ``drawResponse`` overloads (linemod/linemod_if.cpp:
65-139): draw each template feature as a circle of radius T/2 at the match
offset, color per modality; and blit the (grayscale) template image into
the match rect with per-pixel max.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from fealess.bank import TemplateBank

# modality colors (BGR) — linemod_if.cpp:68-72 (orange, green, ...)
COLORS = [(0, 140, 255), (0, 255, 0), (0, 255, 255), (0, 140, 255),
          (0, 0, 255)]


def draw_response(image: np.ndarray, bank: TemplateBank, slot: int,
                  offset_xy: Tuple[int, int], level: int = 0,
                  t: Optional[int] = None) -> np.ndarray:
    """Draw the matched template's features at ``offset_xy`` (in place).

    Circle radius T/2, color per modality (drawResponse #1,
    linemod_if.cpp:65-92)."""
    import cv2
    t = t or 5
    fx = np.asarray(bank.feat_x)[slot, level]
    fy = np.asarray(bank.feat_y)[slot, level]
    fv = np.asarray(bank.feat_valid)[slot, level]
    ox, oy = offset_xy
    for m in range(fx.shape[0]):
        color = COLORS[m % len(COLORS)]
        for x, y, ok in zip(fx[m], fy[m], fv[m]):
            if ok:
                cv2.circle(image, (int(x) + ox, int(y) + oy), t // 2,
                           color, 2)
    return image


def blit_template(image: np.ndarray, template_gray: np.ndarray,
                  offset_xy: Tuple[int, int]) -> np.ndarray:
    """Blit a template's grayscale pixels into the match rect with
    per-pixel max (drawResponse #2's overlay, linemod_if.cpp:96-139)."""
    ox, oy = offset_xy
    h, w = template_gray.shape[:2]
    ih, iw = image.shape[:2]
    x1 = min(ox + w, iw)
    y1 = min(oy + h, ih)
    if ox >= iw or oy >= ih or x1 <= max(ox, 0) or y1 <= max(oy, 0):
        return image
    sub = image[max(oy, 0):y1, max(ox, 0):x1]
    tpl = template_gray[max(oy, 0) - oy:y1 - oy, max(ox, 0) - ox:x1 - ox]
    if sub.ndim == 3 and tpl.ndim == 2:
        tpl = tpl[..., None]
    np.maximum(sub, tpl, out=sub)
    return image


def save_ply(path: str, points: np.ndarray,
             colors: Optional[np.ndarray] = None,
             valid: Optional[np.ndarray] = None) -> int:
    """Write a point cloud as ASCII PLY for external 3D viewers.

    The debug role of the reference's PCL cloud viewers (show_cloud /
    show_mesh behind NEED_PCL_DEBUG, ICP/common.cpp:107-259) without the
    PCL dependency: dump any (N, 3) cloud (mm or m) at ICP stages and
    open it in MeshLab/CloudCompare.  ``colors`` is (N, 3) u8 BGR (OpenCV
    order; written as RGB); ``valid`` masks rows.  Returns points written.
    """
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if valid is not None:
        keep = np.asarray(valid, bool).reshape(-1)
    else:
        keep = np.isfinite(pts).all(axis=1)
    pts = pts[keep]
    cols = None
    if colors is not None:
        cols = np.asarray(colors, np.uint8).reshape(-1, 3)[keep]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n")
        if cols is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i, p in enumerate(pts):
            line = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if cols is not None:
                c = cols[i]
                line += f" {c[2]} {c[1]} {c[0]}"
            f.write(line + "\n")
    return len(pts)
