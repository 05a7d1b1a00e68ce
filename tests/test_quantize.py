"""Golden tests for the quantization front-end against a NumPy/cv2 oracle
that restates the reference algorithms (linemod/linemod.cpp:230-385,
595-685) independently of the JAX implementation."""

import cv2
import numpy as np
import pytest

from fealess.ops import quantize as q
from fealess.ops import luts


def _oracle_quantize_gradients(bgr: np.ndarray, weak_threshold: float):
    """Reference semantics: blur -> per-channel Sobel -> argmax channel ->
    phase -> 16->8 bin fold -> >=5-of-9 neighbourhood vote."""
    sm = cv2.GaussianBlur(bgr, (7, 7), 0, 0, borderType=cv2.BORDER_REPLICATE)
    dx = cv2.Sobel(sm, cv2.CV_16S, 1, 0, ksize=3,
                   borderType=cv2.BORDER_REPLICATE).astype(np.int32)
    dy = cv2.Sobel(sm, cv2.CV_16S, 0, 1, ksize=3,
                   borderType=cv2.BORDER_REPLICATE).astype(np.int32)
    mag3 = dx * dx + dy * dy
    h, w = bgr.shape[:2]
    sel = np.where((mag3[..., 0] >= mag3[..., 1]) & (mag3[..., 0] >= mag3[..., 2]), 0,
                   np.where((mag3[..., 1] >= mag3[..., 0]) & (mag3[..., 1] >= mag3[..., 2]), 1, 2))
    ii = np.arange(h)[:, None], np.arange(w)[None, :]
    sdx = dx[ii[0], ii[1], sel].astype(np.float32)
    sdy = dy[ii[0], ii[1], sel].astype(np.float32)
    mag = mag3[ii[0], ii[1], sel].astype(np.float32)
    angle = cv2.phase(sdx, sdy, angleInDegrees=True)
    # convertTo(CV_8U, 16/360) uses cvRound = round-half-to-even
    q16 = np.rint(angle * 16.0 / 360.0).astype(np.int64)
    q8 = (q16 & 7).astype(np.uint8)
    q8[0, :] = 0
    q8[-1, :] = 0
    q8[:, 0] = 0
    q8[:, -1] = 0
    out = np.zeros((h, w), np.uint8)
    thr2 = weak_threshold * weak_threshold
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            if mag[y, x] <= thr2:
                continue
            hist = np.zeros(8, np.int64)
            for dy2 in (-1, 0, 1):
                for dx2 in (-1, 0, 1):
                    hist[q8[y + dy2, x + dx2]] += 1
            ind = int(np.argmax(hist))
            if hist[ind] >= q.NEIGHBOR_THRESHOLD:
                out[y, x] = 1 << ind
    return out, mag


def _oracle_quantize_normals(depth: np.ndarray, distance_threshold: int,
                             difference_threshold: int):
    """Reference semantics of quantizedNormals (linemod.cpp:595-685)."""
    h, w = depth.shape
    r = q.NORMAL_RING_RADIUS
    g = q.NORMAL_GRANULARITY
    lut = luts.normal_lut(g)
    out = np.zeros((h, w), np.uint8)
    d = depth.astype(np.int64)
    for y in range(r, h - r - 1):
        for x in range(r, w - r - 1):
            if d[y, x] >= distance_threshold:
                continue
            A = np.zeros(3)
            b = np.zeros(2)
            for (i, j) in [(-r, -r), (0, -r), (r, -r), (-r, 0), (r, 0),
                           (-r, r), (0, r), (r, r)]:
                delta = d[y + j, x + i] - d[y, x]
                f = abs(delta) < difference_threshold
                fi_, fj_ = f * i, f * j
                A[0] += fi_ * i
                A[1] += fi_ * j
                A[2] += fj_ * j
                b[0] += fi_ * delta
                b[1] += fj_ * delta
            det = A[0] * A[2] - A[1] * A[1]
            ddx = A[2] * b[0] - A[1] * b[1]
            ddy = -A[1] * b[0] + A[0] * b[1]
            nx, ny = 617.0 * ddx, 617.0 * ddy
            nz = -float(det * d[y, x])
            norm = np.sqrt(nx * nx + ny * ny + nz * nz)
            if norm > 0:
                nx, ny, nz = nx / norm, ny / norm, nz / norm
                ix = min(max(int(nx * (g / 2) + g / 2), 0), g - 1)
                iy = min(max(int(ny * (g / 2) + g / 2), 0), g - 1)
                iz = min(max(int(nz * g + g), 0), g - 1)
                out[y, x] = lut[iz, iy, ix]
    return cv2.medianBlur(out, 5)


@pytest.fixture
def scene_bgr(rng):
    # Smooth synthetic scene: gradients are structured, not pure noise.
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (128 + 80 * np.sin(xx / 7.0) * np.cos(yy / 9.0))
    img = np.stack([base, np.roll(base, 3, axis=1),
                    np.roll(base[::-1], 7, axis=0)], axis=-1)
    img += rng.normal(0, 6, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture
def scene_depth(rng):
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 600 + 4 * xx + 2 * yy + 30 * np.sin(xx / 11.0)
    depth += rng.normal(0, 1.5, size=depth.shape)
    return depth.astype(np.uint16)


def test_quantize_gradients_matches_oracle(scene_bgr):
    ours, mag = q.quantize_gradients(scene_bgr, weak_threshold=10.0)
    ref, ref_mag = _oracle_quantize_gradients(scene_bgr, 10.0)
    ours = np.asarray(ours)
    mag = np.asarray(mag)
    np.testing.assert_array_equal(mag, ref_mag)
    mismatch = (ours != ref).mean()
    # fastAtan2 vs cv2.phase may flip pixels exactly on a bin boundary;
    # require near-perfect agreement.
    assert mismatch < 0.002, f"mismatch fraction {mismatch}"


def test_quantize_normals_matches_oracle(scene_depth):
    ours = np.asarray(q.quantize_normals(scene_depth, 2000, 50))
    ref = _oracle_quantize_normals(scene_depth, 2000, 50)
    mismatch = (ours != ref).mean()
    assert mismatch < 0.002, f"mismatch fraction {mismatch}"


def test_quantize_normals_rejects_far_depth(scene_depth):
    far = scene_depth.astype(np.int64) + 3000
    out = np.asarray(q.quantize_normals(far.astype(np.uint16), 2000, 50))
    assert (out == 0).all()


def test_apply_mask(scene_bgr):
    quant, _ = q.quantize_gradients(scene_bgr, 10.0)
    mask = np.zeros(scene_bgr.shape[:2], bool)
    mask[10:30, 10:40] = True
    masked = np.asarray(q.apply_mask(quant, mask))
    assert (masked[~mask] == 0).all()
    np.testing.assert_array_equal(masked[mask], np.asarray(quant)[mask])
