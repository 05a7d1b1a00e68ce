"""KCF tracker family tests: patch sampling vs OpenCV, FHOG vs an
independent loop-style NumPy implementation, and end-to-end tracking
properties (translation, scale adaptation) in raw-gray and HOG modes.

The reference has no tests (SURVEY.md §4); golden values here come from
OpenCV (which the reference itself calls) and from loop-level NumPy
re-derivations of the documented FHOG semantics (fhog.cpp:80-482).
"""

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from fealess.ops.sampling import sample_patch_bilinear
from fealess.tracker import fhog
from fealess.tracker.kcf import (KcfTracker, kcf_reference_config)

NUM_SECTOR = 9


# ---------------------------------------------------------------- sampling

def _ref_subwindow_resize(img, ex, ey, ew, eh, out_w, out_h):
    """The reference path: RectTools::subwindow (BORDER_REPLICATE,
    recttools.hpp:115-131) then cv::resize (kcftracker.cpp:416-419)."""
    h, w = img.shape[:2]
    cx0, cy0 = max(ex, 0), max(ey, 0)
    cx1, cy1 = min(ex + ew, w), min(ey + eh, h)
    cut = img[cy0:cy1, cx0:cx1]
    top, left = cy0 - ey, cx0 - ex
    bottom, right = (ey + eh) - cy1, (ex + ew) - cx1
    cut = cv2.copyMakeBorder(cut, top, bottom, left, right,
                             cv2.BORDER_REPLICATE)
    if (ew, eh) != (out_w, out_h):
        cut = cv2.resize(cut, (out_w, out_h))
    return cut


def test_sample_patch_identity_window_exact():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, size=(60, 80, 3), dtype=np.uint8)
    got = np.asarray(sample_patch_bilinear(jnp.asarray(img),
                                           10.0, 5.0, 32.0, 24.0, 24, 32))
    want = _ref_subwindow_resize(img, 10, 5, 32, 24, 32, 24)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_sample_patch_replicate_border_exact():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, size=(40, 50, 3), dtype=np.uint8)
    # window hangs off every side
    got = np.asarray(sample_patch_bilinear(jnp.asarray(img),
                                           -8.0, -6.0, 70.0, 60.0, 60, 70))
    want = _ref_subwindow_resize(img, -8, -6, 70, 60, 70, 60)
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("window", [
    (4, 8, 40, 30, 20, 24),        # downscale inside the image
    (3, 5, 30, 40, 96, 96),        # upscale
    (10, 2, 37, 29, 50, 41),       # odd sizes
    (-9, 40, 50, 37, 48, 48),      # window hangs off the left edge
    (30, -7, 44, 52, 48, 48),      # and off the top
], ids=["down", "up", "odd", "left_edge", "top_edge"])
def test_sample_patch_resize_matches_cv2(window):
    """The fixed-point sampler equals RectTools::subwindow + cv::resize
    INTER_LINEAR of the 8-bit patch value for value, borders included."""
    x0, y0, sw, sh, oh, ow = window
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    got = np.asarray(sample_patch_bilinear(jnp.asarray(img), x0, y0, sw, sh,
                                           oh, ow))
    want = _ref_subwindow_resize(img, x0, y0, sw, sh, ow, oh)
    np.testing.assert_array_equal(got, want.astype(np.float32))


# ------------------------------------------------------------------- fhog

def _numpy_fhog_raw(image, k):
    """Loop-level re-derivation of getFeatureMaps (fhog.cpp:80-275)."""
    h, w, nch = image.shape
    img = image.astype(np.float32)
    dx = np.zeros_like(img)
    dy = np.zeros_like(img)
    dx[:, 1:-1] = img[:, 2:] - img[:, :-2]
    dy[1:-1, :] = img[2:] - img[:-2]
    sy, sx = h // k, w // k
    boundary = np.arange(NUM_SECTOR + 1) * np.pi / NUM_SECTOR
    bx, by = np.cos(boundary), np.sin(boundary)

    r = np.zeros((h, w), np.float32)
    alfa = np.zeros((h, w, 2), np.int32)
    for j in range(1, h - 1):
        for i in range(1, w - 1):
            c = 0
            x, y = dx[j, i, 0], dy[j, i, 0]
            r[j, i] = np.sqrt(x * x + y * y)
            for ch in range(1, nch):
                m = np.sqrt(dx[j, i, ch] ** 2 + dy[j, i, ch] ** 2)
                if m > r[j, i]:
                    r[j, i] = m
                    x, y = dx[j, i, ch], dy[j, i, ch]
            mx = bx[0] * x + by[0] * y
            maxi = 0
            for kk in range(NUM_SECTOR):
                dot = bx[kk] * x + by[kk] * y
                if dot > mx:
                    mx, maxi = dot, kk
                elif -dot > mx:
                    mx, maxi = -dot, kk + NUM_SECTOR
            alfa[j, i, 0] = maxi % NUM_SECTOR
            alfa[j, i, 1] = maxi

    nearest = np.array([-1] * (k // 2) + [1] * (k - k // 2))
    wts = np.zeros((k, 2), np.float32)
    for j in range(k // 2):
        b = k / 2 + j + 0.5
        a = k / 2 - j - 0.5
        wts[j] = [b / (a + b), a / (a + b)]
    for j in range(k // 2, k):
        a = j - k / 2 + 0.5
        b = -j + k / 2 - 0.5 + k
        wts[j] = [b / (a + b), a / (a + b)]

    out = np.zeros((sy, sx, 3 * NUM_SECTOR), np.float32)
    for i in range(sy):
        for jj_ in range(sx):
            for ii in range(k):
                for jj in range(k):
                    py, px = i * k + ii, jj_ * k + jj
                    if not (0 < py < h - 1 and 0 < px < w - 1):
                        continue
                    rv = r[py, px]
                    a0, a1 = alfa[py, px]
                    out[i, jj_, a0] += rv * wts[ii, 0] * wts[jj, 0]
                    out[i, jj_, a1 + NUM_SECTOR] += rv * wts[ii, 0] * wts[jj, 0]
                    if 0 <= i + nearest[ii] <= sy - 1:
                        out[i + nearest[ii], jj_, a0] += rv * wts[ii, 1] * wts[jj, 0]
                        out[i + nearest[ii], jj_, a1 + NUM_SECTOR] += \
                            rv * wts[ii, 1] * wts[jj, 0]
                    if 0 <= jj_ + nearest[jj] <= sx - 1:
                        out[i, jj_ + nearest[jj], a0] += rv * wts[ii, 0] * wts[jj, 1]
                        out[i, jj_ + nearest[jj], a1 + NUM_SECTOR] += \
                            rv * wts[ii, 0] * wts[jj, 1]
                    if (0 <= i + nearest[ii] <= sy - 1
                            and 0 <= jj_ + nearest[jj] <= sx - 1):
                        out[i + nearest[ii], jj_ + nearest[jj], a0] += \
                            rv * wts[ii, 1] * wts[jj, 1]
                        out[i + nearest[ii], jj_ + nearest[jj], a1 + NUM_SECTOR] += \
                            rv * wts[ii, 1] * wts[jj, 1]
    return out


def test_fhog_raw_maps_match_loop_reference():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, size=(24, 32, 3), dtype=np.uint8).astype(np.float32)
    got = np.asarray(fhog.raw_feature_maps(jnp.asarray(img), 4))
    want = _numpy_fhog_raw(img, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_fhog_constant_image_is_zero():
    img = np.full((32, 32, 3), 127.0, np.float32)
    feats = np.asarray(fhog.fhog31(jnp.asarray(img), 4))
    assert feats.shape == (32 // 4 - 2, 32 // 4 - 2, 31)
    np.testing.assert_allclose(feats, 0.0, atol=1e-6)


def test_fhog_vertical_edge_orientation():
    # vertical edge -> horizontal gradient -> insensitive bin 0 dominates
    img = np.zeros((32, 32, 3), np.float32)
    img[:, 16:] = 200.0
    raw = np.asarray(fhog.raw_feature_maps(jnp.asarray(img), 4))
    ins = raw[2:-2, 2:-2, :NUM_SECTOR].sum(axis=(0, 1))
    assert np.argmax(ins) == 0
    # energy is concentrated: dominant bin carries everything
    assert ins[0] > 0.99 * ins.sum()


def test_fhog_normalize_truncate_bounds():
    rng = np.random.default_rng(4)
    img = rng.normal(size=(40, 40, 3)).astype(np.float32) * 50
    maps = fhog.raw_feature_maps(jnp.asarray(img), 4)
    n = np.asarray(fhog.normalize_and_truncate(maps))
    assert n.shape == (8, 8, 108)
    assert n.min() >= 0.0 and n.max() <= fhog.TRUNCATION + 1e-6


# -------------------------------------------------------------------- kcf

def _frame(cx, cy, size=20, dims=(120, 160), noise_rng=None):
    """A bright textured square centred at (cx, cy) on dark noise."""
    h, w = dims
    img = np.zeros((h, w, 3), np.uint8)
    if noise_rng is not None:
        img = noise_rng.integers(0, 30, size=(h, w, 3), dtype=np.uint8)
    half = size // 2
    y0, y1 = int(cy) - half, int(cy) + half
    x0, x1 = int(cx) - half, int(cx) + half
    tex = (np.indices((y1 - y0, x1 - x0)).sum(0) % 7) * 25 + 80
    img[y0:y1, x0:x1] = tex[..., None].astype(np.uint8)
    return img


@pytest.mark.parametrize("hog,lab", [(False, False), (True, False),
                                     (True, True)])
def test_kcf_tracks_translation(hog, lab):
    rng = np.random.default_rng(5)
    cfg = kcf_reference_config(hog=hog, multiscale=False, lab=lab)
    tracker = KcfTracker(cfg)
    cx = cy = 40.0
    state = tracker.init((cx - 12, cy - 12, 24, 24), _frame(cx, cy, 24,
                                                            noise_rng=rng))
    for _ in range(12):
        cx += 2.0
        cy += 1.0
        state, roi = tracker.update(state, _frame(cx, cy, 24, noise_rng=rng))
    got_cx = roi[0] + roi[2] / 2
    got_cy = roi[1] + roi[3] / 2
    assert abs(got_cx - cx) < 4.0, (got_cx, cx)
    assert abs(got_cy - cy) < 4.0, (got_cy, cy)


def test_kcf_multiscale_adapts_to_growth():
    cfg = kcf_reference_config(hog=True, multiscale=True, lab=False)
    tracker = KcfTracker(cfg)
    size = 20
    state = tracker.init((80 - size, 60 - size, 2 * size, 2 * size),
                         _frame(80, 60, 2 * size))
    w0 = 2 * size
    sizes = [22, 24, 26, 28, 30, 32, 34, 36]
    for s in sizes:
        state, roi = tracker.update(state, _frame(80, 60, 2 * s))
    assert roi[2] > w0 * 1.1, roi          # width grew with the target


def test_kcf_stationary_target_stays_put():
    cfg = kcf_reference_config(hog=True, multiscale=True, lab=True)
    tracker = KcfTracker(cfg)
    img = _frame(60, 50, 24)
    state = tracker.init((48, 38, 24, 24), img)
    for _ in range(5):
        state, roi = tracker.update(state, img)
    assert abs(roi[0] + roi[2] / 2 - 60) < 2.0
    assert abs(roi[1] + roi[3] / 2 - 50) < 2.0
