"""Bit-exactness tests of image primitives against OpenCV.

The quantization front-end makes bit-level decisions (orientation bins,
bitmask votes), so these primitives must match cv2 exactly — any drift
flips labels and breaks template parity.
"""

import cv2
import numpy as np
import pytest

from fealess.ops import image as fi


@pytest.fixture
def img_u8(rng):
    return rng.integers(0, 256, size=(64, 96), dtype=np.uint8)


@pytest.fixture
def img_bgr(rng):
    return rng.integers(0, 256, size=(64, 96, 3), dtype=np.uint8)


def test_gaussian_blur7_matches_cv2(img_bgr):
    ref = cv2.GaussianBlur(img_bgr, (7, 7), 0, 0, borderType=cv2.BORDER_REPLICATE)
    out = np.asarray(fi.gaussian_blur7_u8(img_bgr))
    np.testing.assert_array_equal(out, ref)


def test_sobel3_matches_cv2(img_bgr):
    for axis, (dx, dy) in (("x", (1, 0)), ("y", (0, 1))):
        ref = cv2.Sobel(img_bgr, cv2.CV_16S, dx, dy, ksize=3,
                        borderType=cv2.BORDER_REPLICATE)
        out = np.asarray(fi.sobel3_i16(img_bgr, axis))
        np.testing.assert_array_equal(out, ref)


def test_pyr_down_matches_cv2(img_bgr):
    ref = cv2.pyrDown(img_bgr)
    out = np.asarray(fi.pyr_down_u8(img_bgr))
    np.testing.assert_array_equal(out, ref)


def test_pyr_down_gray_matches_cv2(img_u8):
    ref = cv2.pyrDown(img_u8)
    out = np.asarray(fi.pyr_down_u8(img_u8))
    np.testing.assert_array_equal(out, ref)


def test_median_blur5_matches_cv2(rng):
    # Power-of-two bitmask pixels, like the quantized-normal image.
    img = (1 << rng.integers(0, 8, size=(48, 80))).astype(np.uint8)
    img[rng.random((48, 80)) < 0.3] = 0
    ref = cv2.medianBlur(img, 5)
    out = np.asarray(fi.median_blur5_u8(img))
    # cv2's border handling for medianBlur is BORDER_REPLICATE; interiors
    # must match exactly and borders too.
    np.testing.assert_array_equal(out, ref)


def test_fast_atan2_matches_cv2(rng):
    y = rng.normal(size=(1000,)).astype(np.float32) * 100
    x = rng.normal(size=(1000,)).astype(np.float32) * 100
    ref = cv2.phase(x.reshape(1, -1), y.reshape(1, -1),
                    angleInDegrees=True).ravel()
    out = np.asarray(fi.fast_atan2_deg(y, x))
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_distance_transform_chessboard_matches_cv2(rng):
    mask = (rng.random((60, 90)) < 0.9).astype(np.uint8)
    mask[0, 0] = 0  # ensure at least one zero
    ref = cv2.distanceTransform(mask, cv2.DIST_C, 3)
    out = fi.distance_transform_chessboard(mask.astype(bool))
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_erode3_matches_cv2(rng):
    mask = (rng.random((40, 64)) < 0.7).astype(np.uint8) * 255
    ref = cv2.erode(mask, np.ones((3, 3), np.uint8)) > 0
    out = np.asarray(fi.erode3_bool(mask > 0))
    np.testing.assert_array_equal(out, ref)


def test_erode3_np_matches_device_twin():
    """training._erode3_np must be element-equal to ops.image.erode3_bool
    (the host twin exists so extraction never hits the device)."""
    import numpy as np

    from fealess import training as tr
    from fealess.ops import image as fi

    rng = np.random.default_rng(0)
    m = rng.random((37, 53)) > 0.4
    for it in (1, 2):
        a = tr._erode3_np(m, iterations=it)
        b = np.asarray(fi.erode3_bool(m, iterations=it))
        assert np.array_equal(a, b), it
