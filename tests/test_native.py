"""Native host library (libfealess_host) parity tests.

Builds the library with cmake+ninja on first use (cached in build/native),
then checks the C implementations against the pure-Python fallbacks:
greedy scattered-feature selection (linemod.cpp:135-164 semantics),
chessboard distance transform (cv::distanceTransform DIST_C 3x3), and the
threaded in-order frame loader."""

import os
import subprocess

import cv2
import numpy as np
import pytest

from fealess import training
from fealess.io import native
from fealess.ops import image as fi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    if not native.have_native():
        build = os.path.join(ROOT, "build", "native")
        try:
            subprocess.run(["cmake", "-S",
                            os.path.join(ROOT, "native", "fealess_host"),
                            "-B", build, "-G", "Ninja"],
                           check=True, capture_output=True)
            subprocess.run(["ninja", "-C", build], check=True,
                           capture_output=True)
        except (OSError, subprocess.CalledProcessError) as e:
            pytest.skip(f"cannot build native lib: {e}")
        native._SEARCHED = False     # re-scan now that the .so exists
    if not native.have_native():
        pytest.skip("native lib unavailable")
    return native.load_library()


def test_scatter_matches_python(lib):
    rng = np.random.default_rng(0)
    k = 500
    cand = np.stack([rng.integers(0, 100, k), rng.integers(0, 100, k),
                     rng.integers(0, 8, k)], axis=-1).astype(np.int32)
    for nf in (8, 63):
        dist = float(len(cand) // nf + 1)
        want = training.select_scattered_features(cand, None, nf, dist)
        got = native.select_scattered_features(cand, nf, dist)
        np.testing.assert_array_equal(got, want)


def test_chamfer_matches_python_and_opencv(lib):
    rng = np.random.default_rng(1)
    nz = (rng.random((60, 80)) < 0.9)
    nz[0, 0] = False                    # ensure a zero exists
    got = native.chamfer_chessboard(nz)
    want = fi.distance_transform_chessboard(nz)
    np.testing.assert_allclose(got, want)
    cv = cv2.distanceTransform(nz.astype(np.uint8), cv2.DIST_C, 3)
    np.testing.assert_allclose(got, cv)


def test_frame_loader_native_in_order(lib, tmp_path):
    rng = np.random.default_rng(2)
    colors, depths = [], []
    truth = []
    for i in range(6):
        bgr = rng.integers(0, 255, size=(24, 32, 3), dtype=np.uint8)
        dep = rng.integers(0, 2000, size=(24, 32), dtype=np.uint16)
        cp = str(tmp_path / f"c{i}.png")
        dp = str(tmp_path / f"d{i}.png")
        cv2.imwrite(cp, bgr)
        cv2.imwrite(dp, dep)
        colors.append(cp)
        depths.append(dp)
        truth.append((bgr, dep))
    loader = native.FrameLoader(colors, depths, target_wh=(32, 24),
                                threads=3, capacity=2)
    assert loader._handle is not None   # really the native path
    got = list(loader)
    loader.close()
    assert [g[0] for g in got] == list(range(6))
    for (idx, bgr, dep), (tb, td) in zip(got, truth):
        np.testing.assert_array_equal(bgr, tb)
        np.testing.assert_array_equal(dep, td)


def test_frame_loader_python_fallback(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    bgr = rng.integers(0, 255, size=(16, 16, 3), dtype=np.uint8)
    dep = rng.integers(0, 999, size=(16, 16), dtype=np.uint16)
    cp = str(tmp_path / "c.png")
    dp = str(tmp_path / "d.png")
    cv2.imwrite(cp, bgr)
    cv2.imwrite(dp, dep)
    monkeypatch.setattr(native, "load_library", lambda: None)
    loader = native.FrameLoader([cp, cp], [dp, dp])
    frames = list(loader)
    assert len(frames) == 2
    np.testing.assert_array_equal(frames[0][1], bgr)
    np.testing.assert_array_equal(frames[1][2], dep)


def test_native_extraction_matches_numpy(lib, monkeypatch):
    """The one-call native extractors must be bit-identical to the numpy
    reference path on a realistic quantized view (both modalities, with
    and without mask)."""
    from fealess import config as cfg
    from fealess.ops import quantize as q
    from tests.test_match_e2e import make_scene

    bgr, depth, mask = make_scene(np.random.default_rng(7))
    bits, mag = (np.asarray(a) for a in q.quantize_gradients(bgr, 10.0))
    dn_bits = np.asarray(q.quantize_normals(depth, 2000, 50))

    def numpy_path(fn, *args):
        monkeypatch.setattr(native, fn, lambda *a, **k: NotImplemented)
        return None

    for msk in (mask, None):
        nat_cg = training.extract_gradient_template(bits, mag, msk, 24, 55.0)
        nat_dn = training.extract_normal_template(dn_bits, msk, 24, 2)
        with monkeypatch.context() as m:
            m.setattr(native, "extract_gradient_template",
                      lambda *a, **k: NotImplemented)
            m.setattr(native, "extract_normal_template",
                      lambda *a, **k: NotImplemented)
            ref_cg = training.extract_gradient_template(bits, mag, msk,
                                                        24, 55.0)
            ref_dn = training.extract_normal_template(dn_bits, msk, 24, 2)
        assert np.array_equal(nat_cg, ref_cg), msk is None
        assert np.array_equal(nat_dn, ref_dn), msk is None

    # insufficient-candidate contract: both return None
    hi = float(np.sqrt(mag.max()) + 1)
    assert training.extract_gradient_template(bits, mag, mask, 24, hi) is None
