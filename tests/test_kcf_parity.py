"""KCF/FHOG parity against the COMPILED reference tracker.

r2 verified the tracker stack only against Python loop oracles written by
the same author; this closes the loop against the actual reference
binaries: benchmarks/reference/kcf_bench.cpp links the unmodified
fhog.cpp + kcftracker.cpp and exposes (a) the 31-channel FHOG map of a
patch and (b) a tracked-ROI trace over a synthetic sequence.

Tolerances: FHOG is the same float math in a different summation order
-> 1e-4 relative; the tracked ROI accumulates float drift through FFTs
and sub-pixel peaks over 20 frames -> centers within 2 px and the
per-frame motion direction must agree.
"""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(REPO, "build", "ref_bench")
REF = "/root/reference"


@pytest.fixture(scope="module")
def kcf_bench():
    if not os.path.isdir(REF):
        pytest.skip("reference checkout not mounted")
    exe = os.path.join(BUILD, "kcf_bench")
    gen = ["-G", "Ninja"] if shutil.which("ninja") else []
    subprocess.run(["cmake", "-S", os.path.join(REPO, "benchmarks",
                                                "reference"),
                    "-B", BUILD, "-DCMAKE_BUILD_TYPE=Release", *gen],
                   check=True, capture_output=True, text=True)
    subprocess.run(["cmake", "--build", BUILD, "--target", "kcf_bench"],
                   check=True, capture_output=True, text=True)
    return exe


def test_fhog31_matches_reference(kcf_bench, tmp_path):
    from fealess.tracker import fhog

    rng = np.random.default_rng(4)
    patch = rng.integers(0, 256, (96, 80, 3), np.uint8)
    patch = cv2.GaussianBlur(patch, (3, 3), 0)
    p = str(tmp_path / "patch.png")
    cv2.imwrite(p, patch)

    out = subprocess.run([kcf_bench, "fhog", p, "4"], check=True,
                         capture_output=True, text=True).stdout
    ref = json.loads(out)
    ref_map = np.asarray(ref["feats"], np.float32).reshape(
        ref["sizeY"], ref["sizeX"], ref["numFeatures"])

    ours = np.asarray(fhog.fhog31(patch.astype(np.float32), 4))
    assert ours.shape == ref_map.shape, (ours.shape, ref_map.shape)
    np.testing.assert_allclose(ours, ref_map, rtol=1e-4, atol=2e-5)


def _make_frames(tmp_path, n=20):
    rng = np.random.default_rng(9)
    h, w = 240, 320
    tex = rng.integers(0, 256, (64, 64, 3), np.uint8)
    tex = cv2.GaussianBlur(tex, (3, 3), 0)
    rois = []
    for i in range(n):
        frame = np.full((h, w, 3), 30, np.uint8)
        frame += rng.integers(0, 8, frame.shape, np.uint8)
        x, y = 60 + 2 * i, 50 + i
        frame[y:y + 64, x:x + 64] = tex
        cv2.imwrite(str(tmp_path / f"color_{i:03d}.png"), frame)
        rois.append((x, y))
    return rois


def test_tracked_roi_trace_matches_reference(kcf_bench, tmp_path):
    from fealess.tracker.kcf import KcfTracker, kcf_reference_config

    gt = _make_frames(tmp_path)
    x0, y0, w0, h0 = gt[0][0], gt[0][1], 64, 64
    out = subprocess.run(
        [kcf_bench, "track", str(tmp_path), str(len(gt)),
         str(x0), str(y0), str(w0), str(h0), "1", "1", "1", "0"],
        check=True, capture_output=True, text=True).stdout
    ref_rois = {}
    for line in out.strip().splitlines():
        rec = json.loads(line)
        if "frame" in rec:
            ref_rois[rec["frame"]] = rec["roi"]

    tracker = KcfTracker(kcf_reference_config(hog=True, fixed_window=True,
                                              multiscale=True, lab=False))
    frames = [cv2.imread(str(tmp_path / f"color_{i:03d}.png"))
              for i in range(len(gt))]
    state = tracker.init((x0, y0, w0, h0), frames[0])
    max_center_diff = 0.0
    for i in range(1, len(gt)):
        state, roi = tracker.update(state, frames[i])
        rx, ry, rw, rh = ref_rois[i]
        cx, cy = roi[0] + roi[2] / 2, roi[1] + roi[3] / 2
        rcx, rcy = rx + rw / 2, ry + rh / 2
        max_center_diff = max(max_center_diff,
                              abs(cx - rcx), abs(cy - rcy))
        # both trackers must follow the motion: within 4 px of truth
        assert abs(cx - (gt[i][0] + 32)) < 4.0, (i, roi)
        assert abs(cy - (gt[i][1] + 32)) < 4.0, (i, roi)
    assert max_center_diff < 2.0, max_center_diff
