"""Verify the analytically-regenerated LUTs against the reference data.

These tests parse the reference's machine-generated tables at test time
(read-only) and compare element-for-element with our generating formulas
(fealess/ops/luts.py) — proving the formulas, not copying the blobs.
"""

import os
import re

import numpy as np
import pytest

from fealess.ops import luts
from tests.conftest import REFERENCE_DIR, has_reference

pytestmark = pytest.mark.skipif(not has_reference(),
                                reason="reference tree not mounted")


def _parse_reference_similarity_lut():
    path = os.path.join(REFERENCE_DIR, "linemod", "linemod.cpp")
    with open(path, "r", errors="replace") as f:
        lines = [ln for ln in f
                 if "SIMILARITY_LUT[256]" in ln and not ln.lstrip().startswith("//")]
    assert len(lines) == 1, "active SIMILARITY_LUT not found in reference"
    m = re.search(r"\{([^}]*)\}", lines[0])
    vals = [int(v) for v in re.findall(r"\d+", m.group(1))]
    assert len(vals) == 256
    return np.array(vals, dtype=np.uint8).reshape(8, 2, 16)


def _parse_reference_normal_lut():
    path = os.path.join(REFERENCE_DIR, "linemod", "normal_lut.i")
    with open(path, "r", errors="replace") as f:
        src = f.read()
    g = int(re.search(r"GRANULARITY\s*=\s*(\d+)", src).group(1))
    vals = [int(v) for v in re.findall(r"\b\d+\b",
                                       src[src.index("= {"):])]
    arr = np.array([v for v in vals if True], dtype=np.int64)
    # strip any stray dims; expect g^3 entries at the tail
    arr = arr[-g * g * g:]
    return g, arr.astype(np.uint8).reshape(g, g, g)


def test_similarity_lut_matches_reference():
    ref = _parse_reference_similarity_lut()
    ours = luts.similarity_lut_nibbles()
    np.testing.assert_array_equal(ours, ref)


def test_normal_lut_matches_reference():
    g, ref = _parse_reference_normal_lut()
    ours = luts.normal_lut(g)
    np.testing.assert_array_equal(ours, ref)


def test_normal_lut_is_z_independent():
    g, ref = _parse_reference_normal_lut()
    for z in range(1, g):
        np.testing.assert_array_equal(ref[z], ref[0])


def test_similarity_lut_full_consistent_with_nibbles():
    full = luts.similarity_lut()
    nib = luts.similarity_lut_nibbles()
    for ori in range(8):
        for byte in range(256):
            expect = max(nib[ori, 0, byte & 15], nib[ori, 1, byte >> 4])
            assert full[ori, byte] == expect
