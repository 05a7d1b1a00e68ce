"""Analytic regeneration of the reference's lookup tables.

Both tables in the reference are machine-generated data blobs; here they are
derived from their generating formulas (verified element-for-element against
the reference data in tests/test_luts.py):

- ``SIMILARITY_LUT`` (linemod/linemod.cpp:970): for orientation bin ``o`` and
  a spread bitmask ``b``, the response is ``max_{j in b} score(d(o, j))``
  with circular bin distance ``d`` and ``score = [4, 2, 1, 0, 0]``.
- ``NORMAL_LUT`` (linemod/normal_lut.i, GRANULARITY=20): maps a quantized
  surface normal to one of 8 azimuth sectors of the view cone,
  ``1 << (floor((atan2(ny, nx) + 22.5deg) / 45deg) mod 8)`` — independent of
  nz, so the implementation skips the 3D table entirely and quantizes
  the azimuth directly (see fealess.ops.quantize.quantize_normals).
"""

from __future__ import annotations

import functools

import numpy as np

# Per-distance response scores, index = circular distance between orientation
# bins (0..4).  This is the *active* LUT of the reference; the two commented
# alternatives at linemod.cpp:968-969 correspond to [4,1,0,0,0] / [4,3,2,1,0].
ORIENTATION_SCORES = (4, 2, 1, 0, 0)
MAX_RESPONSE = ORIENTATION_SCORES[0]


@functools.lru_cache(maxsize=None)
def similarity_lut() -> np.ndarray:
    """Full (8, 256) response table: orientation bin x spread byte -> 0..4.

    The reference stores a (8, 2, 16) nibble factorization and takes the max
    of low/high nibble lookups (computeResponseMaps, linemod.cpp:979-1048);
    expanding to the full byte domain is equivalent and gather-friendlier.
    """
    scores = np.asarray(ORIENTATION_SCORES, dtype=np.uint8)
    lut = np.zeros((8, 256), dtype=np.uint8)
    for ori in range(8):
        for byte in range(256):
            best = 0
            for j in range(8):
                if byte & (1 << j):
                    d = min((ori - j) % 8, (j - ori) % 8)
                    best = max(best, int(scores[d]))
            lut[ori, byte] = best
    return lut


@functools.lru_cache(maxsize=None)
def similarity_lut_nibbles() -> np.ndarray:
    """The reference's (8, 2, 16) nibble layout of the same table, for
    byte-exact comparison against SIMILARITY_LUT (linemod.cpp:970)."""
    full = similarity_lut()
    out = np.zeros((8, 2, 16), dtype=np.uint8)
    for ori in range(8):
        for n in range(16):
            out[ori, 0, n] = full[ori, n]          # low nibble: bits 0..3
            out[ori, 1, n] = full[ori, n << 4]     # high nibble: bits 4..7
    return out


def normal_azimuth_bin(nx: np.ndarray, ny: np.ndarray) -> np.ndarray:
    """Azimuth sector of a (projected) normal: 8 bins of 45deg centred on
    multiples of 45deg.  Generating formula of NORMAL_LUT (normal_lut.i)."""
    ang = np.degrees(np.arctan2(ny, nx)) % 360.0
    return np.floor((ang + 22.5) / 45.0).astype(np.int64) % 8


@functools.lru_cache(maxsize=None)
def normal_lut(granularity: int = 20) -> np.ndarray:
    """Regenerate the (G, G, G) NORMAL_LUT for parity testing.

    Indexing matches quantizedNormals (linemod.cpp:664-668):
    ``lut[int(nz*G+G)][int(ny*G/2+G/2)][int(nx*G/2+G/2)]``.  The table is
    z-independent by construction.
    """
    g = granularity
    ys, xs = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    ny = (ys - g / 2) / (g / 2)
    nx = (xs - g / 2) / (g / 2)
    plane = (1 << normal_azimuth_bin(nx, ny)).astype(np.uint8)
    return np.broadcast_to(plane, (g, g, g)).copy()
