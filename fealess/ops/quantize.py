"""Quantization front-end: colour-gradient orientations and depth normals.

Dense, branch-free reimplementations of the reference's two
modalities:

- :func:`quantize_gradients` == ``quantizedOrientations`` +
  ``hysteresisGradient`` (linemod/linemod.cpp:230-385): 7x7 Gaussian ->
  per-channel 3x3 Sobel -> argmax-magnitude channel -> fastAtan2 phase ->
  16-bin quantization folded to 8 -> 3x3 majority vote (>=5 of 9).
- :func:`quantize_normals` == ``quantizedNormals`` (linemod.cpp:595-685):
  bilateral-gated least-squares plane fit over 8 ring neighbours at radius
  5 -> normal -> 8 azimuth sectors (the NORMAL_LUT of normal_lut.i is
  z-independent, see fealess.ops.luts) -> 5x5 median filter.

Outputs are u8 bitmask images: pixel value ``1 << label`` or 0 (no label).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from fealess.ops import image as fi

NEIGHBOR_THRESHOLD = 5  # 3x3 majority vote minimum (linemod.cpp:377)
NORMAL_RING_RADIUS = 5  # plane-fit ring radius (linemod.cpp:607)
NORMAL_GRANULARITY = 20  # normal_lut.i granularity


def quantize_gradients(src_bgr: jax.Array, weak_threshold: float):
    """Quantized gradient-orientation image of a u8 (H, W, 3) image.

    Returns ``(quantized, magnitude)``: u8 bitmask image (1<<bin or 0) and
    float32 squared-magnitude image (the reference's ``magnitude`` output,
    used by template extraction).

    Channel-argmax tie-breaks, the fastAtan2 polynomial, round-half-to-even
    bin rounding, border zeroing and the >=5-vote hysteresis all follow
    linemod.cpp:230-385 exactly.
    """
    smoothed = fi.gaussian_blur7_u8(src_bgr)
    dx = fi.sobel3_i16(smoothed, "x").astype(jnp.int32)   # (H, W, 3)
    dy = fi.sobel3_i16(smoothed, "y").astype(jnp.int32)
    mag = dx * dx + dy * dy

    m0, m1, m2 = mag[..., 0], mag[..., 1], mag[..., 2]
    # if (m0 >= m1 && m0 >= m2) ch0; elif (m1 >= m0 && m1 >= m2) ch1; else ch2
    pick0 = (m0 >= m1) & (m0 >= m2)
    pick1 = (~pick0) & (m1 >= m0) & (m1 >= m2)

    def _take(a):
        # channel select as arithmetic: two selects, no minor-axis gather
        return jnp.where(pick0, a[..., 0],
                         jnp.where(pick1, a[..., 1], a[..., 2]))

    sdx = _take(dx).astype(jnp.float32)
    sdy = _take(dy).astype(jnp.float32)
    magnitude = _take(mag).astype(jnp.float32)

    angle = fi.fast_atan2_deg(sdy, sdx)
    # convertTo(CV_8U, 16/360): cvRound = round-half-to-even, then &7.
    quant16 = jnp.rint(angle * (16.0 / 360.0)).astype(jnp.int32)
    h, w = angle.shape
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    interior = (yy >= 1) & (yy <= h - 2) & (xx >= 1) & (xx <= w - 2)
    quant8 = jnp.where(interior, quant16 & 7, 0)

    # 3x3 label histogram via one-hot shifted sums (zero-padded borders
    # contribute label-0 votes, matching the reference's zeroed margins).
    onehot = (quant8[..., None] == jnp.arange(8)[None, None, :]).astype(jnp.int32)
    onehot_p = jnp.pad(onehot, ((1, 1), (1, 1), (0, 0)))
    hist = sum(jax.lax.slice(onehot_p, (r, c, 0), (r + h, c + w, 8))
               for r in range(3) for c in range(3))
    votes = jnp.max(hist, axis=-1)
    best = jnp.argmax(hist, axis=-1)  # first max index, like the C scan

    strong = magnitude > jnp.float32(weak_threshold * weak_threshold)
    accept = interior & strong & (votes >= NEIGHBOR_THRESHOLD)
    quantized = jnp.where(accept, (1 << best).astype(jnp.uint8), 0)
    return quantized.astype(jnp.uint8), magnitude


def _azimuth_bin_from_grid(ix: jax.Array, iy: jax.Array) -> jax.Array:
    """Sector bitmask of the NORMAL_LUT grid cell (ix, iy) in [0, 20)^2.

    Reproduces ``1 << azimuth_bin((ix-10)/10, (iy-10)/10)`` — the
    generating formula of normal_lut.i, ``round(atan2(dy, dx) / 45 deg)
    mod 8`` — with branch-free octant arithmetic instead of a per-pixel
    table gather.  Exact: sector
    boundaries have irrational slopes (tan 22.5 = sqrt(2)-1), so integer
    grid points never fall on one and f32 comparisons cannot flip a bin
    (element-equality vs the parsed reference table in tests/test_luts.py
    and tests/test_quantize.py).
    """
    dx = (ix - NORMAL_GRANULARITY // 2).astype(jnp.float32)
    dy = (iy - NORMAL_GRANULARITY // 2).astype(jnp.float32)
    ax, ay = jnp.abs(dx), jnp.abs(dy)
    t = jnp.float32(0.41421356)            # tan 22.5deg
    # q: sector within the first quadrant (0 = <22.5deg, 1 = 45, 2 = 90).
    q = ((ay > ax * t).astype(jnp.int32)
         + (ay * t > ax).astype(jnp.int32))
    xn, yn = dx < 0, dy < 0
    bin8 = jnp.where(
        yn,
        jnp.where(xn, 4 + q, (8 - q) & 7),   # 3rd / 4th quadrant
        jnp.where(xn, 4 - q, q))             # 2nd / 1st quadrant
    return (jnp.uint8(1) << bin8.astype(jnp.uint8)).astype(jnp.uint8)


def quantize_normals(depth_u16: jax.Array, distance_threshold: int,
                     difference_threshold: int) -> jax.Array:
    """Quantized surface-normal image of a u16 (H, W) depth image (mm).

    Returns the u8 bitmask image (1<<sector or 0), after the reference's
    5x5 median filter (linemod.cpp:595-685).
    """
    h, w = depth_u16.shape
    r = NORMAL_RING_RADIUS
    d = depth_u16.astype(jnp.int32)
    dpad = jnp.pad(d, ((r, r), (r, r)))

    offsets = [(-r, -r), (0, -r), (r, -r), (-r, 0), (r, 0), (-r, r), (0, r), (r, r)]
    a00 = jnp.zeros((h, w), jnp.int32)
    a01 = jnp.zeros((h, w), jnp.int32)
    a11 = jnp.zeros((h, w), jnp.int32)
    b0 = jnp.zeros((h, w), jnp.int32)
    b1 = jnp.zeros((h, w), jnp.int32)
    for (i, j) in offsets:  # i = x offset, j = y offset (accumBilateral args)
        nb = jax.lax.slice(dpad, (r + j, r + i), (r + j + h, r + i + w))
        delta = nb - d
        f = (jnp.abs(delta) < difference_threshold).astype(jnp.int32)
        fi_, fj_ = f * i, f * j
        a00 += fi_ * i
        a01 += fi_ * j
        a11 += fj_ * j
        b0 += fi_ * delta
        b1 += fj_ * delta

    det = a00 * a11 - a01 * a01
    ddx = a11 * b0 - a01 * b1
    ddy = -a01 * b0 + a00 * b1

    # Magic 617 ~ focal length (linemod.cpp:650-653); exact int32 then f32.
    nx = (617 * ddx).astype(jnp.float32)
    ny = (617 * ddy).astype(jnp.float32)
    nz = (-det * d).astype(jnp.float32)
    norm = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    inv = jnp.where(norm > 0, 1.0 / norm, 0.0)
    g2 = NORMAL_GRANULARITY // 2
    ix = jnp.clip((nx * inv * g2 + g2).astype(jnp.int32), 0, NORMAL_GRANULARITY - 1)
    iy = jnp.clip((ny * inv * g2 + g2).astype(jnp.int32), 0, NORMAL_GRANULARITY - 1)
    sector = _azimuth_bin_from_grid(ix, iy)

    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    # Reference loop bounds: y in [r, H-r-1), x in [r, W-r-1) (linemod.cpp:619).
    interior = (yy >= r) & (yy < h - r - 1) & (xx >= r) & (xx < w - r - 1)
    valid = interior & (d < distance_threshold) & (norm > 0)
    quant = jnp.where(valid, sector, 0).astype(jnp.uint8)
    return fi.median_blur5_u8(quant)


def apply_mask(quantized: jax.Array, mask: jax.Array | None) -> jax.Array:
    """``QuantizedPyramid::quantize`` masking (copyTo with mask,
    linemod.cpp:456-459/741-744)."""
    if mask is None:
        return quantized
    return jnp.where(mask, quantized, 0).astype(jnp.uint8)
