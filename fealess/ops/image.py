"""Statically-shaped image primitives used by the quantization front-end.

Each primitive reproduces the exact arithmetic of the OpenCV call used by
the reference (cited per function), because the downstream quantizations are
bit-level decisions (orientation bins, bitmask votes) where float drift flips
labels.  Integer paths use the same fixed-point scheme as OpenCV's u8 SIMD
kernels, so outputs are bit-exact (verified against cv2 in tests).

All functions take/return ``jnp`` arrays with static shapes and are safe
under ``jit``.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# OpenCV's fixed small Gaussian kernel for ksize=7, sigma=0
# (getGaussianKernel small_gaussian_tab): [4,14,28,36,28,14,4]/128.
_GAUSS7 = np.array([4, 14, 28, 36, 28, 14, 4], dtype=np.int32)
# pyrDown 5-tap kernel [1,4,6,4,1]/16 (per axis).
_PYR5 = np.array([1, 4, 6, 4, 1], dtype=np.int32)


def _pad_replicate(x: jax.Array, r: int, axes=(0, 1)) -> jax.Array:
    pad = [(0, 0)] * x.ndim
    for a in axes:
        pad[a] = (r, r)
    return jnp.pad(x, pad, mode="edge")


def _pad_reflect101(x: jax.Array, r: int, axes=(0, 1)) -> jax.Array:
    pad = [(0, 0)] * x.ndim
    for a in axes:
        pad[a] = (r, r)
    return jnp.pad(x, pad, mode="reflect")


def _sep_filter_int(x: jax.Array, kernel: np.ndarray, pad_mode: str) -> jax.Array:
    """Separable integer filter; returns the raw int32 accumulator
    (caller applies the fixed-point shift)."""
    r = len(kernel) // 2
    pad = _pad_replicate if pad_mode == "replicate" else _pad_reflect101
    xp = pad(x.astype(jnp.int32), r, axes=(0,))
    h = x.shape[0]
    acc = jnp.zeros_like(x, dtype=jnp.int32)
    for i, k in enumerate(kernel):
        acc = acc + int(k) * jax.lax.slice_in_dim(xp, i, i + h, axis=0)
    xp = pad(acc, r, axes=(1,))
    w = x.shape[1]
    acc = jnp.zeros_like(acc)
    for i, k in enumerate(kernel):
        acc = acc + int(k) * jax.lax.slice_in_dim(xp, i, i + w, axis=1)
    return acc


def gaussian_blur7_u8(img: jax.Array) -> jax.Array:
    """7x7 Gaussian blur of a u8 image, BORDER_REPLICATE.

    Matches ``GaussianBlur(src, dst, Size(7,7), 0, 0, BORDER_REPLICATE)``
    (linemod.cpp:247): OpenCV's u8 path runs the fixed small kernel in 8-bit
    fixed point (coefficients x256 per axis, combined shift 16 with
    round-half-up), which we reproduce exactly in int32.
    """
    k = _GAUSS7 * 2  # x256 per-axis fixed-point coefficients (sum 256)
    acc = _sep_filter_int(img, k, "replicate")
    return ((acc + (1 << 15)) >> 16).astype(jnp.uint8)


def sobel3_i16(img: jax.Array, axis: str) -> jax.Array:
    """3x3 Sobel derivative of a u8 image into int16, BORDER_REPLICATE.

    Matches ``Sobel(smoothed, d, CV_16S, dx, dy, 3, 1.0, 0.0,
    BORDER_REPLICATE)`` (linemod.cpp:248-249).  ``axis`` is "x" or "y".
    """
    deriv = np.array([-1, 0, 1], dtype=np.int32)
    smooth = np.array([1, 2, 1], dtype=np.int32)
    x = img.astype(jnp.int32)
    h, w = img.shape[:2]
    kr, kc = (smooth, deriv) if axis == "x" else (deriv, smooth)
    xp = _pad_replicate(x, 1, axes=(0,))
    acc = sum(int(k) * jax.lax.slice_in_dim(xp, i, i + h, axis=0)
              for i, k in enumerate(kr))
    xp = _pad_replicate(acc, 1, axes=(1,))
    acc = sum(int(k) * jax.lax.slice_in_dim(xp, i, i + w, axis=1)
              for i, k in enumerate(kc))
    return acc.astype(jnp.int16)


def _even_odd(x: jax.Array, axis: int):
    """(even-index, odd-index) views along ``axis`` via reshape (no
    strided gather)."""
    shape = list(x.shape)
    n = shape[axis]
    shape[axis:axis + 1] = [n // 2, 2]
    v = x.reshape(shape)
    idx = [slice(None)] * v.ndim
    idx[axis + 1] = 0
    even = v[tuple(idx)]
    idx[axis + 1] = 1
    return even, v[tuple(idx)]


def _pyr5_axis_even(x: jax.Array, axis: int) -> jax.Array:
    """5-tap [1,4,6,4,1] filter along ``axis``, BORDER_REFLECT_101,
    evaluated at EVEN output positions only (the pyrDown decimation) —
    1/4 of the full-filter work, assembled from even/odd reshape views.

    out[y] = e[y-1] + 4 o[y-1] + 6 e[y] + 4 o[y] + e[y+1]  (e/o = even/odd
    input views; y-1/y+1 shifts with reflect-101 edge rows).
    """
    e, o = _even_odd(x, axis)
    n = e.shape[axis]

    def shift(a, d):
        # a shifted by d along axis with reflect-101 boundary fill
        sl = [slice(None)] * a.ndim
        if d == -1:
            sl[axis] = slice(0, n - 1)
            body = a[tuple(sl)]
            sl[axis] = slice(1, 2)          # reflect: x[-1] == x[1]
            return jnp.concatenate([a[tuple(sl)], body], axis=axis)
        sl[axis] = slice(1, n)
        body = a[tuple(sl)]
        # e[n] corresponds to x[H]; reflect-101 gives x[H-2] == e[n-1]
        sl[axis] = slice(n - 1, n)
        return jnp.concatenate([body, a[tuple(sl)]], axis=axis)

    # odd view shifted by -1: o[y-1]; its reflect fill is o[0]'s mirror
    # x[-1] = x[1] = o[0]  ->  shift(o, -1) edge row must be o[0]
    sl = [slice(None)] * o.ndim
    sl[axis] = slice(0, n - 1)
    om1 = jnp.concatenate([jax.lax.slice_in_dim(o, 0, 1, axis=axis),
                           o[tuple(sl)]], axis=axis)
    return e * 6 + (om1 + o) * 4 + shift(e, -1) + shift(e, 1)


def pyr_down_u8(img: jax.Array) -> jax.Array:
    """OpenCV ``pyrDown`` of a u8 image to half size (linemod.cpp:441).

    5-tap [1,4,6,4,1]/16 per axis in integer fixed point (combined /256,
    round-half-up), BORDER_REFLECT_101, even-index decimation — computed
    at even output positions only (1/4 the full-filter work).  Supports
    (H, W) and (H, W, C); H and W must be even (640x480 operating point).
    """
    x = img.astype(jnp.int32)
    acc = _pyr5_axis_even(_pyr5_axis_even(x, 0), 1)
    return ((acc + 128) >> 8).astype(jnp.uint8)


def resize_nn_half(img: jax.Array) -> jax.Array:
    """INTER_NEAREST half-size resize = even-index decimation
    (mask/normal pyramid downsample, linemod.cpp:446/730)."""
    return img[::2, ::2]


def _box5_sum_i32(x: jax.Array) -> jax.Array:
    """Separable 5x5 box sum with BORDER_REPLICATE padding."""
    h, w = x.shape
    xp = _pad_replicate(x, 2, axes=(0,))
    acc = sum(jax.lax.slice_in_dim(xp, i, i + h, axis=0) for i in range(5))
    xp = _pad_replicate(acc, 2, axes=(1,))
    return sum(jax.lax.slice_in_dim(xp, i, i + w, axis=1) for i in range(5))


def median_blur5_u8(img: jax.Array) -> jax.Array:
    """5x5 median filter of a u8 BITMASK image, BORDER_REPLICATE.

    Matches ``medianBlur(dst, dst, 5)`` applied to the quantized-normal
    bitmask image (linemod.cpp:684) — median over byte *values*, exact for
    images whose pixels lie in {0} | {1<<k}: instead of a 25-way sort
    network it counts, per candidate value, how many window pixels are
    <= that value (9 separable box sums) and picks the smallest value
    whose cumulative count reaches 13 — the definition of the median of
    25 bytes over this value set.
    """
    values = [0] + [1 << k for k in range(8)]
    x = img.astype(jnp.int32)
    # cumulative counts: cnt_v = #window pixels <= v; select the first v
    # (ascending) with cnt_v >= 13.
    med = jnp.full(img.shape, values[-1], jnp.int32)
    for v in reversed(values[:-1]):
        cnt = _box5_sum_i32((x <= v).astype(jnp.int32))
        med = jnp.where(cnt >= 13, v, med)
    return med.astype(jnp.uint8)


def erode3_bool(mask: jax.Array, iterations: int = 1) -> jax.Array:
    """3x3 binary erosion, BORDER_REPLICATE (cv::erode with default kernel;
    linemod.cpp:466/751)."""
    m = mask
    h, w = mask.shape
    for _ in range(iterations):
        mp = _pad_replicate(m, 1, axes=(0, 1))
        windows = [jax.lax.slice(mp, (dy, dx), (dy + h, dx + w))
                   for dy in range(3) for dx in range(3)]
        acc = windows[0]
        for win in windows[1:]:
            acc = jnp.logical_and(acc, win)
        m = acc
    return m


def fast_atan2_deg(y: jax.Array, x: jax.Array) -> jax.Array:
    """OpenCV ``cv::fastAtan2`` polynomial (used by cv::phase,
    linemod.cpp:303): degrees in [0, 360), ~0.3 deg accuracy.  Reproduced
    exactly so orientation-bin decisions match the reference."""
    p1 = np.float32(np.degrees(0.9997878412794807))
    p3 = np.float32(np.degrees(-0.3258083974640975))
    p5 = np.float32(np.degrees(0.1555786518463281))
    p7 = np.float32(np.degrees(-0.04432655554792128))
    eps = np.float32(1.1920929e-07)  # FLT_EPSILON
    ax, ay = jnp.abs(x), jnp.abs(y)
    big = ax >= ay
    c = jnp.where(big, ay / (ax + eps), ax / (ay + eps))
    c2 = c * c
    poly = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c
    a = jnp.where(big, poly, 90.0 - poly)
    a = jnp.where(x < 0, 180.0 - a, a)
    a = jnp.where(y < 0, 360.0 - a, a)
    return a


def distance_transform_chessboard(nonzero: np.ndarray) -> np.ndarray:
    """Exact chessboard (DIST_C, 3x3) distance of nonzero pixels to the
    nearest zero pixel — ``cv::distanceTransform(.., DIST_C, 3)`` as used in
    depth-normal feature extraction (linemod.cpp:763).

    Host-side (numpy) two-pass chamfer, vectorized per row: the in-row
    left-to-right dependency ``d[c] = min(a[c], d[c-1]+1)`` is a running
    min-plus with unit slope, computed as ``c + cummin(a[c] - c)``.  Only
    runs in the offline training path.
    """
    h, w = nonzero.shape
    idx = np.arange(w, dtype=np.float64)

    def _pass(d: np.ndarray) -> np.ndarray:
        out = np.empty_like(d)
        prev = np.full(w, np.inf)
        for r in range(h):
            up = np.minimum(prev, np.minimum(
                np.concatenate(([np.inf], prev[:-1])),
                np.concatenate((prev[1:], [np.inf]))))
            a = np.minimum(d[r], up + 1.0)
            row = idx + np.minimum.accumulate(a - idx)
            prev = row
            out[r] = row
        return out

    d0 = np.where(nonzero, np.inf, 0.0)
    d1 = _pass(d0)
    d2 = _pass(d1[::-1, ::-1])[::-1, ::-1]
    return np.minimum(d1, d2).astype(np.float32)
