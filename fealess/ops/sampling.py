"""Dynamic-window patch sampling, bit-exact with crop-then-resize.

Device-side replacement for the reference tracker's host-side crop+resize
(``RectTools::subwindow`` with BORDER_REPLICATE followed by ``cv::resize``
INTER_LINEAR of the 8-bit patch, kcf_tracker/recttools.hpp:115-131,
kcftracker.cpp:416-419).  The window origin and size may be traced values,
so a single jitted program serves every frame and every scale — no host
round-trip per frame.

The arithmetic is OpenCV's 8-bit fixed point, so the patch equals the
reference's value for value, borders included:

- output pixel ``j`` samples window coordinate ``(j + 0.5) * src / out -
  0.5``, rounded to f32 (here by exact division); horizontally the
  coordinate is clamped to the window, vertically only the rows are;
- each tap weight is ``round(w * 2048)``, rounded on its own;
- rows are interpolated exactly in integers, and the vertical pass rounds
  like OpenCV's vectorised 8-bit path:
  ``((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2 >> 2``;
- window pixels outside the image read the nearest image pixel.

Being integer, the patch is also the same on every platform; a float
formulation let a GPU's approximate division and fused multiply-adds move
samples by an ulp, which flipped FHOG orientation bins.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fealess.ops.division import div_exact

_COEF_BITS = 11                      # INTER_RESIZE_COEF_BITS of OpenCV
_ONE = 1 << _COEF_BITS


def _axis_taps(origin, src, out: int, size: int, clamp: bool):
    """(image index of tap 0, of tap 1, weight 0, weight 1) for ``out``
    samples of a ``src``-pixel window at ``origin`` along an image axis of
    ``size`` pixels."""
    num = ((2 * jnp.arange(out, dtype=jnp.int32) + 1) * src - out)
    coord = div_exact(num.astype(jnp.float32), jnp.float32(2 * out))
    cell = jnp.floor(coord)
    frac = coord - cell
    cell = cell.astype(jnp.int32)
    if clamp:
        edge = (cell < 0) | (cell >= src - 1)
        frac = jnp.where(edge, jnp.float32(0), frac)
        cell = jnp.clip(cell, 0, src - 1)
    w0 = jnp.round((1 - frac) * _ONE).astype(jnp.int32)
    w1 = jnp.round(frac * _ONE).astype(jnp.int32)
    i0 = jnp.clip(origin + jnp.clip(cell, 0, src - 1), 0, size - 1)
    i1 = jnp.clip(origin + jnp.clip(cell + 1, 0, src - 1), 0, size - 1)
    return i0, i1, w0, w1


def sample_patch_bilinear(image: jax.Array, x0, y0, src_w, src_h,
                          out_h: int, out_w: int) -> jax.Array:
    """Resample the ``src_h x src_w`` window at ``(x0, y0)`` to a static
    ``(out_h, out_w, C)`` float32 patch of 8-bit integer values.

    Args:
      image: ``(H, W, C)`` or ``(H, W)`` uint8 image.
      x0, y0: integer-valued window origin in pixels (traced scalars OK,
        may be negative).
      src_w, src_h: integer-valued window size in pixels (traced OK).
      out_h, out_w: static output size.
    """
    if image.dtype != jnp.uint8:
        raise TypeError(f"sample_patch_bilinear needs a uint8 image, "
                        f"got {image.dtype}")
    squeeze = image.ndim == 2
    if squeeze:
        image = image[..., None]
    img = image.astype(jnp.int32)
    h, w = img.shape[:2]
    as_int = lambda v: jnp.asarray(v).astype(jnp.int32)   # noqa: E731
    u0, u1, a0, a1 = _axis_taps(as_int(x0), as_int(src_w), out_w, w, True)
    v0, v1, b0, b1 = _axis_taps(as_int(y0), as_int(src_h), out_h, h, False)
    a0, a1 = a0[None, :, None], a1[None, :, None]
    r0 = img[v0]                       # (out_h, W, C)
    r1 = img[v1]
    top = r0[:, u0] * a0 + r0[:, u1] * a1
    bot = r1[:, u0] * a0 + r1[:, u1] * a1
    out = ((((top >> 4) * b0[:, None, None]) >> 16)
           + (((bot >> 4) * b1[:, None, None]) >> 16) + 2) >> 2
    out = jnp.clip(out, 0, 255).astype(jnp.float32)
    return out[..., 0] if squeeze else out
