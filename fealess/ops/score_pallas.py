"""Template scorers over decimated response planes (coarse + local refine).

The LINE-MOD score is a sparse sum over template features of decimated
response planes (the reference's SSE linear-memory adds,
linemod/linemod.cpp:1130-1300):

    S[n, y, x] = sum_{f < nvalid[n]} planes[c[n, f], y + ry[n, f], x + rx[n, f]]

with zero padding beyond the image.  The score tables (built once per bank
by fealess.detector.build_match_tables) hold per pyramid level the
feature components ``c`` (channel), ``ry``/``rx`` (decimated offsets),
sorted valid-first, and ``nvalid``, the valid count of each template.

- :func:`coarse_scores` scores every template at every position of the
  coarse level.  On a CUDA device it runs a Pallas kernel through Triton
  (:func:`_coarse_scores_triton`); everywhere else the plain XLA form
  (:func:`_coarse_scores_xla`, one gather summed over features).  The
  kernel runs one program per (template, row tile), loops over that
  template's valid features only (about half the slots at the coarse
  level are padding) and accumulates the tile in i32 registers, reading
  the u8 plane stack, which stays in L2.  Measured on an NVIDIA H100
  80GB HBM3 at a 400 W power limit, 1024-template 640x480 fixture:
  0.088 ms for the kernel vs 0.225 ms for the plain form alone, and
  1.34 vs 1.39 ms per frame inside the jitted ``recognize_top1`` with
  plane ICP (medians of six interleaved runs; the kernel was faster in
  five of the six pairs).
  The dispatch is by lowering platform (``jax.lax.platform_dependent``),
  so a computation committed to the CPU device takes the plain path in a
  process whose default device is a GPU.
- :func:`local_scores` scores the refinement candidates' 16x16 windows as
  one gather of (K, F, 16, 16) summed over features: about 2 M adds per
  level, so one fused XLA op on every platform.

Offsets at or beyond the plane's height or width only ever read the zero
padding, so the scorers clamp them there; the padding then needs no bound
from the table.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

LOCAL_WINDOW = 16   # 16x16 decimated refinement patch (linemod.cpp:1243)
_ROW_TILE = 32      # coarse-kernel rows per program (power of two)


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# Coarse whole-image scorer
# ---------------------------------------------------------------------------

def _coarse_kernel(c_ref, ry_ref, rx_ref, nv_ref, planes_ref, out_ref, *,
                   f: int, th: int, tw: int):
    n = pl.program_id(0)
    y0 = pl.program_id(1) * th

    def body(i, acc):
        k = n * f + i
        tile = planes_ref[c_ref[k], pl.ds(y0 + ry_ref[k], th),
                          pl.ds(rx_ref[k], tw)]
        return acc + tile.astype(jnp.int32)

    out_ref[...] = jax.lax.fori_loop(0, nv_ref[n], body,
                                     jnp.zeros((th, tw), jnp.int32))


def _coarse_scores_triton(planes: jax.Array, table, *,
                          interpret: bool = False) -> jax.Array:
    c, hd, wd = planes.shape
    n, f = table["c"].shape
    th = min(_ROW_TILE, _next_pow2(hd))
    tw = _next_pow2(wd)
    n_rt = -(-hd // th)
    # Zero rows/columns past the image are the scorer's zero padding; the
    # tile's own overhang (rows >= hd, columns >= wd) is sliced off below.
    stack = jnp.pad(planes.astype(jnp.uint8),
                    ((0, 0), (0, n_rt * th), (0, tw)))
    out = pl.pallas_call(
        functools.partial(_coarse_kernel, f=f, th=th, tw=tw),
        grid=(n, n_rt),
        out_specs=pl.BlockSpec((None, th, tw), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((n, n_rt * th, tw), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=2, num_stages=2),
        interpret=interpret,
        name="coarse_scores",
    )(table["c"].reshape(-1), jnp.minimum(table["ry"], hd).reshape(-1),
      jnp.minimum(table["rx"], wd).reshape(-1), table["nvalid"], stack)
    return out[:, :hd, :wd]


def _coarse_scores_xla(planes: jax.Array, table) -> jax.Array:
    """The plain form: one gather of (N, F, Hd, Wd) summed over features;
    padding features read an appended all-zero channel."""
    c, hd, wd = planes.shape
    n, f = table["c"].shape
    padded = jnp.pad(planes.astype(jnp.int32), ((0, 1), (0, hd), (0, wd)))
    live = jnp.arange(f)[None, :] < table["nvalid"][:, None]
    cc = jnp.where(live, table["c"], c)[:, :, None, None]
    yy = (jnp.minimum(table["ry"], hd)[:, :, None, None]
          + jnp.arange(hd)[:, None])
    xx = jnp.minimum(table["rx"], wd)[:, :, None, None] + jnp.arange(wd)
    return jnp.sum(padded[cc, yy, xx], axis=1)


def coarse_scores(planes: jax.Array, table) -> jax.Array:
    """(N, Hd, Wd) i32 whole-image raw scores at the coarse level
    (``similarity``, linemod.cpp:1130-1214 — zero-padded beyond the
    image instead of the reference's flat-buffer wrap; wrapped candidate
    positions are filtered by the caller either way).

    ``table`` is the coarse entry of detector.build_match_tables.
    """
    return jax.lax.platform_dependent(planes, table,
                                      cuda=_coarse_scores_triton,
                                      default=_coarse_scores_xla)


# ---------------------------------------------------------------------------
# Local 16x16 refinement scorer
# ---------------------------------------------------------------------------

def local_scores(planes: jax.Array, table_k, px0, py0) -> jax.Array:
    """(K, 16, 16) i32 window scores around refinement candidates
    (``similarityLocal``, linemod.cpp:1226-1300).

    Args:
      planes: (C, Hd, Wd) decimated response planes (all modalities).
      table_k: per-candidate slot-gathered table arrays — ``c``/``ry``/
        ``rx`` (K, F) valid-first features, ``nvalid`` (K,).
      px0 / py0: (K,) i32 decimated window origins (negative only for
        degenerate clamps; clamped to 0 with the out-of-window features
        discarded).

    Window reads past the image score 0 (the per-feature bounds discard
    of linemod.cpp:1257-1258); features whose window row start falls
    outside [0, Hd] and padding features read an appended zero channel.
    """
    c, hd, wd = planes.shape
    w16 = LOCAL_WINDOW
    # Zero-pad one redirect channel and a window past the last row and
    # column (row starts are kept <= hd, column starts clamped to wd).
    padded = jnp.pad(planes.astype(jnp.int32), ((0, 1), (0, w16), (0, w16)))
    px0c = jnp.maximum(px0, 0)
    py0c = jnp.maximum(py0, 0)
    a = py0c[:, None] + table_k["ry"]             # (K, F) window start row
    f = a.shape[1]
    keep = ((a >= 0) & (a <= hd)
            & (jnp.arange(f)[None, :] < table_k["nvalid"][:, None]))
    cc = jnp.where(keep, table_k["c"], c)[:, :, None, None]
    yy = jnp.where(keep, a, 0)[:, :, None, None] + jnp.arange(w16)[:, None]
    xx = (jnp.minimum(px0c[:, None] + table_k["rx"], wd)[:, :, None, None]
          + jnp.arange(w16))
    return jnp.sum(padded[cc, yy, xx], axis=1)
