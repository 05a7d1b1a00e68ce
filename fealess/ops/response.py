"""Spread-binarized orientations, response maps, and decimated layout.

The reference implements these stages with SSE pointer loops
(linemod/linemod.cpp:882-1117); here they are dense tensor ops that XLA
fuses into a handful of elementwise passes:

- :func:`spread`: OR of the quantized bitmask image over a TxT
  down/right-looking window (``spread``/``orUnaligned8u``,
  linemod.cpp:882-965).
- :func:`response_maps`: per-orientation similarity 0..4 from the spread
  byte.  Instead of the reference's nibble-LUT shuffle
  (``computeResponseMaps`` + SIMILARITY_LUT, linemod.cpp:970-1048) we
  evaluate the generating rule directly with bitwise ops — response =
  score of the closest set orientation bit, scores [4,2,1,0,0] by circular
  distance — which is branch-free integer arithmetic with no gather.
- :func:`decimate`: re-layout of each response map into the
  (T*T, H/T * W/T) "linear memory" ordering (``linearize``,
  linemod.cpp:1060-1088) as one dense (8*T*T, P) tensor, so template
  scoring becomes row-gather + shifted add (see fealess.ops.similarity).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fealess.ops.luts import ORIENTATION_SCORES


def _or_window_1d(x: jax.Array, t: int, axis: int) -> jax.Array:
    """OR over the length-T window [i, i+T) along ``axis`` by
    shift-doubling: O(log T) passes instead of T."""
    h = x.shape[axis]
    pad = [(0, 0), (0, 0)]
    pad[axis] = (0, t)
    xp = jnp.pad(x, pad)

    def shifted(arr, d):
        start = [0, 0]
        start[axis] = d
        limit = list(xp.shape)
        limit[axis] = d + h
        return jax.lax.slice(arr, start, limit)

    # acc covers offsets [0, span); double while 2*span <= t, then one
    # final shift closes the remainder.
    acc = shifted(xp, 0)
    span = 1
    while span * 2 <= t:
        acc = acc | shifted(jnp.pad(acc, pad), span)
        span *= 2
    if span < t:
        acc = acc | shifted(jnp.pad(acc, pad), t - span)
    return acc


def spread(quantized: jax.Array, t: int) -> jax.Array:
    """OR each pixel's bitmask over the TxT window anchored at the pixel
    (shifts down/right read, i.e. dst[y,x] |= src[y+dy, x+dx]).

    Separable (rows then columns) with shift-doubling: 2*O(log T) dense
    passes instead of the T^2 shifted ORs of ``orUnaligned8u``
    (linemod.cpp:882-965) — 6 passes at T=8 instead of 64.
    """
    rows = _or_window_1d(quantized, t, axis=1)
    return _or_window_1d(rows, t, axis=0)


def response_maps(spread_img: jax.Array) -> jax.Array:
    """(8, H, W) u8 response stack from the spread bitmask image.

    Equivalent to SIMILARITY_LUT lookups (verified against the expanded
    table in tests): for orientation ``o``, the response is the max of
    ORIENTATION_SCORES[d] over set bits at circular distance ``d``.
    """
    b = spread_img.astype(jnp.int32)

    def rot(x, k):
        """Circular 8-bit rotate-left by k: bit o of rot(x, k) is bit
        (o - k) % 8 of x."""
        return ((x << k) | (x >> (8 - k))) & 0xFF

    # m1 has bit o set iff b has a bit at circular distance 1 from o, m2
    # at distance <= 2 — computed ONCE for all 8 orientations.
    m1 = rot(b, 1) | rot(b, 7)
    m2 = m1 | rot(b, 2) | rot(b, 6)
    s4, s2, s1 = ORIENTATION_SCORES[0], ORIENTATION_SCORES[1], \
        ORIENTATION_SCORES[2]
    maps = []
    for ori in range(8):
        resp = jnp.where(
            ((b >> ori) & 1) == 1, s4,
            jnp.where(((m1 >> ori) & 1) == 1, s2,
                      jnp.where(((m2 >> ori) & 1) == 1, s1, 0)))
        maps.append(resp)
    return jnp.stack(maps).astype(jnp.uint8)


def decimate(resp: jax.Array, t: int) -> jax.Array:
    """(8, H, W) responses -> (8*T*T, P) decimated planes, P = (H/T)*(W/T).

    Channel ``label*T*T + a*T + b`` holds ``resp[label, a::T, b::T]``
    row-major — exactly the reference's linear-memory rows
    (linemod.cpp:1060-1088).
    """
    c, h, w = resp.shape
    assert h % t == 0 and w % t == 0, (h, w, t)
    hd, wd = h // t, w // t
    x = resp.reshape(c, hd, t, wd, t)
    x = x.transpose(0, 2, 4, 1, 3)            # (8, T, T, Hd, Wd)
    return x.reshape(c * t * t, hd * wd)


def decimate_2d(resp: jax.Array, t: int) -> jax.Array:
    """(8, H, W) responses -> (8*T*T, H/T, W/T) decimated planes.

    Same channel order as :func:`decimate` but keeping the 2D position
    grid — the layout consumed by the dense conv scorer
    (fealess.detector), where template matching is a one-hot-kernel
    2D correlation.
    """
    c, h, w = resp.shape
    assert h % t == 0 and w % t == 0, (h, w, t)
    hd, wd = h // t, w // t
    x = resp.reshape(c, hd, t, wd, t)
    x = x.transpose(0, 2, 4, 1, 3)            # (8, T, T, Hd, Wd)
    return x.reshape(c * t * t, hd, wd)


def decimate_quant(quant: jax.Array, t: int) -> jax.Array:
    """(H, W) image -> (T*T, H/T, W/T) subgrids, channel a*T + b =
    quant[a::T, b::T]."""
    h, w = quant.shape
    assert h % t == 0 and w % t == 0, (h, w, t)
    x = quant.reshape(h // t, t, w // t, t)
    return x.transpose(1, 3, 0, 2).reshape(t * t, h // t, w // t)


def _or_scan_shift(q: jax.Array, t: int, res_axis: int, sp_axis: int
                   ) -> jax.Array:
    """One separable pass of the decimated spread: OR the length-T window
    along one image axis, operating on residue-decimated subgrids.

    For output residue ``a``: contributions come from residues >= a at
    the same decimated position and residues < a at the next one:
    ``out[a] = suffix_or(q)[a] | shift(prefix_or(q)[a])``, where the
    prefix/suffix ORs run over ``res_axis`` and ``shift`` reads the next
    decimated row/col along ``sp_axis`` (zero fill past the edge).
    """
    qs = jnp.moveaxis(q, res_axis, 0)
    suf = [qs[t - 1]]
    for a in range(t - 2, -1, -1):
        suf.insert(0, qs[a] | suf[0])
    pre = [jnp.zeros_like(qs[0])]
    for a in range(1, t):
        pre.append(pre[-1] | qs[a - 1])

    sp = sp_axis if sp_axis < res_axis else sp_axis - 1  # axis in qs[a]
    n = qs.shape[1 + sp]

    def nxt(x):
        body = jax.lax.slice_in_dim(x, 1, n, axis=sp)
        pad = jnp.zeros_like(jax.lax.slice_in_dim(x, 0, 1, axis=sp))
        return jnp.concatenate([body, pad], axis=sp)

    out = jnp.stack([suf[a] | nxt(pre[a]) for a in range(t)])
    return jnp.moveaxis(out, 0, res_axis)


def spread_decimated(q_dec: jax.Array, t: int) -> jax.Array:
    """(T, T, Hd, Wd) decimated quant subgrids -> decimated SPREAD
    subgrids of the same shape (== full-resolution :func:`spread`
    sampled at the subgrid positions, without ever materializing the
    full-resolution spread or relayouting 8 response channels)."""
    rows = _or_scan_shift(q_dec, t, res_axis=0, sp_axis=2)
    return _or_scan_shift(rows, t, res_axis=1, sp_axis=3)


def build_level(quantized: jax.Array, t: int) -> jax.Array:
    """quantized bitmask image -> decimated response tensor for one level."""
    return decimate(response_maps(spread(quantized, t)), t)


def _response_stack_i32(spread_img: jax.Array) -> jax.Array:
    """(8, H, W) i32 response stack from a spread bitmask image (same
    generating rule as :func:`response_maps`, kept in i32)."""
    b = spread_img.astype(jnp.int32)

    def rot(x, k):
        return ((x << k) | (x >> (8 - k))) & 0xFF

    m1 = rot(b, 1) | rot(b, 7)
    m2 = m1 | rot(b, 2) | rot(b, 6)
    s4, s2, s1 = ORIENTATION_SCORES[0], ORIENTATION_SCORES[1], \
        ORIENTATION_SCORES[2]
    return jnp.stack(
        [jnp.where(((b >> o) & 1) == 1, s4,
                   jnp.where(((m1 >> o) & 1) == 1, s2,
                             jnp.where(((m2 >> o) & 1) == 1, s1, 0)))
         for o in range(8)])


def build_level_2d(quantized: jax.Array, t: int) -> jax.Array:
    """quantized bitmask image -> (8*T*T, H/T, W/T) i32 decimated
    responses (values 0..4) — the "linear memories" kept on a 2D grid
    (linemod.cpp:1060-1088).

    Equal to ``decimate_2d(response_maps(spread(q, t)), t)`` (tested).
    Decimates FIRST and runs spread + response on the (T, T, H/T, W/T)
    subgrid stack in i32, so the full-resolution spread and the 8-channel
    relayout are never materialized.
    """
    h, w = quantized.shape
    hd, wd = h // t, w // t
    q = quantized.astype(jnp.int32)
    q_dec = decimate_quant(q, t).reshape(t, t, hd, wd)
    b = spread_decimated(q_dec, t).reshape(t * t, hd, wd)
    return _response_stack_i32(b).reshape(8 * t * t, hd, wd)
