"""Batched template-similarity accumulation over decimated response planes.

The reference slides each template over "linear memories" with SSE u8 adds
(``similarity``/``similarityLocal``, linemod/linemod.cpp:1130-1300).  The
dense equivalence used here: with the decimated response tensor
``D[c, p]`` (c = label*T*T + (y%T)*T + (x%T), p = (y//T)*Wd + (x//T), see
fealess.ops.response.decimate), the whole-image score of template ``n``
at decimated position ``p`` is

    S[n, p] = sum_f D[c(n,f), p + off(n,f)]

i.e. a per-feature row-gather + shifted add — including, deliberately, the
reference's flat-buffer wraparound at row ends (similarity() allows the
template to wrap left/right and later filters those candidates;
linemod.cpp:1152-1156).  All shapes are static; features are padded to a
fixed F with a validity mask.

Role: this module is the INDEPENDENT ORACLE for the production scorers.
It shares no code with ``ops.score_pallas`` (flat-buffer row gathers
scanned over features here; a 2-D gather or the Triton kernel there) and
is consumed by ``chip_smoke.py`` (the card's scores must equal it on every
non-wrapping position) and by ``tests/test_response.py`` and
``tests/test_score_tables.py``.  It is not a serving path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

LOCAL_WINDOW = 16  # 16x16 decimated refinement patch (linemod.cpp:1243)


def pack_features(x: jax.Array, y: jax.Array, label: jax.Array,
                  t: int, wd: int):
    """(x, y, label) feature coords -> (channel, offset) into the decimated
    (C, P) tensor of fealess.ops.response.decimate."""
    c = label * (t * t) + (y % t) * t + (x % t)
    off = (y // t) * wd + (x // t)
    return c, off


def whole_image_similarity(d: jax.Array, feat_c: jax.Array,
                           feat_off: jax.Array, feat_valid: jax.Array,
                           positions: int) -> jax.Array:
    """Coarse whole-image raw scores for a batch of templates.

    Args:
      d: ``(C, Ppad)`` u8 decimated responses, right-padded with zeros so
         every ``off + positions`` slice is in range (Ppad >= 2*positions).
      feat_c / feat_off / feat_valid: ``(N, F)`` packed template features.
      positions: P = Hd*Wd of this level.

    Returns:
      ``(N, P)`` int32 raw scores (sum of 0..4 responses per feature).
    """
    def step(acc, packed):
        cf, of, vf = packed                       # each (N,)
        rows = d[cf]                              # (N, Ppad) row gather
        sl = jax.vmap(
            lambda row, o: jax.lax.dynamic_slice(row, (o,), (positions,))
        )(rows, of)
        return acc + jnp.where(vf[:, None], sl.astype(jnp.int32), 0), None

    n = feat_c.shape[0]
    init = jnp.zeros((n, positions), jnp.int32)
    acc, _ = jax.lax.scan(
        step, init, (feat_c.T, feat_off.T, feat_valid.T))
    return acc


def mask_template_positions(scores: jax.Array, template_positions: jax.Array
                            ) -> jax.Array:
    """Zero scores at flat positions >= span_y*Wd + span_x + 1 — the
    reference only writes that many entries (linemod.cpp:1158-1162)."""
    p = scores.shape[-1]
    pos = jnp.arange(p)[None, :]
    return jnp.where(pos < template_positions[:, None], scores, 0)


def local_similarity(d_flat: jax.Array, feat_c: jax.Array,
                     feat_base: jax.Array, feat_valid: jax.Array,
                     plane_stride: int, wd: int) -> jax.Array:
    """16x16 local refinement scores around candidate positions.

    Args:
      d_flat: ``(C * plane_stride,)`` u8 — per-channel flattened decimated
        planes, each padded to ``plane_stride`` >= P + 16*Wd + 16 so window
        reads past the image bottom return 0 (the reference reads past its
        buffer there; we document that divergence).
      feat_c: ``(K, F)`` channel per candidate-feature.
      feat_base: ``(K, F)`` flat base offset (row0*Wd + col0) per feature.
      feat_valid: ``(K, F)`` gate (padding and shifted-out-of-bounds).
      plane_stride: elements per channel plane in d_flat.
      wd: decimated image width (flat row stride).

    Returns:
      ``(K, 16*16)`` int32 window scores (flat row-major), reproducing the
      flat-buffer row-wrap of similarityLocal (linemod.cpp:1226-1300).
    """
    w16 = LOCAL_WINDOW
    woff = (jnp.arange(w16)[:, None] * wd
            + jnp.arange(w16)[None, :]).reshape(-1)           # (256,)
    idx = (feat_c[..., None] * plane_stride
           + feat_base[..., None] + woff[None, None, :])      # (K, F, 256)
    idx = jnp.clip(idx, 0, d_flat.shape[0] - 1)
    g = d_flat[idx].astype(jnp.int32)
    return jnp.sum(jnp.where(feat_valid[..., None], g, 0), axis=1)
