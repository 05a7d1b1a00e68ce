"""Felzenszwalb HOG (FHOG) features, fully vectorized.

Dense JAX re-derivation of the latentsvm FHOG used by the reference
tracker (kcf_tracker/fhog.cpp):

- ``getFeatureMaps`` (fhog.cpp:80-275): per-pixel [-1,0,1] gradients, the
  channel with the largest magnitude wins; orientation assigned to 1 of 9
  contrast-insensitive and 1 of 18 contrast-sensitive sectors by maximal
  (signed) dot product with the sector boundary vectors; magnitudes
  bilinearly shared between the 2x2 nearest cells.  Image border pixels
  (first/last row/column) are excluded exactly as the reference's loop
  bounds do.
- ``normalizeAndTruncate`` (fhog.cpp:290-399): per-cell energy = sum of
  squared insensitive bins; 4 diagonal 2x2 block norms; truncation at
  ``alfa``; the outermost cell ring is cropped.
- ``PCAFeatureMaps`` (fhog.cpp:414-482): the analytic projection to 31
  dims: 18 sensitive sums over the 4 norms (x 1/2), 9 insensitive sums
  over the 4 norms (x 1/2), 4 per-norm sums over the 18 sensitive bins
  (x 1/sqrt(18)).

The reference scatters per-pixel contributions through pointer arithmetic;
here the same sums are computed as dense masked tensor contractions — the
idiomatic formulation for a vector unit (no gathers or scatters at all).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

# f32 products stay out of TF32 on GPUs
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)

NUM_SECTOR = 9          # fhog.hpp:91
TRUNCATION = 0.2        # kcftracker.cpp:428


def _cell_weights(k: int) -> np.ndarray:
    """Bilinear in-cell interpolation weights (fhog.cpp:190-207): for pixel
    row/col ``j`` within a cell, ``w[j, 0]`` is the own-cell weight and
    ``w[j, 1]`` the neighbour-cell weight."""
    w = np.zeros((k, 2), np.float32)
    for j in range(k // 2):
        b = k / 2 + j + 0.5
        a = k / 2 - j - 0.5
        w[j, 0] = 1.0 / a * ((a * b) / (a + b))
        w[j, 1] = 1.0 / b * ((a * b) / (a + b))
    for j in range(k // 2, k):
        a = j - k / 2 + 0.5
        b = -j + k / 2 - 0.5 + k
        w[j, 0] = 1.0 / a * ((a * b) / (a + b))
        w[j, 1] = 1.0 / b * ((a * b) / (a + b))
    return w


@functools.lru_cache()
def _boundary_vectors():
    ang = np.arange(NUM_SECTOR + 1) * (np.pi / NUM_SECTOR)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def raw_feature_maps(image: jax.Array, k: int) -> jax.Array:
    """getFeatureMaps: (H, W, C) float image -> (H//k, W//k, 27) maps."""
    h, w = image.shape[:2]
    sy, sx = h // k, w // k

    # [-1, 0, 1] gradients; border rows/cols are masked out below, so the
    # filter's border mode is irrelevant (fhog.cpp:137-182 loops 1..n-2).
    xpad = jnp.pad(image, ((0, 0), (1, 1), (0, 0)), mode="edge")
    dx = xpad[:, 2:] - xpad[:, :-2]
    ypad = jnp.pad(image, ((1, 1), (0, 0), (0, 0)), mode="edge")
    dy = ypad[2:] - ypad[:-2]

    mag = jnp.sqrt(dx * dx + dy * dy)            # (H, W, C)
    best = jnp.argmax(mag, axis=-1)              # first max wins, as the
    r = jnp.max(mag, axis=-1)                    # reference's strict > does
    gx = jnp.take_along_axis(dx, best[..., None], axis=-1)[..., 0]
    gy = jnp.take_along_axis(dy, best[..., None], axis=-1)[..., 0]

    cosv, sinv = _boundary_vectors()
    dots = (gx[..., None] * cosv[:NUM_SECTOR]
            + gy[..., None] * sinv[:NUM_SECTOR])         # (H, W, 9)
    # The reference scans k: dot first, then -dot, strict-> updates — the
    # winner is the FIRST index attaining the max of the interleaved
    # sequence [d0, -d0, d1, -d1, ...].
    inter = jnp.stack([dots, -dots], axis=-1).reshape(*dots.shape[:-1],
                                                      2 * NUM_SECTOR)
    idx = jnp.argmax(inter, axis=-1)
    maxi = idx // 2 + (idx % 2) * NUM_SECTOR     # sensitive bin 0..17
    ins = maxi % NUM_SECTOR                      # insensitive bin 0..8

    interior = jnp.zeros((h, w), bool).at[1:h - 1, 1:w - 1].set(True)
    r = jnp.where(interior, r, 0.0)

    onehot_ins = jax.nn.one_hot(ins, NUM_SECTOR, dtype=jnp.float32)
    onehot_sens = jax.nn.one_hot(maxi, 2 * NUM_SECTOR, dtype=jnp.float32)
    feat = jnp.concatenate([onehot_ins, onehot_sens], axis=-1) \
        * r[..., None]                                        # (H, W, 27)

    feat = feat[:sy * k, :sx * k].reshape(sy, k, sx, k, 3 * NUM_SECTOR)
    wts = _cell_weights(k)
    w0 = jnp.asarray(wts[:, 0])
    w1 = jnp.asarray(wts[:, 1])
    half = k // 2

    # y-pass: own cell, then neighbour rows (first half -> cell above,
    # second half -> cell below; out-of-range contributions are dropped,
    # matching the boundary guards at fhog.cpp:227-253).
    own_y = _einsum("ykxjc,k->yxjc", feat, w0)
    up = _einsum("ykxjc,k->yxjc", feat[:, :half], w1[:half])
    dn = _einsum("ykxjc,k->yxjc", feat[:, half:], w1[half:])
    ymaps = own_y.at[:-1].add(up[1:]).at[1:].add(dn[:-1])

    own_x = _einsum("yxjc,j->yxc", ymaps, w0)
    lf = _einsum("yxjc,j->yxc", ymaps[:, :, :half], w1[:half])
    rt = _einsum("yxjc,j->yxc", ymaps[:, :, half:], w1[half:])
    return own_x.at[:, :-1].add(lf[:, 1:]).at[:, 1:].add(rt[:, :-1])


def normalize_and_truncate(maps: jax.Array,
                           alfa: float = TRUNCATION) -> jax.Array:
    """(sy, sx, 27) -> (sy-2, sx-2, 108), fhog.cpp:290-399."""
    p = NUM_SECTOR
    ins = maps[..., :p]
    sens = maps[..., p:]
    pn = jnp.sum(ins * ins, axis=-1)             # (sy, sx)

    # Diagonal 2x2 block norms around each interior cell, in the exact
    # order of fhog.cpp:326-380: A=(+,+), B=(-,+), C=(+,-), D=(-,-).
    c = pn[1:-1, 1:-1]
    rgt = pn[1:-1, 2:]
    lft = pn[1:-1, :-2]
    dwn = pn[2:, 1:-1]
    up = pn[:-2, 1:-1]
    dr = pn[2:, 2:]
    ur = pn[:-2, 2:]
    dl = pn[2:, :-2]
    ul = pn[:-2, :-2]
    eps = jnp.float32(np.finfo(np.float32).eps)
    na = jnp.sqrt(c + rgt + dwn + dr) + eps
    nb = jnp.sqrt(c + rgt + up + ur) + eps
    nc = jnp.sqrt(c + lft + dwn + dl) + eps
    nd = jnp.sqrt(c + lft + up + ul) + eps

    ins_c = ins[1:-1, 1:-1]
    sens_c = sens[1:-1, 1:-1]
    blocks = [ins_c / na[..., None], ins_c / nb[..., None],
              ins_c / nc[..., None], ins_c / nd[..., None],
              sens_c / na[..., None], sens_c / nb[..., None],
              sens_c / nc[..., None], sens_c / nd[..., None]]
    out = jnp.concatenate(blocks, axis=-1)       # (sy-2, sx-2, 108)
    return jnp.minimum(out, alfa)


def pca_feature_maps(maps108: jax.Array) -> jax.Array:
    """(sy, sx, 108) -> (sy, sx, 31), fhog.cpp:414-482."""
    p = NUM_SECTOR
    ins4 = maps108[..., :4 * p].reshape(*maps108.shape[:-1], 4, p)
    sens4 = maps108[..., 4 * p:].reshape(*maps108.shape[:-1], 4, 2 * p)
    ny = 1.0 / np.sqrt(4.0)
    nx = 1.0 / np.sqrt(2.0 * p)
    part_sens = jnp.sum(sens4, axis=-2) * ny         # (.., 18)
    part_ins = jnp.sum(ins4, axis=-2) * ny           # (.., 9)
    part_norm = jnp.sum(sens4, axis=-1) * nx         # (.., 4)
    return jnp.concatenate([part_sens, part_ins, part_norm], axis=-1)


def fhog31(image: jax.Array, cell_size: int) -> jax.Array:
    """Full FHOG pipeline: (H, W, C) float -> (H//k - 2, W//k - 2, 31)."""
    return pca_feature_maps(
        normalize_and_truncate(raw_feature_maps(image, cell_size)))
