"""Depth-image back-projection (pinhole unprojection), fully vectorized.

Dense JAX equivalent of ``cup_d2pc::depthTo3d`` (ICP/depth_to_3d.cpp:191-221)
and ``rescaleDepth`` (ICP/depth_to_3d.cpp:244-269):

- u16 depth in millimetres is divided by 1000 to metres; a raw value of 0 is
  invalid and becomes NaN (depth_to_3d.cpp:255-260).
- unprojection is the dense no-mask path (depth_to_3d.cpp:99-137):
  ``x = (u - cx)/fx * z``, ``y = (v - cy)/fy * z``.

The downstream pipeline immediately rescales to millimetres
(ICP/detection.cpp:38-40); :func:`depth_to_3d_mm` fuses that.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rescale_depth_to_m(depth_u16: jax.Array) -> jax.Array:
    """u16 depth (mm) -> float32 metres, 0 -> NaN."""
    z = depth_u16.astype(jnp.float32) / 1000.0
    return jnp.where(depth_u16 == 0, jnp.nan, z)


def depth_to_3d(depth_u16: jax.Array, k: jax.Array) -> jax.Array:
    """Back-project an ``(H, W)`` u16 depth image (mm) to ``(H, W, 3)`` metres.

    ``k`` is the 3x3 pinhole intrinsic matrix.  Invalid (zero) depth yields
    NaN points, matching rescaleDepth + depthTo3dNoMask semantics.
    """
    h, w = depth_u16.shape
    z = rescale_depth_to_m(depth_u16)
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    u = jnp.arange(w, dtype=jnp.float32)[None, :]
    v = jnp.arange(h, dtype=jnp.float32)[:, None]
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    return jnp.stack([x, y, z], axis=-1)


def depth_to_3d_mm(depth_u16: jax.Array, k: jax.Array) -> jax.Array:
    """Back-project to millimetres (depthTo3d followed by scale_mat_vec3f
    x1000, ICP/detection.cpp:38-40)."""
    return depth_to_3d(depth_u16, k) * 1000.0


def depth_to_3d_sparse(depth_u16: jax.Array, k: jax.Array,
                       mask: jax.Array, capacity: int):
    """Masked back-projection to a fixed-capacity point LIST.

    Dense equivalent of ``depthTo3dSparse``/``depthTo3dMask``
    (ICP/depth_to_3d.cpp:148-180, 59-92): the reference emits a ragged
    ``1 x N`` point list for the mask-nonzero pixels; here the selected
    points are compacted (stable, row-major pixel order — the reference's
    iteration order) into a static ``(capacity, 3)`` array in metres plus a
    validity mask, so the result is jit-safe.  Pixels with zero depth are
    dropped even when masked in, matching the NaN propagation of
    rescaleDepth (depth_to_3d.cpp:255-260).

    Returns ``(points_m, valid)`` with shapes ``(capacity, 3)`` and
    ``(capacity,)``; rows beyond the selected count hold NaN.
    """
    pts = depth_to_3d(depth_u16, k).reshape(-1, 3)
    sel = (mask.reshape(-1) != 0) & (depth_u16.reshape(-1) != 0)
    take = min(capacity, sel.shape[0])
    order = jnp.argsort(jnp.logical_not(sel), stable=True)[:take]
    valid = sel[order]
    out = jnp.where(valid[:, None], pts[order], jnp.nan)
    if take < capacity:
        # Fewer pixels than capacity: pad to the promised static shapes.
        out = jnp.pad(out, ((0, capacity - take), (0, 0)),
                      constant_values=jnp.nan)
        valid = jnp.pad(valid, (0, capacity - take))
    return out, valid


def intrinsics_matrix(fx: float, fy: float, cx: float, cy: float) -> jax.Array:
    """Build a 3x3 K (setCamIntrinsic, ICP/common.cpp:374-379)."""
    return jnp.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                     dtype=jnp.float32)


def scale_intrinsics(fx: float, fy: float, cx: float, cy: float,
                     zoom: float):
    """Scale intrinsics when resizing the input to the processing width
    (PrepareInputData, CadReco/obj_reco_lmicp.cpp:241-248)."""
    return fx * zoom, fy * zoom, cx * zoom, cy * zoom


def normals_from_point_image(points: jax.Array) -> jax.Array:
    """Per-pixel surface normals of an ``(H, W, 3)`` point image.

    Central-difference tangents along u and v, normal = normalize(du x dv),
    oriented to face the camera (``n . p <= 0``).  Pixels whose neighbourhood
    contains invalid (NaN) points get a zero normal — downstream consumers
    treat ``|n| < 0.5`` as invalid.  This feeds the point-to-plane ICP mode,
    which has no reference counterpart (the reference's refinement is
    point-to-point only, ICP/ICP.cpp:730-744; its quantized-normal modality
    linemod.cpp:595-685 is a separate 8-bin code, not a float normal).
    """
    p = points
    # edge-replicated central differences (one-sided at the borders)
    du = jnp.concatenate([p[:, 1:2] - p[:, 0:1],
                          (p[:, 2:] - p[:, :-2]) * 0.5,
                          p[:, -1:] - p[:, -2:-1]], axis=1)
    dv = jnp.concatenate([p[1:2] - p[0:1],
                          (p[2:] - p[:-2]) * 0.5,
                          p[-1:] - p[-2:-1]], axis=0)
    n = jnp.cross(du, dv)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    ok = jnp.isfinite(norm[..., 0]) & (norm[..., 0] > 1e-12)
    n = jnp.where(ok[..., None], n / jnp.where(ok[..., None], norm, 1.0), 0.0)
    # face the camera: flip where the normal points away from the origin ray
    flip = jnp.sum(n * p, axis=-1) > 0
    return jnp.where(flip[..., None], -n, n)


def valid_mm(points_mm: jax.Array, max_depth_mm: float = 900.0) -> jax.Array:
    """Validity of back-projected points in mm: ``z <= 900``.

    NaN z compares False, so invalid depth is rejected exactly like
    ``is_vec3f_valid`` (ICP/common.cpp:260-266).
    """
    return points_mm[..., 2] <= max_depth_mm
