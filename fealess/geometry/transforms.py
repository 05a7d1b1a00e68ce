"""Rigid-body transforms and the Kabsch/SVD alignment step.

JAX equivalents of the reference's OpenCV matrix plumbing:
- ``transformPoints`` (ICP/ICP.cpp:28-45) -> :func:`transform_points`
- SVD alignment step (ICP/ICP.cpp:730-744) -> :func:`kabsch`
- pose composition (ICP/ICP.cpp:793-797, ICP/detection.cpp:232-234)
  -> :func:`compose_rt`

All functions are pure, jit-friendly, and batched via leading dims where
noted.  Points are ``(..., N, 3)`` float32; rotations ``(3, 3)``;
translations ``(3,)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST   # keeps f32 products out of TF32


def transform_points(points: jax.Array, r: jax.Array, t: jax.Array) -> jax.Array:
    """Apply ``p -> R p + t`` to an ``(..., N, 3)`` point array."""
    return jnp.matmul(points, r.T, precision=_HI) + t


def compose_rt(r_outer: jax.Array, t_outer: jax.Array,
               r_inner: jax.Array, t_inner: jax.Array):
    """Compose two rigid transforms: result = outer . inner.

    Matches the reference's incremental update ``T <- R* T + T*; R <- R* R``
    (ICP/ICP.cpp:793-797) with outer = (R*, T*).
    """
    return (jnp.matmul(r_outer, r_inner, precision=_HI),
            jnp.matmul(r_outer, t_inner, precision=_HI) + t_outer)


def masked_mean(points: jax.Array, mask: jax.Array) -> jax.Array:
    """Mean of ``points`` ``(N, 3)`` over rows where ``mask`` is True.

    Equivalent of ``getMean`` (ICP/ICP.cpp:8-25) with padding-mask support.
    Returns zeros when the mask is empty (the reference never hits that case
    because it bails out below 3 points, ICP.cpp:711-715).
    """
    w = mask.astype(points.dtype)[..., None]
    count = jnp.maximum(jnp.sum(w, axis=-2), 1.0)
    return jnp.sum(points * w, axis=-2) / count[..., 0]


def kabsch(model: jax.Array, ref: jax.Array, mask: jax.Array):
    """One point-to-point alignment step: R*, T* minimizing ||R m + T - r||.

    Reproduces the reference's (non-centered) covariance + SVD step
    (ICP/ICP.cpp:726-744): ``cov = sum_i m_i r_i^T``, ``[U,S,Vt] = svd(cov)``,
    ``R* = V U^T``, ``T* = r_mean - R* m_mean``.  Note the reference does NOT
    subtract centroids before accumulating the covariance; we keep that
    behaviour for parity (it changes the optimum only negligibly when
    centroids are near the origin, but parity matters for ADD).

    Degenerate covariances (reference guards via cv::checkRange,
    ICP.cpp:748-749) are handled by the caller skipping the update.

    Args:
      model: ``(N, 3)`` model points.
      ref:   ``(N, 3)`` corresponding reference points.
      mask:  ``(N,)`` bool validity of each pair.

    Returns:
      ``(r_opt, t_opt, ok)`` where ``ok`` is False if the SVD produced
      non-finite values.
    """
    m_centroid = masked_mean(model, mask)
    r_centroid = masked_mean(ref, mask)
    w = mask.astype(model.dtype)[:, None]
    cov = jnp.matmul((model * w).T, ref * w, precision=_HI)
    u, _, vt = jnp.linalg.svd(cov)
    r_opt = jnp.matmul(vt.T, u.T, precision=_HI)
    t_opt = r_centroid - jnp.matmul(r_opt, m_centroid, precision=_HI)
    ok = jnp.all(jnp.isfinite(r_opt)) & jnp.all(jnp.isfinite(t_opt))
    r_opt = jnp.where(ok, r_opt, jnp.eye(3, dtype=model.dtype))
    t_opt = jnp.where(ok, t_opt, jnp.zeros(3, dtype=model.dtype))
    return r_opt, t_opt, ok


def skew(v: jax.Array) -> jax.Array:
    """Cross-product matrix [v]x of a 3-vector."""
    z = jnp.zeros((), v.dtype)
    return jnp.array([[z, -v[2], v[1]],
                      [v[2], z, -v[0]],
                      [-v[1], v[0], z]])


def so3_exp(omega: jax.Array) -> jax.Array:
    """Rodrigues exponential map: axis-angle 3-vector -> rotation matrix.

    Used by the point-to-plane Gauss-Newton update (not present in the
    reference, which only does SVD point-to-point, ICP/ICP.cpp:730-744).
    Taylor-safe at small angles.
    """
    theta2 = jnp.sum(omega * omega)
    theta = jnp.sqrt(theta2)
    k = skew(omega)
    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks near zero
    small = theta < 1e-6
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.where(
        small, 1.0, theta))
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta2))
    return (jnp.eye(3, dtype=omega.dtype) + a * k
            + b * jnp.matmul(k, k, precision=_HI))


def pose_matrix_4x4(r: jax.Array, t: jax.Array) -> jax.Array:
    """Pack ``R, t`` into a 4x4 row-major world2cam matrix.

    Matches the ``Convert(R, T, Mat4x4F&)`` layout used for
    ``TObjRecoResult.tWorld2Cam`` (CadReco/obj_reco_lmicp.cpp:20-30).
    """
    top = jnp.concatenate([r, t[:, None]], axis=1)
    bottom = jnp.array([[0.0, 0.0, 0.0, 1.0]], dtype=r.dtype)
    return jnp.concatenate([top, bottom], axis=0)


def pose_from_13floats(pose_info: jax.Array):
    """Split the 13-float template pose record into (R, t, view_distance).

    The record is a row-major 3x4 world2cam matrix followed by the view
    distance (test/linemod_train.cpp:52-57; obj_reco_lmicp.cpp:144-152).
    """
    rows = pose_info[:12].reshape(3, 4)
    return rows[:, :3], rows[:, 3], pose_info[12]


def rotation_geodesic_deg(r1: jax.Array, r2: jax.Array) -> jax.Array:
    """Geodesic angle between two rotations, in degrees (ADD-style metric)."""
    cos = (jnp.trace(jnp.matmul(r1.T, r2, precision=_HI)) - 1.0) * 0.5
    return jnp.degrees(jnp.arccos(jnp.clip(cos, -1.0, 1.0)))


def add_metric(r1, t1, r2, t2, model_points: jax.Array) -> jax.Array:
    """Average Distance of model points between two poses (ADD metric)."""
    p1 = transform_points(model_points, r1, t1)
    p2 = transform_points(model_points, r2, t2)
    return jnp.mean(jnp.linalg.norm(p1 - p2, axis=-1))
