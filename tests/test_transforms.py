"""Property tests for rigid transforms and Kabsch alignment."""

import numpy as np
import jax.numpy as jnp

from fealess.geometry import transforms as tf


def _random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float32)


def test_transform_points_roundtrip(rng):
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    r = _random_rotation(rng)
    t = rng.normal(size=3).astype(np.float32)
    moved = np.asarray(tf.transform_points(jnp.asarray(pts), jnp.asarray(r),
                                           jnp.asarray(t)))
    back = np.asarray(tf.transform_points(jnp.asarray(moved),
                                          jnp.asarray(r.T),
                                          jnp.asarray(-r.T @ t)))
    np.testing.assert_allclose(back, pts, atol=1e-4)


def test_kabsch_recovers_rotation_about_origin(rng):
    # The reference's non-centred covariance recovers the exact transform
    # when the optimal T is 0 (pure rotation).
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    r = _random_rotation(rng)
    ref = pts @ r.T
    mask = np.ones(100, bool)
    r_opt, t_opt, ok = tf.kabsch(jnp.asarray(pts), jnp.asarray(ref),
                                 jnp.asarray(mask))
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(r_opt), r, atol=1e-4)
    np.testing.assert_allclose(np.asarray(t_opt), 0, atol=1e-4)


def test_kabsch_respects_mask(rng):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    r = _random_rotation(rng)
    ref = pts @ r.T
    # corrupt half the pairs; mask them out
    ref2 = ref.copy()
    ref2[50:] = rng.normal(size=(50, 3))
    mask = np.arange(100) < 50
    r_opt, _, ok = tf.kabsch(jnp.asarray(pts), jnp.asarray(ref2),
                             jnp.asarray(mask))
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(r_opt), r, atol=1e-4)


def test_compose_rt_matches_matrix_product(rng):
    r1, r2 = _random_rotation(rng), _random_rotation(rng)
    t1 = rng.normal(size=3).astype(np.float32)
    t2 = rng.normal(size=3).astype(np.float32)
    rc, tc = tf.compose_rt(jnp.asarray(r1), jnp.asarray(t1),
                           jnp.asarray(r2), jnp.asarray(t2))
    m1 = np.asarray(tf.pose_matrix_4x4(jnp.asarray(r1), jnp.asarray(t1)))
    m2 = np.asarray(tf.pose_matrix_4x4(jnp.asarray(r2), jnp.asarray(t2)))
    mc = np.asarray(tf.pose_matrix_4x4(rc, tc))
    np.testing.assert_allclose(mc, m1 @ m2, atol=1e-4)


def test_pose_from_13floats_layout():
    rec = np.arange(13, dtype=np.float32)
    r, t, d = tf.pose_from_13floats(jnp.asarray(rec))
    np.testing.assert_array_equal(np.asarray(r),
                                  [[0, 1, 2], [4, 5, 6], [8, 9, 10]])
    np.testing.assert_array_equal(np.asarray(t), [3, 7, 11])
    assert float(d) == 12.0


def test_rotation_geodesic_and_add(rng):
    r = _random_rotation(rng)
    eye = np.eye(3, dtype=np.float32)
    ang = float(tf.rotation_geodesic_deg(jnp.asarray(eye), jnp.asarray(eye)))
    assert abs(ang) < 1e-3
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    t = np.array([1.0, 0, 0], np.float32)
    add = float(tf.add_metric(jnp.asarray(eye), jnp.asarray(t),
                              jnp.asarray(eye), jnp.zeros(3), jnp.asarray(pts)))
    np.testing.assert_allclose(add, 1.0, atol=1e-5)
