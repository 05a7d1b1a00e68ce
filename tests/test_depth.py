"""Tests for depth back-projection (ICP/depth_to_3d.cpp semantics)."""

import numpy as np
import jax.numpy as jnp

from fealess.geometry import depth as gd


def test_depth_to_3d_pinhole(rng):
    h, w = 24, 32
    k = gd.intrinsics_matrix(608.0, 608.0, 16.0, 12.0)
    d = rng.integers(200, 2000, size=(h, w)).astype(np.uint16)
    pts = np.asarray(gd.depth_to_3d(jnp.asarray(d), k))
    # reproject: u = fx*x/z + cx
    z = d.astype(np.float64) / 1000.0
    u = 608.0 * pts[..., 0] / z + 16.0
    v = 608.0 * pts[..., 1] / z + 12.0
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    np.testing.assert_allclose(u, uu, atol=1e-3)
    np.testing.assert_allclose(v, vv, atol=1e-3)
    np.testing.assert_allclose(pts[..., 2], z, atol=1e-6)


def test_depth_zero_is_nan():
    d = np.array([[0, 1000]], dtype=np.uint16)
    k = gd.intrinsics_matrix(608.0, 608.0, 0.0, 0.0)
    pts = np.asarray(gd.depth_to_3d(jnp.asarray(d), k))
    assert np.isnan(pts[0, 0, 2])
    assert pts[0, 1, 2] == 1.0


def test_depth_to_3d_mm_scaling():
    d = np.array([[500]], dtype=np.uint16)
    k = gd.intrinsics_matrix(608.0, 608.0, 0.0, 0.0)
    pts = np.asarray(gd.depth_to_3d_mm(jnp.asarray(d), k))
    assert pts[0, 0, 2] == 500.0


def test_valid_mm_cap():
    pts = np.array([[[0, 0, 800.0], [0, 0, 901.0], [0, 0, np.nan]]],
                   dtype=np.float32)
    valid = np.asarray(gd.valid_mm(jnp.asarray(pts)))
    np.testing.assert_array_equal(valid, [[True, False, False]])


def test_scale_intrinsics():
    fx, fy, cx, cy = gd.scale_intrinsics(1280.0, 1280.0, 640.0, 360.0, 0.5)
    assert (fx, fy, cx, cy) == (640.0, 640.0, 320.0, 180.0)


def test_depth_to_3d_sparse_compaction():
    # masked sparse back-projection: stable row-major order, zero-depth
    # dropped, padded rows NaN (depthTo3dSparse, ICP/depth_to_3d.cpp:148-180)
    d = np.zeros((4, 4), np.uint16)
    d[1, 2] = 500
    d[2, 1] = 1000
    d[3, 3] = 0          # masked in but invalid depth
    mask = np.zeros((4, 4), np.uint8)
    mask[1, 2] = mask[2, 1] = mask[3, 3] = 1
    mask[0, 0] = 0       # valid-depth pixel outside mask must not appear
    k = gd.intrinsics_matrix(100.0, 100.0, 2.0, 2.0)
    pts, valid = gd.depth_to_3d_sparse(jnp.asarray(d), k,
                                       jnp.asarray(mask), capacity=4)
    assert valid.tolist() == [True, True, False, False]
    dense = np.asarray(gd.depth_to_3d(jnp.asarray(d), k))
    np.testing.assert_allclose(np.asarray(pts[0]), dense[1, 2], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(pts[1]), dense[2, 1], rtol=1e-6)
    assert np.isnan(np.asarray(pts[2:])).all()


def test_depth_to_3d_sparse_pads_to_capacity():
    # capacity > H*W must still return the promised static shapes
    # (padded with NaN/False) so jit callers see a fixed shape (ADVICE r1)
    d = np.full((2, 2), 700, np.uint16)
    mask = np.ones((2, 2), np.uint8)
    k = gd.intrinsics_matrix(100.0, 100.0, 1.0, 1.0)
    pts, valid = gd.depth_to_3d_sparse(jnp.asarray(d), k,
                                       jnp.asarray(mask), capacity=9)
    assert pts.shape == (9, 3) and valid.shape == (9,)
    assert valid.tolist() == [True] * 4 + [False] * 5
    assert np.isnan(np.asarray(pts[4:])).all()


def test_depth_to_3d_sparse_truncates_to_capacity():
    d = np.full((4, 4), 700, np.uint16)
    mask = np.ones((4, 4), np.uint8)
    k = gd.intrinsics_matrix(100.0, 100.0, 2.0, 2.0)
    pts, valid = gd.depth_to_3d_sparse(jnp.asarray(d), k,
                                       jnp.asarray(mask), capacity=5)
    assert valid.all() and pts.shape == (5, 3)
    dense = np.asarray(gd.depth_to_3d(jnp.asarray(d), k)).reshape(-1, 3)
    np.testing.assert_allclose(np.asarray(pts), dense[:5], rtol=1e-6)
