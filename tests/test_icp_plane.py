"""Point-to-plane Gauss-Newton ICP tests: exp-map golden values vs
cv2.Rodrigues, normal estimation on synthetic surfaces, rigid-transform
recovery, and sharded (psum 6x6) parity with the single-device path."""

import cv2
import numpy as np
import jax
import jax.numpy as jnp

from fealess import config as cfg
from fealess import icp as icp_mod
from fealess.geometry import depth as gd
from fealess.geometry import transforms as tf
from fealess.parallel import mesh as mesh_mod
from fealess.parallel import sharded_icp


def test_so3_exp_matches_rodrigues(rng):
    for _ in range(5):
        w = rng.normal(size=3).astype(np.float32) * 0.5
        got = np.asarray(tf.so3_exp(jnp.asarray(w)))
        want, _ = cv2.Rodrigues(w.astype(np.float64))
        np.testing.assert_allclose(got, want, atol=1e-5)
    # tiny angle: series branch
    w = np.array([1e-9, -2e-9, 5e-10], np.float32)
    got = np.asarray(tf.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(got, np.eye(3), atol=1e-7)


def _bowl_surface(rng, n=40):
    """Curved surface z = 600 + quadratic bowl — well-constrained for
    point-to-plane in all 6 DoF."""
    xs = np.linspace(-80, 80, n, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs)
    gz = 600 + 0.004 * (gx ** 2) + 0.007 * (gy ** 2)
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    # analytic unit normals of z = f(x, y): (-df/dx, -df/dy, 1)/norm,
    # flipped to face the camera (negative z component)
    nrm = np.stack([0.008 * gx, 0.014 * gy, -np.ones_like(gx)],
                   axis=-1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts.astype(np.float32), nrm.astype(np.float32)


def test_normals_from_point_image_plane():
    # tilted plane z = 500 + 0.2x + 0.1y over a pixel grid
    h, w = 32, 48
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    x = np.broadcast_to(u, (h, w))
    y = np.broadcast_to(v, (h, w))
    z = 500 + 0.2 * x + 0.1 * y
    pts = jnp.asarray(np.stack([x, y, z], axis=-1))
    n = np.asarray(gd.normals_from_point_image(pts))
    want = np.array([0.2, 0.1, -1.0])
    want /= np.linalg.norm(want)
    inner = n[2:-2, 2:-2]
    np.testing.assert_allclose(inner, np.broadcast_to(want, inner.shape),
                               atol=1e-3)
    # camera-facing: n . p <= 0
    assert np.all(np.sum(n * np.asarray(pts), axis=-1) <= 1e-3)


def test_normals_invalid_nan_pixels():
    pts = np.full((8, 8, 3), np.nan, np.float32)
    pts[:, :, 2] = np.nan
    n = np.asarray(gd.normals_from_point_image(jnp.asarray(pts)))
    assert np.all(n == 0)


def _rot(axis, deg):
    axis = np.asarray(axis, np.float64)
    axis /= np.linalg.norm(axis)
    a = np.radians(deg)
    k = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(a) * k
            + (1 - np.cos(a)) * k @ k).astype(np.float32)


def test_plane_icp_recovers_transform(rng):
    ref, normals = _bowl_surface(rng)
    r_true = _rot([0.2, 1.0, -0.3], 3.0)
    t_true = np.array([6.0, -4.0, 5.0], np.float32)
    centroid = ref.mean(axis=0)
    model = (ref - centroid) @ r_true + centroid - r_true.T @ t_true
    initial = np.linalg.norm(model - ref, axis=1).mean()

    cap = 2048
    pr, mask = icp_mod.pad_cloud(ref, np.ones(len(ref), bool), cap)
    pm, _ = icp_mod.pad_cloud(model, np.ones(len(model), bool), cap)
    pn = np.zeros((cap, 3), np.float32)
    pn[:len(normals)] = normals

    icp_cfg = cfg.IcpConfig(mode="point_to_plane", max_iterations=20,
                            dist_mean_threshold=0.01,
                            dist_diff_threshold=1e-6)
    res = icp_mod.icp_refine(jnp.asarray(pr), jnp.asarray(pm),
                             jnp.asarray(mask), icp_cfg,
                             ref_normals=jnp.asarray(pn))
    assert bool(res.ok)
    moved = model @ np.asarray(res.r).T + np.asarray(res.t)
    resid = np.linalg.norm(moved - ref, axis=1).mean()
    assert resid < 0.05 * initial, f"residual {resid} vs initial {initial}"


def test_plane_icp_converges_quickly(rng):
    """Plane mode reaches the dist_mean threshold within a few GN steps
    (the point mode with exact index pairings is one-shot optimal, so no
    iteration-count comparison is meaningful here)."""
    ref, normals = _bowl_surface(rng)
    r_true = _rot([0.5, 0.2, 1.0], 2.0)
    t_true = np.array([3.0, 2.0, -4.0], np.float32)
    centroid = ref.mean(axis=0)
    model = (ref - centroid) @ r_true + centroid - r_true.T @ t_true

    cap = 2048
    pr, mask = icp_mod.pad_cloud(ref, np.ones(len(ref), bool), cap)
    pm, _ = icp_mod.pad_cloud(model, np.ones(len(model), bool), cap)
    pn = np.zeros((cap, 3), np.float32)
    pn[:len(normals)] = normals

    kw = dict(max_iterations=30, dist_mean_threshold=0.05,
              dist_diff_threshold=1e-7)
    plane = icp_mod.icp_refine(
        jnp.asarray(pr), jnp.asarray(pm), jnp.asarray(mask),
        cfg.IcpConfig(mode="point_to_plane", **kw),
        ref_normals=jnp.asarray(pn))
    assert int(plane.iterations) <= 5
    assert float(plane.dist_mean) <= 0.05


def test_plane_icp_sharded_matches_single(rng):
    ref, normals = _bowl_surface(rng, n=32)
    r_true = _rot([1.0, 0.1, 0.4], 2.5)
    t_true = np.array([4.0, -2.0, 3.0], np.float32)
    centroid = ref.mean(axis=0)
    model = (ref - centroid) @ r_true + centroid - r_true.T @ t_true

    cap = 1024     # divisible by 8
    pr, mask = icp_mod.pad_cloud(ref, np.ones(len(ref), bool), cap)
    pm, _ = icp_mod.pad_cloud(model, np.ones(len(model), bool), cap)
    pn = np.zeros((cap, 3), np.float32)
    pn[:len(normals)] = normals

    icp_cfg = cfg.IcpConfig(mode="point_to_plane", max_iterations=8,
                            dist_mean_threshold=0.01,
                            dist_diff_threshold=1e-6)
    single = icp_mod.icp_refine(jnp.asarray(pr), jnp.asarray(pm),
                                jnp.asarray(mask), icp_cfg,
                                ref_normals=jnp.asarray(pn))
    m = mesh_mod.make_mesh([("p", 8)])
    sharded = jax.jit(lambda r, n, mo, ma: sharded_icp.icp_plane_sharded(
        r, n, mo, ma, icp_cfg, m))(jnp.asarray(pr), jnp.asarray(pn),
                                   jnp.asarray(pm), jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(sharded.r), np.asarray(single.r),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(sharded.t), np.asarray(single.t),
                               atol=1e-2)
    assert int(sharded.iterations) == int(single.iterations)
