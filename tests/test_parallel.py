"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4d).

Template-sharded matching and point-sharded ICP must produce the same
results as their single-device counterparts.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fealess import config as cfg
from fealess import detector, icp as icp_mod, training
from fealess.bank import pack_bank
from fealess.parallel import mesh as mesh_mod
from fealess.parallel import sharded_icp, sharded_match
from tests.test_match_e2e import H, W, make_scene


@pytest.fixture(scope="module")
def det_cfg():
    return cfg.DetectorConfig(image_width=W, image_height=H,
                              max_candidates=8)


@pytest.fixture(scope="module")
def scene_and_bank(det_cfg):
    rng = np.random.default_rng(7)
    bgr, depth, mask = make_scene(rng)
    pose = np.arange(13, dtype=np.float32)
    view = training.add_template(bgr, depth, mask, pose, det_cfg)
    assert view is not None
    # capacity 8 -> one slot per device on the 8-device mesh
    bank = pack_bank({"obj": [view]}, levels=det_cfg.pyramid_levels,
                     capacity=8)
    return (bgr, depth), bank


def test_eight_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_match_equals_local(scene_and_bank, det_cfg):
    (bgr, depth), bank = scene_and_bank
    local = jax.jit(lambda b, i, d: detector.match_bank(
        b, i, d, 75.0, det_cfg))(bank, jnp.asarray(bgr), jnp.asarray(depth))
    m = mesh_mod.template_mesh()
    sharded = jax.jit(lambda b, i, d: sharded_match.match_bank_sharded(
        b, i, d, 75.0, det_cfg, m))(bank, jnp.asarray(bgr),
                                    jnp.asarray(depth))
    lv = np.asarray(local.valid)
    sv = np.asarray(sharded.valid)
    assert sv.any()
    # top match identical
    lt, st = int(np.argmax(lv)), int(np.argmax(sv))
    assert np.asarray(local.x)[lt] == np.asarray(sharded.x)[st]
    assert np.asarray(local.y)[lt] == np.asarray(sharded.y)[st]
    assert np.asarray(local.similarity)[lt] == np.asarray(sharded.similarity)[st]
    assert np.asarray(local.template_slot)[lt] == \
        np.asarray(sharded.template_slot)[st]


def test_sharded_icp_equals_local(rng):
    pts = rng.normal(size=(500, 3)).astype(np.float32) * [50, 40, 10]
    pts[:, 2] += 600
    r = np.array([[0.999, -0.035, 0.0], [0.035, 0.999, 0.0], [0, 0, 1.0]],
                 np.float32)
    model = pts @ r + np.array([5.0, -3.0, 2.0], np.float32)
    padded_r, mask = icp_mod.pad_cloud(pts, np.ones(len(pts), bool), 1024)
    padded_m, _ = icp_mod.pad_cloud(model, np.ones(len(model), bool), 1024)
    ic = cfg.IcpConfig(max_iterations=15)

    local = icp_mod.icp_point_to_point(jnp.asarray(padded_r),
                                       jnp.asarray(padded_m),
                                       jnp.asarray(mask), ic)
    m = mesh_mod.make_mesh([("p", 8)])
    dist = sharded_icp.icp_sharded(jnp.asarray(padded_r),
                                   jnp.asarray(padded_m),
                                   jnp.asarray(mask), ic, m)
    np.testing.assert_allclose(np.asarray(dist.r), np.asarray(local.r),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(dist.t), np.asarray(local.t),
                               atol=1e-3)
    assert int(dist.iterations) == int(local.iterations)


def test_batch_recon_sharded_matches_single(scene_and_bank, det_cfg):
    """Frame-sharded batch Recognition == single-device vmapped batch."""
    from fealess.parallel import batch_recon

    (bgr, depth), bank = scene_and_bank
    engine = cfg.EngineConfig(detector=det_cfg, refine_crop=96,
                              icp=cfg.IcpConfig(max_points=2048),
                              template_fx=608.0, template_fy=608.0,
                              template_cx=W / 2.0, template_cy=H / 2.0)
    rng = np.random.default_rng(1)
    md = jnp.asarray(rng.integers(400, 880, size=(bank.capacity, 96, 96),
                                  dtype=np.uint16))
    orig = jnp.zeros((bank.capacity, 2), jnp.int32)
    kk = jnp.asarray([[608.0, 0, W / 2.0], [0, 608.0, H / 2.0], [0, 0, 1]],
                     jnp.float32)
    b = 8
    bgr_b = jnp.broadcast_to(jnp.asarray(bgr), (b,) + bgr.shape)
    depth_b = jnp.broadcast_to(jnp.asarray(depth), (b,) + depth.shape)

    single = jax.jit(lambda *a: batch_recon.recognize_batch(*a, engine))(
        bank, md, orig, bgr_b, depth_b, kk)
    m = mesh_mod.make_mesh([("d", 8)])
    sharded = jax.jit(lambda *a: batch_recon.recognize_batch_sharded(
        *a, engine, m))(bank, md, orig, bgr_b, depth_b, kk)
    np.testing.assert_allclose(np.asarray(sharded.similarity),
                               np.asarray(single.similarity), atol=1e-4)
    np.testing.assert_allclose(np.asarray(sharded.pose),
                               np.asarray(single.pose), atol=1e-2)


def test_match_batch_2d_mesh(scene_and_bank, det_cfg):
    """(d=2, t=4) frame x template mesh: each frame's merged global
    top-K must equal the single-device full-bank match on that frame."""
    from fealess.parallel import batch_recon

    (bgr, depth), bank = scene_and_bank
    bgrs = jnp.asarray(np.stack([bgr, np.roll(bgr, 10, axis=1)]))
    deps = jnp.asarray(np.stack([depth, np.roll(depth, 10, axis=1)]))
    m2 = mesh_mod.make_mesh([("d", 2), ("t", 4)])
    out = jax.jit(lambda b_, i_, d_: batch_recon.match_batch_2d(
        b_, i_, d_, 75.0, det_cfg, m2))(bank, bgrs, deps)

    for f in range(2):
        ref = jax.jit(lambda b_, i_, d_: detector.match_bank(
            b_, i_, d_, 75.0, det_cfg))(bank, bgrs[f], deps[f])
        rv = np.asarray(ref.valid)
        ov = np.asarray(out.valid[f])
        assert rv.any() and ov.any(), f
        ri = int(np.argmax(rv))
        oi = int(np.argmax(ov))
        assert int(out.x[f][oi]) == int(ref.x[ri])
        assert int(out.y[f][oi]) == int(ref.y[ri])
        assert float(out.similarity[f][oi]) == pytest.approx(
            float(ref.similarity[ri]))
        assert int(out.template_slot[f][oi]) == int(ref.template_slot[ri])
