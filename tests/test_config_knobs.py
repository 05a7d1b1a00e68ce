"""Every public config field must observably change behaviour.

VERDICT r4 found one dead knob (``valid_depth_max_mm``); this suite pins
each field of the config dataclasses (fealess.config) to an
observable effect so a knob can never silently become a no-op again.
Fields whose effect is structural (shapes) are asserted on shapes; numeric
knobs on value changes.  Modalities selection (LINE vs LINE-MOD) is
covered by tests/test_misc_parity.py.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from fealess import config as cfg
from fealess import detector, icp as icp_mod, nms as nms_mod, training
from fealess.bank import pack_bank
from fealess.ops import quantize as q
from tests.test_match_e2e import H, W, make_scene


@pytest.fixture(scope="module")
def scene():
    return make_scene(np.random.default_rng(7))


@pytest.fixture(scope="module")
def det_cfg():
    return cfg.DetectorConfig(image_width=W, image_height=H,
                              max_candidates=16)


@pytest.fixture(scope="module")
def bank(scene, det_cfg):
    bgr, depth, mask = scene
    pose = np.zeros(13, np.float32)
    pose[0] = pose[5] = pose[10] = 1.0
    view = training.add_template(bgr, depth, mask, pose, det_cfg)
    assert view is not None
    return pack_bank({"obj": [view]}, levels=det_cfg.pyramid_levels,
                     modalities=2, capacity=8,
                     max_features=det_cfg.max_features)


# ---------------------------------------------------------------- modalities

def test_cg_weak_threshold(scene):
    bgr = scene[0]
    lo, _ = q.quantize_gradients(bgr, 10.0)
    hi, _ = q.quantize_gradients(bgr, 200.0)
    assert not np.array_equal(np.asarray(lo), np.asarray(hi))


def test_cg_strong_threshold(scene, det_cfg):
    bgr, _, mask = scene
    bits, mag = (np.asarray(a) for a in q.quantize_gradients(bgr, 10.0))
    a = training.extract_gradient_template(bits, mag, mask, 16, 55.0)
    assert a is not None and len(a) == 16
    # the gate is on squared magnitude: a high enough threshold empties
    # the candidate pool below num_features and extraction fails
    hi = float(np.sqrt(mag.max()) + 1)
    assert training.extract_gradient_template(bits, mag, mask, 16, hi) is None


def test_cg_num_features(scene):
    bgr, _, mask = scene
    bits, mag = (np.asarray(a) for a in q.quantize_gradients(bgr, 10.0))
    a = training.extract_gradient_template(bits, mag, mask, 8, 55.0)
    b = training.extract_gradient_template(bits, mag, mask, 24, 55.0)
    assert len(a) == 8 and len(b) == 24


def test_dn_distance_threshold(scene):
    depth = scene[1]
    a = np.asarray(q.quantize_normals(depth, 2000, 50))
    b = np.asarray(q.quantize_normals(depth, 800, 50))
    assert not np.array_equal(a, b)


def test_dn_difference_threshold(scene):
    depth = scene[1]
    a = np.asarray(q.quantize_normals(depth, 2000, 50))
    b = np.asarray(q.quantize_normals(depth, 2000, 1))
    assert not np.array_equal(a, b)


def test_dn_num_features_and_extract_threshold(scene):
    _, depth, mask = scene
    bits = np.asarray(q.quantize_normals(depth, 2000, 50))
    a = training.extract_normal_template(bits, mask, 8, 2)
    b = training.extract_normal_template(bits, mask, 20, 2)
    c = training.extract_normal_template(bits, mask, 8, 0)
    assert len(a) == 8 and len(b) == 20
    assert not np.array_equal(a, c)    # threshold changes the candidate set


# ------------------------------------------------------------------ detector

def test_t_at_level_changes_grid(scene, det_cfg):
    bgr, depth, _ = scene
    planes5 = detector.response_planes(
        detector.quantized_pyramid(jnp.asarray(bgr), jnp.asarray(depth),
                                   det_cfg), det_cfg)
    det4 = dataclasses.replace(det_cfg, t_at_level=(4, 8))
    planes4 = detector.response_planes(
        detector.quantized_pyramid(jnp.asarray(bgr), jnp.asarray(depth),
                                   det4), det4)
    assert planes5[0][0].shape != planes4[0][0].shape


def test_max_candidates_sets_match_k(bank, scene, det_cfg):
    bgr, depth, _ = scene
    m = detector.match_bank(bank, jnp.asarray(bgr), jnp.asarray(depth),
                            75.0, det_cfg)
    assert m.x.shape == (det_cfg.max_candidates,)
    det8 = dataclasses.replace(det_cfg, max_candidates=8)
    m8 = detector.match_bank(bank, jnp.asarray(bgr), jnp.asarray(depth),
                             75.0, det8)
    assert m8.x.shape == (8,)


def test_max_features_bounds_bank(scene, det_cfg):
    bgr, depth, mask = scene
    pose = np.zeros(13, np.float32)
    view = training.add_template(bgr, depth, mask, pose, det_cfg)
    b32 = pack_bank({"obj": [view]}, levels=2, modalities=2, capacity=8,
                    max_features=32)
    assert b32.feat_x.shape[-1] == 32


def test_matching_threshold_gates_candidates(bank, scene, det_cfg):
    bgr, depth, _ = scene
    lo = detector.match_bank(bank, jnp.asarray(bgr), jnp.asarray(depth),
                             75.0, det_cfg)
    hi = detector.match_bank(bank, jnp.asarray(bgr), jnp.asarray(depth),
                             100.0, det_cfg)
    assert bool(np.asarray(lo.valid).any())
    # raw > 2nf + 100%*2nf is unsatisfiable (max response = 4nf)
    assert not bool(np.asarray(hi.valid).any())


# ----------------------------------------------------------------------- icp


def _cloud_pair(n=64, seed=0, z0=600.0):
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=(n, 3)).astype(np.float32) * 20
    ref[:, 2] += z0
    ang = 0.05
    r = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    model = ref @ r.T + np.array([4.0, -2.0, 1.0], np.float32)
    mask = np.ones(n, bool)
    return (jnp.asarray(ref), jnp.asarray(model), jnp.asarray(mask))


def test_icp_max_iterations(ref_model=None):
    ref, model, mask = _cloud_pair()
    tight = dict(dist_mean_threshold=1e-9, dist_diff_threshold=1e-12)
    a = icp_mod.icp_point_to_point(
        ref, model, mask, cfg.IcpConfig(max_iterations=1, **tight))
    b = icp_mod.icp_point_to_point(
        ref, model, mask, cfg.IcpConfig(max_iterations=10, **tight))
    assert int(a.iterations) == 1 and int(b.iterations) > 1


def test_icp_dist_mean_threshold():
    ref, model, mask = _cloud_pair()
    a = icp_mod.icp_point_to_point(
        ref, model, mask, cfg.IcpConfig(dist_mean_threshold=1e9))
    assert int(a.iterations) == 0          # loop never entered


def test_icp_dist_diff_threshold():
    ref, model, mask = _cloud_pair()
    a = icp_mod.icp_point_to_point(
        ref, model, mask,
        cfg.IcpConfig(dist_mean_threshold=1e-9, dist_diff_threshold=1e30))
    b = icp_mod.icp_point_to_point(
        ref, model, mask,
        cfg.IcpConfig(dist_mean_threshold=1e-9, dist_diff_threshold=1e-12))
    assert int(a.iterations) == 1 and int(b.iterations) > 1


def test_icp_min_points():
    ref, model, _ = _cloud_pair()
    small = jnp.zeros(ref.shape[0], bool).at[:5].set(True)
    a = icp_mod.icp_point_to_point(ref, model, small,
                                   cfg.IcpConfig(min_points=3))
    b = icp_mod.icp_point_to_point(ref, model, small,
                                   cfg.IcpConfig(min_points=10))
    assert bool(a.ok) and not bool(b.ok)


def test_icp_squared_distance_gate():
    # distances land between 3*dist_mean and (3*dist_mean)^2 so the two
    # gate conventions keep different correspondence sets
    rng = np.random.default_rng(3)
    ref = rng.normal(size=(48, 3)).astype(np.float32) * 15
    ref[:, 2] += 600
    model = ref + rng.normal(size=ref.shape).astype(np.float32) * 1.2
    model[:8] += 2.3     # pair dist ~4: inside 3*mean, outside sqrt(3*mean)
    mask = jnp.ones(48, bool)
    tight = dict(dist_mean_threshold=1e-9, dist_diff_threshold=1e-12,
                 max_iterations=5)       # gate only acts from iteration 2
    a = icp_mod.icp_point_to_point(
        jnp.asarray(ref), jnp.asarray(model), mask,
        cfg.IcpConfig(squared_distance_gate=True, **tight))
    b = icp_mod.icp_point_to_point(
        jnp.asarray(ref), jnp.asarray(model), mask,
        cfg.IcpConfig(squared_distance_gate=False, **tight))
    assert not np.allclose(np.asarray(a.t), np.asarray(b.t))


def test_icp_centered_covariance():
    ref, model, mask = _cloud_pair(z0=800.0)
    a = icp_mod.icp_point_to_point(ref, model, mask,
                                   cfg.IcpConfig(max_iterations=1))
    b = icp_mod.icp_point_to_point(
        ref, model, mask,
        cfg.IcpConfig(max_iterations=1, centered_covariance=True))
    assert not np.allclose(np.asarray(a.r), np.asarray(b.r))


def test_icp_valid_depth_max_mm():
    ref, model, mask = _cloud_pair(z0=600.0)
    # half the pairs beyond the default 900mm cap
    ref = ref.at[:32, 2].add(500.0)
    model = model.at[:32, 2].add(500.0)
    a = icp_mod.icp_point_to_point(ref, model, mask, cfg.IcpConfig())
    b = icp_mod.icp_point_to_point(
        ref, model, mask, cfg.IcpConfig(valid_depth_max_mm=2000.0))
    assert not np.allclose(np.asarray(a.dist_mean), np.asarray(b.dist_mean))
    # EngineConfig exposes the same knob read-only
    e = cfg.EngineConfig(icp=cfg.IcpConfig(valid_depth_max_mm=1234.0))
    assert e.valid_depth_max_mm == 1234.0


def test_icp_mode_dispatch():
    ref, model, mask = _cloud_pair()
    # the production default is point_to_plane -> normals are required
    assert cfg.IcpConfig().mode == "point_to_plane"
    with pytest.raises(ValueError):
        icp_mod.icp_refine(ref, model, mask, cfg.IcpConfig())
    rngn = np.random.default_rng(5)
    nrm = rngn.normal(size=(ref.shape[0], 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    a = icp_mod.icp_refine(ref, model, mask,
                           cfg.IcpConfig(max_iterations=1),
                           ref_normals=jnp.asarray(nrm))
    b = icp_mod.icp_refine(ref, model, mask,
                           cfg.IcpConfig(mode="point_to_point",
                                         max_iterations=1))
    assert not np.allclose(np.asarray(a.r), np.asarray(b.r))


def test_icp_plane_degeneracy_gate():
    """Constant normals (planar scene) must flip the loop to Kabsch
    updates; forcing the gate off must change the result."""
    ref, model, mask = _cloud_pair()
    normals = jnp.tile(jnp.asarray([0.0, 0.0, 1.0]), (ref.shape[0], 1))
    gated = icp_mod.icp_point_to_plane(
        ref, normals, model, mask, cfg.IcpConfig(max_iterations=1))
    forced = icp_mod.icp_point_to_plane(
        ref, normals, model, mask,
        cfg.IcpConfig(max_iterations=1, plane_min_normal_anisotropy=-1.0))
    point = icp_mod.icp_point_to_point(
        ref, model, mask, cfg.IcpConfig(max_iterations=1))
    # the gated run selects Kabsch -> matches the point mode's alignment
    np.testing.assert_allclose(np.asarray(gated.r), np.asarray(point.r),
                               atol=1e-4)
    assert not np.allclose(np.asarray(forced.r), np.asarray(gated.r))


def test_icp_plane_damping():
    ref, model, mask = _cloud_pair()
    rngn = np.random.default_rng(5)
    nrm = rngn.normal(size=(ref.shape[0], 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    a = icp_mod.icp_point_to_plane(
        ref, jnp.asarray(nrm), model, mask,
        cfg.IcpConfig(max_iterations=1))
    b = icp_mod.icp_point_to_plane(
        ref, jnp.asarray(nrm), model, mask,
        cfg.IcpConfig(max_iterations=1, plane_damping=10.0))
    assert not np.allclose(np.asarray(a.t), np.asarray(b.t))


def test_icp_plane_point_blend():
    ref, model, mask = _cloud_pair()
    rngn = np.random.default_rng(5)
    nrm = rngn.normal(size=(ref.shape[0], 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    a = icp_mod.icp_point_to_plane(
        ref, jnp.asarray(nrm), model, mask,
        cfg.IcpConfig(max_iterations=1, plane_point_blend=0.0))
    b = icp_mod.icp_point_to_plane(
        ref, jnp.asarray(nrm), model, mask,
        cfg.IcpConfig(max_iterations=1, plane_point_blend=5.0))
    assert not np.allclose(np.asarray(a.t), np.asarray(b.t))


def test_icp_max_points_caps_refine_pairs(scene):
    from fealess import pipeline

    _, depth, _ = scene
    k = jnp.asarray([[608.0, 0, 120], [0, 608.0, 80], [0, 0, 1]],
                    jnp.float32)
    eng_a = cfg.EngineConfig(icp=cfg.IcpConfig(max_points=64))
    eng_b = cfg.EngineConfig(icp=cfg.IcpConfig(max_points=16384))
    args = (jnp.asarray(depth), k, jnp.asarray(depth), k,
            90, 60, 80, 48, 80, 48,
            jnp.eye(3), jnp.zeros(3))
    a = pipeline.refine_match(*args, eng_a, crop_h=96, crop_w=96)
    b = pipeline.refine_match(*args, eng_b, crop_h=96, crop_w=96)
    assert int(a.n_pairs) == 64
    assert int(b.n_pairs) > 64


# ---------------------------------------------------------------- engine/nms

def test_nms_object_distance():
    t = jnp.asarray([[0.0, 0, 600], [30.0, 0, 600]])
    dist = jnp.asarray([0.5, 0.4])
    npts = jnp.asarray([100, 100])
    valid = jnp.ones(2, bool)
    wide = nms_mod.nms_3d(t, dist, npts, valid, 50.0)
    tight = nms_mod.nms_3d(t, dist, npts, valid, 10.0)
    assert int(np.asarray(wide.keep).sum()) == 1
    assert int(np.asarray(tight.keep).sum()) == 2
