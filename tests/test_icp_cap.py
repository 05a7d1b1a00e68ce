"""ICP point-budget truncation impact (VERDICT r2 weak #7).

A 192x160-px rect back-projects ~30k valid pairs; refine_match compacts
them to ``IcpConfig.max_points`` in raster order (spatially biased to the
rect top).  This bounds the pose drift that truncation introduces on a
fixture-scale refine: 4k / 16k budgets must agree with the untruncated
solve to sub-degree / sub-mm."""

import numpy as np
import jax.numpy as jnp
import pytest

from fealess import config as cfg
from fealess import pipeline

W, H = 640, 480
FX = FY = 608.0
CX, CY = 320.0, 240.0


def _scene(rng, dx=0, dy=0):
    depth = np.full((H, W), 1200, np.uint16)
    ys, xs = slice(160 + dy, 320 + dy), slice(240 + dx, 432 + dx)
    yy2, xx2 = np.mgrid[0:160, 0:192].astype(np.float32)
    bump = 25.0 * np.sin(xx2 / 23.0) * np.cos(yy2 / 17.0)
    depth[ys, xs] = (700 + 0.4 * xx2 + 0.3 * yy2 + bump).astype(np.uint16)
    return depth


def _refine(max_points, scene, model, rng):
    ecfg = cfg.EngineConfig(
        icp=cfg.IcpConfig(max_points=max_points),
        template_fx=FX, template_fy=FY, template_cx=CX, template_cy=CY)
    k = jnp.asarray([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], jnp.float32)
    r_match = jnp.eye(3)
    t_match = jnp.zeros(3)
    return pipeline.refine_match(
        jnp.asarray(scene), k, jnp.asarray(model), k,
        192, 160, 240, 160, 243, 162, r_match, t_match, ecfg,
        crop_h=256, crop_w=256)


def _pose_diff(a, b):
    c = (np.trace(np.asarray(a.r).T @ np.asarray(b.r)) - 1) / 2
    rot = np.degrees(np.arccos(np.clip(c, -1, 1)))
    trans = np.linalg.norm(np.asarray(a.t) - np.asarray(b.t))
    return rot, trans


@pytest.mark.parametrize("budget,rot_tol,trans_tol", [
    (16384, 0.2, 1.0),
    (4096, 0.5, 2.0),
])
def test_truncation_drift_bounded(budget, rot_tol, trans_tol):
    rng = np.random.default_rng(0)
    model = _scene(rng)
    scene = _scene(rng, dx=3, dy=2)

    full = _refine(256 * 256, scene, model, rng)     # no truncation
    assert bool(full.icp.ok)
    assert int(full.n_pairs) > 25000, int(full.n_pairs)

    capped = _refine(budget, scene, model, rng)
    assert bool(capped.icp.ok)
    rot, trans = _pose_diff(full, capped)
    assert rot < rot_tol, (budget, rot)
    assert trans < trans_tol, (budget, trans)
