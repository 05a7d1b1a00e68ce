"""End-to-end detector test: train a template on a synthetic RGB-D view,
match the same frame, expect ~100% similarity at the object location
(property (b) of SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from fealess import config as cfg
from fealess import detector, training
from fealess.bank import pack_bank

H, W = 160, 240  # divisible by 5 (level-0 T) and 16 (level-1 T=8 after /2)


def make_scene(rng):
    """A textured box on a flat background, in color and depth."""
    bgr = np.full((H, W, 3), 40, np.uint8)
    bgr += rng.integers(0, 12, size=bgr.shape, dtype=np.uint8)
    # textured object
    ys, xs = slice(48, 112), slice(80, 176)
    yy, xx = np.mgrid[48:112, 80:176]
    tex = (128 + 90 * np.sin(xx / 6.0) * np.cos(yy / 5.0)).astype(np.uint8)
    bgr[ys, xs, 0] = tex
    bgr[ys, xs, 1] = 255 - tex
    bgr[ys, xs, 2] = 200

    depth = np.full((H, W), 1200, np.uint16)
    yy2, xx2 = np.mgrid[0:64, 0:96].astype(np.float32)
    depth[ys, xs] = (700 + 0.8 * xx2 + 0.5 * yy2).astype(np.uint16)

    mask = np.zeros((H, W), bool)
    mask[ys, xs] = True
    return bgr, depth, mask


@pytest.fixture(scope="module")
def scene():
    return make_scene(np.random.default_rng(7))


@pytest.fixture(scope="module")
def det_cfg():
    return cfg.DetectorConfig(image_width=W, image_height=H,
                              max_candidates=16)


@pytest.fixture(scope="module")
def trained(scene, det_cfg):
    bgr, depth, mask = scene
    pose = np.arange(13, dtype=np.float32)
    view = training.add_template(bgr, depth, mask, pose, det_cfg)
    assert view is not None, "template extraction failed"
    return view


def test_template_extraction_counts(trained, det_cfg):
    v = trained
    assert len(v.features) == det_cfg.pyramid_levels
    assert len(v.features[0][0]) == det_cfg.color_gradient.num_features
    assert len(v.features[0][1]) == det_cfg.depth_normal.num_features
    assert len(v.features[1][0]) == det_cfg.color_gradient.num_features // 2
    # post-crop coordinates are non-negative and inside the bbox
    for l in range(2):
        for m in range(2):
            f = v.features[l][m]
            assert (f[:, 0] >= 0).all() and (f[:, 0] <= v.width[l]).all()
            assert (f[:, 1] >= 0).all() and (f[:, 1] <= v.height[l]).all()
            assert (f[:, 2] >= 0).all() and (f[:, 2] < 8).all()


def test_self_match_near_perfect(scene, det_cfg, trained):
    bgr, depth, mask = scene
    bank = pack_bank({"obj": [trained]}, levels=det_cfg.pyramid_levels)
    m = detector.match_bank(bank, jnp.asarray(bgr), jnp.asarray(depth),
                            75.0, det_cfg)
    valid = np.asarray(m.valid)
    assert valid.any(), "no matches found on the training frame"
    sim = np.asarray(m.similarity)
    x = np.asarray(m.x)
    y = np.asarray(m.y)
    # Best match: high similarity at the template's level-0 bbox origin.
    assert sim[0] >= 95.0, f"top similarity {sim[0]}"
    assert abs(int(x[0]) - trained.offset_x[0]) <= det_cfg.t_at_level[0]
    assert abs(int(y[0]) - trained.offset_y[0]) <= det_cfg.t_at_level[0]


def test_no_match_on_blank_scene(det_cfg, trained):
    bank = pack_bank({"obj": [trained]}, levels=det_cfg.pyramid_levels)
    blank_bgr = np.full((H, W, 3), 40, np.uint8)
    blank_depth = np.full((H, W), 1200, np.uint16)
    m = detector.match_bank(bank, jnp.asarray(blank_bgr),
                            jnp.asarray(blank_depth), 75.0, det_cfg)
    assert not np.asarray(m.valid).any()


def test_match_wide_image_right_edge():
    """A processing width beyond the 640 contract (level-0 Wd = 160 >
    128 lanes) must match correctly — the local scorer falls back to its
    width-agnostic path (ADVICE r3) — including an object flush against
    the right image border (right-edge window reads)."""
    wh, ww = 320, 800                  # div by 5 and by 16 (level-1 T=8)
    rng2 = np.random.default_rng(11)
    bgr = np.full((wh, ww, 3), 40, np.uint8)
    bgr += rng2.integers(0, 12, size=bgr.shape, dtype=np.uint8)
    ys, xs = slice(128, 192), slice(ww - 100, ww - 4)
    yy, xx = np.mgrid[ys, xs]
    tex = (128 + 90 * np.sin(xx / 6.0) * np.cos(yy / 5.0)).astype(np.uint8)
    bgr[ys, xs, 0] = tex
    bgr[ys, xs, 1] = 255 - tex
    bgr[ys, xs, 2] = 200
    depth = np.full((wh, ww), 1200, np.uint16)
    yy2, xx2 = np.mgrid[0:64, 0:96].astype(np.float32)
    depth[ys, xs] = (700 + 0.8 * xx2 + 0.5 * yy2).astype(np.uint16)
    mask = np.zeros((wh, ww), bool)
    mask[ys, xs] = True

    dcfg = cfg.DetectorConfig(image_width=ww, image_height=wh,
                              max_candidates=16)
    view = training.add_template(bgr, depth, mask,
                                 np.arange(13, dtype=np.float32), dcfg)
    assert view is not None
    bank = pack_bank({"obj": [view]}, levels=dcfg.pyramid_levels)
    m = detector.match_bank(bank, jnp.asarray(bgr), jnp.asarray(depth),
                            75.0, dcfg)
    assert np.asarray(m.valid).any()
    assert np.asarray(m.similarity)[0] >= 95.0
    assert abs(int(np.asarray(m.x)[0]) - view.offset_x[0]) <= \
        dcfg.t_at_level[0]
    assert abs(int(np.asarray(m.y)[0]) - view.offset_y[0]) <= \
        dcfg.t_at_level[0]


def test_match_translated_object(scene, det_cfg, trained):
    """Shift the whole scene; the match position must shift with it."""
    bgr, depth, mask = scene
    dx, dy = 20, 10
    bgr2 = np.roll(np.roll(bgr, dy, axis=0), dx, axis=1)
    depth2 = np.roll(np.roll(depth, dy, axis=0), dx, axis=1)
    bank = pack_bank({"obj": [trained]}, levels=det_cfg.pyramid_levels)
    m = detector.match_bank(bank, jnp.asarray(bgr2), jnp.asarray(depth2),
                            75.0, det_cfg)
    assert np.asarray(m.valid).any()
    assert np.asarray(m.similarity)[0] >= 90.0
    assert abs(int(np.asarray(m.x)[0]) - (trained.offset_x[0] + dx)) <= \
        det_cfg.t_at_level[0]
    assert abs(int(np.asarray(m.y)[0]) - (trained.offset_y[0] + dy)) <= \
        det_cfg.t_at_level[0]


def test_roi_box_gates_candidates(trained, scene, det_cfg):
    """Positional search gate (detector roi_box): a box containing the
    object reproduces the ungated match; a box away from it kills every
    candidate (the tracked pipeline's cheap gate)."""
    import jax.numpy as jnp
    from fealess.bank import pack_bank

    bgr, depth, mask = scene
    bank = pack_bank({"obj": [trained]}, levels=det_cfg.pyramid_levels,
                     capacity=8)
    free = detector.match_bank(bank, jnp.asarray(bgr), jnp.asarray(depth),
                               75.0, det_cfg)
    assert bool(np.asarray(free.valid).any())

    inside = detector.match_bank(
        bank, jnp.asarray(bgr), jnp.asarray(depth), 75.0, det_cfg,
        roi_box=jnp.asarray([60.0, 30.0, 200.0, 130.0]))
    fi_, ii = int(np.argmax(np.asarray(free.valid))), int(
        np.argmax(np.asarray(inside.valid)))
    assert int(inside.x[ii]) == int(free.x[fi_])
    assert float(inside.similarity[ii]) == float(free.similarity[fi_])

    away = detector.match_bank(
        bank, jnp.asarray(bgr), jnp.asarray(depth), 75.0, det_cfg,
        roi_box=jnp.asarray([0.0, 0.0, 30.0, 20.0]))
    assert not bool(np.asarray(away.valid).any())
