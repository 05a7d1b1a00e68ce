"""Multi-object recognition: two instances of a trained object in one
frame -> two NMS-surviving poses at the right translations (the
detection()+NMS multi-candidate design, ICP/NMS.cpp:6-40, which the
reference engine exposes only as top-1)."""

import numpy as np

from fealess.engine import CamIntrinsics
from tests.test_engine import FX, FY, CX, CY, _engine, feature_dir  # noqa: F401
from tests.test_match_e2e import H, W


def _two_instance_scene(rng, bgr, depth):
    """Paste the trained object block (from make_scene: bbox x80:176,
    y48:112) at two non-overlapping locations on a fresh background."""
    tex = bgr[48:112, 80:176].copy()
    dep = depth[48:112, 80:176].copy()
    out_bgr = np.full((H, W, 3), 40, np.uint8)
    out_bgr += rng.integers(0, 12, size=out_bgr.shape, dtype=np.uint8)
    out_depth = np.full((H, W), 1200, np.uint16)
    spots = [(16, 16), (128, 88)]          # (x0, y0), boxes don't overlap
    for x0, y0 in spots:
        out_bgr[y0:y0 + 64, x0:x0 + 96] = tex
        out_depth[y0:y0 + 64, x0:x0 + 96] = dep
    return out_bgr, out_depth, spots


def test_two_instances_survive_nms(feature_dir):  # noqa: F811
    eng = _engine(feature_dir)
    _, (bgr, depth, mask), _ = feature_dir
    rng = np.random.default_rng(3)
    scene_bgr, scene_depth, spots = _two_instance_scene(rng, bgr, depth)
    cam = CamIntrinsics(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H)
    results = eng.recognition_multi(scene_bgr, scene_depth, cam,
                                    max_objects=4)
    assert len(results) == 2, [r.similarity for r in results]
    z = float(depth[mask].mean())
    # template was trained at (80, 48); expected per-instance translation
    expected = [np.array([(x0 - 80) * z / FX, (y0 - 48) * z / FY, 0.0])
                for x0, y0 in spots]
    got = sorted([r.world2cam[:3, 3] for r in results],
                 key=lambda t: t[0])
    expected = sorted(expected, key=lambda t: t[0])
    for g, e in zip(got, expected):
        assert np.linalg.norm(g - e) < 20.0, (g, e)
    for r in results:
        assert r.obj_tag == "obj"
        assert r.similarity >= 90.0


def test_single_instance_multi_returns_one(feature_dir):  # noqa: F811
    """On the training frame the multi path must NMS-collapse duplicate
    candidates to a single result matching the top-1 path."""
    eng = _engine(feature_dir)
    _, (bgr, depth, _), _ = feature_dir
    cam = CamIntrinsics(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H)
    multi = eng.recognition_multi(bgr, depth, cam, max_objects=4)
    assert len(multi) == 1
    top1 = eng.recognition(bgr, depth, cam)
    np.testing.assert_allclose(multi[0].world2cam, top1[0].world2cam,
                               atol=5.0)


def test_multi_no_per_frame_model_depth_upload(feature_dir, monkeypatch):  # noqa: F811
    """recognition_multi must ride the device-resident model-depth stack
    uploaded once at add_obj — not re-upload it per frame (~134 MB/frame
    at 1024 templates; VERDICT r3 #2).  Spy on the engine module's
    jnp.asarray: no call may see the (N, crop, crop) stack."""
    import fealess.engine as engine_mod

    eng = _engine(feature_dir)
    _, (bgr, depth, _), _ = feature_dir
    cam = CamIntrinsics(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H)
    stack_shape = eng._model_depth.shape
    real_jnp = engine_mod.jnp
    uploaded = []

    class _Spy:
        def asarray(self, x, *a, **k):
            if np.shape(x) == stack_shape:
                uploaded.append(np.shape(x))
            return real_jnp.asarray(x, *a, **k)

        def __getattr__(self, name):
            return getattr(real_jnp, name)

    monkeypatch.setattr(engine_mod, "jnp", _Spy())
    assert eng.recognition_multi(bgr, depth, cam, max_objects=4)
    assert eng.recognition(bgr, depth, cam)
    assert not uploaded, f"model-depth stack re-uploaded: {uploaded}"


def test_empty_scene_multi(feature_dir):  # noqa: F811
    eng = _engine(feature_dir)
    cam = CamIntrinsics(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H)
    blank_bgr = np.full((H, W, 3), 40, np.uint8)
    blank_depth = np.full((H, W), 1200, np.uint16)
    assert eng.recognition_multi(blank_bgr, blank_depth, cam) == []


def test_multi_tracked_recognizer(feature_dir):  # noqa: F811
    """N-object gated tracking: both pasted instances stay tracked and
    recognized across a panning sequence (per-size-bucket vmapped KCF +
    one union-masked recognition_multi per frame)."""
    from fealess.apps.track import MultiTrackedRecognizer

    eng = _engine(feature_dir)
    _, (bgr, depth, mask), _ = feature_dir
    rng = np.random.default_rng(3)
    scene_bgr, scene_depth, spots = _two_instance_scene(rng, bgr, depth)
    cam = CamIntrinsics(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H)

    mt = MultiTrackedRecognizer(eng, max_objects=4)
    step0 = mt.step(scene_bgr, scene_depth, cam)
    assert step0.redetected and step0.n_tracked == 2
    assert len(step0.results) == 2

    for i in range(1, 4):
        sb = np.roll(np.roll(scene_bgr, 2 * i, axis=1), i, axis=0)
        sd = np.roll(np.roll(scene_depth, 2 * i, axis=1), i, axis=0)
        step = mt.step(sb, sd, cam)
        assert not step.redetected, i
        assert step.n_tracked == 2, i
        assert len(step.results) == 2, i
        # tracked ROIs follow the pan
        for roi in step.rois:
            assert 0 <= roi[0] < W and 0 <= roi[1] < H

    # objects share one geometry bucket -> a single shared tracker
    assert len(mt._trackers) == 1
