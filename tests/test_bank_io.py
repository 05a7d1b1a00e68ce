"""Template bank packing and reference-schema YAML round-trips."""

import numpy as np
import pytest

from fealess import config as cfg
from fealess.bank import TemplateView, pack_bank, unpack_bank
from fealess.io import linemod_yaml


def _view(rng, levels=2, nf=(10, 5)):
    feats = [[rng.integers(0, 40, size=(nf[l], 3)).astype(np.int32) % [40, 40, 8]
              for _ in range(2)] for l in range(levels)]
    return TemplateView(features=feats,
                        width=[38, 19], height=[30, 15],
                        offset_x=[100, 50], offset_y=[60, 30],
                        pose=rng.normal(size=13).astype(np.float32))


def test_pack_unpack_roundtrip(rng):
    classes = {"cup": [_view(rng), _view(rng)], "box": [_view(rng)]}
    bank = pack_bank(classes, levels=2, capacity=8)
    assert bank.num_templates == 3
    assert bank.class_names == ("box", "cup")
    out = unpack_bank(bank)
    for cname in classes:
        assert len(out[cname]) == len(classes[cname])
        for v1, v2 in zip(classes[cname], out[cname]):
            np.testing.assert_allclose(v2.pose, v1.pose)
            assert list(v2.width) == list(v1.width)
            for l in range(2):
                for m in range(2):
                    np.testing.assert_array_equal(v2.features[l][m],
                                                  v1.features[l][m])


def test_yaml_roundtrip(rng, tmp_path):
    det = cfg.DetectorConfig()
    classes = {"cup": [_view(rng)], "box": [_view(rng), _view(rng)]}
    path = str(tmp_path / "linemod_templates.yml")
    linemod_yaml.save_linemod(path, det, classes)
    det2, classes2 = linemod_yaml.load_linemod(path)
    assert det2.t_at_level == det.t_at_level
    assert det2.color_gradient == det.color_gradient
    assert det2.depth_normal == det.depth_normal
    assert set(classes2) == set(classes)
    for cname in classes:
        for v1, v2 in zip(classes[cname], classes2[cname]):
            np.testing.assert_allclose(v2.pose, v1.pose, rtol=1e-6)
            assert list(v2.width) == list(v1.width)
            assert list(v2.offset_x) == list(v1.offset_x)
            for l in range(2):
                for m in range(2):
                    np.testing.assert_array_equal(v2.features[l][m],
                                                  v1.features[l][m])


def test_capacity_overflow(rng):
    with pytest.raises(ValueError):
        pack_bank({"a": [_view(rng), _view(rng)]}, levels=2, capacity=1)


def test_view_from_features_synthetic_template(rng, tmp_path):
    """addSyntheticTemplate equivalent (linemod.hpp:349): a hand-built
    TemplateView from external features validates, YAML round-trips, and
    self-matches when its features describe a real scene."""
    from fealess import detector, training
    from fealess.bank import view_from_features
    from tests.test_match_e2e import make_scene, H, W
    import jax.numpy as jnp

    det_cfg = cfg.DetectorConfig(image_width=W, image_height=H,
                                 max_candidates=16)
    bgr, depth, mask = make_scene(np.random.default_rng(7))
    trained = training.add_template(bgr, depth, mask,
                                    np.arange(13, dtype=np.float32), det_cfg)
    # Rebuild the trained view through the synthetic entry point from its
    # raw feature arrays (as an external rendering pipeline would).
    synth = view_from_features(
        [[np.asarray(fm) for fm in fl] for fl in trained.features],
        trained.width, trained.height, trained.offset_x, trained.offset_y,
        trained.pose)

    path = str(tmp_path / "linemod_templates.yml")
    linemod_yaml.save_linemod(path, det_cfg, {"synth": [synth]})
    _, loaded = linemod_yaml.load_linemod(path)
    for l in range(2):
        for m in range(2):
            np.testing.assert_array_equal(loaded["synth"][0].features[l][m],
                                          synth.features[l][m])

    bank = pack_bank({"synth": [synth]}, levels=det_cfg.pyramid_levels)
    m = detector.match_bank(bank, jnp.asarray(bgr), jnp.asarray(depth),
                            75.0, det_cfg)
    assert np.asarray(m.valid).any()
    assert np.asarray(m.similarity)[0] >= 95.0


def test_view_from_features_validates(rng):
    from fealess.bank import view_from_features

    good = [[np.array([[1, 2, 3]], np.int32)] * 2] * 2
    view_from_features(good, [38, 19], [30, 15], [0, 0], [0, 0],
                       np.zeros(13))
    bad_label = [[np.array([[1, 2, 9]], np.int32)] * 2] * 2
    with pytest.raises(ValueError):
        view_from_features(bad_label, [38, 19], [30, 15], [0, 0], [0, 0],
                           np.zeros(13))
    bad_coord = [[np.array([[45, 2, 3]], np.int32)] * 2] * 2
    with pytest.raises(ValueError):
        view_from_features(bad_coord, [38, 19], [30, 15], [0, 0], [0, 0],
                           np.zeros(13))
    with pytest.raises(ValueError):
        view_from_features(good, [38], [30, 15], [0, 0], [0, 0],
                           np.zeros(13))
