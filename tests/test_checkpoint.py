"""Bank checkpoint round-trips: orbax pytree checkpoint, YAML interop,
and restore-equality of every array field."""

import dataclasses

import numpy as np
import pytest

from fealess import config as cfg
from fealess.io import checkpoint
from tests.test_match_e2e import det_cfg, scene, trained  # noqa: F401


@pytest.fixture()
def packed(trained, det_cfg):  # noqa: F811
    from fealess.bank import pack_bank
    return pack_bank({"obj": [trained]}, levels=det_cfg.pyramid_levels,
                     capacity=4, max_features=63)


def test_bank_checkpoint_roundtrip(tmp_path, packed, det_cfg):  # noqa: F811
    d = str(tmp_path / "ckpt")
    checkpoint.save_bank(d, packed, det_cfg)
    restored, det2 = checkpoint.load_bank(d)
    assert det2 == det_cfg
    assert restored.class_names == packed.class_names
    for f in dataclasses.fields(packed):
        if f.name == "class_names":
            continue
        np.testing.assert_array_equal(
            np.asarray(getattr(restored, f.name)),
            np.asarray(getattr(packed, f.name)), err_msg=f.name)


def test_yaml_interop(tmp_path, packed, det_cfg):  # noqa: F811
    yml = str(tmp_path / "bank.yml")
    checkpoint.export_yaml(yml, packed, det_cfg)
    bank2, det2 = checkpoint.import_yaml(yml, capacity=4)
    assert det2.t_at_level == det_cfg.t_at_level
    np.testing.assert_array_equal(np.asarray(bank2.feat_x[:1]),
                                  np.asarray(packed.feat_x[:1]))
    np.testing.assert_array_equal(np.asarray(bank2.pose[:1]),
                                  np.asarray(packed.pose[:1]))


def test_stage_timer_report():
    import time

    from fealess.utils.profiling import StageTimer
    t = StageTimer()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("a"):
        pass
    t.add("b", 0.5)
    stats = t.stats()
    assert stats["a"].calls == 2
    assert stats["a"].total_s >= 0.01
    assert stats["b"].mean_ms == 500.0
    rep = t.report()
    assert "a" in rep and "b" in rep
