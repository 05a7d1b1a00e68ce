"""Serving artifact (the Android-.so analog): export -> fresh load ->
identical recognition results, plus a measured cold-start comparison
between YAML add_obj and the artifact path.  Both artifact formats are
covered: jax.export's own serialization (with flatbuffers) and the
StableHLO module + signature written where flatbuffers is missing.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from fealess.engine import CamIntrinsics
from fealess.io import export
from fealess.io.export import ServingArtifact
from tests.test_engine import FX, FY, CX, CY, _engine, feature_dir  # noqa: F401
from tests.test_match_e2e import H, W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def engine(feature_dir):  # noqa: F811
    return _engine(feature_dir)


@pytest.fixture(scope="module", params=["serialized", "module"])
def artifact_dir(request, engine, tmp_path_factory):
    """An exported artifact in each format; "module" is what a machine
    without flatbuffers writes."""
    out = str(tmp_path_factory.mktemp(f"artifact_{request.param}"))
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "module":
            mp.setattr(export, "_serialized", lambda exported: None)
        engine.export_artifact(out)
    return out, engine


def test_artifact_roundtrip_results(artifact_dir, feature_dir):  # noqa: F811
    out, eng = artifact_dir
    _, (bgr, depth, _), _ = feature_dir
    cam = CamIntrinsics(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H)
    ref = eng.recognition(bgr, depth, cam)
    art = ServingArtifact(out)
    got = art.recognition(bgr, depth, cam)
    assert len(got) == len(ref) == 1
    assert got[0].obj_tag == ref[0].obj_tag
    assert got[0].similarity == pytest.approx(ref[0].similarity)
    np.testing.assert_allclose(got[0].world2cam, ref[0].world2cam,
                               rtol=1e-5, atol=1e-4)
    assert got[0].match_rect == ref[0].match_rect


def test_artifact_files(artifact_dir):
    out, _ = artifact_dir
    for f in ("recognition.jaxexport", "state.npz", "meta.json"):
        assert os.path.exists(os.path.join(out, f)), f
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["version"] in ("fealess-artifact-1", "fealess-artifact-2")
    assert ("exported" in meta) == (meta["version"] == "fealess-artifact-2")
    assert meta["class_names"] == ["obj"]


def test_artifact_cold_start_beats_add_obj(artifact_dir, feature_dir,  # noqa: F811
                                           tmp_path):
    """Fresh-process cold start to a READY (lowered / deserialized)
    Recognition program: the artifact must beat YAML add_obj + jit
    trace/lower.  Readiness is the right boundary here: the XLA backend
    compile below it is identical StableHLO for both paths, and this
    image's XLA:CPU AOT loader segfaults EXECUTING any cross-process
    deserialized module (verified with a trivial export).  On a GPU,
    chip_smoke.py exports, loads and serves the artifact in one
    process."""
    out, _ = artifact_dir
    path, (bgr, depth, _), _ = feature_dir

    common = """
import time, json
t0 = time.perf_counter()
import jax
jax.config.update("jax_platforms", "cpu")
"""
    engine_script = common + f"""
import jax.numpy as jnp
from fealess import config as cfg, pipeline
from fealess.engine import ObjReco
ecfg = cfg.EngineConfig(
    detector=cfg.DetectorConfig(image_width={W}, image_height={H},
                                max_candidates=16),
    template_fx={FX}, template_fy={FY}, template_cx={CX},
    template_cy={CY}, refine_crop=128)
eng = ObjReco.create("LmICP", ecfg)
eng.add_obj({path!r})
d = eng.cfg.detector
lowered = pipeline.recognize_top1_jit.lower(
    eng.bank, eng._model_depth_dev, eng._origins_dev,
    jnp.zeros((d.image_height, d.image_width, 3), jnp.uint8),
    jnp.zeros((d.image_height, d.image_width), jnp.uint16),
    jnp.zeros((3, 3), jnp.float32), eng.cfg, kernels=eng._kernels)
assert lowered is not None
print(json.dumps({{"ready_s": time.perf_counter() - t0}}))
"""
    artifact_script = common + f"""
from fealess.io.export import ServingArtifact
art = ServingArtifact({out!r})
assert art._call is not None
print(json.dumps({{"ready_s": time.perf_counter() - t0}}))
"""

    def run(script):
        p = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        return json.loads(p.stdout.strip().splitlines()[-1])

    eng_cold = run(engine_script)
    art_cold = run(artifact_script)
    assert art_cold["ready_s"] < eng_cold["ready_s"], (art_cold, eng_cold)
    print(f"cold start to ready program: engine {eng_cold['ready_s']:.2f}s"
          f" vs artifact {art_cold['ready_s']:.2f}s")


def test_artifact_refuses_other_jax_version(artifact_dir, tmp_path):
    """The step holds a Triton call that jax.export does not keep stable
    across versions, so an artifact from another JAX version is refused."""
    import shutil

    out, _ = artifact_dir
    copy = str(tmp_path / "other")
    shutil.copytree(out, copy)
    meta_path = os.path.join(copy, "meta.json")
    meta = json.load(open(meta_path))
    meta["jax_version"] = "0.0.1"
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(IOError, match="written by JAX 0.0.1"):
        ServingArtifact(copy)


def test_module_format_rebuilds_what_deserialize_gives():
    """The module format's rebuilt Exported equals jax.export's own
    deserialization field by field and computes the same; a JAX upgrade
    that changes the Exported fields fails here."""
    import jax
    import jax.numpy as jnp
    from jax import export as jexport

    def step(state, x):
        return {"y": state["a"] @ x + state["b"], "n": jnp.sum(x > 0)}

    args = ({"a": jnp.arange(12.0).reshape(3, 4), "b": jnp.ones(3)},
            jnp.linspace(-1.0, 1.0, 4))
    exp = jexport.export(jax.jit(step), disabled_checks=[
        jexport.DisabledSafetyCheck.custom_call(export._TRITON_CALL)])(*args)
    want = jexport.deserialize(exp.serialize())
    got = export._exported_from_meta(export._exported_to_meta(exp),
                                     exp.mlir_module_serialized)
    for field in ("fun_name", "in_tree", "out_tree", "in_avals",
                  "out_avals", "in_shardings_hlo", "out_shardings_hlo",
                  "nr_devices", "platforms", "ordered_effects",
                  "unordered_effects", "disabled_safety_checks",
                  "mlir_module_serialized", "calling_convention_version",
                  "module_kept_var_idx", "uses_global_constants"):
        assert getattr(got, field) == getattr(want, field), field
    out_got, out_want = got.call(*args), want.call(*args)
    np.testing.assert_array_equal(out_got["y"], out_want["y"])
    assert int(out_got["n"]) == int(out_want["n"]) == 2
