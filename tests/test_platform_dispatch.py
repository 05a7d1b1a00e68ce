"""Per-platform dispatch of the recognition step, and what the main path
may import.

The coarse scorer is the one hand-written kernel on the served path: a
CUDA lowering of the fused step must hold its Triton call beside CUDA
library calls only, and a CPU lowering LAPACK calls only.
"""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fealess import config as cfg
from fealess import detector, pipeline
from fealess.bank import TemplateBank
from fealess.ops import score_pallas

TRITON_CALL = "__gpu$xla.gpu.triton"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _step_args(n=8):
    ecfg = cfg.EngineConfig()
    d = ecfg.detector
    shape = (n, d.pyramid_levels, 2, d.max_features)
    rng = np.random.default_rng(0)
    bank = TemplateBank(
        feat_x=jnp.asarray(rng.integers(0, 96, shape), jnp.int32),
        feat_y=jnp.asarray(rng.integers(0, 96, shape), jnp.int32),
        feat_label=jnp.asarray(rng.integers(0, 8, shape), jnp.int32),
        feat_valid=jnp.ones(shape, bool),
        width=jnp.full((n, d.pyramid_levels), 96, jnp.int32),
        height=jnp.full((n, d.pyramid_levels), 96, jnp.int32),
        offset_x=jnp.zeros((n, d.pyramid_levels), jnp.int32),
        offset_y=jnp.zeros((n, d.pyramid_levels), jnp.int32),
        pose=jnp.zeros((n, 13), jnp.float32),
        class_idx=jnp.zeros((n,), jnp.int32),
        template_idx=jnp.arange(n, dtype=jnp.int32),
        valid=jnp.ones((n,), bool), class_names=("obj",), max_span=97)
    crop = ecfg.refine_crop
    return ecfg, (bank,
                  jnp.zeros((n, crop, crop), jnp.uint16),
                  jnp.zeros((n, 2), jnp.int32),
                  jnp.zeros((d.image_height, d.image_width, 3), jnp.uint8),
                  jnp.zeros((d.image_height, d.image_width), jnp.uint16),
                  jnp.eye(3, dtype=jnp.float32),
                  detector.build_match_tables(bank, d))


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_recognition_step_lowering_per_platform(platform):
    ecfg, args = _step_args()

    def step(bank, md, org, bgr, depth, k, tables):
        return pipeline.recognize_top1(bank, md, org, bgr, depth, k, ecfg,
                                       kernels=tables)

    text = jax.jit(step).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()
    targets = set(re.findall(r"stablehlo.custom_call @([\w$.]+)", text))
    if platform == "cuda":
        assert TRITON_CALL in targets
        assert all(t.startswith("cu") for t in targets - {TRITON_CALL})
    else:
        assert targets and all(t.startswith("lapack_") for t in targets)


def test_engine_imports_without_cv2_and_flax():
    """The served path needs neither OpenCV nor flax: import the engine
    in a child process where both imports fail."""
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("cv2", "flax"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import fealess.engine
        import fealess.io.export
        import fealess.tracker.kcf
        import fealess.parallel.batch_recon
        assert "cv2" not in sys.modules and "flax" not in sys.modules
        print("ok")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.gpu
def test_coarse_kernel_on_gpu_equals_cpu_plain(gpu):
    """The compiled Triton coarse kernel on the card equals the plain
    scorer committed to the CPU device, at the 640x480 coarse grid."""
    rng = np.random.default_rng(1)
    ecfg, args = _step_args(n=64)
    bank, tables = args[0], args[-1]
    planes = rng.integers(0, 5, (2 * 8 * 64, 30, 40)).astype(np.uint8)
    cpu = jax.devices("cpu")[0]
    want = jax.jit(score_pallas.coarse_scores)(
        jax.device_put(planes, cpu), jax.device_put(tables[1], cpu))
    got = jax.jit(score_pallas.coarse_scores)(
        jax.device_put(planes, gpu), jax.device_put(tables[1], gpu))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
