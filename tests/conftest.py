"""Test configuration: run on CPU with 8 virtual devices.

Mirrors the reference's absence of any accelerator requirement for
correctness (the reference is CPU-only C++) while letting every collective
in fealess.parallel run on a virtual 8-device mesh — the standard JAX
analog of a fake backend (SURVEY.md §4d).

``JAX_PLATFORMS`` defaults to ``cpu``.  Tests marked ``gpu`` need a CUDA
device and run on a GPU machine with ``JAX_PLATFORMS=cuda,cpu python -m
pytest -m gpu tests/``; elsewhere they skip (the ``gpu`` fixture decides).

Must run before jax is imported anywhere, hence the env mutation at module
import time (pytest imports conftest first).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# A pytest plugin (jaxtyping) imports jax BEFORE this conftest, freezing
# jax_platforms from the pre-existing env; override the live config too.
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Persistent compilation cache: the suite is XLA-compile-bound; warm
# re-runs skip every big compile.  JAX_COMPILATION_CACHE_DIR, when set,
# names the directory (jax reads it itself); otherwise <checkout>/.jax_cache.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", ".jax_cache")))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.15)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_DIR = "/root/reference"


@pytest.fixture()
def rng():
    """Fresh deterministic generator per test — results must not depend on
    test execution order."""
    return np.random.default_rng(0)


@pytest.fixture()
def gpu():
    """The first CUDA device; skips the test where there is none."""
    try:
        return jax.devices("cuda")[0]
    except RuntimeError:
        pytest.skip("needs a CUDA device (run with JAX_PLATFORMS=cuda,cpu)")


def has_reference() -> bool:
    return os.path.isdir(REFERENCE_DIR)
