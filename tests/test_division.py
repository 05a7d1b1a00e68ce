"""ops.division.div_exact equals IEEE f32 division bit for bit (numpy's),
so quotients that feed comparisons agree between a GPU and the CPU."""

import numpy as np
import jax
import pytest

from fealess.ops.division import div_exact


def _floats(rng, k, lo, hi):
    m = rng.uniform(1.0, 2.0, k)
    e = rng.integers(lo, hi, k)
    s = rng.choice([-1.0, 1.0], k)
    return (s * m * 2.0 ** e).astype(np.float32)


def _case(name, rng, k=50000):
    if name == "random":
        return _floats(rng, k, -40, 40), _floats(rng, k, -40, 40)
    if name == "score":          # detector: score * 100 / (4 * nf)
        n = (rng.integers(0, 2 ** 17, k) * 100).astype(np.float32)
        n[:600] = np.arange(600) * 100                  # includes 0
        return n, (4 * rng.integers(1, 1024, k)).astype(np.float32)
    if name == "integer":
        return (rng.integers(0, 2 ** 24, k).astype(np.float32),
                rng.integers(1, 2 ** 24, k).astype(np.float32))
    if name == "tracker":        # KCF: scale and ROI size / scale_step
        n = np.concatenate([_floats(rng, k // 2, -2, 3),
                            rng.uniform(8, 600, k - k // 2)]).astype(
                                np.float32)
        return n, np.full(k, 1.05, np.float32)
    # consecutive mantissas over one binade: every rounding case
    n = (np.float32(1.0) + np.arange(k, dtype=np.float32)
         * np.float32(2.0 ** -23))
    return n, _floats(rng, k, -3, 3)


@pytest.mark.parametrize("name", ["random", "score", "integer", "tracker",
                                  "mantissas"])
def test_div_exact_equals_ieee_division(name):
    rng = np.random.default_rng(len(name))
    n, d = _case(name, rng)
    got = np.asarray(jax.jit(div_exact)(n, d))
    want = n / d
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
