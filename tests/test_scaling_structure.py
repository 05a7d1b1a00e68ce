"""Machine-checked scaling structure, independent of CPU timesharing.

The virtual-device sweep (benchmarks/scaling.py) can only measure
partitioning overhead — virtual devices timeshare one CPU.  What CAN be
asserted exactly here is the compiled per-device cost model for the
template-sharded match: each device's flops fit ``a + b/n`` (a = the
replicated quantization front-end, b = the work that shards by
template), the ``b`` term is exactly the template-proportional score
work (it scales with bank capacity), and the per-device argument bytes
(the bank shard) shrink with the mesh — the structural content of the
scaling-efficiency target (SURVEY.md §2.6; the work being sharded is
the matchClass template loop, linemod/linemod.cpp:1458)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from __graft_entry__ import _tiny_bank
from fealess import config as cfg
from fealess.parallel import mesh as mesh_mod
from fealess.parallel import sharded_match

SIZES = (1, 2, 4, 8)


def _costs(capacity, sizes):
    det_cfg = cfg.DetectorConfig(image_width=160, image_height=160,
                                 max_candidates=16)
    rng = np.random.default_rng(0)
    bank = _tiny_bank(det_cfg, capacity=capacity, rng=rng)
    bgr = jnp.asarray(rng.integers(0, 255, size=(160, 160, 3),
                                   dtype=np.uint8))
    depth = jnp.asarray(rng.integers(400, 900, size=(160, 160),
                                     dtype=np.uint16))
    flops, arg_bytes = {}, {}
    for n in sizes:
        m = mesh_mod.make_mesh([("t", n)], jax.devices()[:n])
        f = jax.jit(lambda b, i, d, m=m: sharded_match.match_bank_sharded(
            b, i, d, 75.0, det_cfg, m))
        comp = f.lower(bank, bgr, depth).compile()
        ca = comp.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        flops[n] = float(ca["flops"])
        mem = comp.memory_analysis()
        arg_bytes[n] = float(getattr(mem, "argument_size_in_bytes", 0))
    return flops, arg_bytes


def _fit_a_b(flops):
    ns = np.array(sorted(flops), float)
    y = np.array([flops[int(n)] for n in ns])
    design = np.stack([np.ones_like(ns), 1.0 / ns], axis=1)
    (a, b), *_ = np.linalg.lstsq(design, y, rcond=None)
    pred = design @ np.array([a, b])
    rel_err = float(np.max(np.abs(pred - y) / y))
    return a, b, rel_err


@pytest.fixture(scope="module")
def costs_64():
    return _costs(64, SIZES)


def test_per_device_flops_fit_a_plus_b_over_n(costs_64):
    flops, _ = costs_64
    a, b, rel_err = _fit_a_b(flops)
    # the per-device program is exactly "replicated front-end + 1/n-th of
    # the score work": the 1/n model must explain the compiled flops
    assert rel_err < 0.05, (flops, a, b, rel_err)
    assert b > 0, (a, b)


def test_sharded_term_is_the_template_work(costs_64):
    """Doubling the bank must double the ``b/n`` term (score work is
    per-template) while leaving the replicated ``a`` term unchanged —
    i.e. what shards across devices is precisely the work that grows
    with the bank."""
    flops_64, _ = costs_64
    flops_128, _ = _costs(128, (1, 8))
    a64, b64, _ = _fit_a_b(flops_64)
    # two-point solve for capacity 128: f(n) = a + b/n at n=1,8
    b128 = (flops_128[1] - flops_128[8]) * 8.0 / 7.0
    a128 = flops_128[1] - b128
    assert b128 == pytest.approx(2.0 * b64, rel=0.1), (b64, b128)
    assert a128 == pytest.approx(a64, rel=0.05), (a64, a128)


def test_per_device_argument_bytes_shrink(costs_64):
    _, arg_bytes = costs_64
    if arg_bytes[1] == 0:
        pytest.skip("memory_analysis unavailable on this backend")
    # the frame is replicated; the bank (and score tables) shard, so
    # per-device argument bytes must strictly decrease with the mesh
    assert arg_bytes[8] < arg_bytes[4] < arg_bytes[2] < arg_bytes[1], \
        arg_bytes
