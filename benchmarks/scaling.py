"""Scaling-efficiency sweep on a virtual device mesh.

BASELINE.json configs 4-5: template-sharded matching over a growing bank
and frame-sharded batch reconstruction, swept over mesh sizes.  The sweep
runs on N virtual CPU devices (``--xla_force_host_platform_device_count``) — the
collective/partitioning structure is identical to a real slice; absolute
times are CPU times.  NOTE: virtual devices timeshare ONE physical CPU,
so per-device work serializes and "efficiency" here measures partitioning
OVERHEAD only (a real slice runs shards concurrently); the structural
validity of the sharded programs is asserted in tests/test_parallel.py,
and true scaling efficiency must be measured on real multi-chip hardware.

Run:  python benchmarks/scaling.py [--devices 8] [--templates 256]
Prints one JSON line per (config, mesh size).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--templates", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()
    import jax
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from __graft_entry__ import _tiny_bank
    from fealess import config as cfg
    from fealess import detector as det_mod
    from fealess.parallel import batch_recon, mesh as mesh_mod
    from fealess.parallel import sharded_match

    # small operating point so the CPU sweep stays quick
    det_cfg = cfg.DetectorConfig(image_width=160, image_height=160,
                                 max_candidates=16,
                                 max_templates=args.templates)
    engine = cfg.EngineConfig(detector=det_cfg, refine_crop=96,
                              icp=cfg.IcpConfig(max_points=2048))
    rng = np.random.default_rng(0)
    bank = _tiny_bank(det_cfg, capacity=args.templates, rng=rng)
    bgr = jnp.asarray(rng.integers(0, 255, size=(160, 160, 3),
                                   dtype=np.uint8))
    depth = jnp.asarray(rng.integers(400, 900, size=(160, 160),
                                     dtype=np.uint16))

    def timeit(fn, fetch):
        np.asarray(fetch(fn()))
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fetch(fn())
        np.asarray(out)
        return (time.perf_counter() - t0) / args.iters

    sizes = [s for s in (1, 2, 4, 8) if s <= args.devices]
    base = None
    for n in sizes:
        m = mesh_mod.make_mesh([("t", n)], jax.devices()[:n])
        fn = jax.jit(lambda: sharded_match.match_bank_sharded(
            bank, bgr, depth, 75.0, det_cfg, m))
        dt = timeit(fn, lambda o: o.similarity)
        tps = args.templates / dt
        if n == 1:
            base = tps
        eff = tps / (base * n)
        print(json.dumps({
            "config": "template_sharded_match",
            "mesh": n, "templates_per_s": round(tps, 1),
            "vs_1dev_overhead": round(eff * n, 3),
            "note": ("virtual mesh: devices timeshare one CPU, so the "
                     "replicated front-end serializes n times while the "
                     "score stage's TOTAL work stays constant (∝1/shard "
                     "per device); wall growth well below n*x confirms "
                     "only the front-end is replicated")}))

    # frame-sharded batch recon
    md = jnp.asarray(rng.integers(400, 880, size=(args.templates, 96, 96),
                                  dtype=np.uint16))
    orig = jnp.zeros((args.templates, 2), jnp.int32)
    kk = jnp.asarray([[608.0, 0, 80], [0, 608.0, 80], [0, 0, 1]],
                     jnp.float32)
    bgr_b = jnp.broadcast_to(bgr, (args.batch,) + bgr.shape)
    depth_b = jnp.broadcast_to(depth, (args.batch,) + depth.shape)
    kernels = det_mod.build_match_tables(bank, det_cfg)
    base = None
    for n in [s for s in sizes if args.batch % s == 0]:
        m = mesh_mod.make_mesh([("d", n)], jax.devices()[:n])
        fn = jax.jit(lambda m=m: batch_recon.recognize_batch_sharded(
            bank, md, orig, bgr_b, depth_b, kk, engine, m,
            kernels=kernels))
        dt = timeit(fn, lambda o: o.similarity)
        fps = args.batch / dt
        if n == 1:
            base = fps
        eff = fps / (base * n)
        print(json.dumps({"config": "frame_sharded_batch_recon",
                          "mesh": n, "frames_per_s": round(fps, 2),
                          "vs_1dev_overhead": round(eff * n, 3),
                          "note": "virtual mesh: devices timeshare one CPU"}))


if __name__ == "__main__":
    main()
