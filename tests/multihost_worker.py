"""Worker for the 2-process multi-host launch test (test_multihost.py).

Each process: join the distributed runtime, build the same tiny bank,
feed its OWN local frames into a globally-sharded batch, run the fused
batch Recognition over the global mesh, and verify its addressable
result shards.  Run me via test_multihost.py, not directly.
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")   # before any device use

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main():
    from fealess import config as cfg
    from fealess import training
    from fealess.bank import pack_bank
    from fealess.parallel import batch_recon, multihost
    from tests.test_match_e2e import H, W, make_scene

    multihost.initialize()
    assert jax.process_count() == 2, jax.process_count()
    pid = jax.process_index()
    mesh = multihost.global_mesh("d")
    n_global = jax.device_count()

    det_cfg = cfg.DetectorConfig(image_width=W, image_height=H,
                                 max_candidates=8, max_templates=4)
    ecfg = cfg.EngineConfig(detector=det_cfg, refine_crop=128,
                            template_fx=608.0, template_fy=608.0,
                            template_cx=W / 2.0, template_cy=H / 2.0)
    bgr, depth, mask = make_scene(np.random.default_rng(7))
    pose = np.zeros(13, np.float32)
    pose[0] = pose[5] = pose[10] = 1.0
    pose[12] = 650.0
    view = training.add_template(bgr, depth, mask, pose, det_cfg)
    assert view is not None
    bank = pack_bank({"obj": [view]}, levels=det_cfg.pyramid_levels,
                     capacity=det_cfg.max_templates)

    # per-host local frames: batch = n_global frames globally, each host
    # contributes n_global // 2 (its local devices' shards)
    local_b = n_global // 2
    local = {"bgr": np.stack([bgr] * local_b),
             "depth": np.stack([depth] * local_b)}
    gbatch = multihost.feed_local_batch(mesh, local)

    model_depth = np.zeros((bank.capacity, 128, 128), np.uint16)
    model_depth[0] = depth[:128, :128]
    repl = multihost.replicate(
        mesh, {"md": model_depth,
               "org": np.zeros((bank.capacity, 2), np.int32)})
    bank_repl = multihost.replicate(mesh, bank)
    scene_k = jnp.asarray([[608.0, 0, W / 2], [0, 608.0, H / 2], [0, 0, 1]],
                          jnp.float32)

    step = batch_recon.recognize_batch(
        bank_repl, repl["md"], repl["org"], gbatch["bgr"], gbatch["depth"],
        scene_k, ecfg)
    valid = [bool(s.data[0]) for s in step.valid.addressable_shards]
    sims = [float(s.data[0]) for s in step.similarity.addressable_shards]
    assert len(valid) == local_b, (len(valid), local_b)
    assert all(valid), valid
    assert all(s > 90.0 for s in sims), sims
    print(f"MULTIHOST_OK process={pid} local_shards={len(valid)} "
          f"sim={sims[0]:.1f}", flush=True)


if __name__ == "__main__":
    main()
