"""Data-parallel batch reconstruction over a device mesh.

BASELINE.json config 5 ("pod-scale batch reconstruction"): a batch of
RGB-D frames shards across the mesh's ``d`` axis; every device runs the
full fused Recognition step (match + top-1 + ICP refine,
fealess.pipeline.recognize_top1) on its frame shard with the template
bank, model depths and conv kernels replicated.  Composes with template
sharding (fealess.parallel.sharded_match) as a 2-D mesh: shard the
bank on one axis and frames on the other.

On a multi-host pod this is the whole-program layout: frames arrive
per-host (jax.distributed + host-local data feeding), the bank replicates
over ICI, and the only cross-device traffic is the initial bank broadcast.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fealess import config as cfg
from fealess import pipeline
from fealess.bank import TemplateBank


def recognize_batch(bank: TemplateBank, model_depth_stack: jax.Array,
                    depth_origins: jax.Array, bgr_batch: jax.Array,
                    depth_batch: jax.Array, scene_k: jax.Array,
                    engine: cfg.EngineConfig,
                    kernels=None) -> pipeline.RecoStep:
    """vmapped Recognition over a leading frame axis (single device)."""
    return jax.vmap(
        lambda i, d: pipeline.recognize_top1(
            bank, model_depth_stack, depth_origins, i, d, scene_k, engine,
            kernels=kernels))(bgr_batch, depth_batch)


def match_batch_2d(bank: TemplateBank, bgr_batch: jax.Array,
                   depth_batch: jax.Array, threshold: float,
                   det: cfg.DetectorConfig, mesh: Mesh, tables=None,
                   frame_axis: str = "d", template_axis: str = "t"):
    """Frame x template 2-D mesh matching: frames shard over
    ``frame_axis`` (pure data parallelism), the bank + score tables over
    ``template_axis`` (the matchClass template loop, linemod.cpp:1458),
    and each frame's per-shard top-K merges with an ``all_gather`` over
    the template axis — so every frame's global (similarity desc,
    template asc) candidate list lands on the device row owning that
    frame.  The (d=2, t=4) composition is exercised by
    ``__graft_entry__.dryrun_multichip`` and tests/test_parallel.py.
    """
    from fealess import detector as det_mod
    from fealess.detector import Matches
    from fealess.parallel.sharded_match import _merge_matches
    from jax import shard_map

    nt = mesh.shape[template_axis]
    nd = mesh.shape[frame_axis]
    n = bank.capacity
    b = bgr_batch.shape[0]
    assert n % nt == 0, (n, nt)
    assert b % nd == 0, (b, nd)
    shard_n = n // nt
    if tables is None:
        tables = det_mod.build_match_tables(bank, det)

    def local_fn(bank_s, tables_s, bgr_s, dep_s):
        def one(bgr, dep):
            levels = det_mod.quantized_pyramid(bgr, dep, det)
            planes = det_mod.response_planes(levels, det)
            m = det_mod.match_from_planes(bank_s, planes, threshold, det,
                                          kernels=tables_s)
            shard_id = jax.lax.axis_index(template_axis)
            return dataclasses.replace(
                m, template_slot=m.template_slot + shard_id * shard_n)
        m = jax.vmap(one)(bgr_s, dep_s)              # (b/d, K) fields
        g = jax.lax.all_gather(m, template_axis, axis=1,
                               tiled=True)           # (b/d, nt*K)
        return jax.vmap(
            lambda mm: _merge_matches(mm, det.max_candidates))(g)

    bank_specs = TemplateBank(
        feat_x=P(template_axis), feat_y=P(template_axis),
        feat_label=P(template_axis), feat_valid=P(template_axis),
        width=P(template_axis), height=P(template_axis),
        offset_x=P(template_axis), offset_y=P(template_axis),
        pose=P(template_axis), class_idx=P(template_axis),
        template_idx=P(template_axis), valid=P(template_axis),
        class_names=bank.class_names, max_span=bank.max_span)
    table_specs = tuple(
        None if tl is None else {key: P(template_axis) for key in tl}
        for tl in tables)
    match_spec = Matches(
        x=P(frame_axis), y=P(frame_axis), similarity=P(frame_axis),
        template_slot=P(frame_axis), class_idx=P(frame_axis),
        template_idx=P(frame_axis), valid=P(frame_axis))
    fn = shard_map(local_fn, mesh=mesh,
                   in_specs=(bank_specs, table_specs, P(frame_axis),
                             P(frame_axis)),
                   out_specs=match_spec, check_vma=False)
    return fn(bank, tables, bgr_batch, depth_batch)


def recognize_batch_sharded(bank: TemplateBank,
                            model_depth_stack: jax.Array,
                            depth_origins: jax.Array,
                            bgr_batch: jax.Array, depth_batch: jax.Array,
                            scene_k: jax.Array, engine: cfg.EngineConfig,
                            mesh: Mesh, axis: str = "d",
                            kernels=None) -> pipeline.RecoStep:
    """Frame-sharded batch Recognition via sharding annotations.

    The batch axis must divide by the mesh ``axis`` size.  Expressed with
    ``jax.device_put`` + sharded-in/sharded-out jit so XLA partitions the
    vmapped step automatically (pure data parallelism: no collectives in
    the steady state)."""
    n_dev = mesh.shape[axis]
    b = bgr_batch.shape[0]
    assert b % n_dev == 0, (b, n_dev)
    frame_sharding = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    bgr_batch = jax.device_put(bgr_batch, frame_sharding)
    depth_batch = jax.device_put(depth_batch, frame_sharding)
    bank = jax.device_put(bank, repl)
    model_depth_stack = jax.device_put(model_depth_stack, repl)
    depth_origins = jax.device_put(depth_origins, repl)
    if kernels is not None:
        kernels = jax.device_put(kernels, repl)
    return recognize_batch(bank, model_depth_stack, depth_origins,
                           bgr_batch, depth_batch, scene_k, engine,
                           kernels=kernels)
