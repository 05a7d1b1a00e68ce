"""Template-sharded LINE-MOD matching over a device mesh.

The reference iterates templates serially on one core (matchClass,
linemod/linemod.cpp:1451-1577).  Here the packed bank's template axis is
sharded over the mesh's ``t`` axis: every device builds the (identical,
replicated) response pyramid for the frame, scores and refines only its
template shard, and the per-shard top-K results merge with a global sort —
the psum/argmax-analog reduction of SURVEY.md §2.6.

A frame batch axis can be added outside via ``jax.vmap`` before sharding
(data parallelism composes with template parallelism as a 2-D mesh).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from fealess import config as cfg
from fealess import detector as det_mod
from fealess.bank import TemplateBank
from fealess.detector import Matches


def _merge_matches(m: Matches, k: int) -> Matches:
    """Global (similarity desc, template_idx asc) sort + duplicate
    suppression + truncation to K (linemod.cpp:1437-1439)."""
    sim = jnp.where(m.valid, m.similarity, -jnp.inf)
    order = jnp.lexsort((m.template_idx, -sim))
    x, y = m.x[order], m.y[order]
    sim = sim[order]
    tslot = m.template_slot[order]
    cls = m.class_idx[order]
    tpl = m.template_idx[order]
    valid = m.valid[order]
    same = jnp.concatenate([
        jnp.array([False]),
        (x[1:] == x[:-1]) & (y[1:] == y[:-1]) & (sim[1:] == sim[:-1])
        & (cls[1:] == cls[:-1])])
    valid = valid & ~same
    return Matches(x=x[:k], y=y[:k], similarity=sim[:k],
                   template_slot=tslot[:k], class_idx=cls[:k],
                   template_idx=tpl[:k], valid=valid[:k])


def match_bank_sharded(bank: TemplateBank, bgr: jax.Array,
                       depth_mm: jax.Array, threshold: float,
                       det: cfg.DetectorConfig, mesh: Mesh,
                       axis: str = "t", tables=None) -> Matches:
    """Template-sharded match.  ``bank`` arrays must be shardable on their
    leading axis by the mesh's ``axis`` size.  Returns merged global top-K.

    The frame-dependent front-end (quantized pyramid + response planes)
    is computed ONCE outside the shard_map — it is template-independent,
    so sharding it would only replicate work (r2 rebuilt the full pyramid
    in every shard) — and only the template-dependent scoring runs per
    shard on its bank slice, so the per-device score work scales as
    1/n_shards.  Score ``tables`` (detector.build_match_tables) are built
    once at full N (cheap elementwise math) and fed to the shards split
    on their template axis, or pass precomputed ones.

    Note: ``template_slot`` in the result indexes the GLOBAL bank (shard
    offset re-applied inside the shard).
    """
    nshards = mesh.shape[axis]
    n = bank.capacity
    assert n % nshards == 0, (n, nshards)
    shard_n = n // nshards

    class_names = bank.class_names

    # ---- replicated front-end: frame-dependent, template-independent
    levels = det_mod.quantized_pyramid(bgr, depth_mm, det)
    planes = det_mod.response_planes(levels, det)
    plane_arrays = tuple(p for p, _ in planes)
    plane_hw = tuple(hw for _, hw in planes)
    if tables is None:
        tables = det_mod.build_match_tables(
            bank, det, grid_hw=[(p.shape[1], p.shape[2])
                                for p in plane_arrays])

    def local_match(bank_shard: TemplateBank, tables_shard, *pl):
        planes_l = [(pl[i], plane_hw[i]) for i in range(len(pl))]
        m = det_mod.match_from_planes(bank_shard, planes_l, threshold, det,
                                      kernels=tables_shard)
        shard_id = jax.lax.axis_index(axis)
        slot = m.template_slot + shard_id * shard_n
        return Matches(x=m.x, y=m.y, similarity=m.similarity,
                       template_slot=slot, class_idx=m.class_idx,
                       template_idx=m.template_idx, valid=m.valid)

    bank_specs = TemplateBank(
        feat_x=P(axis), feat_y=P(axis), feat_label=P(axis),
        feat_valid=P(axis), width=P(axis), height=P(axis),
        offset_x=P(axis), offset_y=P(axis), pose=P(axis),
        class_idx=P(axis), template_idx=P(axis), valid=P(axis),
        class_names=class_names, max_span=bank.max_span)
    table_specs = tuple(
        None if tl is None else {key: P(axis) for key in tl}
        for tl in tables)

    fn = shard_map(local_match, mesh=mesh,
                   in_specs=(bank_specs, table_specs) + (P(),) * len(
                       plane_arrays),
                   out_specs=Matches(x=P(axis), y=P(axis),
                                     similarity=P(axis),
                                     template_slot=P(axis),
                                     class_idx=P(axis),
                                     template_idx=P(axis), valid=P(axis)),
                   check_vma=False)
    merged = fn(bank, tables, *plane_arrays)   # leading axis = nshards * K
    return _merge_matches(merged, det.max_candidates)


def jit_match_sharded(mesh: Mesh, det: cfg.DetectorConfig,
                      threshold: float, axis: str = "t"):
    """Build the jitted sharded matcher once for a mesh/config."""
    @jax.jit
    def fn(bank, bgr, depth_mm):
        return match_bank_sharded(bank, bgr, depth_mm, threshold, det,
                                  mesh, axis)
    return fn
