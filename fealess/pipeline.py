"""Detection refinement glue: match rect -> paired clouds -> ICP -> pose.

Reimplements ``detection()`` (ICP/detection.cpp:11-254) as a jittable
function over fixed-size crops:

- the model-template depth and the scene depth are back-projected with
  their own intrinsics (template uses the hardcoded K = [608,0,320;
  0,608,240;0,0,1], initInternalMat, ICP/common.cpp:326-372; the scene
  uses the camera K), in metres, then scaled x1000 to mm
  (detection.cpp:29-40);
- equal-size rects are cropped from both (template rect at its stored
  offset, scene rect at the match position, obj_reco_lmicp.cpp:127-133);
- points are index-paired and valid only where BOTH have z <= 900mm
  (matToVec paired variant, ICP/common.cpp:380-405);
- translation init mode 2 (the active ``test_id``, detection.cpp:147-199):
  ``t_tmp = centroid(ref) - centroid(model)``, ``t_init = t_tmp + t_match``,
  model points shifted by ``t_tmp``;
- ICP (fealess.icp) then final composition ``T = R t_init + T_icp``,
  ``R = R_icp r_match`` (detection.cpp:232-234).

Crops are static ``(crop_h, crop_w)`` windows (config) masked to the true
rect size, so the whole path jits once for any template.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp

from fealess import config as cfg
from fealess import icp as icp_mod
from fealess.geometry import depth as gd


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RefineResult:
    r: Any                # (3, 3) final rotation (world2cam)
    t: Any                # (3,) final translation, mm
    icp: icp_mod.IcpResult
    n_pairs: Any          # valid paired points fed to ICP


def _crop_points_mm(depth_u16: jax.Array, k: jax.Array,
                    x0, y0, crop_h: int, crop_w: int) -> jax.Array:
    """Back-project a (crop_h, crop_w) window at (x0, y0) to mm points.

    Equivalent to depthTo3d on the full image followed by rect cropping
    (detection.cpp:29-43) — unprojection uses absolute pixel coords.  The
    image is zero-padded so a window extending past the bottom/right edge
    reads invalid (0) depth instead of silently shifting the origin —
    shifting would misalign the index pairing between the model and scene
    rects.
    """
    padded = jnp.pad(depth_u16, ((0, crop_h), (0, crop_w)))
    x0c = jnp.clip(x0, 0, depth_u16.shape[1])
    y0c = jnp.clip(y0, 0, depth_u16.shape[0])
    window = jax.lax.dynamic_slice(padded, (y0c, x0c), (crop_h, crop_w))
    z = jnp.where(window == 0, jnp.nan,
                  window.astype(jnp.float32) / 1000.0)
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    u = (x0c + jnp.arange(crop_w, dtype=jnp.int32)).astype(jnp.float32)[None, :]
    v = (y0c + jnp.arange(crop_h, dtype=jnp.int32)).astype(jnp.float32)[:, None]
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    return jnp.stack([x, y, z], axis=-1) * 1000.0


def paired_clouds(scene_depth_u16: jax.Array, scene_k: jax.Array,
                  model_depth_u16: jax.Array, template_k: jax.Array,
                  rect_w, rect_h, model_x0, model_y0, match_x, match_y,
                  engine: cfg.EngineConfig, crop_h: int = 256,
                  crop_w: int = 256):
    """The ICP inputs of one match: index-paired (ref, model) clouds
    compacted to ``engine.icp.max_points`` rows, their pair mask, the ref
    normals (plane mode, else None) and the translation ``t_tmp`` that
    init mode 2 shifted the model by.

    ``model_depth_u16`` is the template's depth image ALREADY converted to
    u16 mm (the reference multiplies the stored 0.1mm png by 0.1 into
    CV_16UC1, obj_reco_lmicp.cpp:185-188).  ``model_x0/model_y0`` is the
    template rect origin (offset_x/offset_y); ``match_x/match_y`` the
    scene rect origin; both rects are ``rect_w x rect_h``.
    """
    model_pts = _crop_points_mm(model_depth_u16, template_k,
                                model_x0, model_y0, crop_h, crop_w)
    ref_pts = _crop_points_mm(scene_depth_u16, scene_k,
                              match_x, match_y, crop_h, crop_w)
    plane_mode = engine.icp.mode == "point_to_plane"
    ref_normals = (gd.normals_from_point_image(ref_pts).reshape(-1, 3)
                   if plane_mode else None)

    uu = jnp.arange(crop_w)[None, :]
    vv = jnp.arange(crop_h)[:, None]
    in_rect = (uu < rect_w) & (vv < rect_h)
    z_max = engine.icp.valid_depth_max_mm
    z_ok = ((model_pts[..., 2] <= z_max)
            & (ref_pts[..., 2] <= z_max))   # NaN -> False
    pair_mask = (in_rect & z_ok).reshape(-1)

    model_flat = model_pts.reshape(-1, 3)
    ref_flat = ref_pts.reshape(-1, 3)
    pad = jnp.float32(icp_mod.PAD_COORD)
    model_flat = jnp.where(pair_mask[:, None], model_flat, pad)
    ref_flat = jnp.where(pair_mask[:, None], ref_flat, pad)

    # Compact valid pairs to the ICP point budget: the static crop is
    # mostly padding (the reference feeds exactly the rect's valid pixels,
    # detection.cpp:98-114), and NN cost is quadratic in cloud size.  A
    # stable sort keeps pairs index-aligned and in raster order; when more
    # than max_points pairs are valid the excess is dropped (documented
    # divergence — the reference uses all rect points).
    cap = engine.icp.max_points
    if cap < pair_mask.shape[0]:
        order = jnp.argsort(jnp.logical_not(pair_mask), stable=True)
        take = order[:cap]
        model_flat = model_flat[take]
        ref_flat = ref_flat[take]
        pair_mask = pair_mask[take]
        if ref_normals is not None:
            ref_normals = ref_normals[take]

    # Translation init, mode test_id=2 (detection.cpp:147-199).
    def mmean(pts):
        w = pair_mask.astype(jnp.float32)[:, None]
        return (jnp.sum(jnp.where(pair_mask[:, None], pts, 0.0) * 1.0, axis=0)
                / jnp.maximum(jnp.sum(w), 1.0))

    t_tmp = mmean(ref_flat) - mmean(model_flat)
    model_flat = jnp.where(pair_mask[:, None], model_flat + t_tmp, model_flat)
    return ref_flat, model_flat, pair_mask, ref_normals, t_tmp


def refine_match(scene_depth_u16: jax.Array, scene_k: jax.Array,
                 model_depth_u16: jax.Array, template_k: jax.Array,
                 rect_w, rect_h,
                 model_x0, model_y0, match_x, match_y,
                 r_match: jax.Array, t_match: jax.Array,
                 engine: cfg.EngineConfig,
                 crop_h: int = 256, crop_w: int = 256) -> RefineResult:
    """Jittable detection() equivalent for one match: the paired clouds
    of :func:`paired_clouds`, ICP, then the final composition."""
    ref_flat, model_flat, pair_mask, ref_normals, t_tmp = paired_clouds(
        scene_depth_u16, scene_k, model_depth_u16, template_k, rect_w,
        rect_h, model_x0, model_y0, match_x, match_y, engine, crop_h, crop_w)
    t_init = t_tmp + t_match
    result = icp_mod.icp_refine(ref_flat, model_flat, pair_mask, engine.icp,
                                ref_normals=ref_normals)
    hi = jax.lax.Precision.HIGHEST
    t_final = jnp.matmul(result.r, t_init, precision=hi) + result.t
    r_final = jnp.matmul(result.r, r_match, precision=hi)
    return RefineResult(r=r_final, t=t_final, icp=result,
                        n_pairs=jnp.sum(pair_mask))


@functools.partial(jax.jit, static_argnames=("engine", "max_objects"))
def recognize_multi_jit(bank, model_depth_stack, depth_origins, bgr,
                        scene_depth_u16, scene_k, engine: cfg.EngineConfig,
                        max_objects: int, kernels=None,
                        class_mask=None, roi_mask=None) -> "MultiRecoStep":
    return recognize_multi(bank, model_depth_stack, depth_origins, bgr,
                           scene_depth_u16, scene_k, engine, max_objects,
                           kernels, class_mask=class_mask,
                           roi_mask=roi_mask)


@functools.partial(jax.jit, static_argnames=("engine",))
def recognize_top1_jit(bank, model_depth_stack, depth_origins, bgr,
                       scene_depth_u16, scene_k, engine: cfg.EngineConfig,
                       kernels=None, class_mask=None,
                       roi_mask=None, roi_box=None) -> "RecoStep":
    return recognize_top1(bank, model_depth_stack, depth_origins, bgr,
                          scene_depth_u16, scene_k, engine, kernels,
                          class_mask=class_mask, roi_mask=roi_mask,
                          roi_box=roi_box)


@functools.partial(jax.jit, static_argnames=("engine", "crop_h", "crop_w"))
def refine_match_jit(scene_depth_u16, scene_k, model_depth_u16, template_k,
                     rect_w, rect_h, model_x0, model_y0, match_x, match_y,
                     r_match, t_match, engine: cfg.EngineConfig,
                     crop_h: int = 256, crop_w: int = 256) -> RefineResult:
    return refine_match(scene_depth_u16, scene_k, model_depth_u16,
                        template_k, rect_w, rect_h, model_x0, model_y0,
                        match_x, match_y, r_match, t_match, engine,
                        crop_h, crop_w)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RecoStep:
    """Device-side Recognition result (cf. TObjRecoResult, lotus_common.h:
    95-100): pose as 4x4 world2cam plus the match/refine diagnostics."""
    pose: Any           # (4, 4) f32
    valid: Any          # bool — a match above threshold existed
    similarity: Any
    class_idx: Any
    template_slot: Any
    match_x: Any
    match_y: Any
    refine: RefineResult


def candidate_template(bank, model_depth_stack, depth_origins, slot,
                       engine: cfg.EngineConfig):
    """Gather one candidate slot's template data: (model depth crop,
    template K, rect w, rect h, model x0, model y0, r_match, t_match)."""
    from fealess.geometry import transforms as tf

    r_match, t_match, _ = tf.pose_from_13floats(bank.pose[slot])
    dx0 = depth_origins[slot, 0]
    dy0 = depth_origins[slot, 1]
    template_k = jnp.asarray(
        [[engine.template_fx, 0.0, 0.0],
         [0.0, engine.template_fy, 0.0],
         [0.0, 0.0, 1.0]], jnp.float32)
    template_k = template_k.at[0, 2].set(engine.template_cx
                                         - dx0.astype(jnp.float32))
    template_k = template_k.at[1, 2].set(engine.template_cy
                                         - dy0.astype(jnp.float32))
    return (model_depth_stack[slot], template_k, bank.width[slot, 0],
            bank.height[slot, 0], bank.offset_x[slot, 0] - dx0,
            bank.offset_y[slot, 0] - dy0, r_match, t_match)


def _refine_candidate(bank, model_depth_stack, depth_origins,
                      scene_depth_u16, scene_k, slot, mx, my,
                      engine: cfg.EngineConfig, crop: int):
    """Gather one candidate's template data and ICP-refine it -> (pose,
    RefineResult).  Shared by the top-1 and multi-object paths; vmappable
    over (slot, mx, my)."""
    from fealess.geometry import transforms as tf

    md, template_k, rect_w, rect_h, mx0, my0, r_match, t_match = \
        candidate_template(bank, model_depth_stack, depth_origins, slot,
                           engine)
    res = refine_match(scene_depth_u16, scene_k, md, template_k,
                       rect_w, rect_h, mx0, my0, mx, my,
                       r_match, t_match, engine, crop_h=crop, crop_w=crop)
    return tf.pose_matrix_4x4(res.r, res.t), res


def recognize_top1(bank, model_depth_stack: jax.Array,
                   depth_origins: jax.Array, bgr: jax.Array,
                   scene_depth_u16: jax.Array, scene_k: jax.Array,
                   engine: cfg.EngineConfig, kernels=None,
                   class_mask=None, roi_mask=None,
                   roi_box=None) -> RecoStep:
    """The full Recognition step as ONE jittable function: match the whole
    bank, take the best match (obj_reco_lmicp.cpp:111 takes top-1 only),
    gather its model depth/pose and ICP-refine — no host round trip
    between stages, so frames pipeline through the device back-to-back
    and the step can be vmapped over a frame batch or shard_mapped.

    Args:
      bank: packed TemplateBank.
      model_depth_stack: (N, crop, crop) u16 mm — per-slot model depth,
        pre-cropped at ``depth_origins`` (engine.ObjReco builds this).
      depth_origins: (N, 2) int32 (x0, y0) crop origins.
      bgr / scene_depth_u16: the frame at the processing resolution.
      scene_k: (3, 3) zoomed intrinsics.
    """
    from fealess import detector as det_mod

    d = engine.detector
    crop = model_depth_stack.shape[-1]
    masks = None if roi_mask is None else [roi_mask, roi_mask]
    matches = det_mod.match_bank(bank, bgr, scene_depth_u16,
                                 engine.matching_threshold, d,
                                 masks=masks, kernels=kernels,
                                 class_mask=class_mask, roi_box=roi_box)
    # Matches are sorted (similarity desc, template asc); slot 0 is the
    # best candidate and `valid[0]` says whether any survived.
    slot = matches.template_slot[0]
    valid = matches.valid[0]
    mx, my = matches.x[0], matches.y[0]
    pose, res = _refine_candidate(bank, model_depth_stack, depth_origins,
                                  scene_depth_u16, scene_k, slot, mx, my,
                                  engine, crop)
    return RecoStep(pose=pose, valid=valid, similarity=matches.similarity[0],
                    class_idx=matches.class_idx[0], template_slot=slot,
                    match_x=mx, match_y=my, refine=res)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MultiRecoStep:
    """Multi-object Recognition result: the top-M refined candidates after
    3D NMS.  Slot ``i`` is live when ``valid[i]``; its fields are taken
    from the NMS cluster winner (nonMaximumSuppression emits the winner's
    pose per cluster, ICP/NMS.cpp:30-39)."""
    poses: Any          # (M, 4, 4)
    valid: Any          # (M,) cluster seeded here and above threshold
    similarity: Any     # (M,)
    class_idx: Any      # (M,)
    template_slot: Any  # (M,)
    icp_dist: Any       # (M,)
    inlier_ratio: Any   # (M,)
    n_pairs: Any        # (M,)
    match_x: Any        # (M,)
    match_y: Any        # (M,)


def recognize_multi(bank, model_depth_stack: jax.Array,
                    depth_origins: jax.Array, bgr: jax.Array,
                    scene_depth_u16: jax.Array, scene_k: jax.Array,
                    engine: cfg.EngineConfig,
                    max_objects: int, kernels=None,
                    class_mask=None, roi_mask=None) -> MultiRecoStep:
    """Multi-object Recognition: match the bank, ICP-refine the top-M
    candidates in parallel (vmap — the reference refines top-1 only,
    obj_reco_lmicp.cpp:111; its detection()+NMS path ICP/NMS.cpp:6-40 is
    the multi-candidate design this realizes), then 3D NMS over the
    refined translations."""
    from fealess import detector as det_mod
    from fealess import nms as nms_mod

    d = engine.detector
    crop = model_depth_stack.shape[-1]
    masks = None if roi_mask is None else [roi_mask, roi_mask]
    matches = det_mod.match_bank(bank, bgr, scene_depth_u16,
                                 engine.matching_threshold, d,
                                 masks=masks, kernels=kernels,
                                 class_mask=class_mask)
    m = max_objects
    slots = matches.template_slot[:m]
    mxs = matches.x[:m]
    mys = matches.y[:m]
    valid = matches.valid[:m]

    # lax.map, not vmap: under vmap the plane-ICP degeneracy gate's
    # lax.cond lowers to a select that computes BOTH the GN and Kabsch
    # updates per candidate.
    poses, res = jax.lax.map(
        lambda sxy: _refine_candidate(
            bank, model_depth_stack, depth_origins, scene_depth_u16,
            scene_k, sxy[0], sxy[1], sxy[2], engine, crop),
        (slots, mxs, mys))

    # 3D NMS over refined candidate translations (NMS.cpp:6-40); the
    # model-point count is the ICP pair count, the score its dist_mean.
    t = poses[:, :3, 3]
    icp_dist = jnp.where(res.icp.dist_mean < 0, jnp.float32(1e9),
                         res.icp.dist_mean)
    cand_valid = valid & res.icp.ok
    nms = nms_mod.nms_3d(t, icp_dist, res.n_pairs, cand_valid,
                         engine.nms_object_distance)
    w = jnp.maximum(nms.winner, 0)
    return MultiRecoStep(
        poses=poses[w], valid=nms.keep,
        similarity=matches.similarity[:m][w],
        class_idx=matches.class_idx[:m][w],
        template_slot=slots[w],
        icp_dist=res.icp.dist_mean[w],
        inlier_ratio=res.icp.inlier_ratio[w],
        n_pairs=res.n_pairs[w],
        match_x=mxs[w], match_y=mys[w])
