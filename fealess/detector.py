"""The LINE-MOD detector match path, as one jittable function.

Reproduces ``Detector::match``/``matchClass`` (linemod/linemod.cpp:
1356-1577) with static shapes:

- quantized pyramid -> spread -> response maps -> decimated planes per
  (level, modality) (the dense reformulation of "linear memories"),
- coarse whole-image scores for EVERY template at the lowest pyramid level
  (the reference loops templates serially; here it is the sparse
  accumulator of fealess.ops.score_pallas over valid-first score tables,
  a Pallas/Triton kernel on a CUDA device),
- static top-K candidate selection (the reference keeps all
  above-threshold candidates; we keep the K best by score, K =
  ``DetectorConfig.max_candidates`` — a documented divergence that is
  lossless whenever the scene has fewer than K candidate detections),
- per-level 16x16 local refinement with the exact clamp/offset/score
  arithmetic of matchClass (linemod.cpp:1509-1573),
- final (similarity desc, template_id asc) ordering with duplicate
  suppression (linemod.cpp:1437-1439).

Scores match the reference bit-for-bit: raw threshold
``int(2nf + thr/100*2nf + 0.5)``, coarse score ``raw*100/(4nf)+0.5``,
refined score ``best*100/(4nf)`` (linemod.cpp:1487, 1502, 1566).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from fealess import config as cfg
from fealess.bank import TemplateBank
from fealess.ops import image as fi
from fealess.ops import quantize as q
from fealess.ops import response, score_pallas, similarity
from fealess.ops.division import div_exact


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Matches:
    """Static-K match results (cf. cup_linemod::Match, linemod.hpp:253-286).

    ``template_slot`` indexes the packed bank; ``class_idx``/``template_idx``
    recover the reference's (class_id, template_id) pair.  Sorted by
    (similarity desc, template_idx asc); ``valid`` gates live entries.
    """
    x: Any
    y: Any
    similarity: Any
    template_slot: Any
    class_idx: Any
    template_idx: Any
    valid: Any


def quantized_pyramid(bgr: jax.Array, depth_mm: jax.Array,
                      det: cfg.DetectorConfig,
                      masks: Optional[List] = None):
    """Per-level (quantized_cg, quantized_dn) images (Detector::match
    pyramid construction, linemod.cpp:1388-1416).

    ColorGradient re-quantizes a pyrDown'd source; DepthNormal
    NN-downsamples its level-0 quantized image (linemod.cpp:434-452,
    721-739).  ``masks``, when given, is [cg_mask, dn_mask] at level 0.
    """
    cg, dn = det.color_gradient, det.depth_normal
    use_cg = "color_gradient" in det.modalities
    use_dn = "depth_normal" in det.modalities
    levels = []
    src = bgr
    qdn = (q.quantize_normals(depth_mm, dn.distance_threshold,
                              dn.difference_threshold) if use_dn else None)
    cg_mask = dn_mask = None
    if masks is not None:
        cg_mask, dn_mask = (masks * 2)[:2] if len(masks) == 1 else masks
    for l in range(det.pyramid_levels):
        if l > 0:
            src = fi.pyr_down_u8(src)
            qdn = None if qdn is None else qdn[::2, ::2]
            cg_mask = None if cg_mask is None else cg_mask[::2, ::2]
            dn_mask = None if dn_mask is None else dn_mask[::2, ::2]
        mods = []
        if use_cg:
            qcg = q.quantize_gradients(src, cg.weak_threshold)[0]
            mods.append(q.apply_mask(qcg, cg_mask))
        if use_dn:
            mods.append(q.apply_mask(qdn, dn_mask))
        levels.append(tuple(mods))
    return levels


def _offset(t: int) -> int:
    """Pixel offset of a decimated cell's reported position
    (linemod.cpp:1495, 1517)."""
    return t // 2 + (t % 2 - 1)


def response_planes(levels, det: cfg.DetectorConfig):
    """Decimated 2D response stacks per level: list of
    ((C_all, Hd, Wd) u8, (h, w)).  Channels concatenate the modalities
    (the "linear memories" of linemod.cpp:1060-1088, kept on a 2D grid
    so scoring is a dense conv)."""
    out = []
    for l, mods in enumerate(levels):
        t = det.t_at_level[l]
        h, w = mods[0].shape
        planes = jnp.concatenate(
            [response.build_level_2d(quant, t) for quant in mods], axis=0)
        out.append((planes, (h, w)))
    return out


def _kernel_hw(bank: TemplateBank, det: cfg.DetectorConfig, l: int,
               hd: int, wd: int) -> int:
    """Template span at level ``l`` in decimated cells (bank.max_span is
    the level-0 bbox side in px); score-table features at or beyond it
    are discarded."""
    if bank.max_span <= 0:
        return max(hd, wd)
    return min((bank.max_span >> l) // det.t_at_level[l] + 1, max(hd, wd))


def _level_table(bank: TemplateBank, det: cfg.DetectorConfig, l: int,
                 nb: int):
    """Valid-first feature table for level ``l`` (consumed by
    fealess.ops.score_pallas):

    - ``c``/``ry``/``rx``: (N, M*F) i32 feature channel (modality folded
      in) and decimated offsets, valid features first in bank order,
      padding entries zero,
    - ``nvalid``: (N,) i32 valid count; features at index >= nvalid are
      padding and are never iterated.

    Features whose offset reaches ``nb`` cells (the template span) are
    discarded.  Pure elementwise/sort arithmetic over the bank's feature
    arrays — cheap to (re)build under jit, so sharded callers can pass
    ``kernels=None``.
    """
    t = det.t_at_level[l]
    m_idx = jnp.arange(bank.modalities, dtype=jnp.int32)[None, :, None]
    fx = bank.feat_x[:, l]
    fy = bank.feat_y[:, l]
    fl = bank.feat_label[:, l]
    fv = bank.feat_valid[:, l]
    n = bank.capacity
    c = ((m_idx * 8 + fl) * (t * t) + (fy % t) * t + (fx % t)).reshape(n, -1)
    ry = (fy // t).reshape(n, -1)
    rx = (fx // t).reshape(n, -1)
    fv = fv.reshape(n, -1) & (rx < nb) & (ry < nb)
    order = jnp.argsort(~fv, axis=1, stable=True)
    fv_s = jnp.take_along_axis(fv, order, axis=1)
    table = {key: jnp.where(fv_s, jnp.take_along_axis(v, order, axis=1),
                            0).astype(jnp.int32)
             for key, v in (("c", c), ("ry", ry), ("rx", rx))}
    table["nvalid"] = jnp.sum(fv, axis=1, dtype=jnp.int32)
    return table


def build_match_tables(bank: TemplateBank, det: cfg.DetectorConfig,
                       grid_hw=None, levels=None):
    """Per-level valid-first score tables for the sparse scorers (the
    reformulation of the reference's linear-memory SSE adds,
    linemod.cpp:1130-1300; see fealess.ops.score_pallas).

    Bank-dependent only: precompute per bank (the engine caches them),
    or pass ``kernels=None`` to build under jit (elementwise, cheap).
    """
    if levels is None:
        levels = tuple(range(bank.levels))
    tables = []
    for l in range(bank.levels):
        if l not in levels:
            tables.append(None)
            continue
        t = det.t_at_level[l]
        if grid_hw is None:
            hd = (det.image_height >> l) // t
            wd = (det.image_width >> l) // t
        else:
            hd, wd = grid_hw[l]
        tables.append(_level_table(bank, det, l,
                                   _kernel_hw(bank, det, l, hd, wd)))
    return tuple(tables)


# Benchmark-only gate for ``match_from_planes(profile_stop=...)``: the
# stop-early variants return Matches with deliberately polluted similarity
# (they exist to time pipeline prefixes) and must never run in production.
# benchmarks/profile_fixture.py flips this before profiling.
ALLOW_PROFILE_STOPS = False


def exact_top_k_rows(flat: jax.Array, k: int, rows: int):
    """Exact global top-k of ``flat`` (equal to ``jax.lax.top_k(flat,
    k)`` including tie order) via per-row top-k + merge over the
    ``(rows, cols)`` reshape.  Tie order (value
    desc, flat index asc) is preserved: per-row top_k ties by column,
    and the merged (row, rank) order IS flat-index order for equal
    values.  Falls back to the flat form when the rows are too small to
    cover k."""
    p = flat.shape[0] // rows
    kk = min(k, p)
    if rows * kk < k or p <= 1:
        return jax.lax.top_k(flat, k)
    s2, i2 = jax.lax.top_k(flat.reshape(rows, p), kk)
    gidx = (jnp.arange(rows, dtype=jnp.int32)[:, None] * p
            + i2.astype(jnp.int32))
    top, im = jax.lax.top_k(s2.reshape(-1), k)
    return top, gidx.reshape(-1)[im]


def match_bank(bank: TemplateBank, bgr: jax.Array, depth_mm: jax.Array,
               threshold: float, det: cfg.DetectorConfig,
               masks: Optional[List] = None,
               kernels=None, class_mask=None, roi_box=None) -> Matches:
    """Full match over the template bank. All shapes static; jit-safe.

    ``kernels`` are the per-level score tables from
    :func:`build_match_tables`; pass precomputed ones to skip the
    rebuild (they depend only on the bank).  ``class_mask`` is an
    optional (capacity,) bool slot mask restricting the search to a
    subset of the bank — the class_ids filter of ``Detector::match``
    (linemod/linemod.hpp:317-325); build it from class names with
    :func:`fealess.bank.class_slot_mask`.  ``roi_box`` is an
    optional (4,) f32 ``(x0, y0, x1, y1)`` level-0 pixel box gating
    candidate POSITIONS at the coarse stage — the cheap search-region
    gate of the tracked pipeline (a feature-level ``masks`` breaks the
    front-end's XLA fusion; the box gate costs a compare per candidate
    position).  Semantics: a candidate survives iff its template
    rect intersects the box (vs the reference demo's zeroing of
    quantized features outside the mask, linemod_acq.cpp:136-191 — same
    intent, documented divergence)."""
    levels = quantized_pyramid(bgr, depth_mm, det, masks)
    planes = response_planes(levels, det)
    return match_from_planes(bank, planes, threshold, det, kernels,
                             class_mask=class_mask, roi_box=roi_box)


def match_from_planes(bank: TemplateBank, planes, threshold: float,
                      det: cfg.DetectorConfig, kernels=None,
                      class_mask=None, roi_box=None, *,
                      profile_stop=None) -> Matches:
    """Score the bank against decimated response planes.

    The coarse level computes all-template, all-position scores with the
    sparse accumulator (fealess.ops.score_pallas.coarse_scores
    — O(N·F·P) adds, the true work of the reference's linear-memory SSE
    loop, instead of the O(N·C·k²·P) dense one-hot conv whose kernel is
    >99.9% zeros at 1k templates) and feeds static top-K selection; finer
    levels score ONLY each surviving candidate's 16x16 window with the
    local scorer (O(K·F·256) — the cost shape of the reference's
    coarse-to-fine, linemod.cpp:1509-1573).  Semantics of matchClass
    (linemod.cpp:1451-1577) except that candidates whose template would
    wrap across the row end score their true (zero-padded) value instead
    of the reference's flat-buffer wraparound mixture, and candidate
    positions are restricted to non-wrapping ones (a strict improvement:
    wrapped scores are noise the reference filters only implicitly);
    clamped refinement windows never wrap, so zero-padded windows equal
    the reference's flat-buffer reads there (tested), and out-of-bounds
    features at degenerate clamps are discarded like similarityLocal's
    per-feature bounds checks (linemod.cpp:1257-1258)."""
    if profile_stop is not None and not ALLOW_PROFILE_STOPS:
        raise ValueError(
            "profile_stop is a benchmark-only hook (its stop-early returns "
            "carry polluted similarity); set detector.ALLOW_PROFILE_STOPS "
            "from a profiling harness to use it")
    l_coarse = det.pyramid_levels - 1
    t_c = det.t_at_level[l_coarse]
    d_c, (h_c, w_c) = planes[l_coarse]
    hd, wd = h_c // t_c, w_c // t_c
    p = hd * wd
    n = bank.capacity
    k = det.max_candidates
    if kernels is None or any(kernels[lv] is None
                              for lv in range(det.pyramid_levels)):
        kernels = build_match_tables(
            bank, det, grid_hw=[(pl_[0].shape[1], pl_[0].shape[2])
                                for pl_ in planes])

    # --- Coarse sparse scores at the lowest level (linemod.cpp:1462-1506)
    raw_i = score_pallas.coarse_scores(d_c, kernels[l_coarse])  # (N,Hd,Wd)

    nf = bank.num_features()                  # (N, L)
    nf_c = nf[:, l_coarse]
    raw_thr = (2 * nf_c
               + (np.float32(threshold) / np.float32(100.0)) * (2 * nf_c)
               + 0.5).astype(jnp.int32)
    wf = (bank.width[:, l_coarse] - 1) // t_c + 1
    hf = (bank.height[:, l_coarse] - 1) // t_c + 1
    px_idx = jnp.arange(wd)[None, None, :]
    py_idx = jnp.arange(hd)[None, :, None]
    slot_ok = bank.valid
    if class_mask is not None:
        # class_ids restriction (linemod.hpp:317-325): only masked-in
        # slots may seed candidates; refinement scores survivors only, so
        # gating the coarse stage filters the whole match.
        slot_ok = slot_ok & class_mask
    cand_ok = ((raw_i > raw_thr[:, None, None])
               & (px_idx <= (wd - wf)[:, None, None])
               & (py_idx <= (hd - hf)[:, None, None])
               & slot_ok[:, None, None])
    if roi_box is not None:
        # positional search-region gate (see match_bank): template rect
        # [x, x + w0) x [y, y + h0) at level-0 scale must intersect the
        # box.  Candidate pixel position at the coarse level scales by
        # 2^l_coarse back to level 0.
        sc = jnp.float32(1 << l_coarse)
        off_cf = jnp.float32(_offset(t_c))
        cand_x0 = ((px_idx.astype(jnp.float32) * t_c + off_cf) * sc)
        cand_y0 = ((py_idx.astype(jnp.float32) * t_c + off_cf) * sc)
        w0 = bank.width[:, 0].astype(jnp.float32)[:, None, None]
        h0 = bank.height[:, 0].astype(jnp.float32)[:, None, None]
        cand_ok = (cand_ok
                   & (cand_x0 + w0 > roi_box[0])
                   & (cand_x0 < roi_box[2])
                   & (cand_y0 + h0 > roi_box[1])
                   & (cand_y0 < roi_box[3]))
    # Exact top-K with the conversion DEFERRED to the survivors: within
    # a template row the reference score raw*100/(4nf)+0.5 is a positive
    # affine map of raw, so per-row top-k on masked i32 raw scores picks
    # the same entries in the same order; only the (N, kk) survivors
    # convert to f32 for the global merge.  Saves two full passes over
    # N*P floats (~0.2 ms at 1024t) and keeps the tie order of the flat
    # f32 formulation (rows ascend, columns ascend within a row).
    scale = div_exact(jnp.float32(100.0),
                      (4 * jnp.maximum(nf_c, 1)).astype(jnp.float32))
    p_cols = p
    kk = min(k, p_cols)
    if n * kk >= k and p_cols > 1:
        raw_masked = jnp.where(cand_ok, raw_i, -1).reshape(n, p_cols)
        s2, i2 = jax.lax.top_k(raw_masked, kk)
        s2f = jnp.where(s2 >= 0,
                        s2.astype(jnp.float32) * scale[:, None] + 0.5,
                        -jnp.inf)
        gidx = (jnp.arange(n, dtype=jnp.int32)[:, None] * p_cols
                + i2.astype(jnp.int32))
        top_scores, im = jax.lax.top_k(s2f.reshape(-1), k)
        top_idx = gidx.reshape(-1)[im]
    else:
        score = raw_i.astype(jnp.float32) * scale[:, None, None] + 0.5
        flat = jnp.where(cand_ok, score, -jnp.inf).reshape(-1)
        top_scores, top_idx = exact_top_k_rows(flat, k, n)
    tslot = top_idx // p
    pidx = top_idx % p
    off_c = _offset(t_c)
    x = (pidx % wd) * t_c + off_c
    y = (pidx // wd) * t_c + off_c
    sim = top_scores
    valid = jnp.isfinite(top_scores)
    if profile_stop == "topk":     # profiling hook (benchmarks only)
        cls0 = bank.class_idx[tslot]
        return Matches(x=x, y=y, similarity=sim, template_slot=tslot,
                       class_idx=cls0, template_idx=bank.template_idx[tslot],
                       valid=valid)

    # --- Local refinement up the pyramid (linemod.cpp:1509-1573):
    # candidate-windowed feature gather — only the K survivors' templates
    # are scored, over their 16x16 windows (similarityLocal semantics).
    for l in range(det.pyramid_levels - 2, -1, -1):
        t = det.t_at_level[l]
        d_l, (h, w) = planes[l]
        hd_l, wd_l = h // t, w // t
        border = 8 * t
        offs = _offset(t)
        width_l = bank.width[tslot, l]
        height_l = bank.height[tslot, l]
        nf_l = jnp.maximum(nf[tslot, l], 1)

        # Clamp with the lower bound winning (degenerate template-bigger-
        # than-search-area case): the window then anchors at the border
        # and features hanging off the image are discarded per-feature
        # (similarityLocal's bounds checks, linemod.cpp:1257-1258).
        x = jnp.maximum(jnp.minimum(x * 2 + 1, w - width_l - border), border)
        y = jnp.maximum(jnp.minimum(y * 2 + 1, h - height_l - border), border)

        win = similarity.LOCAL_WINDOW
        px0 = x // t - 8
        py0 = y // t - 8
        table_l = kernels[l]
        # Slot-gather the candidates' table rows via a one-hot matmul,
        # exact for i32 values < 2^24 under HIGHEST precision (table
        # entries are channel/offset indices < 2^16).  Whether this beats
        # a plain row gather on a GPU is not measured yet.
        oh = jax.nn.one_hot(tslot, n, dtype=jnp.float32)
        hi = jax.lax.Precision.HIGHEST
        table_k = {key: jnp.round(jnp.matmul(
            oh, table_l[key].astype(jnp.float32),
            precision=hi)).astype(jnp.int32) for key in table_l}
        if profile_stop == "gather":   # profiling hook (benchmarks only)
            return Matches(x=x, y=y,
                           similarity=(sim + table_k["c"].sum()
                                       + d_l.sum().astype(jnp.float32)),
                           template_slot=tslot, class_idx=bank.class_idx[tslot],
                           template_idx=bank.template_idx[tslot], valid=valid)
        total_i = score_pallas.local_scores(d_l, table_k, px0, py0)
        if profile_stop == "kernel":   # profiling hook (benchmarks only)
            return Matches(x=x, y=y,
                           similarity=sim + total_i.sum().astype(jnp.float32),
                           template_slot=tslot, class_idx=bank.class_idx[tslot],
                           template_idx=bank.template_idx[tslot], valid=valid)
        total = total_i.reshape(k, win * win).astype(jnp.float32)

        best = jnp.max(total, axis=1)
        best_idx = jnp.argmax(total, axis=1)       # first max, row-major
        best_r, best_c = best_idx // win, best_idx % win
        x = (x // t - 8 + best_c) * t + offs
        y = (y // t - 8 + best_r) * t + offs
        sim = div_exact(best * 100.0, (4 * nf_l).astype(jnp.float32))
        valid = valid & (sim >= jnp.float32(threshold))

    if profile_stop == "local":    # profiling hook (benchmarks only)
        cls0 = bank.class_idx[tslot]
        return Matches(x=x, y=y, similarity=sim, template_slot=tslot,
                       class_idx=cls0, template_idx=bank.template_idx[tslot],
                       valid=valid)

    # --- Final ordering + duplicate suppression (linemod.cpp:1437-1439)
    sim = jnp.where(valid, sim, -jnp.inf)
    tpl_idx = bank.template_idx[tslot]
    order = jnp.lexsort((tpl_idx, -sim))
    x, y, sim, tslot, valid = (x[order], y[order], sim[order], tslot[order],
                               valid[order])
    cls = bank.class_idx[tslot]
    tpl = bank.template_idx[tslot]
    same_as_prev = jnp.concatenate([
        jnp.array([False]),
        (x[1:] == x[:-1]) & (y[1:] == y[:-1]) & (sim[1:] == sim[:-1])
        & (cls[1:] == cls[:-1])])
    valid = valid & ~same_as_prev
    return Matches(x=x, y=y, similarity=sim, template_slot=tslot,
                   class_idx=cls, template_idx=tpl, valid=valid)


@functools.partial(jax.jit, static_argnames=("threshold", "det"))
def match_bank_jit(bank: TemplateBank, bgr: jax.Array, depth_mm: jax.Array,
                   threshold: float, det: cfg.DetectorConfig,
                   kernels=None) -> Matches:
    return match_bank(bank, bgr, depth_mm, threshold, det, kernels=kernels)


