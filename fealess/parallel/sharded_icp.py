"""Point-sharded ICP: distributed 3x3 covariance/centroid reductions.

The SP/CP-analog of SURVEY.md §2.6: for large point clouds, the paired
model/ref clouds shard across the mesh's ``p`` axis; every ICP iteration
computes per-shard partial sums (correspondence counts, centroids, the
3x3 covariance) that reduce with ``psum``; the tiny SVD solve replicates.
Brute-force NN searches the FULL ref cloud per query shard: each shard
holds its query slice and the whole ref (replicated), so no ppermute ring
is needed at these sizes (ref clouds are <= a few hundred KB).

Numeric semantics identical to fealess.icp (which documents the
reference parity rules).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from fealess import config as cfg
from fealess import icp as icp_mod
from fealess.geometry import transforms as tf
from fealess.icp import IcpResult


def icp_sharded(ref: jax.Array, model: jax.Array, pair_mask: jax.Array,
                icp: cfg.IcpConfig, mesh: Mesh, axis: str = "p") -> IcpResult:
    """Point-sharded ICP.  ``ref``/``model``/``pair_mask`` are (P, 3)/(P,)
    index-paired padded clouds; P must divide by the mesh axis size.

    All shards run the same while_loop in lockstep (the loop state is
    replicated scalars + the local model shard); cross-shard state reduces
    with psum each iteration.
    """
    fmax = jnp.float32(jnp.finfo(jnp.float32).max)
    hi = jax.lax.Precision.HIGHEST

    def psum(x):
        return jax.lax.psum(x, axis)

    def pair_stats(model_s, ref_s, mask_s, dist_thr):
        valid = (mask_s & (ref_s[:, 2] <= icp.valid_depth_max_mm)
                 & (model_s[:, 2] <= icp.valid_depth_max_mm))
        dist = jnp.linalg.norm(model_s - ref_s, axis=1)
        inlier = valid & (dist <= dist_thr)
        n_inlier = psum(jnp.sum(inlier))
        n_valid = psum(jnp.sum(valid))
        dist_sum = psum(jnp.sum(jnp.where(inlier, dist, 0.0)))
        dist_mean = jnp.where(n_valid > 0,
                              dist_sum / n_inlier.astype(jnp.float32), fmax)
        ratio = jnp.where(n_valid > 0,
                          n_inlier.astype(jnp.float32)
                          / n_valid.astype(jnp.float32), 0.0)
        return dist_mean, ratio

    def local_fn(ref_s, model_s, mask_s, ref_full):
        n_pairs = psum(jnp.sum(mask_s))
        ok = n_pairs >= icp.min_points
        dist_mean0, ratio0 = pair_stats(model_s, ref_s, mask_s, fmax)

        def cond(state):
            it, _, _, _, dist_mean, dist_diff, _ = state
            return ((dist_mean > icp.dist_mean_threshold)
                    & (dist_diff > icp.dist_diff_threshold)
                    & (it < icp.max_iterations))

        def body(state):
            it, r_acc, t_acc, model_tmp, dist_mean, dist_diff, ratio = state
            it = it + 1

            def identity_corr():
                return ref_s, mask_s

            def nn_corr():
                idx, d2 = icp_mod.nearest_neighbor(model_tmp, ref_full)
                gate = 3.0 * dist_mean
                if not icp.squared_distance_gate:
                    gate = gate * gate
                keep = mask_s & (d2 <= gate)
                return ref_full[idx], keep

            cor_ref, cor_mask = jax.lax.cond(it == 1, identity_corr, nn_corr)
            n_cor = psum(jnp.sum(cor_mask))
            enough = n_cor >= icp.min_points

            w = cor_mask.astype(jnp.float32)[:, None]
            count = jnp.maximum(n_cor.astype(jnp.float32), 1.0)
            m_centroid = psum(jnp.sum(model_tmp * w, axis=0)) / count
            r_centroid = psum(jnp.sum(cor_ref * w, axis=0)) / count
            if icp.centered_covariance:
                cov = psum(jnp.matmul(((model_tmp - m_centroid) * w).T,
                                      (cor_ref - r_centroid) * w,
                                      precision=hi))
            else:
                cov = psum(jnp.matmul((model_tmp * w).T, cor_ref * w,
                                      precision=hi))
            u, _, vt = jnp.linalg.svd(cov)
            r_opt = jnp.matmul(vt.T, u.T, precision=hi)
            t_opt = r_centroid - jnp.matmul(r_opt, m_centroid, precision=hi)
            finite = jnp.all(jnp.isfinite(r_opt)) & jnp.all(jnp.isfinite(t_opt))
            do_update = enough & finite
            r_opt = jnp.where(do_update, r_opt, jnp.eye(3))
            t_opt = jnp.where(do_update, t_opt, jnp.zeros(3))

            new_model = jnp.matmul(model_tmp, r_opt.T, precision=hi) + t_opt
            thr = 3.0 * dist_mean
            new_dist, new_ratio = pair_stats(new_model, ref_s, mask_s, thr)
            new_diff = dist_mean - new_dist

            model_tmp = jnp.where(do_update, new_model, model_tmp)
            dist_diff = jnp.where(do_update, new_diff, dist_diff)
            dist_mean = jnp.where(do_update, new_dist, dist_mean)
            ratio = jnp.where(do_update, new_ratio, ratio)
            t_acc = jnp.where(
                do_update, jnp.matmul(r_opt, t_acc, precision=hi) + t_opt,
                t_acc)
            r_acc = jnp.where(
                do_update, jnp.matmul(r_opt, r_acc, precision=hi), r_acc)
            it = jnp.where(enough, it, icp.max_iterations)
            return it, r_acc, t_acc, model_tmp, dist_mean, dist_diff, ratio

        init = (jnp.int32(0), jnp.eye(3, dtype=jnp.float32),
                jnp.zeros(3, jnp.float32), model_s, dist_mean0, fmax, ratio0)
        state = jax.lax.while_loop(
            cond, body,
            jax.lax.cond(ok, lambda: init,
                         lambda: (jnp.int32(icp.max_iterations),) + init[1:]))
        it, r_acc, t_acc, _, dist_mean, _, ratio = state
        return IcpResult(
            r=jnp.where(ok, r_acc, jnp.eye(3)),
            t=jnp.where(ok, t_acc, jnp.zeros(3)),
            dist_mean=jnp.where(ok, dist_mean, -1.0),
            inlier_ratio=ratio, iterations=it, ok=ok)

    out_specs = IcpResult(r=P(), t=P(), dist_mean=P(), inlier_ratio=P(),
                          iterations=P(), ok=P())
    fn = shard_map(local_fn, mesh=mesh,
                   in_specs=(P(axis), P(axis), P(axis), P()),
                   out_specs=out_specs, check_vma=False)
    return fn(ref, model, pair_mask, ref)


def icp_plane_sharded(ref: jax.Array, ref_normals: jax.Array,
                      model: jax.Array, pair_mask: jax.Array,
                      icp: cfg.IcpConfig, mesh: Mesh,
                      axis: str = "p") -> IcpResult:
    """Point-sharded point-to-plane ICP: the distributed 6x6 Gauss-Newton
    reduction (BASELINE.json north star).  Each shard accumulates its
    partial ``H = sum J J^T`` and ``g = sum J r`` over its point slice;
    ``psum`` combines them and every shard solves the replicated 6x6
    system.  NN runs against the replicated full ref cloud, as in
    :func:`icp_sharded`.  Numeric semantics match
    fealess.icp.icp_point_to_plane.
    """
    fmax = jnp.float32(jnp.finfo(jnp.float32).max)
    hi = jax.lax.Precision.HIGHEST

    def psum(x):
        return jax.lax.psum(x, axis)

    def pair_stats(model_s, ref_s, mask_s, dist_thr):
        valid = (mask_s & (ref_s[:, 2] <= icp.valid_depth_max_mm)
                 & (model_s[:, 2] <= icp.valid_depth_max_mm))
        dist = jnp.linalg.norm(model_s - ref_s, axis=1)
        inlier = valid & (dist <= dist_thr)
        n_inlier = psum(jnp.sum(inlier))
        n_valid = psum(jnp.sum(valid))
        dist_sum = psum(jnp.sum(jnp.where(inlier, dist, 0.0)))
        dist_mean = jnp.where(n_valid > 0,
                              dist_sum / n_inlier.astype(jnp.float32), fmax)
        ratio = jnp.where(n_valid > 0,
                          n_inlier.astype(jnp.float32)
                          / n_valid.astype(jnp.float32), 0.0)
        return dist_mean, ratio

    def local_fn(ref_s, norm_s, model_s, mask_s, ref_full, norm_full):
        n_pairs = psum(jnp.sum(mask_s))
        ok = n_pairs >= icp.min_points
        normal_ok = jnp.sum(norm_s * norm_s, axis=1) > 0.25
        # plane-degeneracy gate (see icp.icp_point_to_plane): psum'd
        # normal scatter, replicated eigensolve
        nmask = (mask_s & normal_ok
                 & (ref_s[:, 2] <= icp.valid_depth_max_mm))
        nw_g = nmask.astype(jnp.float32)[:, None]
        scatter = psum(jnp.matmul((norm_s * nw_g).T, norm_s * nw_g,
                                  precision=hi))
        scatter = scatter / jnp.maximum(psum(jnp.sum(nw_g)), 1.0)
        evals = jnp.linalg.eigvalsh(scatter)
        plane_ok = evals[1] > icp.plane_min_normal_anisotropy * evals[2]
        dist_mean0, ratio0 = pair_stats(model_s, ref_s, mask_s, fmax)

        def cond(state):
            it, _, _, _, dist_mean, dist_diff, _ = state
            return ((dist_mean > icp.dist_mean_threshold)
                    & (dist_diff > icp.dist_diff_threshold)
                    & (it < icp.max_iterations))

        def body(state):
            it, r_acc, t_acc, model_tmp, dist_mean, dist_diff, ratio = state
            it = it + 1

            def identity_corr():
                return ref_s, norm_s, mask_s & normal_ok

            def nn_corr():
                idx, d2 = icp_mod.nearest_neighbor(model_tmp, ref_full)
                gate = 3.0 * dist_mean
                if not icp.squared_distance_gate:
                    gate = gate * gate
                n_ok = jnp.sum(norm_full[idx] * norm_full[idx], axis=1) > 0.25
                keep = mask_s & (d2 <= gate) & n_ok
                return ref_full[idx], norm_full[idx], keep

            cor_ref, cor_n, cor_mask = jax.lax.cond(it == 1, identity_corr,
                                                    nn_corr)
            enough = psum(jnp.sum(cor_mask)) >= icp.min_points

            w = cor_mask.astype(jnp.float32)[:, None]
            # centroid-centred rotation block (see icp.icp_point_to_plane)
            n_cor = jnp.maximum(psum(jnp.sum(w)), 1.0)
            centroid = psum(jnp.sum(model_tmp * w, axis=0)) / n_cor
            resid = jnp.sum(cor_n * (model_tmp - cor_ref), axis=1)
            jrow = jnp.concatenate(
                [jnp.cross(model_tmp - centroid, cor_n), cor_n], axis=1)
            jw = jrow * w
            h = psum(jnp.matmul(jw.T, jw, precision=hi))
            g = psum(jnp.matmul(jw.T, (resid * cor_mask)[:, None],
                                precision=hi)[:, 0])
            if icp.plane_point_blend > 0.0:
                # point-to-point anchor (see icp.icp_point_to_plane):
                # per-shard partial H/g, psum'd like the plane block
                mc = model_tmp - centroid
                zeros = jnp.zeros_like(mc[:, 0])
                skew_neg = jnp.stack([
                    jnp.stack([zeros, mc[:, 2], -mc[:, 1]], axis=1),
                    jnp.stack([-mc[:, 2], zeros, mc[:, 0]], axis=1),
                    jnp.stack([mc[:, 1], -mc[:, 0], zeros], axis=1)],
                    axis=1)
                eye3 = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32),
                                        skew_neg.shape)
                j3 = jnp.concatenate([skew_neg, eye3], axis=2)
                j3w = (j3 * w[:, :, None]).reshape(-1, 6)
                r3 = ((model_tmp - cor_ref) * w).reshape(-1, 1)
                lam = jnp.float32(icp.plane_point_blend)
                h = h + lam * psum(jnp.matmul(j3w.T, j3w, precision=hi))
                g = g + lam * psum(jnp.matmul(j3w.T, r3,
                                              precision=hi)[:, 0])
            damp = icp.plane_damping * jnp.diag(jnp.maximum(jnp.diag(h),
                                                            1.0))
            delta = jnp.linalg.solve(h + damp, -g)
            omega, u = delta[:3], delta[3:]
            r_gn = tf.so3_exp(omega)
            t_gn = u + centroid - jnp.matmul(r_gn, centroid, precision=hi)
            # Kabsch update for the degenerate gate (psum'd covariance;
            # non-centered like the point mode's default — full-rank
            # even on planar clouds)
            r_centroid = psum(jnp.sum(cor_ref * w, axis=0)) / n_cor
            if icp.centered_covariance:
                cov = psum(jnp.matmul(((model_tmp - centroid) * w).T,
                                      (cor_ref - r_centroid) * w,
                                      precision=hi))
            else:
                cov = psum(jnp.matmul((model_tmp * w).T, cor_ref * w,
                                      precision=hi))
            uu, _, vt = jnp.linalg.svd(cov)
            r_kb = jnp.matmul(vt.T, uu.T, precision=hi)
            t_kb = r_centroid - jnp.matmul(r_kb, centroid, precision=hi)
            r_opt = jnp.where(plane_ok, r_gn, r_kb)
            t_opt = jnp.where(plane_ok, t_gn, t_kb)
            finite = jnp.where(plane_ok, jnp.all(jnp.isfinite(delta)),
                               jnp.all(jnp.isfinite(r_kb))
                               & jnp.all(jnp.isfinite(t_kb)))
            do_update = enough & finite
            r_opt = jnp.where(do_update, r_opt, jnp.eye(3))
            t_opt = jnp.where(do_update, t_opt, jnp.zeros(3))

            new_model = jnp.matmul(model_tmp, r_opt.T, precision=hi) + t_opt
            thr = 3.0 * dist_mean
            new_dist, new_ratio = pair_stats(new_model, ref_s, mask_s, thr)
            new_diff = dist_mean - new_dist

            model_tmp = jnp.where(do_update, new_model, model_tmp)
            dist_diff = jnp.where(do_update, new_diff, dist_diff)
            dist_mean = jnp.where(do_update, new_dist, dist_mean)
            ratio = jnp.where(do_update, new_ratio, ratio)
            t_acc = jnp.where(
                do_update, jnp.matmul(r_opt, t_acc, precision=hi) + t_opt,
                t_acc)
            r_acc = jnp.where(
                do_update, jnp.matmul(r_opt, r_acc, precision=hi), r_acc)
            it = jnp.where(enough, it, icp.max_iterations)
            return it, r_acc, t_acc, model_tmp, dist_mean, dist_diff, ratio

        init = (jnp.int32(0), jnp.eye(3, dtype=jnp.float32),
                jnp.zeros(3, jnp.float32), model_s, dist_mean0, fmax, ratio0)
        state = jax.lax.while_loop(
            cond, body,
            jax.lax.cond(ok, lambda: init,
                         lambda: (jnp.int32(icp.max_iterations),) + init[1:]))
        it, r_acc, t_acc, _, dist_mean, _, ratio = state
        return IcpResult(
            r=jnp.where(ok, r_acc, jnp.eye(3)),
            t=jnp.where(ok, t_acc, jnp.zeros(3)),
            dist_mean=jnp.where(ok, dist_mean, -1.0),
            inlier_ratio=ratio, iterations=it, ok=ok)

    out_specs = IcpResult(r=P(), t=P(), dist_mean=P(), inlier_ratio=P(),
                          iterations=P(), ok=P())
    fn = shard_map(local_fn, mesh=mesh,
                   in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P()),
                   out_specs=out_specs, check_vma=False)
    return fn(ref, ref_normals, model, pair_mask, ref, ref_normals)
