"""3D non-maximum suppression over candidate object detections.

Masked fixed-shape reformulation of ``nonMaximumSuppression``
(ICP/NMS.cpp:6-40), preserving the exact sequential semantics: for each
unchecked seed ``i`` (input order), scan ``j > i``; any unchecked ``j``
within ``th_obj_dist`` of the CURRENT winner joins the cluster (is marked
checked) and replaces the winner if its model-point count exceeds 85% of
the SEED's count and its ``icp_dist`` is smaller.  One pose is emitted per
cluster, taken from the final winner.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NmsResult:
    keep: Any        # (K,) bool: a cluster was seeded at this index
    winner: Any      # (K,) int32: index of the cluster's winning candidate


def nms_3d(t: jax.Array, icp_dist: jax.Array, n_model_points: jax.Array,
           valid: jax.Array, th_obj_dist: float) -> NmsResult:
    """Args are (K,)-shaped candidate fields (``t`` is (K, 3) mm)."""
    k = t.shape[0]
    dist = jnp.linalg.norm(t[:, None, :] - t[None, :, :], axis=-1)
    near = dist < th_obj_dist                     # (K, K)
    idx = jnp.arange(k)

    def outer(i, state):
        checked, keep, winner = state
        is_seed = valid[i] & ~checked[i]
        size_th = jnp.floor(0.85 * n_model_points[i].astype(jnp.float32))

        def inner(j, carry):
            best, checked = carry
            joins = (is_seed & (j > i) & valid[j] & ~checked[j]
                     & near[best, j])
            checked = checked.at[j].set(checked[j] | joins)
            better = (joins
                      & (n_model_points[j].astype(jnp.float32) > size_th)
                      & (icp_dist[j] < icp_dist[best]))
            return jnp.where(better, j, best), checked

        best, checked = jax.lax.fori_loop(0, k, inner, (i, checked))
        checked = checked.at[i].set(checked[i] | is_seed)
        keep = keep.at[i].set(is_seed)
        winner = winner.at[i].set(jnp.where(is_seed, best, -1))
        return checked, keep, winner

    state = (jnp.zeros((k,), bool), jnp.zeros((k,), bool),
             jnp.full((k,), -1, jnp.int32))
    _, keep, winner = jax.lax.fori_loop(0, k, outer, state)
    del idx
    return NmsResult(keep=keep, winner=winner)
