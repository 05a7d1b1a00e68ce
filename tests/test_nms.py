"""NMS tests against a Python oracle restating NMS.cpp:6-40."""

import numpy as np
import jax.numpy as jnp

from fealess.nms import nms_3d


def _oracle(t, icp_dist, n_pts, valid, th):
    k = len(t)
    checked = [not v for v in valid]
    out = []
    for i in range(k):
        if checked[i]:
            continue
        best = i
        size_th = int(n_pts[i] * 0.85)
        for j in range(i + 1, k):
            if checked[j]:
                continue
            if np.linalg.norm(t[best] - t[j]) < th:
                checked[j] = True
                if n_pts[j] > size_th and icp_dist[j] < icp_dist[best]:
                    best = j
        checked[i] = True
        out.append((i, best))
    return out


def _run(t, icp_dist, n_pts, valid, th):
    res = nms_3d(jnp.asarray(t, jnp.float32), jnp.asarray(icp_dist, jnp.float32),
                 jnp.asarray(n_pts, jnp.int32), jnp.asarray(valid), th)
    keep = np.asarray(res.keep)
    winner = np.asarray(res.winner)
    return [(i, int(winner[i])) for i in range(len(t)) if keep[i]]


def test_nms_matches_oracle(rng):
    for trial in range(5):
        k = 12
        t = rng.normal(size=(k, 3)) * 60
        icp_dist = rng.random(k).astype(np.float32)
        n_pts = rng.integers(50, 150, size=k)
        valid = rng.random(k) < 0.8
        got = _run(t, icp_dist, n_pts, valid, 80.0)
        expect = _oracle(t, icp_dist, n_pts, valid, 80.0)
        assert got == expect, (trial, got, expect)


def test_nms_two_clusters():
    t = np.array([[0, 0, 0], [5, 0, 0], [500, 0, 0]], np.float32)
    icp = np.array([1.0, 0.1, 0.5], np.float32)
    n = np.array([100, 100, 100])
    got = _run(t, icp, n, np.ones(3, bool), 50.0)
    # cluster {0,1} seeded at 0, winner 1 (more inliers-equal, lower dist)
    assert got == [(0, 1), (2, 2)]
