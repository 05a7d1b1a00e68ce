"""ICP property tests: recover known rigid perturbations (SURVEY.md §4b)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fealess import config as cfg
from fealess import icp as icp_mod


def _rot(axis, deg):
    axis = np.asarray(axis, np.float64)
    axis /= np.linalg.norm(axis)
    a = np.radians(deg)
    k = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k).astype(np.float32)


def _cloud(rng, n=400):
    # Surface-like cloud centred near (0, 0, 600) mm, z < 900 valid cap.
    pts = rng.normal(size=(n, 3)).astype(np.float32) * [60, 40, 15]
    pts[:, 2] += 600
    return pts


def test_icp_identity(rng):
    ref = _cloud(rng)
    padded, mask = icp_mod.pad_cloud(ref, np.ones(len(ref), bool), 512)
    res = icp_mod.icp_point_to_point(jnp.asarray(padded), jnp.asarray(padded),
                                     jnp.asarray(mask), cfg.IcpConfig())
    assert bool(res.ok)
    assert float(res.dist_mean) <= 0.5  # terminates at dist_mean_thr
    np.testing.assert_allclose(np.asarray(res.r), np.eye(3), atol=1e-4)
    np.testing.assert_allclose(np.asarray(res.t), 0, atol=1e-3)


def test_icp_recovers_small_transform(rng):
    ref = _cloud(rng, 600)
    r_true = _rot([0.3, 1.0, 0.2], 4.0)
    t_true = np.array([8.0, -5.0, 6.0], np.float32)
    centroid = ref.mean(axis=0)
    # model = inverse-transformed ref (so ICP should find r_true, t_true)
    model = (ref - centroid) @ r_true + centroid - r_true.T @ t_true
    # i.e. r_true @ model + t_true == ref (about the centroid)
    check = model @ r_true.T + t_true
    padded_m, mask = icp_mod.pad_cloud(model, np.ones(len(model), bool), 1024)
    padded_r, _ = icp_mod.pad_cloud(ref, np.ones(len(ref), bool), 1024)
    initial = np.linalg.norm(model - ref, axis=1).mean()

    # Parity mode (reference's non-centred covariance, ICP.cpp:730-735):
    # converges slowly but must reduce the residual substantially.
    icp_cfg = cfg.IcpConfig(max_iterations=30, dist_mean_threshold=0.01,
                            dist_diff_threshold=1e-5)
    res = icp_mod.icp_point_to_point(jnp.asarray(padded_r),
                                     jnp.asarray(padded_m),
                                     jnp.asarray(mask), icp_cfg)
    assert bool(res.ok)
    moved = model @ np.asarray(res.r).T + np.asarray(res.t)
    resid = np.linalg.norm(moved - ref, axis=1).mean()
    assert resid < 0.5 * initial, f"parity residual {resid} vs {initial}"

    # Centred Kabsch (the recommended mode) must nail the transform.
    icp_cfg2 = cfg.IcpConfig(max_iterations=30, dist_mean_threshold=0.01,
                             dist_diff_threshold=1e-6,
                             centered_covariance=True)
    res2 = icp_mod.icp_point_to_point(jnp.asarray(padded_r),
                                      jnp.asarray(padded_m),
                                      jnp.asarray(mask), icp_cfg2)
    moved2 = model @ np.asarray(res2.r).T + np.asarray(res2.t)
    resid2 = np.linalg.norm(moved2 - ref, axis=1).mean()
    assert resid2 < 0.3, f"centred residual {resid2}"
    del check


def test_icp_too_few_points():
    pts = np.zeros((8, 3), np.float32)
    mask = np.zeros(8, bool)
    mask[:2] = True
    res = icp_mod.icp_point_to_point(jnp.asarray(pts), jnp.asarray(pts),
                                     jnp.asarray(mask), cfg.IcpConfig())
    assert not bool(res.ok)
    assert float(res.dist_mean) == -1.0


def test_nearest_neighbor_exact(rng):
    ref = rng.normal(size=(200, 3)).astype(np.float32)
    query = rng.normal(size=(150, 3)).astype(np.float32)
    idx, d2 = icp_mod.nearest_neighbor(jnp.asarray(query), jnp.asarray(ref))
    d_full = ((query[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
    # f32 |q|^2-2qr+|r|^2 may flip exact argmin on near-ties; require the
    # chosen neighbour's true distance to match the true minimum closely.
    chosen = d_full[np.arange(len(query)), np.asarray(idx)]
    np.testing.assert_allclose(chosen, d_full.min(1), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(d2), chosen, rtol=1e-3, atol=1e-3)


def test_icp_invalid_z_excluded(rng):
    """Points beyond the 900mm validity cap must not affect the result."""
    ref = _cloud(rng, 300)
    far = ref.copy()
    far[:, 2] += 2000  # invalid
    both_ref = np.concatenate([ref, far])
    both_model = np.concatenate([ref, far + 50])
    mask = np.ones(len(both_ref), bool)
    pr, m = icp_mod.pad_cloud(both_ref, mask, 1024)
    pm, _ = icp_mod.pad_cloud(both_model, mask, 1024)
    res = icp_mod.icp_point_to_point(jnp.asarray(pr), jnp.asarray(pm),
                                     jnp.asarray(m), cfg.IcpConfig())
    # identical valid pairs -> immediate convergence
    assert float(res.dist_mean) <= 0.5


def _nn_brute(query, ref):
    d2 = ((query[:, None, :].astype(np.float64)
           - ref[None, :, :].astype(np.float64)) ** 2).sum(-1)
    return d2.argmin(1), d2.min(1)


@pytest.mark.parametrize("case", ["ties", "padding", "odd_sizes", "vmap"])
def test_nearest_neighbor_matches_brute_force(rng, case):
    """icp.nearest_neighbor (one fused variadic reduction) against a numpy
    brute force: first-minimum tie-breaking on exact duplicates and integer
    grids, PAD_COORD rows never chosen, sizes that are no power of two,
    and batching under vmap."""
    if case == "ties":
        query = rng.integers(0, 4, (257, 3)).astype(np.float32)
        ref = rng.integers(0, 4, (300, 3)).astype(np.float32)
    elif case == "padding":
        query = rng.normal(size=(200, 3)).astype(np.float32) * 50
        ref = np.full((512, 3), icp_mod.PAD_COORD, np.float32)
        ref[:250] = rng.normal(size=(250, 3)) * 50
        query[150:] = icp_mod.PAD_COORD
    else:
        query = rng.normal(size=(131, 3)).astype(np.float32) * 50
        ref = np.concatenate([query[:40], rng.normal(size=(333, 3))
                              .astype(np.float32) * 50])
    if case == "vmap":
        shifted = query + np.float32(3.0)
        idx, d2 = jax.vmap(icp_mod.nearest_neighbor, in_axes=(0, None))(
            jnp.asarray(np.stack([query, shifted])), jnp.asarray(ref))
        for b, qb in enumerate((query, shifted)):
            want_i, want_d = _nn_brute(qb, ref)
            np.testing.assert_array_equal(np.asarray(idx[b]), want_i)
            np.testing.assert_allclose(np.asarray(d2[b]), want_d,
                                       rtol=1e-5, atol=1e-6)
        return
    idx, d2 = icp_mod.nearest_neighbor(jnp.asarray(query), jnp.asarray(ref))
    want_i, want_d = _nn_brute(query, ref)
    np.testing.assert_array_equal(np.asarray(idx), want_i)
    np.testing.assert_allclose(np.asarray(d2), want_d, rtol=1e-5, atol=1e-6)
    if case == "padding":
        assert np.all(np.asarray(idx)[:150] < 250)
