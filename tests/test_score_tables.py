"""Oracle tests for the sparse score-table path (ops/score_pallas +
detector.build_match_tables): random banks and planes scored against a
direct numpy sum over features (the defining formula of
``similarity``/``similarityLocal``, linemod.cpp:1130-1300)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fealess import config as cfg
from fealess import detector
from fealess.bank import TemplateBank
from fealess.ops import score_pallas, similarity


def _random_bank(rng, n, levels, mods, f, span_px, t_at_level):
    shape = (n, levels, mods, f)
    width = np.full((n, levels), span_px, np.int32)
    for l in range(1, levels):
        width[:, l] = span_px >> l
    fx = np.zeros(shape, np.int32)
    fy = np.zeros(shape, np.int32)
    for l in range(levels):
        fx[:, l] = rng.integers(0, max(span_px >> l, 1), (n, mods, f))
        fy[:, l] = rng.integers(0, max(span_px >> l, 1), (n, mods, f))
    return TemplateBank(
        feat_x=jnp.asarray(fx), feat_y=jnp.asarray(fy),
        feat_label=jnp.asarray(rng.integers(0, 8, shape)),
        feat_valid=jnp.asarray(rng.random(shape) < 0.7),
        width=jnp.asarray(width), height=jnp.asarray(width),
        offset_x=jnp.zeros((n, levels), jnp.int32),
        offset_y=jnp.zeros((n, levels), jnp.int32),
        pose=jnp.zeros((n, 13), jnp.float32),
        class_idx=jnp.zeros((n,), jnp.int32),
        template_idx=jnp.arange(n, dtype=jnp.int32),
        valid=jnp.ones((n,), bool),
        class_names=("obj",), max_span=span_px + 1)


@pytest.fixture()
def rng():
    return np.random.default_rng(3)


def test_coarse_scores_match_direct_sum(rng):
    t = 8
    hd, wd = 12, 15
    mods, f, n = 2, 16, 24
    span = 5 * t          # 5 decimated cells
    det_cfg = cfg.DetectorConfig(image_width=wd * t * 2,
                                 image_height=hd * t * 2)
    bank = _random_bank(rng, n, 2, mods, f, span, det_cfg.t_at_level)
    l = 1
    planes = rng.integers(0, 5, (mods * 8 * t * t, hd, wd), np.uint8)
    tables = detector.build_match_tables(bank, det_cfg,
                                         grid_hw=[(hd * 2, wd * 2),
                                                  (hd, wd)])
    got = np.asarray(score_pallas.coarse_scores(jnp.asarray(planes),
                                                tables[l]))

    fx = np.asarray(bank.feat_x)[:, l]
    fy = np.asarray(bank.feat_y)[:, l]
    fl = np.asarray(bank.feat_label)[:, l]
    fv = np.asarray(bank.feat_valid)[:, l]
    pad = np.pad(planes.astype(np.int64), ((0, 0), (0, 16), (0, 16)))
    want = np.zeros((n, hd, wd), np.int64)
    for ni in range(n):
        for m in range(mods):
            for fi in range(f):
                if not fv[ni, m, fi]:
                    continue
                c = ((m * 8 + fl[ni, m, fi]) * t * t
                     + (fy[ni, m, fi] % t) * t + fx[ni, m, fi] % t)
                ry, rx = fy[ni, m, fi] // t, fx[ni, m, fi] // t
                want[ni] += pad[c, ry:ry + hd, rx:rx + wd]
    np.testing.assert_array_equal(got, want)


def _local_oracle(planes, bank, slots, px0, py0, t, l=0):
    """Direct numpy sum with zero past the image — the per-feature bounds
    discard of similarityLocal (linemod.cpp:1257-1258)."""
    fx = np.asarray(bank.feat_x)[:, l]
    fy = np.asarray(bank.feat_y)[:, l]
    fl = np.asarray(bank.feat_label)[:, l]
    fv = np.asarray(bank.feat_valid)[:, l]
    mods = fx.shape[1]
    # pad generously: window reads start at px0 + rx (rx < span cells)
    pad = np.pad(planes.astype(np.int64),
                 ((0, 0), (0, 256), (0, 256)))
    want = np.zeros((len(slots), 16, 16), np.int64)
    for ki, ni in enumerate(np.asarray(slots)):
        for m in range(mods):
            for fi in range(fx.shape[2]):
                if not fv[ni, m, fi]:
                    continue
                c = ((m * 8 + fl[ni, m, fi]) * t * t
                     + (fy[ni, m, fi] % t) * t + fx[ni, m, fi] % t)
                a = max(int(py0[ki]), 0) + fy[ni, m, fi] // t
                b = max(int(px0[ki]), 0) + fx[ni, m, fi] // t
                want[ki] += pad[c, a:a + 16, b:b + 16]
    return want


def test_local_scores_right_edge_wd128(rng):
    """Candidates whose 16-column window reads run past the right image
    edge at the level-0 640-wide geometry (Wd = 128): in-image columns
    keep their true score, columns past the edge score 0."""
    t = 5
    hd, wd = 96, 128
    mods, f, n = 2, 24, 6
    span = 8 * t                      # rx up to 8 decimated cells
    det_cfg = cfg.DetectorConfig(image_width=wd * t, image_height=hd * t)
    bank = _random_bank(rng, n, 2, mods, f, span, det_cfg.t_at_level)
    planes = rng.integers(0, 5, (mods * 8 * t * t, hd, wd), np.uint8)
    tables = detector.build_match_tables(bank, det_cfg,
                                         grid_hw=[(hd, wd),
                                                  (hd // 2, wd // 2)])
    k = 8
    slots = jnp.asarray(rng.integers(0, n, (k,)))
    # px0 right at the clamp limit: px0 + rx + 15 crosses lane 128 for
    # every rx >= 1 while lanes [px0+rx, 128) are real image columns.
    px0 = jnp.asarray(rng.integers(wd - 16 - 4, wd - 16 + 1, (k,)),
                      jnp.int32)
    py0 = jnp.asarray(rng.integers(0, hd - 16 - 8, (k,)), jnp.int32)
    table_k = {key: tables[0][key][slots] for key in tables[0]}
    got = np.asarray(score_pallas.local_scores(
        jnp.asarray(planes), table_k, px0, py0))
    want = _local_oracle(planes, bank, slots, px0, py0, t)
    np.testing.assert_array_equal(got, want)


def test_local_scores_wide_plane_fallback(rng):
    """A level-0 width that is no power of two (image_width 800 ->
    Wd=160), windows up to the right edge included."""
    t = 5
    hd, wd = 40, 160
    mods, f, n = 2, 20, 5
    span = 6 * t
    det_cfg = cfg.DetectorConfig(image_width=wd * t, image_height=hd * t)
    bank = _random_bank(rng, n, 2, mods, f, span, det_cfg.t_at_level)
    planes = rng.integers(0, 5, (mods * 8 * t * t, hd, wd), np.uint8)
    tables = detector.build_match_tables(bank, det_cfg,
                                         grid_hw=[(hd, wd),
                                                  (hd // 2, wd // 2)])
    k = 6
    slots = jnp.asarray(rng.integers(0, n, (k,)))
    px0 = jnp.asarray(
        np.concatenate([rng.integers(0, wd - 16 - 6, (k - 2,)),
                        [wd - 16, wd - 16 - 1]]), jnp.int32)
    py0 = jnp.asarray(rng.integers(0, hd - 16 - 6, (k,)), jnp.int32)
    table_k = {key: tables[0][key][slots] for key in tables[0]}
    got = np.asarray(score_pallas.local_scores(
        jnp.asarray(planes), table_k, px0, py0))
    want = _local_oracle(planes, bank, slots, px0, py0, t)
    np.testing.assert_array_equal(got, want)


def test_local_scores_match_direct_sum(rng):
    t = 5
    hd, wd = 32, 48
    mods, f, n = 2, 20, 10
    span = 6 * t
    det_cfg = cfg.DetectorConfig(image_width=wd * t, image_height=hd * t)
    bank = _random_bank(rng, n, 2, mods, f, span, det_cfg.t_at_level)
    l = 0
    planes = rng.integers(0, 5, (mods * 8 * t * t, hd, wd), np.uint8)
    tables = detector.build_match_tables(bank, det_cfg,
                                         grid_hw=[(hd, wd),
                                                  (hd // 2, wd // 2)])
    k = 7
    slots = jnp.asarray(rng.integers(0, n, (k,)))
    px0 = jnp.asarray(rng.integers(0, wd - 16 - 6, (k,)), jnp.int32)
    py0 = jnp.asarray(rng.integers(0, hd - 16 - 6, (k,)), jnp.int32)
    table_k = {key: tables[l][key][slots] for key in tables[l]}
    got = np.asarray(score_pallas.local_scores(
        jnp.asarray(planes), table_k, px0, py0))

    fx = np.asarray(bank.feat_x)[:, l]
    fy = np.asarray(bank.feat_y)[:, l]
    fl = np.asarray(bank.feat_label)[:, l]
    fv = np.asarray(bank.feat_valid)[:, l]
    pad = np.pad(planes.astype(np.int64), ((0, 0), (0, 32), (0, 96)))
    want = np.zeros((k, 16, 16), np.int64)
    for ki in range(k):
        ni = int(slots[ki])
        for m in range(mods):
            for fi in range(f):
                if not fv[ni, m, fi]:
                    continue
                c = ((m * 8 + fl[ni, m, fi]) * t * t
                     + (fy[ni, m, fi] % t) * t + fx[ni, m, fi] % t)
                a = int(py0[ki]) + fy[ni, m, fi] // t
                b = int(px0[ki]) + fx[ni, m, fi] // t
                want[ki] += pad[c, a:a + 16, b:b + 16]
    np.testing.assert_array_equal(got, want)


def test_exact_top_k_rows_equals_flat_top_k(rng):
    """The 2-level candidate selection must equal jax.lax.top_k exactly,
    INCLUDING tie order (value desc, flat index asc) — scores are
    quantized ints so ties are common."""
    for rows, cols, k in ((16, 24, 8), (64, 30, 64), (8, 4, 16)):
        # heavy ties: few distinct values
        flat = jnp.asarray(
            rng.integers(0, 6, rows * cols).astype(np.float32))
        flat = jnp.where(jnp.asarray(rng.random(rows * cols) < 0.5),
                         flat, -jnp.inf)
        s0, i0 = jax.lax.top_k(flat, k)
        s1, i1 = detector.exact_top_k_rows(flat, k, rows)
        np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


def test_deferred_topk_equals_flat_f32_formulation():
    """The integer-domain per-row top-k with deferred f32 conversion
    (detector.match_from_planes) must equal the flat f32 formulation
    exactly — values AND flat indices, including heavy ties (the
    identical-template fixture is all ties)."""
    import jax
    import jax.numpy as jnp

    from fealess import detector

    rng = np.random.default_rng(1)
    n, hd, wd = 64, 12, 17
    p = hd * wd
    k = 24
    for trial in range(3):
        raw = rng.integers(0, 12 if trial else 3, size=(n, hd, wd))
        raw = jnp.asarray(raw.astype(np.int32))
        nf = jnp.asarray(rng.integers(1, 127, size=(n,)).astype(np.int32))
        ok = jnp.asarray(rng.random((n, hd, wd)) > 0.3)
        scale = (100.0 / (4 * jnp.maximum(nf, 1)).astype(jnp.float32))

        # reference formulation
        score = raw.astype(jnp.float32) * scale[:, None, None] + 0.5
        flat = jnp.where(ok, score, -jnp.inf).reshape(-1)
        ref_s, ref_i = detector.exact_top_k_rows(flat, k, n)

        # deferred formulation (as in match_from_planes)
        raw_masked = jnp.where(ok, raw, -1).reshape(n, p)
        kk = min(k, p)
        s2, i2 = jax.lax.top_k(raw_masked, kk)
        s2f = jnp.where(s2 >= 0,
                        s2.astype(jnp.float32) * scale[:, None] + 0.5,
                        -jnp.inf)
        gidx = (jnp.arange(n, dtype=jnp.int32)[:, None] * p
                + i2.astype(jnp.int32))
        new_s, im = jax.lax.top_k(s2f.reshape(-1), k)
        new_i = gidx.reshape(-1)[im]

        assert np.array_equal(np.asarray(ref_s), np.asarray(new_s)), trial
        # indices must agree wherever scores are finite (tie order incl.)
        fin = np.isfinite(np.asarray(ref_s))
        assert np.array_equal(np.asarray(ref_i)[fin],
                              np.asarray(new_i)[fin]), trial


def _coarse_oracle_case(rng, hd, wd, n):
    """Random bank + planes at a real coarse geometry (T=8, two
    modalities, 63 features each, 192-px template span)."""
    t = 8
    mods, f = 2, 63
    det_cfg = cfg.DetectorConfig(image_width=wd * t * 2,
                                 image_height=hd * t * 2)
    bank = _random_bank(rng, n, 2, mods, f, 192, det_cfg.t_at_level)
    planes = rng.integers(0, 5, (mods * 8 * t * t, hd, wd), np.uint8)
    tables = detector.build_match_tables(bank, det_cfg,
                                         grid_hw=[(hd * 2, wd * 2),
                                                  (hd, wd)])
    return bank, planes, tables[1], t


def _whole_image_oracle(bank, planes, t, l=1):
    """ops.similarity's flat-buffer scorer plus the mask of candidate-
    eligible positions (no template column wraps past the row end —
    the only positions the detector seeds from)."""
    n = bank.capacity
    c_ch, hd, wd = planes.shape
    p = hd * wd
    mod_off = 8 * jnp.arange(bank.modalities, dtype=jnp.int32)[None, :, None]
    lbl = (bank.feat_label[:, l] + mod_off).reshape(n, -1)
    c_f, off = similarity.pack_features(
        bank.feat_x[:, l].reshape(n, -1), bank.feat_y[:, l].reshape(n, -1),
        lbl, t, wd)
    d_flat = jnp.pad(jnp.asarray(planes).reshape(c_ch, p),
                     ((0, 0), (0, p + 1)))
    want = np.asarray(similarity.whole_image_similarity(
        d_flat, c_f, off, bank.feat_valid[:, l].reshape(n, -1),
        p)).reshape(n, hd, wd)
    wf = (np.asarray(bank.width[:, l]) - 1) // t + 1
    hf = (np.asarray(bank.height[:, l]) - 1) // t + 1
    ok = ((np.arange(wd)[None, None, :] <= (wd - wf)[:, None, None])
          & (np.arange(hd)[None, :, None] <= (hd - hf)[:, None, None]))
    return want, ok


@pytest.mark.parametrize("hd,wd,n", [(30, 40, 8), (60, 80, 8),
                                     (30, 40, 13)],
                         ids=["640x480", "1280x960", "13_templates"])
def test_coarse_triton_kernel_matches_similarity_oracle(rng, hd, wd, n):
    """The Triton coarse kernel, run by the Pallas interpreter, equals
    the independent gather oracle (ops.similarity) at the coarse grids of
    the 640x480 and 1280x960 geometries (one and two row tiles) and at a
    template count that is no power of two."""
    bank, planes, table, t = _coarse_oracle_case(rng, hd, wd, n)
    got = np.asarray(score_pallas._coarse_scores_triton(
        jnp.asarray(planes), table, interpret=True))
    want, ok = _whole_image_oracle(bank, planes, t)
    assert got.shape == (n, hd, wd)
    np.testing.assert_array_equal(np.where(ok, got, 0), np.where(ok, want, 0))
    np.testing.assert_array_equal(
        got, np.asarray(score_pallas._coarse_scores_xla(jnp.asarray(planes),
                                                        table)))


def test_coarse_triton_kernel_under_vmap(rng):
    """A frame batch (parallel.batch_recon vmaps the step) batches the
    Triton kernel's grid; each frame equals its own plain score."""
    bank, planes, table, _ = _coarse_oracle_case(rng, 30, 40, 4)
    batch = jnp.asarray(np.stack([planes, planes[::-1]]))
    got = np.asarray(jax.vmap(lambda p: score_pallas._coarse_scores_triton(
        p, table, interpret=True))(batch))
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], np.asarray(score_pallas._coarse_scores_xla(batch[b],
                                                               table)))


def test_local_scores_match_similarity_oracle(rng):
    """The single-gather local scorer equals ops.similarity's flat-buffer
    window oracle on every window whose reads stay inside the image
    (elsewhere the oracle wraps rows and the scorer reads zeros)."""
    t = 5
    hd, wd = 96, 128
    mods, f, n, k = 2, 63, 12, 32
    det_cfg = cfg.DetectorConfig(image_width=wd * t, image_height=hd * t)
    bank = _random_bank(rng, n, 2, mods, f, 96, det_cfg.t_at_level)
    planes = rng.integers(0, 5, (mods * 8 * t * t, hd, wd), np.uint8)
    tables = detector.build_match_tables(bank, det_cfg,
                                         grid_hw=[(hd, wd),
                                                  (hd // 2, wd // 2)])
    slots = rng.integers(0, n, (k,))
    px0 = rng.integers(0, wd - 16 + 1, (k,)).astype(np.int32)
    py0 = rng.integers(0, hd - 16 + 1, (k,)).astype(np.int32)
    table_k = {key: tables[0][key][slots] for key in tables[0]}
    got = np.asarray(score_pallas.local_scores(
        jnp.asarray(planes), table_k, jnp.asarray(px0), jnp.asarray(py0)))

    mod_off = 8 * np.arange(mods)[None, :, None]
    fx = np.asarray(bank.feat_x)[:, 0].reshape(n, -1)[slots]
    fy = np.asarray(bank.feat_y)[:, 0].reshape(n, -1)[slots]
    lbl = (np.asarray(bank.feat_label)[:, 0] + mod_off).reshape(n, -1)[slots]
    fv = np.asarray(bank.feat_valid)[:, 0].reshape(n, -1)[slots]
    c, _ = similarity.pack_features(jnp.asarray(fx), jnp.asarray(fy),
                                    jnp.asarray(lbl), t, wd)
    ry, rx = fy // t, fx // t
    base = (py0[:, None] + ry) * wd + (px0[:, None] + rx)
    p = hd * wd
    stride = p + 16 * wd + 16
    d_flat = jnp.pad(jnp.asarray(planes).reshape(-1, p),
                     ((0, 0), (0, stride - p))).reshape(-1)
    want = np.asarray(similarity.local_similarity(
        d_flat, c, jnp.asarray(base), jnp.asarray(fv), stride,
        wd)).reshape(k, 16, 16)
    interior = ((np.max(np.where(fv, rx, 0), axis=1) + px0 + 16 <= wd)
                & (np.max(np.where(fv, ry, 0), axis=1) + py0 + 16 <= hd))
    assert interior.sum() >= 8
    np.testing.assert_array_equal(got[interior], want[interior])
