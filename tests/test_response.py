"""Tests for spread / response maps / decimated layout / similarity
accumulation (linemod/linemod.cpp:882-1300 semantics)."""

import numpy as np
import jax.numpy as jnp
import pytest

from fealess.ops import luts, response, similarity


@pytest.fixture
def quant_img(rng):
    img = (1 << rng.integers(0, 8, size=(40, 80))).astype(np.uint8)
    img[rng.random((40, 80)) < 0.4] = 0
    return img


def _oracle_spread(src, t):
    h, w = src.shape
    out = np.zeros_like(src)
    for dy in range(t):
        for dx in range(t):
            shifted = np.zeros_like(src)
            shifted[:h - dy if dy else h, :w - dx if dx else w] = \
                src[dy:, dx:]
            out |= shifted
    return out


def test_spread_matches_oracle(quant_img):
    for t in (5, 8):
        ref = _oracle_spread(quant_img, t)
        out = np.asarray(response.spread(quant_img, t))
        np.testing.assert_array_equal(out, ref)


def test_response_maps_match_similarity_lut(quant_img):
    sp = _oracle_spread(quant_img, 5)
    lut = luts.similarity_lut()  # (8, 256)
    ref = lut[:, sp]             # (8, H, W)
    out = np.asarray(response.response_maps(sp))
    np.testing.assert_array_equal(out, ref)


def test_decimate_layout(quant_img):
    t = 5
    resp = np.asarray(response.response_maps(_oracle_spread(quant_img, t)))
    d = np.asarray(response.decimate(resp, t))
    h, w = quant_img.shape
    hd, wd = h // t, w // t
    assert d.shape == (8 * t * t, hd * wd)
    for label in (0, 3, 7):
        for a in (0, 2, t - 1):
            for b in (0, 1, t - 1):
                row = d[label * t * t + a * t + b]
                np.testing.assert_array_equal(
                    row.reshape(hd, wd), resp[label, a::t, b::t])


def test_whole_image_similarity_matches_direct_sum(quant_img, rng):
    """Score at decimated position p must equal the direct sum of responses
    at the template's shifted feature pixels (the linear-memory identity)."""
    t = 5
    h, w = quant_img.shape
    hd, wd = h // t, w // t
    positions = hd * wd
    resp = np.asarray(response.response_maps(_oracle_spread(quant_img, t)))
    d = np.asarray(response.decimate(resp, t))
    dpad = np.zeros((d.shape[0], 2 * positions), np.uint8)
    dpad[:, :positions] = d

    n, f = 3, 10
    fx = rng.integers(0, 15, size=(n, f))
    fy = rng.integers(0, 15, size=(n, f))
    fl = rng.integers(0, 8, size=(n, f))
    valid = rng.random((n, f)) < 0.8
    c, off = similarity.pack_features(jnp.asarray(fx), jnp.asarray(fy),
                                      jnp.asarray(fl), t, wd)
    scores = np.asarray(similarity.whole_image_similarity(
        jnp.asarray(dpad), c, off, jnp.asarray(valid), positions))

    # direct: template anchored at decimated (py, px): feature pixel is
    # (py*t + fy, px*t + fx)
    for ni in range(n):
        for py in range(0, hd - 3):
            for px in range(0, wd - 3):
                expect = 0
                for fi in range(f):
                    if not valid[ni, fi]:
                        continue
                    yy, xx = py * t + fy[ni, fi], px * t + fx[ni, fi]
                    expect += int(resp[fl[ni, fi], yy, xx])
                assert scores[ni, py * wd + px] == expect, (ni, py, px)


def test_local_similarity_window(quant_img, rng):
    t = 5
    h, w = quant_img.shape
    hd, wd = h // t, w // t
    p = hd * wd
    resp = np.asarray(response.response_maps(_oracle_spread(quant_img, t)))
    d = np.asarray(response.decimate(resp, t))
    stride = p + 16 * wd + 16
    d_flat = np.zeros((d.shape[0] * stride,), np.uint8)
    for ch in range(d.shape[0]):
        d_flat[ch * stride: ch * stride + p] = d[ch]

    f = 6
    fx = rng.integers(0, 10, size=(1, f))
    fy = rng.integers(0, 10, size=(1, f))
    fl = rng.integers(0, 8, size=(1, f))
    valid = np.ones((1, f), bool)
    base_y, base_x = 1, 2  # decimated window origin
    c, _ = similarity.pack_features(jnp.asarray(fx), jnp.asarray(fy),
                                    jnp.asarray(fl), t, wd)
    base = (base_y + jnp.asarray(fy) // t) * wd + (base_x + jnp.asarray(fx) // t)
    out = np.asarray(similarity.local_similarity(
        jnp.asarray(d_flat), c, base, jnp.asarray(valid), stride, wd))
    assert out.shape == (1, 256)

    for wy in range(3):
        for wx in range(3):
            expect = 0
            for fi in range(f):
                yy = (base_y + wy) * t + fy[0, fi]
                xx = (base_x + wx) * t + fx[0, fi]
                expect += int(resp[fl[0, fi], yy, xx])
            assert out[0, wy * 16 + wx] == expect, (wy, wx)


def test_build_level_2d_decimate_first_equivalence(rng):
    """The decimate-first fused pipeline must equal the reference-order
    spread -> response -> decimate composition exactly."""
    from fealess.ops import response as r

    for t in (5, 8):
        h, w = 16 * t, 24 * t
        labels = rng.integers(0, 9, size=(h, w))
        img = np.where(labels == 8, 0, 1 << np.minimum(labels, 7)).astype(np.uint8)
        fused = np.asarray(r.build_level_2d(jnp.asarray(img), t))
        ref = np.asarray(r.decimate_2d(r.response_maps(
            r.spread(jnp.asarray(img), t)), t))
        np.testing.assert_array_equal(fused, ref)

