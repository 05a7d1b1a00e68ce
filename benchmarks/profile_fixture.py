"""Per-stage device timing of the REAL fixture-bank recognition path.

Attributes the per-frame cost of ``pipeline.recognize_top1`` on the
fixture bank under benchmarks/reference/out/ (the bank the measured C++
baseline ran on — 192x160-px template span), stage by stage, using the
on-device chain-slope protocol of bench.py (the slope between a short and
a long on-device dependency chain).

Run on a GPU:  python benchmarks/profile_fixture.py [n_templates]
"""
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
FIXTURE = os.path.join(HERE, "reference", "out")

import cv2  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fealess import config as cfg  # noqa: E402
from fealess import detector as det_mod  # noqa: E402
from fealess import pipeline  # noqa: E402
from fealess.engine import ObjReco  # noqa: E402
from fealess.ops import image as fi  # noqa: E402
from fealess.ops import quantize as q  # noqa: E402
from fealess.ops import response, score_pallas  # noqa: E402

N = int(sys.argv[1]) if len(sys.argv) > 1 else 128
STAGE_FILTER = sys.argv[2].split(",") if len(sys.argv) > 2 else None
ITERS = 30

det_mod.ALLOW_PROFILE_STOPS = True   # stop-early profiling variants

eng = ObjReco.create("LmICP")
eng.add_obj(os.path.join(FIXTURE, "features"))
engine_cfg = eng.cfg
det_cfg = engine_cfg.detector

bank = jax.tree.map(lambda a: a[:N], eng.bank)
model_depth = jnp.asarray(eng._model_depth)[:N]
origins = jnp.asarray(eng._origins_array())[:N]
tables = det_mod.build_match_tables(bank, det_cfg)

bgr = jnp.asarray(cv2.imread(os.path.join(FIXTURE, "scene_bgr.png")))
depth = jnp.asarray(cv2.imread(os.path.join(FIXTURE, "scene_depth.png"),
                               cv2.IMREAD_UNCHANGED))
fx, fy, cx, cy = np.loadtxt(os.path.join(FIXTURE, "cam.txt"))
scene_k = jnp.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], jnp.float32)

OPS = dict(bank=bank, model_depth=model_depth, origins=origins,
           tables=tables, depth=depth, scene_k=scene_k)


def slope(body_fn, iters=ITERS, reps=2):
    @jax.jit
    def chain(b, steps, ops):
        return jax.lax.fori_loop(
            0, steps, lambda i, bb: body_fn(i, bb, ops), b)

    def run(n):
        t0 = time.perf_counter()
        np.asarray(chain(bgr, n, OPS))
        return time.perf_counter() - t0

    run(2)
    lo, hi = 2, 2 + iters
    ts = [run(n) for _ in range(reps) for n in (lo, hi)]
    return (min(ts[1::2]) - min(ts[0::2])) / iters * 1000.0


def dep(b, x):
    return b + (x.astype(jnp.float32).sum()
                > jnp.float32(1e30)).astype(jnp.uint8)


def full(i, b, ops):
    s = pipeline.recognize_top1(ops["bank"], ops["model_depth"],
                                ops["origins"], b, ops["depth"],
                                ops["scene_k"], engine_cfg,
                                kernels=ops["tables"])
    return b + ((s.pose.sum() + s.similarity) < -1e30).astype(jnp.uint8)


def match(i, b, ops):
    m = det_mod.match_bank(ops["bank"], b, ops["depth"], 75.0, det_cfg,
                           kernels=ops["tables"])
    return b + (m.similarity[0] < -1e30).astype(jnp.uint8)


def frontend(i, b, ops):
    levels = det_mod.quantized_pyramid(b, ops["depth"], det_cfg)
    planes = det_mod.response_planes(levels, det_cfg)
    return dep(b, sum(p.sum() for p, _ in planes))


def quant_pyramid(i, b, ops):
    levels = det_mod.quantized_pyramid(b, ops["depth"], det_cfg)
    return dep(b, sum(m.sum() for mods in levels for m in mods))


def grad_l0(i, b, ops):
    qcg, _ = q.quantize_gradients(b, det_cfg.color_gradient.weak_threshold)
    return dep(b, qcg.sum())


def blur_sobel(i, b, ops):
    s = fi.gaussian_blur7_u8(b)
    dx = fi.sobel3_i16(s, "x")
    dy = fi.sobel3_i16(s, "y")
    return dep(b, dx.astype(jnp.int32).sum() + dy.astype(jnp.int32).sum())


def normals(i, b, ops):
    dn = q.quantize_normals(ops["depth"], 2000, 50)
    return dep(b, dn.sum() + b[0, 0, 0].astype(jnp.uint32))


def coarse(i, b, ops):
    # coarse Pallas scorer on fixed planes (front included once, small)
    l = det_cfg.pyramid_levels - 1
    t = det_cfg.t_at_level[l]
    qcg, _ = q.quantize_gradients(b[::2, ::2], 10.0)
    planes = jnp.concatenate([response.build_level_2d(qcg, t)] * 2, axis=0)
    raw = score_pallas.coarse_scores(planes, ops["tables"][l])
    return dep(b, raw)


def _match_stop(stop):
    def fn(i, b, ops):
        levels = det_mod.quantized_pyramid(b, ops["depth"], det_cfg)
        planes = det_mod.response_planes(levels, det_cfg)
        m = det_mod.match_from_planes(ops["bank"], planes, 75.0, det_cfg,
                                      kernels=ops["tables"],
                                      profile_stop=stop)
        return b + ((m.similarity[0] + m.x[0]) < -1e30).astype(jnp.uint8)
    return fn


def coarse_real(i, b, ops):
    """frontend + coarse Pallas scorer on the real planes (subtract the
    frontend stage to get the scorer's own cost)."""
    levels = det_mod.quantized_pyramid(b, ops["depth"], det_cfg)
    planes = det_mod.response_planes(levels, det_cfg)
    l = det_cfg.pyramid_levels - 1
    raw = score_pallas.coarse_scores(planes[l][0], ops["tables"][l])
    return dep(b, raw)


def topk_stage(i, b, ops):
    """frontend + coarse + threshold/mask + lax.top_k (match_from_planes
    up to candidate selection; subtract coarse_real for the top-k cost)."""
    levels = det_mod.quantized_pyramid(b, ops["depth"], det_cfg)
    planes = det_mod.response_planes(levels, det_cfg)
    bank_l = ops["bank"]
    det = det_cfg
    l_coarse = det.pyramid_levels - 1
    t_c = det.t_at_level[l_coarse]
    d_c, (h_c, w_c) = planes[l_coarse]
    hd, wd = h_c // t_c, w_c // t_c
    raw_i = score_pallas.coarse_scores(d_c, ops["tables"][l_coarse])
    nf_c = bank_l.num_features()[:, l_coarse]
    raw_thr = (2 * nf_c + 0.75 * (2 * nf_c) + 0.5).astype(jnp.int32)
    wf = (bank_l.width[:, l_coarse] - 1) // t_c + 1
    hf = (bank_l.height[:, l_coarse] - 1) // t_c + 1
    px_idx = jnp.arange(wd)[None, None, :]
    py_idx = jnp.arange(hd)[None, :, None]
    cand_ok = ((raw_i > raw_thr[:, None, None])
               & (px_idx <= (wd - wf)[:, None, None])
               & (py_idx <= (hd - hf)[:, None, None])
               & bank_l.valid[:, None, None])
    score = (raw_i.astype(jnp.float32) * 100.0
             / (4 * jnp.maximum(nf_c, 1))[:, None, None].astype(jnp.float32))
    flat = jnp.where(cand_ok, score + 0.5, -jnp.inf).reshape(-1)
    # two-level exact top-k, as shipped in detector.match_from_planes
    k = det.max_candidates
    p = hd * wd
    s2, i2 = jax.lax.top_k(flat.reshape(-1, p), min(k, p))
    gidx = (jnp.arange(s2.shape[0], dtype=jnp.int32)[:, None] * p
            + i2.astype(jnp.int32))
    top_scores, im = jax.lax.top_k(s2.reshape(-1), k)
    top_idx = gidx.reshape(-1)[im]
    return dep(b, top_scores) + dep(b, top_idx.astype(jnp.float32))


def planes_l0(i, b, ops):
    """quant + level-0 planes only."""
    levels = det_mod.quantized_pyramid(b, ops["depth"], det_cfg)
    planes = det_mod.response_planes(levels, det_cfg)
    return dep(b, planes[0][0])


def planes_l1(i, b, ops):
    """quant + coarse-level planes only."""
    levels = det_mod.quantized_pyramid(b, ops["depth"], det_cfg)
    planes = det_mod.response_planes(levels, det_cfg)
    return dep(b, planes[det_cfg.pyramid_levels - 1][0])


STAGES = [
    ("full recognize_top1", full),
    ("match_bank", match),
    ("frontend(quant+planes)", frontend),
    ("quant_pyramid", quant_pyramid),
    ("grad L0 only", grad_l0),
    ("blur+sobel L0", blur_sobel),
    ("normals L0 only", normals),
    ("coarse scorer (+sm front)", coarse),
    ("coarse_real(front+coarse)", coarse_real),
    ("topk(front+coarse+topk)", topk_stage),
    ("planes_l0(quant+L0planes)", planes_l0),
    ("planes_l1(quant+L1planes)", planes_l1),
    ("stop_topk(match thru topk)", _match_stop("topk")),
    ("stop_gather(+L0p+table gather)", _match_stop("gather")),
    ("stop_kernel(+local kernel)", _match_stop("kernel")),
    ("stop_local(match thru refine)", _match_stop("local")),
]

print(f"n_templates={N}")
for name, fn in STAGES:
    if STAGE_FILTER and not any(s in name for s in STAGE_FILTER):
        continue
    try:
        ms = slope(fn)
        print(f"{name:32s} {ms:8.3f} ms/frame", flush=True)
    except Exception as e:  # noqa: BLE001
        print(f"{name:32s} FAILED: {type(e).__name__}: {e}", flush=True)
