"""Smoke test of the served recognition path on one NVIDIA GPU.

    python chip_smoke.py           # one card: kernels, end to end, artifact
    python chip_smoke.py --four    # four cards: the sharded paths only

One process drives the card.  Every phase compares the card with the same
computation committed to the host CPU device in this process (the plain
XLA path there) or with the independent gather oracle
``fealess.ops.similarity``, at the widths the engine serves: the
1024-template fixture bank at 640x480 with plane ICP and the 1280x960 wide
fixture (benchmarks/reference/out).  A failed phase raises, so the script
exits non-zero and prints no result line; it refuses to run when JAX finds
no GPU.  The last line of standard output is one JSON object naming the
device.
"""

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

N_LOCAL = 64           # level-0 refinement windows compared
KCF_UPDATES = 8


def card_header() -> str:
    """Name and power limit of the card, read by a child that never
    imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]


def check(name: str, ok: bool, **detail) -> None:
    print(f"[{'OK' if ok else 'FAIL'}] {name} {json.dumps(detail)}",
          flush=True)
    if not ok:
        raise AssertionError(f"phase {name} failed: {detail}")


def on_cpu(tree):
    import jax

    return jax.device_put(tree, jax.devices("cpu")[0])


def cpu_engine(eng):
    """The engine's state committed to the host CPU device."""
    import jax

    cpu = jax.devices("cpu")[0]
    twin = copy.copy(eng)
    twin.bank = jax.device_put(eng.bank, cpu)
    twin._model_depth_dev = jax.device_put(eng._model_depth_dev, cpu)
    twin._origins_dev = jax.device_put(eng._origins_dev, cpu)
    twin._kernels = jax.device_put(eng._kernels, cpu)
    return twin


def fixture_engine():
    from benchmarks import fixtures
    from fealess.engine import CamIntrinsics, ObjReco

    eng = ObjReco.create("LmICP")
    eng.add_obj(os.path.join(fixtures.FIXTURE, "features"))
    fx, fy, cx, cy = fixtures.fixture_intrinsics()
    cam = CamIntrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=640, height=480)
    bgr, depth = fixtures.fixture_frame()
    return eng, cam, bgr, depth


def planes_fn(det):
    import jax

    from fealess import detector

    @jax.jit
    def fn(bgr, depth):
        levels = detector.quantized_pyramid(bgr, depth, det)
        return [p for p, _ in detector.response_planes(levels, det)]
    return fn


def scene_k(cam):
    import jax.numpy as jnp

    return jnp.asarray([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy],
                        [0, 0, 1]], jnp.float32)


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------

def phase_planes(name, det, bgr, depth):
    """Response planes on the card vs the CPU device: exactly equal."""
    import jax
    import jax.numpy as jnp

    fn = planes_fn(det)
    gpu = [np.asarray(p) for p in fn(jnp.asarray(bgr), jnp.asarray(depth))]
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = [np.asarray(p) for p in fn(jnp.asarray(bgr),
                                         jnp.asarray(depth))]
    check(f"planes_{name}",
          all(np.array_equal(a, b) for a, b in zip(gpu, cpu)),
          shapes=[list(p.shape) for p in gpu],
          mismatches=[int(np.sum(a != b)) for a, b in zip(gpu, cpu)])
    return gpu


def phase_coarse(name, bank, det, planes_c):
    """Coarse scores: the Triton kernel on the card vs the plain scorer on
    the CPU device (every position) and vs the gather oracle (every
    candidate-eligible position)."""
    import jax
    import jax.numpy as jnp

    from fealess import detector
    from fealess.ops import score_pallas, similarity

    l = det.pyramid_levels - 1
    t = det.t_at_level[l]
    table = detector.build_match_tables(bank, det)[l]
    fn = jax.jit(score_pallas.coarse_scores)
    got = np.asarray(fn(jnp.asarray(planes_c), table))
    plain = np.asarray(fn(on_cpu(planes_c), on_cpu(table)))

    n = bank.capacity
    c_ch, hd, wd = planes_c.shape
    p = hd * wd
    cpu_bank = on_cpu(bank)
    mod_off = 8 * np.arange(bank.modalities)[None, :, None]
    lbl = (np.asarray(bank.feat_label)[:, l] + mod_off).reshape(n, -1)
    c_f, off = similarity.pack_features(
        cpu_bank.feat_x[:, l].reshape(n, -1),
        cpu_bank.feat_y[:, l].reshape(n, -1), on_cpu(lbl), t, wd)
    d_flat = on_cpu(np.pad(planes_c.reshape(c_ch, p), ((0, 0), (0, p + 1))))
    oracle = np.asarray(jax.jit(similarity.whole_image_similarity,
                                static_argnums=4)(
        d_flat, c_f, off, cpu_bank.feat_valid[:, l].reshape(n, -1),
        p)).reshape(n, hd, wd)
    wf = (np.asarray(bank.width[:, l]) - 1) // t + 1
    hf = (np.asarray(bank.height[:, l]) - 1) // t + 1
    ok = ((np.arange(wd)[None, None, :] <= (wd - wf)[:, None, None])
          & (np.arange(hd)[None, :, None] <= (hd - hf)[:, None, None]))
    check(f"coarse_{name}",
          np.array_equal(got, plain)
          and np.array_equal(np.where(ok, got, 0), np.where(ok, oracle, 0)),
          shape=list(got.shape),
          vs_plain_mismatches=int(np.sum(got != plain)),
          vs_oracle_mismatches=int(np.sum(np.where(ok, got != oracle,
                                                   False))),
          eligible_positions=int(ok.sum()))
    return got


def local_windows(rng, coarse, bank, det, wd0, hd0):
    """(slots, px0, py0): half from the best coarse cells mapped with the
    detector's arithmetic, half random with right-edge windows."""
    n, hd, wd = coarse.shape
    l_c = det.pyramid_levels - 1
    t_c, t0 = det.t_at_level[l_c], det.t_at_level[0]
    flat = np.where(np.asarray(bank.valid)[:, None, None], coarse,
                    -1).reshape(-1)
    top = np.argsort(flat, kind="stable")[::-1][:N_LOCAL // 2]
    slots = top // (hd * wd)
    off_c = t_c // 2 + (t_c % 2 - 1)
    x0 = ((top % wd) * t_c + off_c) * 2 + 1
    y0 = (((top % (hd * wd)) // wd) * t_c + off_c) * 2 + 1
    px0 = np.clip(x0 // t0 - 8, 0, wd0 - 16)
    py0 = np.clip(y0 // t0 - 8, 0, hd0 - 16)
    m = N_LOCAL - len(slots)
    r_px0 = np.concatenate([rng.integers(0, wd0 - 16 + 1, m // 2),
                            rng.integers(wd0 - 24, wd0 - 16 + 1,
                                         m - m // 2)])
    return (np.concatenate([slots, rng.integers(0, n, m)]).astype(np.int32),
            np.concatenate([px0, r_px0]).astype(np.int32),
            np.concatenate([py0, rng.integers(0, hd0 - 16 + 1, m)]
                           ).astype(np.int32))


def phase_local(name, bank, det, planes0, slots, px0, py0):
    """Level-0 16x16 window scores on the card vs the CPU device: exactly
    equal, right-edge windows included."""
    import jax
    import jax.numpy as jnp

    from fealess import detector
    from fealess.ops import score_pallas

    table = detector.build_match_tables(bank, det)[0]
    table_k = {k: np.asarray(v)[slots] for k, v in table.items()}
    fn = jax.jit(score_pallas.local_scores)
    got = np.asarray(fn(jnp.asarray(planes0), table_k, jnp.asarray(px0),
                        jnp.asarray(py0)))
    want = np.asarray(fn(on_cpu(planes0), on_cpu(table_k), on_cpu(px0),
                         on_cpu(py0)))
    check(f"local_{name}", np.array_equal(got, want),
          windows=int(len(slots)),
          right_edge_windows=int(np.sum(px0 >= planes0.shape[2] - 24)),
          mismatches=int(np.sum(got != want)))


def refine_clouds(eng, depth, cam, match_x, match_y, slot):
    """The fixture's compacted (ref, model) refine clouds of one match."""
    import jax
    import jax.numpy as jnp

    from fealess import pipeline

    crop = eng.cfg.refine_crop

    @jax.jit
    def fn(bank, md, org, dep, k):
        tmpl = pipeline.candidate_template(bank, md, org, slot, eng.cfg)
        ref, model, mask, normals, _ = pipeline.paired_clouds(
            dep, k, *tmpl[:6], match_x, match_y, eng.cfg, crop, crop)
        return ref, model, mask, normals

    return fn(eng.bank, eng._model_depth_dev, eng._origins_dev,
              jnp.asarray(depth), scene_k(cam))


def perturbed_clouds(eng, bgr, depth, cam):
    """The fixture's refine clouds of the top match with the model turned
    by 2 degrees and moved by 3 mm, so ICP has iterations to run."""
    import jax
    import jax.numpy as jnp

    top = eng.recognition(bgr, depth, cam)[0]
    slot = int(np.argmax(np.asarray(eng.bank.valid)))
    ref, model, mask, normals = refine_clouds(
        eng, depth, cam, jnp.int32(top.match_rect[0]),
        jnp.int32(top.match_rect[1]), slot)
    ang = np.radians(2.0)
    rz = jnp.asarray([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                     jnp.float32)
    model = jnp.where(mask[:, None],
                      jnp.matmul(model - 500.0, rz.T,
                                 precision=jax.lax.Precision.HIGHEST)
                      + 503.0, model)
    return ref, model, mask, normals


def icp_modes(eng):
    """(name, IcpConfig): point mode, the served plane mode, and the plane
    mode with its anisotropy gate off.  The fixture object is nearly
    planar, so the served plane mode takes its Kabsch update there; the
    third runs the Gauss-Newton step."""
    icfg = eng.cfg.icp
    return [("point_to_point", dataclasses.replace(icfg,
                                                    mode="point_to_point")),
            ("point_to_plane", dataclasses.replace(icfg,
                                                    mode="point_to_plane")),
            ("point_to_plane_gn", dataclasses.replace(
                icfg, mode="point_to_plane",
                plane_min_normal_anisotropy=0.0))]


def icp_pose(result):
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = np.asarray(result.r), np.asarray(result.t)
    return pose


def tilted_depth(depth, cam, slope=0.05):
    """The fixture depth with a ramp of ``slope`` mm per pixel across the
    image (about 2 degrees of tilt at the fixture's depth): the template's
    initial pose then misses, so the ICP of the served path iterates."""
    u = np.arange(depth.shape[1])[None, :]
    ramp = np.round(depth.astype(np.float64) + slope * (u - cam.cx))
    return np.where(depth > 0, ramp, 0).astype(depth.dtype)


def phase_nn(name, query, ref, exact_ties=False):
    """ICP nearest neighbour on the card vs the CPU device.  d² within
    1e-6 relative (FMA contraction may change the last bit); indices
    equal wherever the best and second-best d² differ by more than 1e-6
    relative — everywhere for integer clouds, whose d² are exact."""
    import jax
    import jax.numpy as jnp

    from fealess import icp

    fn = jax.jit(icp.nearest_neighbor)
    idx, d2 = (np.asarray(v) for v in fn(jnp.asarray(query),
                                        jnp.asarray(ref)))
    idx_c, d2_c = (np.asarray(v) for v in fn(on_cpu(query), on_cpu(ref)))
    q = np.asarray(query, np.float32)
    r = np.asarray(ref, np.float32)
    gap = np.empty(len(q), np.float32)
    for s in range(0, len(q), 1024):
        d = ((q[s:s + 1024, None, :] - r[None, :, :]) ** 2).sum(-1)
        two = np.partition(d, 1, axis=1)[:, :2]
        gap[s:s + 1024] = (two[:, 1] - two[:, 0]) / np.maximum(two[:, 1],
                                                                1e-30)
    decisive = np.ones_like(gap, bool) if exact_ties else gap > 1e-6
    rel = np.abs(d2 - d2_c) / np.maximum(np.abs(d2_c), 1e-30)
    check(f"nn_{name}",
          bool(np.all(idx[decisive] == idx_c[decisive])
               and np.all(rel <= 1e-6)),
          shape=[int(len(q)), int(len(r))],
          decisive=int(decisive.sum()),
          idx_mismatch_decisive=int(np.sum(idx[decisive]
                                           != idx_c[decisive])),
          idx_mismatch_all=int(np.sum(idx != idx_c)),
          max_d2_rel=float(rel.max()))


def pose_diff(a, b):
    """(translation mm, rotation deg) between two 4x4 poses.  The angle
    comes from the antisymmetric part of the relative rotation,
    ``|R - R^T|_F = 2 sqrt(2) sin(angle)``, which stays accurate for tiny
    angles where ``arccos((trace - 1) / 2)`` of f32 matrices reads ~0.05
    degrees of pure rounding."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    r = a[:3, :3] @ b[:3, :3].T
    s = np.linalg.norm(r - r.T) / (2 * np.sqrt(2))
    return (float(np.linalg.norm(a[:3, 3] - b[:3, 3])),
            float(np.degrees(np.arcsin(min(s, 1.0)))))


def same_results(gpu, cpu):
    """Identical match fields; poses within 0.1 mm and 0.05 degrees."""
    if len(gpu) != len(cpu) or not gpu:
        return False, {"n_gpu": len(gpu), "n_cpu": len(cpu)}
    worst = [0.0, 0.0]
    same = True
    for g, c in zip(gpu, cpu):
        same &= (g.obj_tag == c.obj_tag and g.match_rect == c.match_rect
                 and g.similarity == c.similarity)
        dt, dr = pose_diff(g.world2cam, c.world2cam)
        worst = [max(worst[0], dt), max(worst[1], dr)]
    return (same and worst[0] <= 0.1 and worst[1] <= 0.05,
            {"n": len(gpu), "match_identical": bool(same),
             "max_dt_mm": worst[0], "max_drot_deg": worst[1],
             "top": [gpu[0].match_rect[:2], gpu[0].similarity]})


def icp_iterations(eng, bgr, depth, cam):
    """ICP iterations of the served top-1 step on the engine's device."""
    import jax.numpy as jnp

    from fealess import pipeline

    k = scene_k(cam)
    step = pipeline.recognize_top1_jit(
        eng.bank, eng._model_depth_dev, eng._origins_dev, jnp.asarray(bgr),
        jnp.asarray(depth), k, eng.cfg, kernels=eng._kernels)
    return int(step.refine.icp.iterations)


def phase_e2e(name, eng, bgr, depth, cam, icp_must_iterate=False):
    """recognition and recognition_multi(4) on the card vs the engine's
    state committed to the CPU device: identical matches, poses within
    0.1 mm / 0.05 degrees.  With ``icp_must_iterate`` the top-1 ICP must
    run at least one iteration on both devices."""
    import jax

    gpu = eng.recognition(bgr, depth, cam)
    gpu4 = eng.recognition_multi(bgr, depth, cam, max_objects=4)
    its = [icp_iterations(eng, bgr, depth, cam)]
    twin = cpu_engine(eng)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = twin.recognition(bgr, depth, cam)
        cpu4 = twin.recognition_multi(bgr, depth, cam, max_objects=4)
        its.append(icp_iterations(twin, bgr, depth, cam))
    ok, detail = same_results(gpu, cpu)
    if icp_must_iterate:
        ok &= min(its) > 0
    check(f"recognition_{name}", ok, icp_iterations=its, **detail)
    ok4, detail4 = same_results(gpu4, cpu4)
    check(f"recognition_multi4_{name}", ok4, **detail4)
    return gpu


def phase_icp(eng, bgr, depth, cam):
    """icp_refine in each mode of :func:`icp_modes` on the perturbed
    fixture clouds (16384 points), card vs CPU device: both iterate,
    poses within 0.1 mm / 0.05 degrees."""
    import jax

    from fealess import icp

    ref, model, mask, normals = perturbed_clouds(eng, bgr, depth, cam)
    for name, icfg in icp_modes(eng):
        extra = (normals,) if icfg.mode == "point_to_plane" else ()
        fn = jax.jit(lambda r_, m_, k_, n_=None: icp.icp_refine(
            r_, m_, k_, icfg, ref_normals=n_))
        got = fn(ref, model, mask, *extra)
        want = fn(*on_cpu((ref, model, mask) + extra))
        its = [int(got.iterations), int(want.iterations)]
        dt, dr = pose_diff(icp_pose(got), icp_pose(want))
        check(f"icp_{name}", min(its) > 0 and dt <= 0.1 and dr <= 0.05,
              points=int(ref.shape[0]), iterations=its, dt_mm=dt,
              drot_deg=dr,
              dist_mean=[float(got.dist_mean), float(want.dist_mean)])


def phase_kcf(bgr):
    """KCF init + updates on shifted fixture frames: ROI traces of the
    card and the CPU device within 0.1 px."""
    import jax

    from fealess.tracker.kcf import KcfTracker, kcf_reference_config

    frames = [np.roll(np.roll(bgr, 3 * i, axis=1), i, axis=0)
              for i in range(KCF_UPDATES + 1)]

    def trace():
        tracker = KcfTracker(kcf_reference_config(
            hog=True, fixed_window=True, multiscale=True, lab=False))
        state = tracker.init((240.0, 160.0, 192.0, 160.0), frames[0])
        rois = []
        for f in frames[1:]:
            state, roi = tracker.update(state, f)
            rois.append(roi)
        return np.stack(rois)

    gpu = trace()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = trace()
    dev = float(np.max(np.abs(gpu - cpu)))
    check("kcf_roi_trace", dev <= 0.1, updates=KCF_UPDATES,
          max_roi_dev_px=dev, last_roi=gpu[-1].tolist())


def phase_artifact(eng, bgr, depth, cam, live):
    """Export the fused step, load it in this process, serve: the same
    results as the live engine."""
    import tempfile

    from fealess.io import export

    with tempfile.TemporaryDirectory(prefix="fealess_artifact_") as d:
        eng.export_artifact(d)
        served = export.ServingArtifact(d).recognition(bgr, depth, cam)
    ok, detail = same_results(served, live)
    check("serving_artifact", ok, **detail)


def phase_report(eng, bgr, depth, cam, header):
    """Memory analysis of the recognition step and one warm per-frame
    time of ``ObjReco.recognition`` (host frame in, pose out).
    Informational."""
    import jax.numpy as jnp

    from fealess import pipeline

    compiled = pipeline.recognize_top1_jit.lower(
        eng.bank, eng._model_depth_dev, eng._origins_dev,
        jnp.asarray(bgr), jnp.asarray(depth), scene_k(cam), eng.cfg,
        kernels=eng._kernels).compile()
    print(f"recognize_top1 memory_analysis: {compiled.memory_analysis()}")
    eng.recognition(bgr, depth, cam)
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        eng.recognition(bgr, depth, cam)
        times.append(time.perf_counter() - t0)
    print(f"warm ObjReco.recognition, 640x480, 1024 templates, plane ICP: "
          f"median {np.median(times) * 1e3:.3f} ms over 20 frames on "
          f"{header} (informational)", flush=True)


def run_one_card(header):
    import jax.numpy as jnp

    from benchmarks import fixtures
    from fealess.engine import ObjReco

    rng = np.random.default_rng(0)
    eng, cam, bgr, depth = fixture_engine()
    det = eng.cfg.detector
    planes = phase_planes("640x480", det, bgr, depth)
    coarse = phase_coarse("640x480_1024t", eng.bank, det, planes[-1])
    slots, px0, py0 = local_windows(rng, coarse, eng.bank, det,
                                    planes[0].shape[2], planes[0].shape[1])
    phase_local("640x480", eng.bank, det, planes[0], slots, px0, py0)

    feat_dir, wbgr, wdepth = fixtures.wide_fixture()
    wcfg = fixtures.wide_engine_config()
    wplanes = phase_planes("1280x960", wcfg.detector, wbgr, wdepth)
    # the 1024-template bank scored on the wide grids
    wide_det = dataclasses.replace(det, image_width=1280, image_height=960)
    wcoarse = phase_coarse("1280x960_1024t", eng.bank, wide_det,
                           wplanes[-1])
    wslots, wpx0, wpy0 = local_windows(rng, wcoarse, eng.bank, wide_det,
                                       wplanes[0].shape[2],
                                       wplanes[0].shape[1])
    phase_local("1280x960", eng.bank, wide_det, wplanes[0], wslots, wpx0,
                wpy0)

    live = phase_e2e("640x480_1024t", eng, bgr, depth, cam)
    phase_e2e("640x480_1024t_tilted", eng, bgr, tilted_depth(depth, cam),
              cam, icp_must_iterate=True)
    phase_icp(eng, bgr, depth, cam)
    top = live[0]
    slot = int(np.argmax(np.asarray(eng.bank.valid)))
    ref, model, mask, _ = refine_clouds(eng, depth, cam,
                                        jnp.int32(top.match_rect[0]),
                                        jnp.int32(top.match_rect[1]), slot)
    print(f"refine clouds: {int(np.asarray(mask).sum())} valid pairs of "
          f"{ref.shape[0]}", flush=True)
    phase_nn("fixture_refine_clouds", np.asarray(model), np.asarray(ref))
    grid = rng.integers(0, 6, (4096, 3)).astype(np.float32)
    phase_nn("integer_grid_ties", grid, grid[::-1].copy(), exact_ties=True)

    weng = ObjReco.create("LmICP", wcfg)
    weng.add_obj(feat_dir)
    phase_e2e("1280x960_wide", weng, wbgr, wdepth, fixtures.wide_camera())

    phase_kcf(bgr)
    phase_artifact(eng, bgr, depth, cam, live)
    phase_report(eng, bgr, depth, cam, header)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def spans_all(arr, n):
    """True when ``arr`` has shards on ``n`` distinct devices."""
    return len({s.device for s in arr.addressable_shards}) == n


def matches_equal(a, b):
    va, vb = np.asarray(a.valid), np.asarray(b.valid)
    if not np.array_equal(va, vb):
        return False
    return all(np.array_equal(np.asarray(getattr(a, f))[va],
                              np.asarray(getattr(b, f))[vb])
               for f in ("x", "y", "similarity", "template_slot",
                         "class_idx", "template_idx"))


def run_four_cards():
    import jax
    import jax.numpy as jnp

    from fealess import detector, icp, pipeline
    from fealess.parallel import (batch_recon, mesh as mesh_mod,
                                      sharded_icp, sharded_match)

    devs = jax.devices()
    n_dev = len(devs)
    if n_dev != 4:
        raise SystemExit(f"--four needs 4 devices, JAX found {n_dev}")
    eng, cam, bgr, depth = fixture_engine()
    det = eng.cfg.detector
    thr = eng.cfg.matching_threshold
    k = scene_k(cam)

    # template-sharded match over a 4-card template mesh
    tmesh = mesh_mod.template_mesh(4)
    sbank = mesh_mod.shard_bank(eng.bank, tmesh)
    sharded = jax.jit(lambda b, i, d: sharded_match.match_bank_sharded(
        b, i, d, thr, det, tmesh))(sbank, jnp.asarray(bgr),
                                   jnp.asarray(depth))
    single = detector.match_bank_jit(eng.bank, jnp.asarray(bgr),
                                     jnp.asarray(depth), thr, det,
                                     kernels=eng._kernels)
    check("four_template_sharded_match",
          matches_equal(sharded, single) and spans_all(sbank.feat_x, 4),
          valid=int(np.asarray(sharded.valid).sum()),
          bank_devices=len({s.device for s in
                            sbank.feat_x.addressable_shards}))

    # frame-sharded batch recognition: 4 frames, one per card
    frames = np.stack([np.roll(bgr, 4 * i, axis=1) for i in range(4)])
    depths = np.stack([np.roll(depth, 4 * i, axis=1) for i in range(4)])
    dmesh = mesh_mod.make_mesh([("d", 4)], devs)
    step = jax.jit(lambda f, d_: batch_recon.recognize_batch_sharded(
        eng.bank, eng._model_depth_dev, eng._origins_dev, f, d_, k,
        eng.cfg, dmesh, kernels=eng._kernels))(jnp.asarray(frames),
                                                jnp.asarray(depths))
    ok, worst = spans_all(step.pose, 4), [0.0, 0.0]
    for i in range(4):
        one = pipeline.recognize_top1_jit(
            eng.bank, eng._model_depth_dev, eng._origins_dev,
            jnp.asarray(frames[i]), jnp.asarray(depths[i]), k, eng.cfg,
            kernels=eng._kernels)
        ok &= (int(step.template_slot[i]) == int(one.template_slot)
               and int(step.match_x[i]) == int(one.match_x)
               and int(step.match_y[i]) == int(one.match_y)
               and float(step.similarity[i]) == float(one.similarity))
        dt, dr = pose_diff(step.pose[i], one.pose)
        worst = [max(worst[0], dt), max(worst[1], dr)]
    check("four_frame_sharded_recognition",
          ok and worst[0] <= 0.1 and worst[1] <= 0.05,
          frames=4, max_dt_mm=worst[0], max_drot_deg=worst[1],
          out_devices=len({s.device for s in step.pose.addressable_shards}))

    # point-sharded ICP (point and plane modes) on the perturbed clouds
    ref, model, mask, normals = perturbed_clouds(eng, bgr, depth, cam)
    pmesh = mesh_mod.make_mesh([("p", 4)], devs)
    sharded_fns = {"point_to_point": sharded_icp.icp_sharded,
                   "point_to_plane": sharded_icp.icp_plane_sharded}
    for name, icfg in icp_modes(eng):
        fn = sharded_fns[icfg.mode]
        extra = (normals,) if icfg.mode == "point_to_plane" else ()
        got = jax.jit(lambda *a: fn(*a, icfg, pmesh))(ref, *extra, model,
                                                      mask)
        want = jax.jit(lambda r_, m_, k_, n_=None: icp.icp_refine(
            r_, m_, k_, icfg, ref_normals=n_))(ref, model, mask, *extra)
        dt, dr = pose_diff(icp_pose(got), icp_pose(want))
        check(f"four_point_sharded_icp_{name}", dt <= 0.1 and dr <= 0.05,
              iterations=[int(got.iterations), int(want.iterations)],
              dt_mm=dt, drot_deg=dr)

    # 2x2 frame x template mesh
    mesh2 = mesh_mod.make_mesh([("d", 2), ("t", 2)], devs)
    m2 = jax.jit(lambda f, d_: batch_recon.match_batch_2d(
        eng.bank, f, d_, thr, det, mesh2))(jnp.asarray(frames[:2]),
                                           jnp.asarray(depths[:2]))
    ok = True
    for i in range(2):
        one = detector.match_bank_jit(eng.bank, jnp.asarray(frames[i]),
                                      jnp.asarray(depths[i]), thr, det,
                                      kernels=eng._kernels)
        ok &= matches_equal(jax.tree.map(lambda a: a[i], m2), one)
    check("four_match_batch_2d", ok and spans_all(m2.x, 4),
          frames=2, out_devices=len({s.device for s in
                                     m2.x.addressable_shards}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args()

    header = card_header()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{dev.platform} ({dev.device_kind})")
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(ROOT, ".jax_cache"))
    from fealess.io import native

    print(f"card: {header}")
    print(f"jax {jax.__version__} devices {jax.devices()}")
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    print("native host library: "
          + ("libfealess_host.so loaded" if native.have_native()
             else "not built, Python fallback"), flush=True)
    if args.four:
        run_four_cards()
    else:
        run_one_card(header)
    print(f"card: {header}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
