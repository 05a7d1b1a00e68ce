"""App-layer tests: scan-package training driver, CLI actions (train /
recon / track / eval), and the KCF-gated TrackedRecognizer on a synthetic
moving-object series."""

import json
import os

import cv2
import numpy as np
import pytest

from fealess.apps import cli, scan_package
from tests.test_match_e2e import H, W, make_scene

FX = FY = 608.0


def _write_package(d, n_frames=2, shifts=((0, 0), (10, 5))):
    """Reference training-package layout: gray/ depth/ pose/ view/ pngs +
    txts; depth png in 0.1mm units; frame i = scene shifted by shifts[i]."""
    rng = np.random.default_rng(7)
    bgr, depth, _ = make_scene(rng)
    for sub in ("gray", "depth", "pose", "view"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for i in range(n_frames):
        dx, dy = shifts[i]
        b = np.roll(np.roll(bgr, dy, axis=0), dx, axis=1)
        z = np.roll(np.roll(depth, dy, axis=0), dx, axis=1)
        cv2.imwrite(os.path.join(d, "gray", f"{i}.png"), b)
        cv2.imwrite(os.path.join(d, "depth", f"{i}.png"),
                    (z.astype(np.uint32) * 10).astype(np.uint16))
        pose = np.zeros((3, 4), np.float32)
        pose[0, 0] = pose[1, 1] = pose[2, 2] = 1.0
        with open(os.path.join(d, "pose", f"{i}.txt"), "w") as fh:
            fh.write(" ".join(str(v) for v in pose.reshape(-1)) + "\n")
        with open(os.path.join(d, "view", f"{i}.txt"), "w") as fh:
            fh.write("# header\n# header2\n650.0\n")
    return bgr, depth


def _write_cube_obj(path, half=30.0):
    with open(path, "w") as fh:
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    fh.write(f"v {sx * half} {sy * half} {sz * half}\n")
        fh.write("f 1 2 3\nf 5 6 7\nf 1 2 5\nf 3 4 7\n")


@pytest.fixture(scope="module")
def package_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pkg"))
    _write_package(d)
    _write_cube_obj(os.path.join(d, "model.obj"))
    added, seen = scan_package.train_package(d, class_id="obj")
    assert seen == 2
    assert added >= 1
    return d


def test_convert_raw_roundtrip(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "gray"))
    os.makedirs(os.path.join(d, "depth"))
    rng = np.random.default_rng(0)
    depth = rng.uniform(400, 1000, size=(480, 640)).astype(np.float32)
    rgba = rng.integers(0, 255, size=(480, 640, 4), dtype=np.uint8)
    depth.tofile(os.path.join(d, "depth", "0.raw"))
    rgba.tofile(os.path.join(d, "gray", "0.raw"))
    n = scan_package.convert_raw_package(d)
    assert n == 1
    assert not os.path.exists(os.path.join(d, "depth", "0.raw"))
    dp = cv2.imread(os.path.join(d, "depth", "0.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(dp, np.rint(depth * 10).astype(np.uint16))
    gp = cv2.imread(os.path.join(d, "gray", "0.png"))
    np.testing.assert_array_equal(gp, rgba[:, :, [2, 1, 0]])


def test_iter_training_frames_mask_sentinel(package_dir):
    frames = list(scan_package.iter_training_frames(package_dir))
    assert len(frames) == 2
    f = frames[0]
    assert f.pose13.shape == (13,)
    assert f.pose13[12] == 650.0
    # sentinel: background (1200mm) is NOT in the mask, object (<=900) is
    assert not f.mask[0, 0]
    assert f.mask[80, 120]


def test_cli_recon_jsonl(package_dir, capsys):
    rc = cli.main(["recon", package_dir, "--refine-crop", "128",
                   "--icp-max-points", "8192"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 2
    rec0 = json.loads(lines[0])
    assert rec0["results"], "frame 0 must detect the trained object"
    assert rec0["results"][0]["obj"] == "obj"
    pose = np.asarray(rec0["results"][0]["pose"])
    assert pose.shape == (4, 4)
    # frame 0 is the training view: pose ~ identity
    np.testing.assert_allclose(pose[:3, :3], np.eye(3), atol=0.1)
    assert np.linalg.norm(pose[:3, 3]) < 15.0


def test_cli_recon_plane_mode(package_dir, capsys):
    rc = cli.main(["recon", package_dir, "--icp-mode", "point_to_plane",
                   "--refine-crop", "128", "--icp-max-points", "8192"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    rec0 = json.loads(lines[0])
    assert rec0["results"]
    pose = np.asarray(rec0["results"][0]["pose"])
    np.testing.assert_allclose(pose[:3, :3], np.eye(3), atol=0.1)


def test_cli_eval(package_dir, capsys, tmp_path):
    rc = cli.main(["recon", package_dir, "--refine-crop", "128",
                   "--icp-max-points", "8192"])
    assert rc == 0
    out = tmp_path / "results.jsonl"
    out.write_text(capsys.readouterr().out)
    rc = cli.main(["eval", package_dir, str(out), "--model-scale", "1.0"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_frames"] == 2
    assert summary["detection_rate"] >= 0.5
    # frame 0 is the training frame; its ADD must pass at tau=0.1
    assert summary["add_pass_rate"] >= 0.5


def test_tracked_recognizer_series(package_dir):
    """Moving object: frame 0 full detect + tracker init, later frames
    gated matches that keep reporting poses."""
    from fealess.apps.track import TrackedRecognizer
    from fealess.engine import CamIntrinsics
    import dataclasses
    from fealess import config as cfg
    from fealess.engine import ObjReco

    det = cfg.DetectorConfig(image_width=W, image_height=H)
    ecfg = cfg.EngineConfig(detector=det, refine_crop=128,
                            template_fx=FX, template_fy=FY,
                            template_cx=W / 2.0, template_cy=H / 2.0,
                            icp=dataclasses.replace(cfg.IcpConfig(),
                                                    max_points=8192))
    eng = ObjReco.create("LmICP", ecfg)
    eng.add_obj(package_dir)
    cam = CamIntrinsics(fx=FX, fy=FY, cx=W / 2.0, cy=H / 2.0,
                        width=W, height=H)
    tracker = TrackedRecognizer(eng)

    rng = np.random.default_rng(7)
    bgr, depth, _ = make_scene(rng)
    shifts = [(0, 0), (4, 2), (8, 4), (12, 6)]
    steps = []
    for dx, dy in shifts:
        b = np.roll(np.roll(bgr, dy, axis=0), dx, axis=1)
        z = np.roll(np.roll(depth, dy, axis=0), dx, axis=1)
        steps.append(tracker.step(b, z, cam))

    assert steps[0].redetected and steps[0].tracking
    assert steps[0].results
    for s in steps[1:]:
        assert not s.redetected          # gated path stayed live
        assert s.results, "gated match lost the object"
        assert s.roi is not None
    # poses drift with the object: x translation grows
    xs = [s.results[0].world2cam[0, 3] for s in steps]
    assert xs[-1] > xs[0] + 15.0


def test_tracked_recognizer_lost_then_redetect(package_dir):
    import dataclasses
    from fealess import config as cfg
    from fealess.apps.track import TrackedRecognizer
    from fealess.engine import CamIntrinsics, ObjReco

    det = cfg.DetectorConfig(image_width=W, image_height=H)
    ecfg = cfg.EngineConfig(detector=det, refine_crop=128,
                            template_fx=FX, template_fy=FY,
                            template_cx=W / 2.0, template_cy=H / 2.0,
                            icp=dataclasses.replace(cfg.IcpConfig(),
                                                    max_points=8192))
    eng = ObjReco.create("LmICP", ecfg)
    eng.add_obj(package_dir)
    cam = CamIntrinsics(fx=FX, fy=FY, cx=W / 2.0, cy=H / 2.0,
                        width=W, height=H)
    tracker = TrackedRecognizer(eng, max_lost=1)

    rng = np.random.default_rng(7)
    bgr, depth, _ = make_scene(rng)
    blank_bgr = np.full_like(bgr, 40)
    blank_depth = np.full_like(depth, 1200)

    s0 = tracker.step(bgr, depth, cam)
    assert s0.tracking
    s1 = tracker.step(blank_bgr, blank_depth, cam)   # object vanished
    assert not s1.results
    assert not s1.tracking                            # lost -> reset
    s2 = tracker.step(bgr, depth, cam)                # full re-detect
    assert s2.redetected and s2.results


def test_roi_from_mask_and_depth():
    from fealess.apps import acquire
    m = np.zeros((40, 60), np.uint8)
    m[10:20, 15:30] = 1
    assert acquire.roi_from_mask(m) == (15.0, 10.0, 15.0, 10.0)
    assert acquire.roi_from_mask(m, pad=5) == (10.0, 5.0, 25.0, 20.0)
    assert acquire.roi_from_mask(np.zeros((4, 4))) is None
    d = np.full((40, 60), 2000, np.uint16)   # all beyond the 900mm cap
    d[10:20, 15:30] = 500
    assert acquire.roi_from_depth(d, pad=0) == (15.0, 10.0, 15.0, 10.0)


def test_box_extractor_headless_raises(monkeypatch):
    from fealess.apps import acquire
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises(RuntimeError):
        acquire.BoxExtractor().extract("w", np.zeros((8, 8, 3), np.uint8))


def test_acquire_series_depth_pairs_by_stem(tmp_path):
    """Depth frames must pair with color frames by basename, not by sorted
    position: >=10 unpadded numeric names break lexicographic order, and a
    corrupt color png must not shift later pairs (ADVICE r1)."""
    from fealess.apps import acquire
    src = tmp_path / "src"
    dsrc = tmp_path / "dsrc"
    src.mkdir(); dsrc.mkdir()
    n_frames = 12
    for i in range(n_frames):
        cv2.imwrite(str(src / f"{i}.png"),
                    np.full((480, 640, 3), i, np.uint8))
        cv2.imwrite(str(dsrc / f"{i}.png"),
                    np.full((480, 640), 1000 + i, np.uint16))
    # corrupt one color frame: the reader skips it; depth for later frames
    # must still pair with the right color frame
    (src / "3.png").write_bytes(b"not a png")
    out = tmp_path / "pkg"
    n = acquire.acquire_series(str(src), str(out), depth_dir=str(dsrc))
    assert n == n_frames - 1
    # output index i corresponds to source stems [0,1,2,4,5,...,11]
    kept = [s for s in range(n_frames) if s != 3]
    for i, s in enumerate(kept):
        c = cv2.imread(str(out / "gray" / f"{i}.png"))
        d = cv2.imread(str(out / "depth" / f"{i}.png"),
                       cv2.IMREAD_UNCHANGED)
        assert int(c[0, 0, 0]) == s, (i, s)
        assert int(d[0, 0]) == 1000 + s, (i, s)


def test_acquire_series_layout(tmp_path):
    from fealess.apps import acquire
    src = tmp_path / "src"
    dsrc = tmp_path / "dsrc"
    src.mkdir(); dsrc.mkdir()
    for i in range(3):
        cv2.imwrite(str(src / f"{i}.png"),
                    np.full((480, 640, 3), 10 * i, np.uint8))
        cv2.imwrite(str(dsrc / f"{i}.png"),
                    np.full((480, 640), 500 + i, np.uint16))
    out = tmp_path / "pkg"
    n = acquire.acquire_series(str(src), str(out), depth_dir=str(dsrc),
                               max_frames=2, save_clouds=True)
    assert n == 2
    assert sorted(os.listdir(out / "gray")) == ["0.png", "1.png"]
    assert sorted(os.listdir(out / "depth")) == ["0.png", "1.png"]
    d0 = cv2.imread(str(out / "depth" / "0.png"), cv2.IMREAD_UNCHANGED)
    assert d0.dtype == np.uint16 and d0[0, 0] == 500
    cloud = np.loadtxt(out / "cloud" / "0.txt")
    assert cloud.shape == (480 * 640, 3)
    np.testing.assert_allclose(cloud[:, 2], 500.0, atol=1e-3)   # mm


def test_cli_acq_command(tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    cv2.imwrite(str(src / "0.png"), np.zeros((480, 640, 3), np.uint8))
    rc = cli.main(["acq", str(src), str(tmp_path / "out")])
    assert rc == 0
    assert os.path.exists(tmp_path / "out" / "gray" / "0.png")
    assert "intrinsics" in capsys.readouterr().out


def test_cli_recon_profile(package_dir, capsys):
    """--profile prints the printTimeOfICP-analog stage report: host
    wall segments plus the chain-slope device-stage table."""
    rc = cli.main(["recon", package_dir, "--refine-crop", "128",
                   "--icp-max-points", "8192", "--profile"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "host-io(decode+wait)" in err
    assert "recognition(+fetch)" in err
    assert "frontend(quant+planes)" in err
    assert "full(match+icp_refine)" in err


def test_cli_export_and_artifact_recon(package_dir, tmp_path, capsys):
    """fealess export writes the serving artifact; recon --artifact
    serves from it with the same detections as the engine path."""
    art = str(tmp_path / "artifact")
    rc = cli.main(["export", package_dir, art, "--width", str(W),
                   "--height", str(H), "--refine-crop", "128",
                   "--icp-max-points", "8192"])
    assert rc == 0
    capsys.readouterr()

    rc = cli.main(["recon", package_dir, "--refine-crop", "128",
                   "--icp-max-points", "8192"])
    assert rc == 0
    ref_lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]

    rc = cli.main(["recon", package_dir, "--artifact", art,
                   "--refine-crop", "128", "--icp-max-points", "8192"])
    assert rc == 0
    art_lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
    assert len(art_lines) == len(ref_lines) >= 1
    for a, b in zip(art_lines, ref_lines):
        assert bool(a["results"]) == bool(b["results"])
        if a["results"]:
            assert a["results"][0]["similarity"] == pytest.approx(
                b["results"][0]["similarity"])
