"""The OpenCV-free readers of the served path, pinned against OpenCV:
PNG decoding (fealess.io.png) and the OpenCV-YAML subset
(fealess.io.opencv_yaml) that carries the template database."""

import struct
import zlib

import numpy as np
import pytest

from fealess.io import opencv_yaml, png

cv2 = pytest.importorskip("cv2")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _write_png_all_filters(path, img):
    """Encode ``img`` (stored channel order) with scanline filters cycling
    through None, Sub, Up, Average and Paeth."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    raw = img.astype(">u2" if depth == 16 else np.uint8).tobytes()
    stride = w * ch * depth // 8
    bpp = ch * depth // 8
    rows = [raw[y * stride:(y + 1) * stride] for y in range(h)]
    out = bytearray()
    prior = bytes(stride)
    for y, row in enumerate(rows):
        ftype = y % 5
        enc = bytearray(stride)
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
            enc[i] = (x - pred) & 0xFF
        out += bytes([ftype]) + enc
        prior = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                             color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(out)))
                + chunk(b"IEND", b""))


def _image(kind, rng):
    shape = {"gray8": (23, 37), "bgr8": (23, 37, 3), "bgra8": (23, 37, 4),
             "gray16": (23, 37)}[kind]
    if kind == "gray16":
        return rng.integers(0, 65536, shape).astype(np.uint16)
    return rng.integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("writer", ["opencv", "all_filters"])
@pytest.mark.parametrize("kind", ["gray8", "bgr8", "bgra8", "gray16"])
def test_read_png_equals_opencv(tmp_path, kind, writer):
    rng = np.random.default_rng(len(kind) + len(writer))
    img = _image(kind, rng)
    path = str(tmp_path / f"{kind}.png")
    if writer == "opencv":
        assert cv2.imwrite(path, img)
    else:
        # PNG stores RGB(A): reverse the color channels of the BGR image
        stored = img[..., [2, 1, 0, 3][:img.shape[2]]] if img.ndim == 3 \
            else img
        _write_png_all_filters(path, stored)
    got = png.read_png(path)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(got, img)
    assert got.dtype == img.dtype


def test_imread_missing_file_is_none(tmp_path):
    assert png.imread(str(tmp_path / "absent.png")) is None


_DOC = {
    "pyramid_levels": 2,
    "T": [5, 8],
    "modalities": [{"type": "ColorGradient", "weak_threshold": 10.0,
                    "num_features": 63, "strong_threshold": 55.5}],
    "classes": [{
        "class_id": "obj_7",
        "modalities": ["ColorGradient"],
        "template_pyramids": [{
            "template_id": 0,
            "template_pose": [1.0, -0.25, 1e-05, 800.0],
            "templates": [{"width": 191, "features": [[74, 0, 4],
                                                      [0, 54, 0]]},
                          {"width": 96, "features": []}]}]}],
}


@pytest.mark.parametrize("suffix", [".yml", ".yml.gz"])
def test_yaml_written_here_reads_in_opencv(tmp_path, suffix):
    path = str(tmp_path / f"db{suffix}")
    opencv_yaml.dump(path, _DOC)
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    assert fs.isOpened()
    root = fs.root()
    assert int(root.getNode("pyramid_levels").real()) == 2
    assert [root.getNode("T").at(i).real() for i in range(2)] == [5, 8]
    mod = root.getNode("modalities").at(0)
    assert mod.getNode("type").string() == "ColorGradient"
    assert mod.getNode("strong_threshold").real() == 55.5
    cls = root.getNode("classes").at(0)
    assert cls.getNode("class_id").string() == "obj_7"
    tp = cls.getNode("template_pyramids").at(0)
    pose = tp.getNode("template_pose")
    assert [pose.at(i).real() for i in range(4)] == [1.0, -0.25, 1e-05,
                                                    800.0]
    feats = tp.getNode("templates").at(0).getNode("features")
    assert [[int(feats.at(k).at(j).real()) for j in range(3)]
            for k in range(feats.size())] == [[74, 0, 4], [0, 54, 0]]
    assert tp.getNode("templates").at(1).getNode("features").size() == 0
    fs.release()
    assert opencv_yaml.load(path) == _DOC


def test_yaml_written_by_opencv_reads_here(tmp_path):
    path = str(tmp_path / "cv.yml")
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    fs.write("pyramid_levels", 2)
    fs.startWriteStruct("T", cv2.FILE_NODE_SEQ | cv2.FILE_NODE_FLOW)
    for t in (5, 8):
        fs.write("", t)
    fs.endWriteStruct()
    fs.startWriteStruct("classes", cv2.FILE_NODE_SEQ)
    fs.startWriteStruct("", cv2.FILE_NODE_MAP)
    fs.write("class_id", "obj")
    fs.startWriteStruct("template_pose",
                        cv2.FILE_NODE_SEQ | cv2.FILE_NODE_FLOW)
    pose = [0.9510565400123596, -0.3090169943749474, 0.0, 12.5, 650.0,
            1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]   # wraps over lines
    for p in pose:
        fs.write("", p)
    fs.endWriteStruct()
    fs.startWriteStruct("features", cv2.FILE_NODE_SEQ)
    for row in ([1, 2, 3], [4, 5, 6]):
        fs.startWriteStruct("", cv2.FILE_NODE_SEQ | cv2.FILE_NODE_FLOW)
        for v in row:
            fs.write("", v)
        fs.endWriteStruct()
    fs.endWriteStruct()
    fs.startWriteStruct("empty", cv2.FILE_NODE_SEQ)
    fs.endWriteStruct()
    fs.endWriteStruct()
    fs.endWriteStruct()
    fs.release()
    doc = opencv_yaml.load(path)
    assert doc["pyramid_levels"] == 2 and doc["T"] == [5, 8]
    cls = doc["classes"][0]
    assert cls["class_id"] == "obj"
    assert cls["template_pose"] == pytest.approx(pose, rel=1e-15)
    assert cls["features"] == [[1, 2, 3], [4, 5, 6]]
    assert not cls["empty"]
