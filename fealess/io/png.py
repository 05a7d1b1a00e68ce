"""PNG decoding with numpy and zlib only.

Reads the images the engine consumes — 8-bit gray, BGR and BGRA (stored
RGB/RGBA), 8-bit gray+alpha and 16-bit gray depth maps — non-interlaced,
with all five scanline filters.  Channel order follows OpenCV
(``cv2.imread(path, cv2.IMREAD_UNCHANGED)``): color comes back BGR, 16-bit
samples in native byte order.

Writing PNGs (the apps' debug output) stays with OpenCV: :func:`imwrite`
imports it on first use and says so when it is missing.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # PNG color type -> samples/pixel


def _paeth_row(raw: bytes, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(len(raw))
    up = prior.tolist()
    for i, x in enumerate(raw):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (x + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(raw: bytes, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(len(raw))
    up = prior.tolist()
    for i, x in enumerate(raw):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (x + ((a + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(data, np.uint8)[:height * (stride + 1)]
    rows = rows.reshape(height, stride + 1)
    ftype = rows[:, 0]
    if np.any(ftype > 4):
        raise ValueError("invalid PNG scanline filter")
    out = rows[:, 1:].copy()
    # None and Sub rows depend on no other row: decode them all at once
    # (Sub is a running byte sum per channel, modulo 256).
    sub = ftype == 1
    if sub.any():
        w = stride // bpp
        out[sub] = np.cumsum(out[sub].reshape(-1, w, bpp), axis=1,
                             dtype=np.uint8).reshape(-1, stride)
    zero = np.zeros(stride, np.uint8)
    for y in np.nonzero(ftype >= 2)[0]:
        prior = out[y - 1] if y > 0 else zero
        if ftype[y] == 2:
            out[y] = out[y] + prior
        elif ftype[y] == 3:
            out[y] = _average_row(out[y].tobytes(), prior, bpp)
        else:
            out[y] = _paeth_row(out[y].tobytes(), prior, bpp)
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file -> (H, W) or (H, W, C) uint8/uint16 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise IOError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise IOError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or interlace:
        raise IOError(f"{path}: unsupported PNG (bit depth {depth}, color "
                      f"type {color}, interlace {interlace})")
    ch = _CHANNELS[color]
    bytes_per_sample = depth // 8
    bpp = ch * bytes_per_sample
    out = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp,
                    bpp)
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
    img = out.reshape(height, width, ch)
    if ch >= 3:                                     # RGB(A) -> BGR(A)
        img = img[..., [2, 1, 0] + list(range(3, ch))]
    return img[..., 0] if ch == 1 else img


def imread(path: str):
    """``read_png``, or None when the file does not exist (the
    ``cv2.imread`` contract the callers test for)."""
    try:
        return read_png(path)
    except FileNotFoundError:
        return None


def imwrite(path: str, img: np.ndarray) -> None:
    """Write an image with OpenCV (an optional dependency)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "writing images needs OpenCV (the cv2 package)") from e
    if not cv2.imwrite(path, img):
        raise IOError(f"cannot write {path}")
