"""ctypes bindings for the native host library (native/fealess_host).

Three host-side components that complement the device compute path:

- ``select_scattered_features``: the greedy scattered-feature pick of
  ``QuantizedPyramid::selectScatteredFeatures`` (reference linemod/
  linemod.cpp:135-164) — inherently sequential, O(candidates x kept);
- ``chamfer_chessboard``: exact DIST_C 3x3 distance transform (the
  ``cv::distanceTransform`` call at linemod.cpp:763);
- ``FrameLoader``: threaded RGB-D frame prefetcher replacing the
  reference's synchronous capture/IO loops (test/linemod_recon.cpp:44-111,
  test/img_series_reader.*) so decode overlaps device compute.

Every entry point has a pure-Python fallback (fealess.training /
ops.image / imageio via cv2) used when the shared library is absent; build
it with ``cmake -S native/fealess_host -B build/native -G Ninja &&
ninja -C build/native``.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_SEARCHED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def load_library() -> Optional[ctypes.CDLL]:
    """Locate and load libfealess_host.so (FEALESS_HOST_LIB env overrides;
    returns None when unavailable)."""
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    candidates = []
    env = os.environ.get("FEALESS_HOST_LIB")
    if env:
        candidates.append(env)
    root = _repo_root()
    candidates += [
        os.path.join(root, "build", "native", "libfealess_host.so"),
        os.path.join(root, "native", "build", "libfealess_host.so"),
    ]
    for path in candidates:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            lib.fealess_select_scattered_features.restype = ctypes.c_int
            lib.fealess_select_scattered_features.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.POINTER(ctypes.c_int32)]
            lib.fealess_chamfer_chessboard.restype = None
            lib.fealess_chamfer_chessboard.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            for name in ("fealess_extract_gradient_template",
                         "fealess_extract_normal_template"):
                fn = getattr(lib, name, None)
                if fn is None:
                    continue   # older lib build; Python path handles it
                fn.restype = ctypes.c_int
            if hasattr(lib, "fealess_extract_gradient_template"):
                lib.fealess_extract_gradient_template.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.POINTER(ctypes.c_int32)]
                lib.fealess_extract_normal_template.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
            lib.fealess_loader_create.restype = ctypes.c_void_p
            lib.fealess_loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
            lib.fealess_loader_next.restype = ctypes.c_int
            lib.fealess_loader_next.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.fealess_loader_destroy.restype = None
            lib.fealess_loader_destroy.argtypes = [ctypes.c_void_p]
            _LIB = lib
            break
    return _LIB


def have_native() -> bool:
    return load_library() is not None


def select_scattered_features(candidates: np.ndarray, num_features: int,
                              distance: float) -> np.ndarray:
    """Native greedy scattered selection; candidates (K, 3) int32 sorted by
    descending score.  Falls back to the Python loop when unavailable."""
    lib = load_library()
    if lib is None:
        from fealess import training
        return training.select_scattered_features(
            candidates, None, num_features, distance)
    cand = np.ascontiguousarray(candidates, np.int32)
    out = np.empty((num_features, 3), np.int32)
    n = lib.fealess_select_scattered_features(
        cand.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(cand),
        num_features, ctypes.c_float(distance),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out[:n]


def chamfer_chessboard(nonzero: np.ndarray) -> np.ndarray:
    """Exact Chebyshev distance transform; falls back to the Python/NumPy
    two-pass chamfer."""
    lib = load_library()
    if lib is None:
        from fealess.ops import image as fi
        return fi.distance_transform_chessboard(nonzero)
    src = np.ascontiguousarray(nonzero.astype(np.uint8))
    h, w = src.shape
    out = np.empty((h, w), np.float32)
    lib.fealess_chamfer_chessboard(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def extract_gradient_template(angle_bits: np.ndarray, magnitude: np.ndarray,
                              mask: Optional[np.ndarray], num_features: int,
                              strong_threshold: float
                              ) -> Optional[np.ndarray]:
    """Full native ColorGradient extraction (erode + candidates + stable
    sort + greedy) in ONE GIL-free call; returns (nf, 3) int32 or None.
    Returns NotImplemented when the native lib (or symbol) is absent so
    the caller can run the numpy path."""
    lib = load_library()
    if lib is None or not hasattr(lib, "fealess_extract_gradient_template"):
        return NotImplemented
    bits = np.ascontiguousarray(angle_bits, np.uint8)
    mag = np.ascontiguousarray(magnitude, np.float32)
    h, w = bits.shape
    m = (None if mask is None
         else np.ascontiguousarray(mask.astype(np.uint8)))
    out = np.empty((num_features, 3), np.int32)
    n = lib.fealess_extract_gradient_template(
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mag.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        None if m is None
        else m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, num_features, ctypes.c_float(strong_threshold),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out if n == num_features else None


def extract_normal_template(normal_bits: np.ndarray,
                            mask: Optional[np.ndarray], num_features: int,
                            extract_threshold: int) -> Optional[np.ndarray]:
    """Full native DepthNormal extraction (erode x2 + per-label chamfer +
    count balancing + stable sort + greedy); see
    :func:`extract_gradient_template` for the return contract."""
    lib = load_library()
    if lib is None or not hasattr(lib, "fealess_extract_normal_template"):
        return NotImplemented
    bits = np.ascontiguousarray(normal_bits, np.uint8)
    h, w = bits.shape
    m = (None if mask is None
         else np.ascontiguousarray(mask.astype(np.uint8)))
    out = np.empty((num_features, 3), np.int32)
    n = lib.fealess_extract_normal_template(
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        None if m is None
        else m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, num_features, extract_threshold,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out if n == num_features else None


class FrameLoader:
    """Threaded in-order RGB-D frame stream (native when available).

    Iterates ``(index, bgr u8 (H,W,3), depth u16 (H,W))``; frames whose
    files fail to decode are skipped.  ``target_wh`` resizes on the decode
    threads (nearest for depth), off the critical path.
    """

    def __init__(self, color_paths: Sequence[str],
                 depth_paths: Sequence[str],
                 target_wh: Optional[Tuple[int, int]] = None,
                 threads: int = 4, capacity: int = 8):
        assert len(color_paths) == len(depth_paths)
        self._paths = (list(color_paths), list(depth_paths))
        self._target = target_wh
        self._handle = None
        self._lib = load_library()
        self._i = 0
        # The native loader copies into caller-sized buffers, so the frame
        # dimensions must be known up front: native path requires target_wh.
        if self._lib is not None and color_paths and target_wh:
            n = len(color_paths)
            carr = (ctypes.c_char_p * n)(
                *[p.encode() for p in color_paths])
            darr = (ctypes.c_char_p * n)(
                *[p.encode() for p in depth_paths])
            tw, th = target_wh if target_wh else (0, 0)
            self._handle = self._lib.fealess_loader_create(
                carr, darr, n, tw, th, threads, capacity)
            # probe buffer dims: decode lazily sized at first frame
            self._tw, self._th = tw, th

    def __iter__(self):
        return self

    def __next__(self):
        import cv2
        colors, depths = self._paths
        if self._handle is not None:
            while True:
                if self._i >= len(colors):
                    raise StopIteration
                w, h = self._tw, self._th
                bgr = np.empty((h, w, 3), np.uint8)
                depth = np.empty((h, w), np.uint16)
                wo = ctypes.c_int()
                ho = ctypes.c_int()
                rc = self._lib.fealess_loader_next(
                    self._handle,
                    bgr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                    ctypes.byref(wo), ctypes.byref(ho))
                idx = self._i
                self._i += 1
                if rc < 0:
                    raise StopIteration
                if rc == 0:
                    continue
                return idx, bgr, depth
        # Python fallback: synchronous cv2 decode
        while True:
            if self._i >= len(colors):
                raise StopIteration
            idx = self._i
            self._i += 1
            bgr = cv2.imread(colors[idx], cv2.IMREAD_COLOR)
            depth = cv2.imread(depths[idx], cv2.IMREAD_UNCHANGED)
            if bgr is None or depth is None:
                continue
            if self._target:
                tw, th = self._target
                bgr = cv2.resize(bgr, (tw, th))
                depth = cv2.resize(depth, (tw, th),
                                   interpolation=cv2.INTER_NEAREST)
            return idx, bgr, np.asarray(depth, np.uint16)

    def close(self):
        if self._handle is not None:
            self._lib.fealess_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
