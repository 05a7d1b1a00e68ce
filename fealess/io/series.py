"""Frame sources: video file, camera, or image file list.

Reimplements ``CImgSeriesReader`` (reference test/img_series_reader.h:9-28,
.cpp): one reader interface over the three source types the demo driver
supports.  RGB-D directory series (gray/ + depth/ png pairs) stream through
the threaded native loader instead (fealess.io.native.FrameLoader).
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


class ImageSeriesReader:
    """Iterate BGR frames from a video file, camera index, or file list.

    ``source``: path to a video file, an integer camera id, a directory
    (all pngs/jpgs, numerically sorted), or an explicit list of paths.
    """

    def __init__(self, source, target_wh: Optional[Tuple[int, int]] = None):
        self._target = target_wh
        self._cap = None
        self._paths: List[str] = []
        if isinstance(source, int):
            self._cap = self._open_capture(source)
        elif isinstance(source, (list, tuple)):
            self._paths = list(source)
        elif os.path.isdir(source):
            files = []
            for ext in ("png", "jpg", "jpeg", "bmp"):
                files += glob.glob(os.path.join(source, f"*.{ext}"))

            def _key(p):
                stem = os.path.splitext(os.path.basename(p))[0]
                return (0, int(stem)) if stem.isdigit() else (1, stem)
            self._paths = sorted(files, key=_key)
        else:
            self._cap = self._open_capture(source)

    @staticmethod
    def _open_capture(source):
        import cv2
        cap = cv2.VideoCapture(source)
        if not cap.isOpened():
            raise IOError(f"cannot open video source {source!r}")
        return cap

    def __iter__(self) -> Iterator[np.ndarray]:
        for _, frame in self.iter_named():
            yield frame

    def iter_named(self) -> Iterator[Tuple[Optional[str], np.ndarray]]:
        """Yield ``(stem, frame)`` pairs; ``stem`` is the source file's
        basename without extension (None for video/camera sources).  The
        stem lets consumers pair auxiliary per-frame files (depth, pose) by
        NAME rather than by yield position — unreadable files are skipped
        (``continue``), so positional pairing would silently shift."""
        import cv2
        if self._cap is not None:
            while True:
                ok, frame = self._cap.read()
                if not ok:
                    return
                yield None, self._resize(frame)
        else:
            for p in self._paths:
                frame = cv2.imread(p, cv2.IMREAD_COLOR)
                if frame is None:
                    continue
                stem = os.path.splitext(os.path.basename(p))[0]
                yield stem, self._resize(frame)

    def _resize(self, frame: np.ndarray) -> np.ndarray:
        if self._target is None:
            return frame
        import cv2
        return cv2.resize(frame, self._target)

    def close(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None
