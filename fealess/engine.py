"""The product engine API: ObjReco facade.

Mirrors ``CObjRecoCAD``/``CObjRecoLmICP`` (CadReco/obj_reco_temp.h:6-30,
obj_reco_lmicp.cpp:47-348): create an engine, ``add_obj`` a trained
feature directory (``linemod_templates.yml`` + ``depth/<tid>.png`` model
depths), then ``recognition`` on RGB-D frames returning world2cam poses.

Host-side orchestration only — all compute runs through the jitted match
(fealess.detector) and refine (fealess.pipeline) paths.  Divergence
from the reference, documented: the scene intrinsics passed to refinement
are the zoomed (resized-to-640) intrinsics; the reference passes the
caller's unzoomed intrinsics even though the depth was resized
(obj_reco_lmicp.cpp:101/188 vs 243-248) — identical whenever the input is
already ``image_width`` wide.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from fealess import config as cfg
from fealess import detector as det_mod
from fealess import pipeline
from fealess.bank import TemplateBank, pack_bank
from fealess.geometry import depth as gd
from fealess.io import linemod_yaml, png

def _require_cv2(what: str):
    """OpenCV is optional: only frame resizing and the EPNP path use it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (the cv2 package)") from e
    return cv2


# Error codes (CadReco/lotus_common.h:5-10)
ERROR_INVALID_PARAM = 0x80000001
ERROR_OPEN_FILE_FAILED = 0x80000002


@dataclasses.dataclass
class CamIntrinsics:
    """TCamIntrinsicParam equivalent (lotus_common.h:24-35)."""
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


@dataclasses.dataclass
class RecoResult:
    """TObjRecoResult equivalent (lotus_common.h:95-100), plus the match
    rect at processing resolution (used by the tracker-gated pipeline,
    cf. linemod_acq.cpp:160)."""
    obj_tag: str
    world2cam: np.ndarray          # 4x4 row-major
    similarity: float
    icp_dist: float
    inlier_ratio: float
    match_rect: Optional[tuple] = None   # (x, y, w, h)


class ObjReco:
    """LmICP recognition engine (CObjRecoLmICP)."""

    def __init__(self, engine_cfg: Optional[cfg.EngineConfig] = None):
        self.cfg = engine_cfg or cfg.EngineConfig()
        self.bank: Optional[TemplateBank] = None
        # per-object state; clear_obj() is the single reset point
        self._kernels = None
        self._model_depth: Optional[np.ndarray] = None   # (N, CROP, CROP) u16 mm
        self._model_depth_dev = None
        self._origins_dev = None
        self._depth_origin: dict = {}                    # slot -> crop origin
        self._feature_path = ""

    # -- factory (CObjRecoCAD::Create, obj_reco_temp.cpp:13-30)
    @staticmethod
    def create(algorithm: str = "LmICP",
               engine_cfg: Optional[cfg.EngineConfig] = None) -> "ObjReco":
        if algorithm != "LmICP":
            raise NotImplementedError(
                f"algorithm {algorithm!r} not implemented (reference "
                "implements only LmICP, obj_reco_temp.cpp:13-30)")
        return ObjReco(engine_cfg)

    @staticmethod
    def get_version() -> str:
        return "fealess-0.1.0"

    def clear_obj(self) -> None:
        """Drop the loaded bank and every per-object cache (the reference's
        ClearObj is a ``return 0`` stub, obj_reco_lmicp.cpp:77-80; here it
        actually resets, and ``add_obj`` calls it first so re-adding can
        never leak the previous bank's depth crops/origins/kernels)."""
        self.bank = None
        self._kernels = None
        self._model_depth = None
        self._model_depth_dev = None
        self._origins_dev = None
        self._depth_origin = {}
        self._feature_path = ""

    def add_obj(self, feature_path: str) -> None:
        """Load ``<dir>/linemod_templates.yml`` and per-template model
        depths ``<dir>/depth/<tid>.png`` (AddObj, obj_reco_lmicp.cpp:67-74;
        depth load obj_reco_lmicp.cpp:156-188).  Depth pngs are stored in
        0.1mm units and converted to u16 mm here.  Replaces any previously
        loaded object (state is cleared first; see :meth:`clear_obj`)."""
        self.clear_obj()
        self._feature_path = feature_path
        yml = os.path.join(feature_path, "linemod_templates.yml")
        det_cfg, classes = linemod_yaml.load_linemod(yml)
        det_cfg = dataclasses.replace(
            det_cfg,
            image_width=self.cfg.detector.image_width,
            image_height=self.cfg.detector.image_height,
            max_candidates=self.cfg.detector.max_candidates,
            max_features=self.cfg.detector.max_features,
            max_templates=self.cfg.detector.max_templates)
        self.cfg = dataclasses.replace(self.cfg, detector=det_cfg)
        n_real = sum(len(v) for v in classes.values())
        if n_real == 0:
            raise IOError(f"no classes in {yml}")  # ERROR_OPEN_FILE_FAILED
        # Size the packed bank to the loaded templates (rounded up to a
        # multiple of 8) instead of always padding to
        # max_templates: every match stage is O(capacity), so a 30-view
        # bank must not pay a 1024-slot bank's coarse/top-K cost.
        cap = min(self.cfg.detector.max_templates, -(-n_real // 8) * 8)
        self.bank = pack_bank(classes, levels=det_cfg.pyramid_levels,
                              modalities=len(det_cfg.modalities),
                              capacity=cap,
                              max_features=det_cfg.max_features)
        # score tables for the sparse scorer: bank-dependent only,
        # build once here instead of per frame
        self._kernels = det_mod.build_match_tables(self.bank,
                                                   self.cfg.detector)
        self._load_model_depths(classes)

    def _model_depth_path(self, cname: str, tid: int,
                          multi_class: bool) -> str:
        """Per-template model-depth png path.

        Multi-class banks key depths per class (``depth/<class>/<tid>.png``
        — the analog of the reference's one-directory-per-object contract,
        obj_reco_lmicp.cpp:67-74, which makes the flat ``depth/<tid>.png``
        unambiguous there); single-class banks keep the reference's flat
        layout.  A per-class directory also wins for single-class banks
        when present.
        """
        qualified = os.path.join(self._feature_path, "depth", cname,
                                 f"{tid}.png")
        if multi_class or os.path.exists(qualified):
            return qualified
        return os.path.join(self._feature_path, "depth", f"{tid}.png")

    def _load_model_depths(self, classes) -> None:
        """Pre-crop each template's model depth to the static refine
        window, converted to u16 mm (x model_depth_scale).

        Missing or size-mismatched depth pngs are a hard error: an
        all-zero depth slot silently refines against an empty cloud and
        fails only via ``icp.ok`` downstream (the reference aborts load
        on a bad png too, obj_reco_lmicp.cpp:156-161).
        """
        from fealess.utils.logging import get_logger

        n = self.bank.capacity
        crop = self.cfg.refine_crop
        out = np.zeros((n, crop, crop), np.uint16)
        multi_class = len(classes) > 1
        slot = 0
        missing: List[str] = []
        for cname in sorted(classes.keys()):
            for tid, view in enumerate(classes[cname]):
                path = self._model_depth_path(cname, tid, multi_class)
                img = png.imread(path)
                if img is None:
                    missing.append(path)
                    slot += 1
                    continue
                if img.ndim != 2:
                    raise IOError(
                        f"model depth {path} is not single-channel "
                        f"(shape {img.shape})")  # ERROR_OPEN_FILE_FAILED
                x0 = max(int(view.offset_x[0]), 0)
                y0 = max(int(view.offset_y[0]), 0)
                if (img.shape[0] <= y0 or img.shape[1] <= x0):
                    raise IOError(
                        f"model depth {path} ({img.shape[1]}x{img.shape[0]}"
                        f") does not cover template rect origin "
                        f"({x0}, {y0})")
                mm = (img.astype(np.float32)
                      * self.cfg.model_depth_scale)
                # convertTo(CV_16UC1, 0.1) rounds half away from zero? cv
                # uses cvRound (half-to-even); match it:
                mm16 = np.rint(mm).astype(np.uint16)
                # Crop at the EXACT template rect origin (zero-padded past
                # the image edge): the refine step index-pairs the model
                # and scene rects, so the rect must start at the crop
                # origin — clamping here would shift the pairing.
                win = mm16[y0:y0 + crop, x0:x0 + crop]
                out[slot, :win.shape[0], :win.shape[1]] = win
                # remember the crop origin actually used
                self._depth_origin[slot] = (x0, y0)
                slot += 1
        if missing:
            raise IOError(
                f"{len(missing)} model depth png(s) missing, e.g. "
                f"{missing[0]}")  # ERROR_OPEN_FILE_FAILED
        get_logger().debug("loaded %d model depths", slot)
        self._model_depth = out
        # device-resident copies for the fused Recognition step (uploaded
        # once per add_obj, not per frame)
        self._model_depth_dev = jnp.asarray(out)
        self._origins_dev = jnp.asarray(self._origins_array())

    def set_roi(self, roi_mask: np.ndarray) -> None:
        """SetROI is a stub in the reference (obj_reco_lmicp.cpp:81-84)."""

    def export_artifact(self, path: str) -> None:
        """Write the serialized serving artifact (the libObjRecoLmICP.so
        analog — android/Android.mk): the fused Recognition step via
        jax.export plus all engine state; a fresh process serves from it
        without re-tracing (fealess.io.export.ServingArtifact)."""
        from fealess.io import export as export_mod
        export_mod.export_artifact(self, path)

    # -- advanced params (Set/GetAdvancedParam are stubs in the reference,
    # obj_reco_lmicp.cpp:206-214; here they actually reconfigure)
    _PARAM_PATHS = {
        "matching_threshold": ("matching_threshold",),
        "icp_iterations": ("icp", "max_iterations"),
        "icp_dist_mean_threshold": ("icp", "dist_mean_threshold"),
        "icp_dist_diff_threshold": ("icp", "dist_diff_threshold"),
        "icp_mode": ("icp", "mode"),
        "max_objects": ("max_objects",),
        "nms_object_distance": ("nms_object_distance",),
    }

    def set_advanced_param(self, name: str, value) -> None:
        path = self._PARAM_PATHS.get(name)
        if path is None:
            raise KeyError(f"unknown advanced param {name!r}; "
                           f"known: {sorted(self._PARAM_PATHS)}")
        if len(path) == 1:
            self.cfg = dataclasses.replace(self.cfg, **{path[0]: value})
        else:
            sub = getattr(self.cfg, path[0])
            sub = dataclasses.replace(sub, **{path[1]: value})
            self.cfg = dataclasses.replace(self.cfg, **{path[0]: sub})

    def get_advanced_param(self, name: str):
        path = self._PARAM_PATHS[name]
        obj = self.cfg
        for p in path:
            obj = getattr(obj, p)
        return obj

    def compute_pose_epnp(self, model_depth_raw: np.ndarray,
                          match_x: int, match_y: int,
                          pose_init_4x4: np.ndarray,
                          cam: CamIntrinsics) -> Optional[np.ndarray]:
        """The reference's dormant EPNP pose path (``ComputePose`` behind
        EPNP_LM, obj_reco_lmicp.cpp:275-348): back-project the template's
        masked depth pixels into the model frame with the initial pose,
        pair them with their scene pixel positions at the match offset,
        and solvePnP-EPNP for the pose.  ``model_depth_raw`` is the stored
        0.1mm-unit u16 png."""
        cv2 = _require_cv2("the EPNP pose path")
        raw = np.asarray(model_depth_raw)
        sentinel = raw[0, 0]
        ii, jj = np.nonzero(raw < sentinel)
        z = raw[ii, jj].astype(np.float32) * self.cfg.model_depth_scale
        ok = z >= 10.0                      # EFFECTIVE_DEPTH gate
        ii, jj, z = ii[ok], jj[ok], z[ok]
        if len(z) < 4:
            return None
        k = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy],
                      [0, 0, 1]], np.float64)
        inv_k = np.linalg.inv(k)
        pix = np.stack([jj, ii, np.ones_like(jj)], axis=0).astype(np.float64)
        xc = (inv_k @ pix) * z[None, :]
        r = np.asarray(pose_init_4x4, np.float64)[:3, :3]
        t = np.asarray(pose_init_4x4, np.float64)[:3, 3]
        xw = (r.T @ (xc - t[:, None])).T.astype(np.float32)
        img_pts = np.stack([jj + match_x, ii + match_y],
                           axis=-1).astype(np.float32)
        ok2, rvec, tvec = cv2.solvePnP(xw, img_pts, k, None,
                                       flags=cv2.SOLVEPNP_EPNP)
        if not ok2:
            return None
        rot, _ = cv2.Rodrigues(rvec)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rot
        pose[:3, 3] = tvec[:, 0]
        return pose

    def _origins_array(self) -> np.ndarray:
        out = np.zeros((self.bank.capacity, 2), np.int32)
        off_x = np.asarray(self.bank.offset_x)[:, 0]
        off_y = np.asarray(self.bank.offset_y)[:, 0]
        out[:, 0] = off_x
        out[:, 1] = off_y
        for slot, (x0, y0) in self._depth_origin.items():
            out[slot] = (x0, y0)
        return out

    def _prepare_frame(self, rgb_bgr: np.ndarray, depth_u16: np.ndarray,
                       cam: CamIntrinsics):
        """PrepareInputData (obj_reco_lmicp.cpp:216-259): resize to the
        processing width, zoom the intrinsics — then pad bottom/right to
        the pyramid alignment (every level T-divisible) so ANY camera
        geometry serves.  The reference instead hard-requires the 640x480
        4:3 operating point; here padded rows carry zero depth (invalid)
        and zero color, intrinsics are untouched (padding doesn't move
        the principal point), and match/refine coordinates stay valid
        because padding is strictly bottom/right."""
        d = self.cfg.detector
        if (rgb_bgr.shape[0] != cam.height or rgb_bgr.shape[1] != cam.width
                or depth_u16.shape != (cam.height, cam.width)):
            raise ValueError("image size must match camera intrinsics")
        zoom = d.image_width / cam.width
        w = d.image_width
        h = int(round(cam.height * zoom))
        if zoom != 1.0:
            cv2 = _require_cv2("resizing frames to the processing width")
            rgb_bgr = cv2.resize(rgb_bgr, (w, h))
            depth_u16 = cv2.resize(depth_u16, (w, h),
                                   interpolation=cv2.INTER_NEAREST)
        align = d.pyramid_alignment
        h_pad = -(-h // align) * align
        w_pad = -(-w // align) * align
        if (h_pad, w_pad) != (h, w):
            rgb_bgr = np.pad(rgb_bgr, ((0, h_pad - h), (0, w_pad - w),
                                       (0, 0)))
            depth_u16 = np.pad(depth_u16, ((0, h_pad - h), (0, w_pad - w)))
        if (d.image_height, d.image_width) != (h_pad, w_pad):
            # first frame from a camera with a new aspect: pin the
            # processing dims (jit keys on them) and refresh the tables
            self.cfg = dataclasses.replace(
                self.cfg, detector=dataclasses.replace(
                    d, image_height=h_pad, image_width=w_pad))
            if self.bank is not None:
                self._kernels = det_mod.build_match_tables(
                    self.bank, self.cfg.detector)
        fx, fy, cx, cy = gd.scale_intrinsics(cam.fx, cam.fy, cam.cx, cam.cy,
                                             zoom)
        scene_k = gd.intrinsics_matrix(fx, fy, cx, cy)
        return rgb_bgr, depth_u16, scene_k

    def _class_mask(self, class_ids):
        """class_ids -> device slot mask (Detector::match's class filter,
        linemod.hpp:317-325), or None for an unrestricted search."""
        if class_ids is None:
            return None
        from fealess.bank import class_slot_mask
        return jnp.asarray(class_slot_mask(self.bank, class_ids))

    def recognition_multi(self, rgb_bgr: np.ndarray, depth_u16: np.ndarray,
                          cam: CamIntrinsics,
                          max_objects: Optional[int] = None,
                          class_ids: Optional[List[str]] = None,
                          roi_mask: Optional[np.ndarray] = None
                          ) -> List[RecoResult]:
        """Multi-object Recognition: refine the top-M match candidates in
        parallel on device and 3D-NMS the refined poses (the multi-object
        design of ICP/NMS.cpp:6-40; the reference engine itself only
        returns top-1, obj_reco_lmicp.cpp:111).  ``class_ids`` restricts
        the search to those classes (linemod.hpp:317-325)."""
        if self.bank is None:
            raise RuntimeError("add_obj not called")
        import jax

        m = max_objects or self.cfg.max_objects
        rgb_bgr, depth_u16, scene_k = self._prepare_frame(rgb_bgr,
                                                          depth_u16, cam)
        # Same serving-path treatment as the top-1 path: the model-depth
        # stack and crop origins are the device-resident copies uploaded
        # once at add_obj (not per frame — at 1024 templates the stack is
        # ~134 MB), the step is one fused device program, and the result
        # is fetched with ONE bulk device_get.
        if roi_mask is not None and roi_mask.shape != rgb_bgr.shape[:2]:
            ph = rgb_bgr.shape[0] - roi_mask.shape[0]
            pw = rgb_bgr.shape[1] - roi_mask.shape[1]
            roi_mask = np.pad(roi_mask, ((0, ph), (0, pw)))
        step = pipeline.recognize_multi_jit(
            self.bank, self._model_depth_dev, self._origins_dev,
            jnp.asarray(rgb_bgr), jnp.asarray(depth_u16), scene_k,
            self.cfg, m, kernels=self._kernels,
            class_mask=self._class_mask(class_ids),
            roi_mask=None if roi_mask is None
            else jnp.asarray(roi_mask.astype(bool)))
        host = jax.device_get(step)
        widths = np.asarray(self.bank.width)[:, 0]
        heights = np.asarray(self.bank.height)[:, 0]
        results: List[RecoResult] = []
        for i in np.nonzero(host.valid)[0]:
            slot = int(host.template_slot[i])
            results.append(RecoResult(
                obj_tag=self.bank.class_names[int(host.class_idx[i])],
                world2cam=np.asarray(host.poses[i]),
                similarity=float(host.similarity[i]),
                icp_dist=float(host.icp_dist[i]),
                inlier_ratio=float(host.inlier_ratio[i]),
                match_rect=(float(host.match_x[i]),
                            float(host.match_y[i]),
                            float(widths[slot]), float(heights[slot]))))
        return results

    def recognition(self, rgb_bgr: np.ndarray, depth_u16: np.ndarray,
                    cam: CamIntrinsics,
                    roi_mask: Optional[np.ndarray] = None,
                    class_ids: Optional[List[str]] = None
                    ) -> List[RecoResult]:
        """Full Recognition (obj_reco_lmicp.cpp:86-204): resize to the
        processing width, match, take the top match, ICP-refine its pose.
        ``roi_mask`` (processing resolution) gates matching to a region —
        the tracker-gated path (linemod_acq.cpp:136-191); ``class_ids``
        restricts the search to those classes (linemod.hpp:317-325, e.g.
        re-detecting one known class inside a tracked ROI).

        Both the unmasked and the ROI-masked paths are the FUSED device
        step (pipeline.recognize_top1): match + top-1 select + refine
        compile into one program and the host does exactly one device
        round trip per frame, so CLI/tracker throughput matches bench.py.
        """
        import jax

        if self.bank is None:
            raise RuntimeError("add_obj not called")
        rgb_bgr, depth_u16, scene_k = self._prepare_frame(rgb_bgr,
                                                          depth_u16, cam)
        if roi_mask is not None and roi_mask.shape != rgb_bgr.shape[:2]:
            ph = rgb_bgr.shape[0] - roi_mask.shape[0]
            pw = rgb_bgr.shape[1] - roi_mask.shape[1]
            if ph < 0 or pw < 0:
                raise ValueError(
                    f"roi_mask {roi_mask.shape} larger than processing "
                    f"frame {rgb_bgr.shape[:2]}")
            roi_mask = np.pad(roi_mask, ((0, ph), (0, pw)))
        step = pipeline.recognize_top1_jit(
            self.bank, self._model_depth_dev, self._origins_dev,
            jnp.asarray(rgb_bgr), jnp.asarray(depth_u16), scene_k,
            self.cfg, kernels=self._kernels,
            class_mask=self._class_mask(class_ids),
            roi_mask=None if roi_mask is None
            else jnp.asarray(roi_mask.astype(bool)))
        host = jax.device_get(step)          # one bulk fetch
        if not bool(host.valid):
            return []
        slot = int(host.template_slot)
        return [RecoResult(
            obj_tag=self.bank.class_names[int(host.class_idx)],
            world2cam=np.asarray(host.pose),
            similarity=float(host.similarity),
            icp_dist=float(host.refine.icp.dist_mean),
            inlier_ratio=float(host.refine.icp.inlier_ratio),
            match_rect=(float(host.match_x), float(host.match_y),
                        float(np.asarray(self.bank.width)[slot, 0]),
                        float(np.asarray(self.bank.height)[slot, 0])))]
