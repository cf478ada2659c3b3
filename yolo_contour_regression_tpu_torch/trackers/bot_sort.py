"""BoT-SORT: ByteTrack with camera-motion compensation and an optional
appearance term (counterpart of the JAX package's ``trackers/bot_sort.py``),
host numpy without cv2.

``GMC`` estimates the 2x3 warp from the previous frame to this one on the
half-size gray image and scales its translation back. ``sparseOptFlow`` (the
default, as in JAX) is ``good_features_to_track`` in this frame, the
previous frame's corners followed by ``calc_optical_flow_pyr_lk`` and
``estimate_affine_partial_2d`` (RANSAC) on those the flow kept, the cv2
calls JAX makes, reproduced in ``data/imgproc.py``. ``none`` is the
identity. ``ecc``, ``orb`` and ``sift`` are not ported yet. ``BOTSORT``
warps the tracked and lost tracks' means by the estimate before the
Kalman prediction, as JAX does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..data.augment import _resize_linear_u8, bgr_to_gray
from ..data.imgproc import (calc_optical_flow_pyr_lk, estimate_affine_partial_2d,
                            good_features_to_track)
from .byte_tracker import BYTETracker, STrack
from .utils.kalman_filter import KalmanFilterXYWH

NOT_PORTED_GMC = {m: f"GMC method '{m}' is not ported (ROADMAP Queue 1 item 3.2b)"
                  for m in ("ecc", "orb", "sift")}


class GMC:
    """Global (camera) motion compensation: ``apply(frame)`` gives the 2x3
    float32 warp from the previous frame to ``frame`` (the identity on the
    first frame or when the estimate fails)."""

    METHODS = ("sparseOptFlow", "orb", "sift", "ecc", "none")

    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2):
        if method in (None, "None"):
            method = "none"
        if method not in self.METHODS:
            raise ValueError(f"unknown GMC method '{method}', choose from {self.METHODS}")
        if method in NOT_PORTED_GMC:
            raise NotImplementedError(NOT_PORTED_GMC[method])
        self.method = method
        self.downscale = max(1, downscale)
        self.prev_gray: Optional[np.ndarray] = None
        self.prev_pts: Optional[np.ndarray] = None

    def _prep(self, frame: np.ndarray) -> np.ndarray:
        gray = bgr_to_gray(frame) if frame.ndim == 3 else frame
        if self.downscale > 1:
            h, w = gray.shape
            gray = _resize_linear_u8(gray[..., None], h // self.downscale,
                                     w // self.downscale)[..., 0]
        return gray

    def _rescale(self, H: np.ndarray) -> np.ndarray:
        if self.downscale > 1:
            H = H.copy()
            H[0, 2] *= self.downscale
            H[1, 2] *= self.downscale
        return H

    @staticmethod
    def _fit_affine(src: np.ndarray, dst: np.ndarray) -> Optional[np.ndarray]:
        if len(src) < 4:
            return None
        m, _ = estimate_affine_partial_2d(src, dst)
        return None if m is None else m.astype(np.float32)

    def apply(self, frame: np.ndarray) -> np.ndarray:
        if self.method == "none":
            return np.eye(2, 3, dtype=np.float32)
        gray = self._prep(frame)
        H = np.eye(2, 3, dtype=np.float32)
        pts = good_features_to_track(gray)
        if self.prev_gray is not None and self.prev_pts is not None and pts is not None:
            nxt, status = calc_optical_flow_pyr_lk(self.prev_gray, gray, self.prev_pts)
            ok = status.flatten() == 1
            m = self._fit_affine(self.prev_pts[ok], nxt[ok])
            if m is not None:
                H = self._rescale(m)
        self.prev_pts = pts
        self.prev_gray = gray
        return H


class BOTrack(STrack):
    shared_kalman = KalmanFilterXYWH()

    def __init__(self, xywh, score, cls, feat: Optional[np.ndarray] = None, feat_history: int = 50):
        super().__init__(xywh, score, cls)
        self.smooth_feat = None
        self.curr_feat = None
        self.alpha = 0.9
        if feat is not None:
            self.update_features(feat)

    def update_features(self, feat: np.ndarray):
        feat = feat / (np.linalg.norm(feat) + 1e-9)
        self.curr_feat = feat
        if self.smooth_feat is None:
            self.smooth_feat = feat
        else:
            self.smooth_feat = self.alpha * self.smooth_feat + (1 - self.alpha) * feat
            self.smooth_feat /= np.linalg.norm(self.smooth_feat) + 1e-9

    @staticmethod
    def tlwh_to_xyah(tlwh):  # BoT-SORT measures xywh directly
        return np.asarray(
            [tlwh[0] + tlwh[2] / 2, tlwh[1] + tlwh[3] / 2, tlwh[2], tlwh[3]], np.float32
        )

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        x, y, w, h = self.mean[:4]
        return np.asarray([x - w / 2, y - h / 2, w, h], np.float32)


class BOTSORT(BYTETracker):
    """BYTETracker over ``BOTrack``s (XYWH Kalman state) with ``GMC``."""

    def __init__(self, proximity_thresh=0.5, appearance_thresh=0.25, with_reid=False,
                 gmc_method: str = "sparseOptFlow", **kw):
        super().__init__(**kw)
        self.proximity_thresh = proximity_thresh
        self.appearance_thresh = appearance_thresh
        self.with_reid = with_reid
        self.gmc = GMC(method=gmc_method)

    def _kf(self):
        return KalmanFilterXYWH()

    def _new_tracks(self, xywhs, scores, clss):
        return [BOTrack(b, s, c) for b, s, c in zip(xywhs, scores, clss)]

    def apply_gmc(self, frame: np.ndarray):
        """Warp the tracked and lost tracks' mean positions by the camera
        motion that ``GMC`` estimates."""
        H = self.gmc.apply(frame)
        R = H[:2, :2]
        t = H[:2, 2]
        for track in self._joint(self.tracked, self.lost):
            if track.mean is not None:
                track.mean[:2] = R @ track.mean[:2] + t

    def update(self, boxes_xyxy, scores, classes, frame: Optional[np.ndarray] = None):
        if frame is not None:
            self.apply_gmc(frame)
        return super().update(boxes_xyxy, scores, classes)
