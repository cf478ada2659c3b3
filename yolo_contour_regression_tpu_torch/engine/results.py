"""Inference result containers (counterpart of the JAX package's
``engine/results.py``), numpy-backed. A detect result carries boxes only
(``contours`` and ``masks`` are None), a pose result boxes and
``keypoints`` (n, K, D) in the image's pixels, a segment result no
keypoints (None).

A segment_ori result carries its masks as computed (``masks``), a classify
result its probabilities (``probs``, a ``Probs``) and nothing else.

For the polar segment task ``Results.masks`` is lazy where the predictor
says so (``lazy_masks``, JAX's ``retina_masks or boxes``, true at the
defaults): the first read rasterizes the polar contours at
the original image size through ``ops.raster.fill_polygons_cv2`` on the
predictor's device (the CUDA kernel on a card, the plain version on the
CPU). Its rule is the JAX facade's, ``cv2.fillPoly`` of the valid vertices
at 3-bit subpixel precision (JAX ``contours_to_masks_host``), reproduced
without cv2: the masks are the JAX facade's, pixel for pixel. Without the flag (``predict(boxes=
False)``) a result holds contours and no masks (``masks`` is None), as
JAX's; ``FastSAMPrompt`` then fills the contours by the even-odd rule.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.raster import fill_polygons_cv2


class Boxes:
    """data rows: [x1, y1, x2, y2, conf, cls]."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data, np.float32).reshape(-1, 6)
        self.orig_shape = orig_shape

    def __len__(self):
        return self.data.shape[0]

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, 4]

    @property
    def cls(self):
        return self.data[:, 5]


class Masks:
    """Binary masks (n, H, W)."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data)
        self.orig_shape = orig_shape

    def __len__(self):
        return self.data.shape[0]


class Contours:
    """Polar contours (n, 36, 2) px + per-ray validity (n, 36)."""

    def __init__(self, points: np.ndarray, valid: np.ndarray, orig_shape):
        self.points = np.asarray(points, np.float32)
        self.valid = np.asarray(valid, bool)
        self.orig_shape = orig_shape

    def __len__(self):
        return self.points.shape[0]


class Probs:
    """Class probabilities (nc,): ``top1``, ``top5`` (ranked by
    ``np.argsort(-data)``) and ``top1conf``, as the JAX ``Probs``."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, np.float32)

    @property
    def top1(self) -> int:
        return int(self.data.argmax())

    @property
    def top5(self):
        return np.argsort(-self.data)[:5].tolist()

    @property
    def top1conf(self) -> float:
        return float(self.data.max())


def contours_to_masks(points: np.ndarray, valid: np.ndarray, height: int, width: int,
                      device="cuda") -> np.ndarray:
    """(n, V, 2) px contours + validity -> (n, H, W) bool masks, filled on
    ``device`` as the JAX facade fills them (``cv2.fillPoly`` at
    ``shift=3``; fewer than 3 valid vertices give an empty mask)."""
    pts = torch.as_tensor(points, dtype=torch.float32).to(device).contiguous()
    ok = torch.as_tensor(valid, dtype=torch.bool).to(device).contiguous()
    return fill_polygons_cv2(pts, ok, height, width).cpu().numpy()


class Results:
    """One image's results: boxes, contours and lazy masks (or masks as
    given), keypoints, or probabilities. ``lazy_masks`` lets ``masks`` fill
    the contours on first read; without it ``masks`` is what was given."""

    def __init__(
        self,
        orig_img: np.ndarray,
        path: str,
        names: Dict[int, str],
        boxes: Optional[np.ndarray] = None,
        contours=None,
        keypoints: Optional[np.ndarray] = None,
        speed: Optional[Dict[str, float]] = None,
        device="cuda",
        masks: Optional[np.ndarray] = None,
        probs: Optional[np.ndarray] = None,
        lazy_masks: bool = False,
    ):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.contours = (
            Contours(contours[0], contours[1], self.orig_shape) if contours is not None else None
        )
        self.keypoints = keypoints
        self.device = device
        self.speed = speed or {}
        self._masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.probs = Probs(probs) if probs is not None else None
        self._lazy_masks = bool(lazy_masks)

    @property
    def masks(self) -> Optional[Masks]:
        if self._masks is None and self._lazy_masks and self.contours is not None:
            self._masks = Masks(
                contours_to_masks(
                    self.contours.points, self.contours.valid, *self.orig_shape,
                    device=self.device,
                ),
                self.orig_shape,
            )
        return self._masks

    def __len__(self):
        for v in (self.boxes, self.contours):
            if v is not None:
                return len(v)
        return 0
