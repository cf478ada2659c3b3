"""Prompts over everything-mode results (counterpart of the JAX package's
``models/fastsam/prompt.py``): ``everything_prompt`` (every mask),
``box_prompt`` (the mask of largest IoU with the box), ``point_prompt`` (the
union of the masks holding foreground points, less those holding
background points).

The masks are the results' own (``Results.masks``, the cv2-rule fill kernel
at the predictor's defaults); a result predicted with ``boxes=False`` holds
none, and its polar contours are filled here by the even-odd rule, JAX's
jnp fill (``ops/raster.py:fill_polygons``, the even-odd kernel on a card).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ...ops.raster import fill_polygons


class FastSAMPrompt:
    def __init__(self, img, results):
        self.img = img
        self.results = results
        self.res = results[0] if isinstance(results, (list, tuple)) else results

    def _masks(self) -> np.ndarray:
        """(n, H, W) bool candidate masks."""
        if self.res.masks is not None:
            return np.asarray(self.res.masks.data).astype(bool)
        h, w = self.res.orig_shape
        if self.res.contours is not None and len(self.res.contours):
            dev = getattr(self.res, "device", "cpu")
            pts = torch.from_numpy(self.res.contours.points).to(dev).contiguous()
            ok = torch.from_numpy(self.res.contours.valid).to(dev).contiguous()
            return fill_polygons(pts, ok, h, w).cpu().numpy()
        return np.zeros((0, h, w), bool)

    def everything_prompt(self) -> np.ndarray:
        return self._masks()

    def box_prompt(self, bbox: Sequence[float]) -> np.ndarray:
        """(1, H, W): the mask of largest IoU with the box (the box's pixels
        taken as ``int`` of its corners)."""
        masks = self._masks()
        if masks.shape[0] == 0:
            return masks
        x1, y1, x2, y2 = (int(v) for v in bbox)
        box_area = max((x2 - x1) * (y2 - y1), 1)
        inter = masks[:, y1:y2, x1:x2].sum((1, 2))
        union = masks.sum((1, 2)) + box_area - inter
        iou = inter / np.maximum(union, 1)
        return masks[iou.argmax()][None]

    def point_prompt(self, points: Sequence[Sequence[float]], pointlabel: Sequence[int]
                     ) -> np.ndarray:
        """(1, H, W): the union of the masks holding label-1 points, less the
        masks holding the others, point by point in order. A background
        point on no mask changes nothing (JAX's raises there: ``~False``
        is the integer -1)."""
        masks = self._masks()
        if masks.shape[0] == 0:
            return masks
        h, w = masks.shape[1:]
        on = np.zeros((h, w), bool)
        for (x, y), lab in zip(points, pointlabel):
            xi, yi = int(np.clip(x, 0, w - 1)), int(np.clip(y, 0, h - 1))
            hit = masks[:, yi, xi]
            if not hit.any():
                continue
            if lab == 1:
                on |= masks[hit].any(0)
            else:
                on &= ~masks[hit].any(0)
        return on[None]

    def text_prompt(self, text: str):
        raise ImportError("text_prompt needs a CLIP model, which is not available here; use "
                          "box_prompt/point_prompt/everything_prompt")

    def plot(self, output_path: Optional[str] = None, masks: Optional[np.ndarray] = None):
        raise NotImplementedError("FastSAMPrompt.plot needs the annotator and image writing "
                                  "(the JAX utils/plotting.py); it waits for the tracking and "
                                  "annotator slice of the port")
