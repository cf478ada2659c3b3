"""Letterbox for predict-time preprocessing (counterpart of ``letterbox``
in the JAX package's ``data/augment.py``), without cv2: the resize is
bilinear through ``torch.nn.functional.interpolate`` (half-pixel centers,
as cv2's INTER_LINEAR), rounded back to uint8."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


PAD_VALUE = 114


def letterbox(img: np.ndarray, new_shape: Tuple[int, int]
              ) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """Aspect-preserving resize (up or down) of an HWC (or HW) uint8 image,
    centered on a ``PAD_VALUE`` canvas. Returns (img, gain, (pad_x, pad_y))."""
    h, w = img.shape[:2]
    r = min(new_shape[0] / h, new_shape[1] / w)
    nh, nw = round(h * r), round(w * r)
    img = img.reshape(h, w, -1)
    if (nh, nw) != (h, w):
        t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
        t = F.interpolate(t, size=(nh, nw), mode="bilinear", align_corners=False)
        img = t[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()
    dh, dw = new_shape[0] - nh, new_shape[1] - nw
    top, left = dh // 2, dw // 2
    out = np.full((new_shape[0], new_shape[1], img.shape[2]), PAD_VALUE, np.uint8)
    out[top : top + nh, left : left + nw] = img
    return out, r, (float(left), float(top))
