"""Letterbox for predict-time preprocessing (counterpart of ``letterbox``
in the JAX package's ``data/augment.py``), without cv2.

The resize reproduces ``cv2.resize(..., interpolation=cv2.INTER_LINEAR)`` on
uint8 images bit for bit, in numpy integer arithmetic: OpenCV's 11-bit
fixed-point coefficients (``_linear_coeffs``), a horizontal pass into int32
and its vertical pass as its vector code rounds it (``_resize_linear_u8``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

PAD_VALUE = 114
COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
COEF_ONE = 1 << COEF_BITS


def _linear_coeffs(src: int, dst: int, clamp_weights: bool):
    """Per output index: the first source index and its two weights, as
    OpenCV computes them. The scale is 1 / (dst / src) in double; the
    position ``(d + 0.5) * scale - 0.5`` is rounded to float32 and split into
    floor and fraction; the weights are ``rint((1 - f) * 2048)`` and
    ``rint(f * 2048)`` in float32. Columns (``clamp_weights``) take the
    border pixel alone where the position leaves the image; rows keep their
    fraction and clamp only the row index (see ``_resize_linear_u8``)."""
    scale = 1.0 / (dst / src)
    pos = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    first = np.floor(pos)
    frac = (pos - first).astype(np.float32)
    first = first.astype(np.int64)
    if clamp_weights:
        left, right = first < 0, first >= src - 1
        frac[left | right] = 0.0
        first[left] = 0
        first[right] = src - 1
    w0 = np.rint((np.float32(1.0) - frac) * np.float32(COEF_ONE)).astype(np.int32)
    w1 = np.rint(frac * np.float32(COEF_ONE)).astype(np.int32)
    return first, w0, w1


def _resize_linear_u8(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)`` for an
    HWC uint8 image. Horizontal pass: ``S = s0 * a0 + s1 * a1`` (int32, the
    two source columns clamped to the image). Vertical pass, as OpenCV's
    vector code does it: ``(((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >>
    16) + 2) >> 2``, saturated to uint8, with rows ``sy`` and ``sy + 1``
    clamped to the image."""
    h, w = img.shape[:2]
    sx, a0, a1 = _linear_coeffs(w, nw, clamp_weights=True)
    sy, b0, b1 = _linear_coeffs(h, nh, clamp_weights=False)
    src = img.astype(np.int32)
    rows = src[:, sx] * a0[None, :, None] + src[:, np.minimum(sx + 1, w - 1)] * a1[None, :, None]
    r0, r1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    out = (((b0[:, None, None] * (rows[r0] >> 4)) >> 16)
           + ((b1[:, None, None] * (rows[r1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def letterbox(img: np.ndarray, new_shape: Tuple[int, int]
              ) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """Aspect-preserving resize (up or down) of an HWC (or HW) uint8 image,
    centered on a ``PAD_VALUE`` canvas. Returns (img, gain, (pad_x, pad_y))."""
    h, w = img.shape[:2]
    r = min(new_shape[0] / h, new_shape[1] / w)
    nh, nw = round(h * r), round(w * r)
    img = img.reshape(h, w, -1)
    if (nh, nw) != (h, w):
        img = _resize_linear_u8(img, nh, nw)
    dh, dw = new_shape[0] - nh, new_shape[1] - nw
    top, left = dh // 2, dw // 2
    out = np.full((new_shape[0], new_shape[1], img.shape[2]), PAD_VALUE, np.uint8)
    out[top : top + nh, left : left + nw] = img
    return out, r, (float(left), float(top))
