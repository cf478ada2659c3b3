"""Letterbox and the host side of the sample pipelines (counterparts of
``letterbox``, ``Sample``, ``letterbox_sample``, ``format_sample``,
``format_sample_raw``, ``collate`` and the fork's grayscale classify
transforms in the JAX package's ``data/augment.py``), without cv2. The
detect-family train transforms run on the device
(``data/device_augment.py``); the host cv2 train pipeline is not ported.

The resize reproduces ``cv2.resize(..., interpolation=cv2.INTER_LINEAR)`` on
uint8 images (any channel count) bit for bit, in numpy integer arithmetic:
OpenCV's 11-bit fixed-point coefficients (``_linear_coeffs``), a horizontal
pass into int32 and its vertical pass as its vector code rounds it
(``_resize_linear_u8``). ``bgr_to_gray`` is cv2's ``COLOR_BGR2GRAY`` on
uint8, exact. ``resize_linear_f32`` is the same resize of float32 images
(cv2's float path, in torch): a separate algorithm, see its docstring.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.polar import NUM_CONTOUR_POINTS
from .instance import Instances

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


# cv2's BGR2GRAY on uint8: 15-bit fixed-point weights of B, G and R
GRAY_WEIGHTS = (3735, 19235, 9798)
GRAY_SHIFT = 15


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` for an HWC uint8 BGR image,
    exactly: ``(3735 B + 19235 G + 9798 R + 2^14) >> 15``."""
    x = img.astype(np.int32)
    wb, wg, wr = GRAY_WEIGHTS
    g = x[..., 0] * wb + x[..., 1] * wg + x[..., 2] * wr + (1 << (GRAY_SHIFT - 1))
    return (g >> GRAY_SHIFT).astype(np.uint8)


def _resize_to_square_u8(g: np.ndarray, imgsz: int) -> np.ndarray:
    """``cv2.resize(g, (imgsz, imgsz))`` of a one-channel uint8 image."""
    if g.shape[:2] == (imgsz, imgsz):
        return g.copy()
    return _resize_linear_u8(g[..., None], imgsz, imgsz)[..., 0]


def classify_transform_eval(img: np.ndarray, imgsz: int) -> np.ndarray:
    """The fork's classify eval transform: gray (``bgr_to_gray``), resized to
    imgsz x imgsz (cv2's INTER_LINEAR, exactly), ``/ 255`` in float32 and
    repeated to 3 channels -> (imgsz, imgsz, 3) float32."""
    g = _resize_to_square_u8(bgr_to_gray(img), imgsz)
    g = g.astype(np.float32) / 255.0
    return np.repeat(g[..., None], 3, -1)


def classify_transform_train(img: np.ndarray, imgsz: int, rng, noise) -> np.ndarray:
    """The fork's classify train transform: as the eval one, with a
    brightness factor ``rng.uniform(0.6, 1.4)`` (``rng`` the dataset's
    ``random.Random``), clipped to [0, 255] in float32, then, where
    ``rng.random() < 0.5``, Gaussian noise ``noise.normal(0, 8, shape)``
    added in float64 and clipped again. ``noise`` is a
    ``numpy.random.Generator`` (JAX draws it from numpy's global state,
    ``np.random``, which has the same ``normal`` and may be passed here to
    reproduce its draws)."""
    g = _resize_to_square_u8(bgr_to_gray(img), imgsz)
    b = rng.uniform(0.6, 1.4)
    g = np.clip(g.astype(np.float32) * b, 0, 255)
    if rng.random() < 0.5:
        g = np.clip(g + noise.normal(0, 8, g.shape), 0, 255)
    g = (g / 255.0).astype(np.float32)
    return np.repeat(g[..., None], 3, -1)


def _linear_taps_f32(src: int, dst: int, device):
    """cv2's float INTER_LINEAR taps along one axis: per output index the
    two source indices and the float32 fraction. The position ``(d + 0.5) *
    (src / dst) - 0.5`` is taken in double; where it leaves the image the
    border pixel is taken alone (fraction 0)."""
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    first = np.floor(pos)
    frac = pos - first
    first = first.astype(np.int64)
    out = (first < 0) | (first >= src - 1)
    frac[out] = 0.0
    first = np.clip(first, 0, src - 1)
    return (torch.from_numpy(first).to(device), torch.from_numpy(np.minimum(first + 1, src - 1))
            .to(device), torch.from_numpy(frac.astype(np.float32)).to(device))


def _lerp_fma(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``fma(b - a, f, a)`` in float32, rounded once: the product of two
    float32 numbers is exact in float64, so only the sum rounds (twice: to
    float64, then float32)."""
    return ((b - a).double() * f.double() + a.double()).float()


def resize_linear_f32(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``cv2.resize(m, (width, height), interpolation=cv2.INTER_LINEAR)`` of
    float32 images x (n, h, w), on x's device: a horizontal then a vertical
    pass, each ``fma(x1 - x0, f, x0)`` in float32 on the taps of
    ``_linear_taps_f32`` (cv2's float path; it differs from the uint8 one).
    Equal to cv2 on every pixel of random images at every up- and
    down-scale tried, except sources one pixel high or wide, which cv2
    treats apart (within 2e-6). The same size returns a copy, as cv2."""
    n, h, w = x.shape
    if (h, w) == (height, width):
        return x.clone()
    x0, x1, fx = _linear_taps_f32(w, width, x.device)
    y0, y1, fy = _linear_taps_f32(h, height, x.device)
    rows = _lerp_fma(x[:, :, x0], x[:, :, x1], fx)
    return _lerp_fma(rows[:, y0], rows[:, y1], fy[:, None])


def letterbox(img: np.ndarray, new_shape: Tuple[int, int], scaleup: bool = True
              ) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """Aspect-preserving resize of an HWC (or HW) uint8 image, centered on a
    ``PAD_VALUE`` canvas; with ``scaleup=False`` it only shrinks. Returns
    (img, gain, (pad_x, pad_y))."""
    h, w = img.shape[:2]
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    nh, nw = round(h * r), round(w * r)
    img = img.reshape(h, w, -1)
    if (nh, nw) != (h, w):
        img = _resize_linear_u8(img, nh, nw)
    dh, dw = new_shape[0] - nh, new_shape[1] - nw
    top, left = dh // 2, dw // 2
    out = np.full((new_shape[0], new_shape[1], img.shape[2]), PAD_VALUE, np.uint8)
    out[top : top + nh, left : left + nw] = img
    return out, r, (float(left), float(top))


def bgr_to_rgb(img: np.ndarray) -> np.ndarray:
    """A contiguous copy of an HWC image with its channels reversed (cv2's
    BGR2RGB), one strided copy per channel: several times faster in numpy
    than copying ``img[..., ::-1]`` whole."""
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        out[..., c] = img[..., -1 - c]
    return out


class Sample:
    """One image and its labels mid-pipeline: img HWC uint8 BGR, inst in
    pixels. ``ori_shape`` (h0, w0) and ``ratio_pad`` (gain, pad_x, pad_y)
    record the letterbox, so a validator can map predictions back to the
    image's own frame; ``letterbox_sample`` sets them."""

    __slots__ = ("img", "inst", "ori_shape", "ratio_pad")

    def __init__(self, img: np.ndarray, inst: Instances, ori_shape=None, ratio_pad=None):
        self.img = img
        self.inst = inst
        self.ori_shape = ori_shape
        self.ratio_pad = ratio_pad


def letterbox_sample(s: Sample, imgsz, scaleup: bool = True) -> Sample:
    """Letterbox a sample to ``imgsz`` (an int, square, or an (h, w) tuple),
    moving its labels with the image."""
    h0, w0 = s.img.shape[:2]
    shape = (imgsz, imgsz) if isinstance(imgsz, int) else tuple(imgsz)
    img, r, (px, py) = letterbox(s.img, shape, scaleup=scaleup)
    inst = s.inst.copy()
    inst.scale(r, r)
    inst.translate(px, py)
    return Sample(img, inst, ori_shape=(h0, w0), ratio_pad=(r, px, py))


def _padded_labels(s: Sample, max_instances: int) -> Dict[str, np.ndarray]:
    """The sample's labels normalized to its image and padded to
    ``max_instances``: cls, bboxes (xywh), segments, mask_gt, and where the
    sample has them keypoints (max_instances, K, 3), xy normalized."""
    h, w = s.img.shape[:2]
    n = min(len(s.inst), max_instances)
    cls = np.zeros((max_instances,), np.int32)
    bboxes = np.zeros((max_instances, 4), np.float32)
    segments = np.zeros((max_instances, NUM_CONTOUR_POINTS, 2), np.float32)
    mask = np.zeros((max_instances,), bool)
    if n:
        inst = s.inst
        cls[:n] = inst.cls[:n].astype(np.int32)
        xyxy = inst.bboxes[:n]
        xywh = np.concatenate([(xyxy[:, :2] + xyxy[:, 2:]) / 2, xyxy[:, 2:] - xyxy[:, :2]], -1)
        bboxes[:n] = xywh / np.array([w, h, w, h], np.float32)
        segments[:n] = inst.segments[:n] / np.array([w, h], np.float32)
        mask[:n] = True
    out = {"cls": cls, "bboxes": bboxes, "segments": segments, "mask_gt": mask}
    if s.inst.keypoints is not None:
        kpts = np.zeros((max_instances, s.inst.keypoints.shape[1], 3), np.float32)
        if n:
            kpts[:n] = s.inst.keypoints[:n]
            kpts[:n, :, 0] /= w
            kpts[:n, :, 1] /= h
        out["keypoints"] = kpts
    return out


def format_sample(s: Sample, max_instances: int) -> Dict[str, np.ndarray]:
    """Sample -> the dense per-image dict, labels normalized to the image and
    padded to ``max_instances``. The image stays uint8, flipped BGR -> RGB on
    the host; the device's ``.float() / 255`` then equals the JAX package's
    float32 image bit for bit. ``ori_shape`` and ``ratio_pad`` are float32,
    as the JAX package stores them."""
    h, w = s.img.shape[:2]
    return {
        "img": bgr_to_rgb(s.img),
        **_padded_labels(s, max_instances),
        "ori_shape": np.asarray(s.ori_shape if s.ori_shape else (h, w), np.float32),
        "ratio_pad": np.asarray(s.ratio_pad if s.ratio_pad else (1.0, 0.0, 0.0), np.float32),
    }


def format_sample_raw(s: Sample, max_instances: int) -> Dict[str, np.ndarray]:
    """Sample -> the dense per-image dict of the train path, whose
    augmentation runs on the device (``data/device_augment.py``): the
    letterboxed image as it is (uint8 BGR), the labels normalized and padded
    as ``format_sample`` pads them, and the letterbox geometry the mosaic
    places its tiles by: ``content_hw`` (the resized image's size, Python's
    ``round(h0 * r)``) and ``pad_tl`` (top and left pad), float32."""
    h, w = s.img.shape[:2]
    r, px, py = s.ratio_pad if s.ratio_pad else (1.0, 0.0, 0.0)
    h0, w0 = s.ori_shape if s.ori_shape else (h, w)
    return {
        "img": np.ascontiguousarray(s.img, np.uint8),
        **_padded_labels(s, max_instances),
        "content_hw": np.asarray([round(h0 * r), round(w0 * r)], np.float32),
        "pad_tl": np.asarray([py, px], np.float32),
    }


INSTANCE_BUCKETS = (8, 16, 32)
# the per-instance keys that ``collate`` trims to the bucket
INSTANCE_KEYS = ("cls", "bboxes", "segments", "mask_gt", "keypoints")


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-image dicts, and trim the padded instance axis to the
    smallest bucket of ``INSTANCE_BUCKETS`` that holds the batch's most
    instances (else keep the pad; classify samples have no instances)."""
    out = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    if "mask_gt" not in out:
        return out
    n_pad = out["mask_gt"].shape[1]
    n_act = int(out["mask_gt"].sum(axis=1).max())
    cap = next((b for b in INSTANCE_BUCKETS if n_act <= b < n_pad), n_pad)
    for k in INSTANCE_KEYS:
        if k in out:
            out[k] = out[k][:, :cap]
    return out
