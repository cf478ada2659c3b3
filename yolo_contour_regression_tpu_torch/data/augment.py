"""Letterbox and the host side of the sample pipelines (counterparts of
``letterbox``, ``Sample``, ``letterbox_sample``, the host train transforms
``mosaic4``, ``mosaic9``, ``copy_paste``, ``random_perspective``, ``mixup``,
``pixel_augment``, ``random_hsv``, ``random_flip`` and ``train_transform``,
``format_sample``, ``format_sample_raw``, ``collate`` and the fork's
grayscale classify transforms in the JAX package's ``data/augment.py``),
without cv2. The detect-family train transforms also run on the device
(``data/device_augment.py``); the host chain here is the JAX package's
for ``device_augment=false``, ``mosaic9``, ``copy_paste`` and RT-DETR.

The host transforms draw from the dataset's ``random.Random`` in the JAX
order, call by call, so every later draw stays in step with JAX's; their
images equal JAX's cv2 images byte for byte through the numpy copies of the
cv2 functions in ``data/imgproc.py`` and ``fill_poly`` below. No draw
depends on a pixel, so a sample whose ``img`` is None (its size in ``hw``)
goes through every transform drawing and moving its labels as usual,
without pixel work: ``TrainDataset.plan`` makes that pass in read order and
renders the pixels later, in parallel.

The resize reproduces ``cv2.resize(..., interpolation=cv2.INTER_LINEAR)`` on
uint8 images (any channel count) bit for bit, in numpy integer arithmetic:
OpenCV's 11-bit fixed-point coefficients (``_linear_coeffs``), a horizontal
pass into int32 and its vertical pass as its vector code rounds it
(``_resize_linear_u8``). ``bgr_to_gray`` is cv2's ``COLOR_BGR2GRAY`` on
uint8, exact. ``resize_linear_f32`` is the same resize of float32 images
(cv2's float path, in torch): a separate algorithm, see its docstring.
"""
from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.polar import NUM_CONTOUR_POINTS
from ..ops.raster import XY_SHIFT
from . import imgproc
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


def letterbox_geometry(h: int, w: int, new_shape: Tuple[int, int], scaleup: bool = True):
    """The letterbox of an h x w image to ``new_shape``: the gain, the
    resized size (nh, nw) and the (top, left) pad."""
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    nh, nw = round(h * r), round(w * r)
    return r, (nh, nw), ((new_shape[0] - nh) // 2, (new_shape[1] - nw) // 2)


def letterbox(img: np.ndarray, new_shape: Tuple[int, int], scaleup: bool = True
              ) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """Aspect-preserving resize of an HWC (or HW) uint8 image, centered on a
    ``PAD_VALUE`` canvas; with ``scaleup=False`` it only shrinks. Returns
    (img, gain, (pad_x, pad_y))."""
    h, w = img.shape[:2]
    r, (nh, nw), (top, left) = letterbox_geometry(h, w, new_shape, scaleup)
    img = img.reshape(h, w, -1)
    if (nh, nw) != (h, w):
        img = _resize_linear_u8(img, nh, nw)
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
    image's own frame; ``letterbox_sample`` sets them. ``img`` None with
    ``hw`` (h, w): a sample without pixels (see the module docstring)."""

    __slots__ = ("img", "inst", "ori_shape", "ratio_pad", "_hw")

    def __init__(self, img: Optional[np.ndarray], inst: Instances, ori_shape=None, ratio_pad=None,
                 hw=None):
        self.img = img
        self.inst = inst
        self.ori_shape = ori_shape
        self.ratio_pad = ratio_pad
        self._hw = None if hw is None else (int(hw[0]), int(hw[1]))

    @property
    def hw(self) -> Tuple[int, int]:
        return self.img.shape[:2] if self.img is not None else self._hw


def letterbox_sample(s: Sample, imgsz, scaleup: bool = True) -> Sample:
    """Letterbox a sample to ``imgsz`` (an int, square, or an (h, w) tuple),
    moving its labels with the image."""
    h0, w0 = s.hw
    shape = (imgsz, imgsz) if isinstance(imgsz, int) else tuple(imgsz)
    if s.img is None:
        r, _, (py, px) = letterbox_geometry(h0, w0, shape, scaleup)
        img, px, py = None, float(px), float(py)
    else:
        img, r, (px, py) = letterbox(s.img, shape, scaleup=scaleup)
    inst = s.inst.copy()
    inst.scale(r, r)
    inst.translate(px, py)
    return Sample(img, inst, ori_shape=(h0, w0), ratio_pad=(r, px, py), hw=shape)


# --- the host train transforms --------------------------------------------------


def _resize_long_side(smp: Sample, s: int) -> Tuple[Optional[np.ndarray], float, int, int]:
    """The sample's image with its long side scaled to ``s`` (cv2's default
    INTER_LINEAR, ``_resize_linear_u8``; None without pixels), the gain and
    the new size."""
    h, w = smp.hw
    r = s / max(h, w)
    img = smp.img
    if r != 1:
        h, w = round(h * r), round(w * r)
        if img is not None:
            img = _resize_linear_u8(img.reshape(img.shape[0], img.shape[1], -1), h, w)
    return img, r, h, w


def mosaic4(samples: List[Sample], imgsz: int, rng: random.Random) -> Sample:
    """Four samples on a 2 imgsz canvas filled with ``PAD_VALUE``, their
    corners meeting at a centre ``(xc, yc)`` drawn ``int(rng.uniform(s // 2,
    3 s // 2))``, y first; each sample's long side scaled to imgsz first.
    Labels moved with their tiles and clipped to the canvas."""
    s = imgsz
    yc = int(rng.uniform(s // 2, 3 * s // 2))
    xc = int(rng.uniform(s // 2, 3 * s // 2))
    pixels = samples[0].img is not None
    canvas = np.full((2 * s, 2 * s, 3), PAD_VALUE, np.uint8) if pixels else None
    insts = []
    for i, smp in enumerate(samples):
        img, r, h, w = _resize_long_side(smp, s)
        if i == 0:  # top left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif i == 1:  # top right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif i == 2:  # bottom left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
        else:  # bottom right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b = 0, 0
        if pixels:
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y1b + (y2a - y1a), x1b:x1b + (x2a - x1a)]
        inst = smp.inst.copy()
        inst.scale(r, r)
        inst.translate(x1a - x1b, y1a - y1b)
        insts.append(inst)
    inst = Instances.concatenate(insts)
    inst.clip(2 * s, 2 * s)
    return Sample(canvas, inst, hw=(2 * s, 2 * s))


# mosaic9's 3x3 cells, the centre first
MOSAIC9_CELLS = ((1, 1), (0, 0), (0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1), (2, 2))


def mosaic9(samples: List[Sample], imgsz: int, rng: random.Random) -> Sample:
    """Nine samples on a 3 imgsz canvas, one per cell of ``MOSAIC9_CELLS``
    at the cell's top left (long side scaled to imgsz); the central 2 imgsz
    square is kept, labels clipped to it and the degenerate ones dropped.
    Draws nothing."""
    s = imgsz
    pixels = samples[0].img is not None
    canvas = np.full((3 * s, 3 * s, 3), PAD_VALUE, np.uint8) if pixels else None
    insts = []
    for (gy, gx), smp in zip(MOSAIC9_CELLS, samples):
        img, r, h, w = _resize_long_side(smp, s)
        y0, x0 = gy * s, gx * s
        if pixels:
            canvas[y0:y0 + h, x0:x0 + w] = img
        inst = smp.inst.copy()
        inst.scale(r, r)
        inst.translate(x0, y0)
        insts.append(inst)
    inst = Instances.concatenate(insts)
    o = s // 2
    inst.translate(-o, -o)
    inst.clip(2 * s, 2 * s)
    img = np.ascontiguousarray(canvas[o:o + 2 * s, o:o + 2 * s]) if pixels else None
    return Sample(img, inst.remove_degenerate(), hw=(2 * s, 2 * s))


def _clip_lines(w: int, h: int, x1, y1, x2, y2):
    """OpenCV's ``clipLine`` on int64 arrays, elementwise: each segment cut
    to [0, w-1] x [0, h-1], the intercepts truncated from double. Returns
    (inside, x1, y1, x2, y2); a segment wholly outside comes back as it
    was, with inside False."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    def step(num, a, b):  # (int64)((double)num * a / b)
        return np.trunc(num.astype(np.float64) * a / np.where(b == 0, 1, b)).astype(np.int64)

    c1, c2 = code(x1, y1), code(x2, y2)
    go = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    s = go & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = np.where(s, x1 + step(a - y1, x2 - x1, y2 - y1), x1)
    y1 = np.where(s, a, y1)
    c1 = np.where(s, (x1 < 0) + (x1 > right) * 2, c1)
    s = go & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = np.where(s, x2 + step(a - y2, x2 - x1, y2 - y1), x2)
    y2 = np.where(s, a, y2)
    c2 = np.where(s, (x2 < 0) + (x2 > right) * 2, c2)
    go = go & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    s = go & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = np.where(s, y1 + step(a - x1, y2 - y1, x2 - x1), y1)
    x1 = np.where(s, a, x1)
    c1 = np.where(s, 0, c1)
    s = go & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = np.where(s, y2 + step(a - x2, y2 - y1, x2 - x1), y2)
    x2 = np.where(s, a, x2)
    c2 = np.where(s, 0, c2)
    return (c1 | c2) == 0, x1, y1, x2, y2


def _draw_lines(mask: np.ndarray, x1, y1, x2, y2, value: int):
    """OpenCV's 8-connected lines from (x1, y1) to (x2, y2) (int64 arrays),
    each clipped to the mask and run left to right: pixel k of the major
    axis steps the minor axis ``ceil((2 minor k - major) / (2 major))``
    times."""
    h, w = mask.shape
    ok, x1, y1, x2, y2 = _clip_lines(w, h, x1, y1, x2, y2)
    flip = x2 < x1
    x1, x2, y1, y2 = np.where(flip, x2, x1), np.where(flip, x1, x2), np.where(flip, y2, y1), \
        np.where(flip, y1, y2)
    dx, dy = x2 - x1, y2 - y1
    sy = np.where(dy < 0, -1, 1)
    vert = np.abs(dy) > dx
    major = np.where(vert, np.abs(dy), dx)[ok]
    minor = np.where(vert, dx, np.abs(dy))[ok]
    if not major.size:
        return
    x1, y1, sy, vert = x1[ok, None], y1[ok, None], sy[ok, None], vert[ok, None]
    k = np.arange(int(major.max()) + 1)
    m = (2 * minor[:, None] * k + major[:, None] - 1) // np.maximum(2 * major[:, None], 1)
    m = np.where(major[:, None] == 0, 0, m)
    on = k <= major[:, None]
    xs = np.where(vert, x1 + m, x1 + k)
    ys = np.where(vert, y1 + sy * k, y1 + sy * m)
    mask[ys[on], xs[on]] = value


def fill_poly(mask: np.ndarray, pts: np.ndarray, value: int = 1) -> np.ndarray:
    """``cv2.fillPoly(mask, [pts], value)`` for one polygon of int32 points
    (V, 2) at shift 0 with LINE_8, in place, as OpenCV's
    ``CollectPolyEdges`` and ``FillEdgeCollection`` draw it:

    - each edge from vertex i-1 (cyclic) to vertex i is drawn as an
      8-connected line (``_draw_lines``);
    - an edge with y0 != y1 spans rows [min y, max y) with x in 16.16 fixed
      point, ``dx = trunc((X1 - X0) / (y1 - y0))``; an edge whose line leaves
      the image takes X and dx from the clipped line's integer ends (and y
      too, unless they coincide);
    - on each row the edges' x sorted and paired fill the columns
      ``(a + 0xFFFF) >> 16`` through ``b >> 16``, clipped to the image.

    The host fill of ``copy_paste``; ``ops/raster.py:fill_polygons_cv2`` is
    the shift-3 rule of the predict masks."""
    h, w = mask.shape
    p1 = np.asarray(pts, np.int64).reshape(-1, 2)
    if len(p1) == 0:
        return mask
    p0 = np.roll(p1, 1, axis=0)
    x0, y0, x1, y1 = p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1]
    X0, X1 = x0 << XY_SHIFT, x1 << XY_SHIFT
    out = (x0 < 0) | (x0 >= w) | (x1 < 0) | (x1 >= w) | (y0 < 0) | (y0 >= h) | (y1 < 0) | (y1 >= h)
    _, u0x, u0y, u1x, u1y = _clip_lines(w, h, x0, y0, x1, y1)
    cx0, cx1 = np.where(out, u0x << XY_SHIFT, X0), np.where(out, u1x << XY_SHIFT, X1)
    apart = out & (u0y != u1y)
    cy0, cy1 = np.where(apart, u0y, y0), np.where(apart, u1y, y1)
    num, den = cx1 - cx0, cy1 - cy0
    dx = np.where(den == 0, 0, np.abs(num) // np.maximum(np.abs(den), 1))
    dx = np.where((num < 0) != (den < 0), -dx, dx)
    down = y0 < y1
    ya, yb = np.where(down, y0, y1), np.where(down, y1, y0)
    xa = np.where(down, cx0 + (y0 - cy0) * dx, cx1 + (y1 - cy1) * dx)
    live = y0 != y1
    rows = np.arange(h)[:, None]
    act = live & (ya <= rows) & (rows < yb)  # (h, V)
    r, e = np.nonzero(act)
    if r.size:
        x = xa[e] + (r - ya[e]) * dx[e]
        order = np.lexsort((x, r))
        r, x = r[order], x[order]
        lo = np.maximum((x[0::2] + (1 << XY_SHIFT) - 1) >> XY_SHIFT, 0)
        hi = np.minimum(x[1::2] >> XY_SHIFT, w - 1)
        rr = r[0::2]
        n = np.maximum(hi - lo + 1, 0)
        if n.sum():
            run = np.repeat(np.arange(len(n)), n)
            col = lo[run] + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
            mask[rr[run], col] = value
    _draw_lines(mask, x0, y0, x1, y1, value)
    return mask


def _box_ioa(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Intersection of ``box`` (4,) with each of ``boxes`` (m, 4) over that
    box's area (+1e-7), xyxy."""
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = (np.clip(boxes[:, 2] - boxes[:, 0], 0, None)
            * np.clip(boxes[:, 3] - boxes[:, 1], 0, None))
    return inter / (area + 1e-7)


def copy_paste(s: Sample, p: float, rng: random.Random) -> Sample:
    """Paste mirrored instances (reference CopyPaste): of the sample's n
    instances ``rng.sample(range(n), max(1, round(p n)))``, each flipped
    left-right whose box is at least 2 px each way, whose intersection with
    every existing box is at most 0.3 of that box, and which has a contour;
    its contour (truncated to int32) is filled (``fill_poly``) and the
    mirrored image copied in there. A sample without contours is returned as
    it is, with no draw."""
    n = len(s.inst)
    if p <= 0 or n == 0 or not s.inst.segments.reshape(n, -1).any():
        return s
    h, w = s.hw
    flipped = s.inst.copy()
    flipped.fliplr(w)
    pasted = []
    for i in rng.sample(range(n), max(1, round(p * n))):
        box = flipped.bboxes[i]
        if (box[2] - box[0]) < 2 or (box[3] - box[1]) < 2:
            continue
        if _box_ioa(box, s.inst.bboxes).max(initial=0.0) > 0.30:
            continue
        seg = flipped.segments[i]
        if not seg.any():
            continue
        if s.img is not None:
            mask = fill_poly(np.zeros((h, w), np.uint8), seg.astype(np.int32)) == 1
            s.img = s.img.copy()
            s.img[mask] = np.fliplr(s.img)[mask]
        pasted.append(i)
    if pasted:
        s.inst = Instances.concatenate([s.inst, flipped.select(np.asarray(pasted))])
    return s


def _warp_points(xy: np.ndarray, m: np.ndarray, perspective: bool) -> np.ndarray:
    """(P, 2) float32 points through ``m`` in float32, as JAX does it
    (``[x, y, 1] @ m.T.astype(float32)``, divided by w for a perspective)."""
    out = np.concatenate([xy, np.ones((xy.shape[0], 1), np.float32)], 1) @ m.T.astype(np.float32)
    return out[:, :2] / out[:, 2:3] if perspective else out[:, :2]


def random_perspective(s: Sample, imgsz: int, rng: random.Random, degrees: float = 0.0,
                       translate: float = 0.1, scale: float = 0.5, shear: float = 0.0,
                       perspective: float = 0.0, border: Tuple[int, int] = (0, 0)) -> Sample:
    """The affine (or perspective) warp of image and labels: the output is
    the image size plus twice ``border`` (negative after a mosaic, which
    crops the 2x canvas back to imgsz). ``M = T @ S @ R @ P @ C`` in
    float64 from the draws, in this order: P's two, the angle, the scale,
    the two shears, the two translations. The image by
    ``imgproc.warp_perspective`` where ``perspective`` is set, else
    ``imgproc.warp_affine``, border ``PAD_VALUE``. Contours, box corners
    (instances without a contour) and keypoints in float32; keypoints
    leaving the output lose their visibility; then boxes from the contours,
    clipping and ``remove_degenerate``."""
    img = s.img
    h0, w0 = s.hw
    width = int(w0 + border[1] * 2)
    height = int(h0 + border[0] * 2)
    C = np.eye(3)
    C[0, 2] = -w0 / 2
    C[1, 2] = -h0 / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    sc = rng.uniform(1 - scale, 1 + scale)
    R[:2] = imgproc.rotation_matrix_2d(a, sc)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height
    M = T @ S @ R @ P @ C
    if img is None:
        pass
    elif perspective:
        img = imgproc.warp_perspective(img, M, (width, height), PAD_VALUE)
    else:
        img = imgproc.warp_affine(img, M[:2], (width, height), PAD_VALUE)
    inst = s.inst.copy()
    n = len(inst)
    if n:
        persp = bool(perspective)
        inst.segments = _warp_points(inst.segments.reshape(-1, 2), M, persp).reshape(n, -1, 2)
        if inst.keypoints is not None:
            kw = inst.keypoints.shape[1]
            inst.keypoints[..., :2] = _warp_points(
                inst.keypoints[..., :2].reshape(-1, 2), M, persp).reshape(n, kw, 2)
            k = inst.keypoints
            out = (k[..., 0] < 0) | (k[..., 0] > width) | (k[..., 1] < 0) | (k[..., 1] > height)
            k[..., 2] = np.where(out, 0.0, k[..., 2])
        inst.segments[..., 0] = inst.segments[..., 0].clip(0, width)
        inst.segments[..., 1] = inst.segments[..., 1].clip(0, height)
        inst.sync_boxes_from_segments()
        no_seg = ~inst.segments.reshape(n, -1).any(1)
        if no_seg.any():
            bx = inst.bboxes[no_seg]
            corners = np.stack([bx[:, [0, 1]], bx[:, [2, 1]], bx[:, [2, 3]], bx[:, [0, 3]]], 1)
            wc = _warp_points(corners.reshape(-1, 2), M, persp).reshape(-1, 4, 2)
            inst.bboxes[no_seg] = np.concatenate([wc.min(1), wc.max(1)], 1)
        inst.clip(width, height)
        inst = inst.remove_degenerate()
    return Sample(img, inst, hw=(height, width))


def mixup(a: Sample, b: Sample, noise) -> Sample:
    """MixUp: ``r = noise.beta(32, 32)``, the image ``a r + b (1 - r)`` in
    float32 truncated to uint8, the labels concatenated. ``noise`` is a
    numpy generator (JAX draws from numpy's global state, ``np.random``,
    which may be passed here to reproduce its draws)."""
    r = float(noise.beta(32.0, 32.0))
    img = None
    if a.img is not None:
        img = (a.img.astype(np.float32) * np.float32(r)
               + b.img.astype(np.float32) * np.float32(1 - r)).astype(np.uint8)
    return Sample(img, Instances.concatenate([a.inst, b.inst]), hw=a.hw)


def random_hsv(img: np.ndarray, rng: random.Random, hgain: float = 0.015, sgain: float = 0.7,
               vgain: float = 0.4) -> np.ndarray:
    """HSV jitter: three gains ``rng.uniform(-1, 1) * gain + 1``; the image
    to HSV (``imgproc.bgr_to_hsv``), each channel through its table (hue
    ``(x * g) % 180``, saturation and value ``clip(x * g, 0, 255)``, each
    truncated to uint8) and back (``imgproc.hsv_to_bgr``). No draw with all
    gains 0."""
    if not (hgain or sgain or vgain):
        return img
    r = np.array([rng.uniform(-1, 1) for _ in range(3)]) * [hgain, sgain, vgain] + 1
    if img is None:
        return None
    x = np.arange(256)
    luts = (((x * r[0]) % 180).astype(np.uint8), np.clip(x * r[1], 0, 255).astype(np.uint8),
            np.clip(x * r[2], 0, 255).astype(np.uint8))
    hsv = imgproc.bgr_to_hsv(img)
    hsv = np.stack([luts[c][hsv[..., c]] for c in range(3)], -1)
    return imgproc.hsv_to_bgr(hsv)


def random_flip(s: Sample, rng: random.Random, fliplr: float = 0.5, flipud: float = 0.0,
                flip_idx=None) -> Sample:
    """Up-down with probability ``flipud``, then left-right with ``fliplr``
    (keypoints permuted by ``flip_idx``), one draw each."""
    h, w = s.hw
    if rng.random() < flipud:
        if s.img is not None:
            s.img = np.flipud(s.img).copy()
        s.inst.flipud(h)
    if rng.random() < fliplr:
        if s.img is not None:
            s.img = np.fliplr(s.img).copy()
        s.inst.fliplr(w, flip_idx)
    return s


def pixel_augment(img: np.ndarray, rng: random.Random, p: float = 0.01) -> np.ndarray:
    """Four pixel-only branches, each with probability ``p`` in this order
    (the reference's Albumentations Blur, MedianBlur, ToGray and CLAHE):
    a box blur of ``rng.choice([3, 5, 7])``, a median blur of another such
    draw, gray (``bgr_to_gray`` repeated to 3 channels), and CLAHE (clip 4,
    8x8 tiles) on the L channel of Lab. Labels are untouched."""
    if rng.random() < p:
        k = rng.choice([3, 5, 7])
        img = None if img is None else imgproc.box_blur(img, k)
    if rng.random() < p:
        k = rng.choice([3, 5, 7])
        img = None if img is None else imgproc.median_blur(img, k)
    if rng.random() < p and img is not None:
        img = np.repeat(bgr_to_gray(img)[..., None], 3, -1)
    if rng.random() < p and img is not None:
        lab = imgproc.bgr_to_lab(img)
        lab[..., 0] = imgproc.clahe(lab[..., 0], 4.0, (8, 8))
        img = imgproc.lab_to_bgr(lab)
    return img


def train_transform(get_sample: Callable[[int], Sample], index: int, n_total: int, imgsz: int,
                    hyp, rng: random.Random, noise, flip_idx=None) -> Sample:
    """The host train chain for sample ``index`` (``get_sample(i)`` loads raw
    sample i), drawing from ``rng`` in the JAX order: with probability
    ``hyp.mosaic`` a mosaic (``mosaic9`` with probability ``hyp.mosaic9``,
    its eight partners drawn ``rng.randrange``, else ``mosaic4`` with three),
    ``copy_paste`` where ``hyp.copy_paste`` > 0, the warp with border
    ``-imgsz // 2`` and, with probability ``hyp.mixup``, MixUp with a second
    warped ``mosaic4`` of four drawn samples (its beta from ``noise``);
    otherwise the letterbox to imgsz with upscaling and the warp with border
    0. Then ``pixel_augment``, ``random_hsv`` and ``random_flip``."""
    warp = (hyp.degrees, hyp.translate, hyp.scale, hyp.shear, hyp.perspective)
    if rng.random() < hyp.mosaic:
        if rng.random() < getattr(hyp, "mosaic9", 0.0):
            idxs = [index] + [rng.randrange(n_total) for _ in range(8)]
            s = mosaic9([get_sample(i) for i in idxs], imgsz, rng)
        else:
            idxs = [index] + [rng.randrange(n_total) for _ in range(3)]
            s = mosaic4([get_sample(i) for i in idxs], imgsz, rng)
        if getattr(hyp, "copy_paste", 0.0) > 0:
            s = copy_paste(s, hyp.copy_paste, rng)
        border = (-imgsz // 2, -imgsz // 2)
        s = random_perspective(s, imgsz, rng, *warp, border)
        if rng.random() < hyp.mixup:
            idxs2 = [rng.randrange(n_total) for _ in range(4)]
            s2 = mosaic4([get_sample(i) for i in idxs2], imgsz, rng)
            s2 = random_perspective(s2, imgsz, rng, *warp, border)
            s = mixup(s, s2, noise)
    else:
        s = letterbox_sample(get_sample(index), imgsz, scaleup=True)
        s = random_perspective(s, imgsz, rng, *warp, (0, 0))
    s.img = pixel_augment(s.img, rng)
    s.img = random_hsv(s.img, rng, hyp.hsv_h, hyp.hsv_s, hyp.hsv_v)
    return random_flip(s, rng, hyp.fliplr, hyp.flipud, flip_idx)


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
