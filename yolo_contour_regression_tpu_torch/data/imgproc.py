"""numpy copies of the OpenCV image functions the host train pipeline
(``data/augment.py``) and the validator's shrink call in the JAX package,
each equal to ``cv2`` byte for byte on uint8 images (HWC, any channel count
unless stated). The port imports no cv2.

- ``warp_affine`` / ``warp_perspective``: ``cv2.warpAffine`` /
  ``cv2.warpPerspective`` at INTER_LINEAR with a constant border, as
  OpenCV 5's float kernels compute them (see ``_warp_coords``).
- ``rotation_matrix_2d``: ``cv2.getRotationMatrix2D`` about the origin.
- ``bgr_to_hsv`` / ``hsv_to_bgr``: ``COLOR_BGR2HSV`` / ``COLOR_HSV2BGR``
  (H in [0, 180)).
- ``box_blur`` / ``median_blur``: ``cv2.blur`` (BORDER_REFLECT_101) and
  ``cv2.medianBlur`` (BORDER_REPLICATE).
- ``bgr_to_lab`` / ``lab_to_bgr`` / ``clahe``: ``COLOR_BGR2LAB``,
  ``COLOR_LAB2BGR`` (OpenCV's integer paths and their tables) and
  ``cv2.createCLAHE(clip, tiles).apply``.
- ``resize_area``: ``cv2.resize(..., interpolation=cv2.INTER_AREA)`` when
  shrinking.

Each was held against cv2 on every input where that is possible (the
colour conversions over all 2^24 colours) and otherwise on random images
and matrices (``tests/test_torch_port_host_augment.py``).
"""
from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import Tuple

import numpy as np

f32 = np.float32


def _fma32(a, b, c) -> np.ndarray:
    """``fma(a, b, c)`` of float32 operands rounded once to float32: the
    product of two float32 numbers is exact in float64 and, at the sizes
    here, so is the sum."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


# --- warps --------------------------------------------------------------------


def rotation_matrix_2d(angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center=(0, 0), angle, scale)``: (2, 3)
    float64, ``[[a, b, 0], [-b, a, 0]]`` with ``a = cos(angle) * scale``,
    ``b = sin(angle) * scale``, the angle in degrees."""
    rad = angle * (math.pi / 180)
    a, b = math.cos(rad) * scale, math.sin(rad) * scale
    return np.array([[a, b, 0.0], [-b, a, 0.0]])


def invert_affine(m: np.ndarray) -> np.ndarray:
    """The inverse of a (2, 3) affine map in float64, as ``cv2.warpAffine``
    inverts it (``D = 1 / (m00 m11 - m01 m10)``, 0 for a singular map)."""
    m = [float(v) for v in np.asarray(m, np.float64).reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.array(m).reshape(2, 3)


def invert_3x3(m: np.ndarray) -> np.ndarray:
    """The inverse of a 3x3 float64 matrix by cofactors over the determinant,
    as ``cv::invert`` (DECOMP_LU) takes it for n <= 3; 0 if singular."""
    (a, b, c), (d, e, f), (g, h, i) = np.asarray(m, np.float64).tolist()
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    if det == 0:
        return np.zeros((3, 3))
    r = 1.0 / det
    return np.array([[(e * i - f * h) * r, (c * h - b * i) * r, (b * f - c * e) * r],
                     [(f * g - d * i) * r, (a * i - c * g) * r, (c * d - a * f) * r],
                     [(d * h - e * g) * r, (b * g - a * h) * r, (a * e - b * d) * r]])


# the vector width, in output pixels, of OpenCV's warp kernels in its
# AVX-512 build; the columns past the last full vector of a row take the
# scalar tail's arithmetic. An output width that is a multiple of 16 has no
# tail.
WARP_LANES = 16


def _warp_coords(mi: np.ndarray, width: int, height: int) -> Tuple[np.ndarray, ...]:
    """Source coordinates (float32) of each output pixel under the inverse
    map ``mi`` (rows of 3: x, y and, for a perspective, w), as OpenCV 5's
    kernels compute them: the map in float32; per row ``M_r = y * m1 + m2``
    (two roundings), per pixel ``fma(m0, x, M_r)``; the tail columns
    ``fma(x, m0, y * m1) + m2``. A perspective divides x and y by w."""
    mf = np.asarray(mi, np.float64).astype(f32)
    xs = np.arange(width, dtype=f32)[None, :]
    ys = np.arange(height, dtype=f32)[:, None]
    cut = width - width % WARP_LANES
    out = []
    for m0, m1, m2 in mf:
        row = ((ys * m1).astype(f32) + m2).astype(f32)
        v = _fma32(m0, xs, row)
        if cut < width:
            t = (_fma32(xs[:, cut:], m0, (ys * m1).astype(f32)) + m2).astype(f32)
            v[:, cut:] = t
        out.append(v)
    if len(out) == 3:
        return (out[0] / out[2]).astype(f32), (out[1] / out[2]).astype(f32)
    return out[0], out[1]


def _remap_linear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border: int) -> np.ndarray:
    """Bilinear sampling of a uint8 HWC image at float32 source coordinates,
    in float32 as OpenCV 5's kernels do it: ``ix = floor(sx)``, ``a = sx -
    ix``; ``v0 = fma(a, p01 - p00, p00)``, ``v1`` likewise on the next row,
    ``v = fma(b, v1 - v0, v0)``, rounded half to even. A tap outside the
    image reads ``border``. (Each fma is taken in float64, where the
    product and the sum are exact, and rounded once.)"""
    h, w = img.shape[:2]
    c = img.shape[2]
    ix, iy = np.floor(sx), np.floor(sy)
    ax = (sx - ix).astype(np.float64)[..., None]
    ay = (sy - iy).astype(np.float64)[..., None]
    # two border pixels on each side hold every tap of a clamped coordinate
    pad = np.full((h + 4, w + 4, c), border, np.uint8)
    pad[2:h + 2, 2:w + 2] = img
    flat = pad.reshape(-1, c)
    wp = w + 4
    i00 = (np.clip(iy, -2, h).astype(np.int64) + 2) * wp + np.clip(ix, -2, w).astype(np.int64) + 2

    def lerp(i):  # fma(ax, p1 - p0, p0) of one row's two taps
        p0 = flat[i].astype(np.float64)
        v = flat[i + 1] - p0
        v *= ax
        v += p0
        return v.astype(f32)

    v0 = lerp(i00)
    v = lerp(i00 + wp)
    v -= v0
    v = v.astype(np.float64)
    v *= ay
    v += v0
    return np.clip(np.rint(v.astype(f32)), 0, 255).astype(np.uint8)


def warp_affine(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int], border: int = 114
                ) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize=(width, height), borderValue=(border,)
    * 3)`` at INTER_LINEAR: ``m`` (2, 3) maps the image to the output;
    each output pixel samples the image at the inverse map's point."""
    width, height = dsize
    src = img.reshape(img.shape[0], img.shape[1], -1)
    sx, sy = _warp_coords(invert_affine(m), width, height)
    return _remap_linear(src, sx, sy, border).reshape((height, width) + img.shape[2:])


def warp_perspective(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                     border: int = 114) -> np.ndarray:
    """``cv2.warpPerspective(img, m, dsize=(width, height), borderValue=...)``
    at INTER_LINEAR, ``m`` (3, 3)."""
    width, height = dsize
    src = img.reshape(img.shape[0], img.shape[1], -1)
    sx, sy = _warp_coords(invert_3x3(m), width, height)
    return _remap_linear(src, sx, sy, border).reshape((height, width) + img.shape[2:])


# --- HSV ----------------------------------------------------------------------

HSV_SHIFT = 12


@functools.lru_cache(maxsize=None)
def _hsv_tables():
    """OpenCV's BGR2HSV division tables: ``sdiv[i] = round(255 << 12 / i)``,
    ``hdiv[i] = round(180 << 12 / (6 i))``, both 0 at i = 0."""
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << HSV_SHIFT) / i)]).astype(np.int64)
    hdiv = np.concatenate([[0], np.rint((180 << HSV_SHIFT) / (6.0 * i))]).astype(np.int64)
    return sdiv, hdiv


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on uint8, in OpenCV's
    integer arithmetic: V the max, S ``(diff * sdiv[V] + 2^11) >> 12``, H
    from the max channel's difference times ``hdiv[diff]``, the same
    rounding, wrapped into [0, 180)."""
    sdiv, hdiv = _hsv_tables()
    x = img.astype(np.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * sdiv[v] + (1 << (HSV_SHIFT - 1))) >> HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << (HSV_SHIFT - 1))) >> HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` on uint8, in float32 as
    OpenCV 5 computes it: ``s, v = S / 255, V / 255``, ``h = H * (6 / 180)``
    split into its sector and fraction, the four values ``v``, ``v (1 -
    s)``, ``v (1 - fma(s, h))`` and ``v (1 - fma(s, 1 - h))`` picked by the
    sector, times 255 and truncated. S = 0 gives ``v`` in all three."""
    h = img[..., 0].astype(f32) * f32(6.0 / 180)
    s = img[..., 1].astype(f32) * f32(1.0 / 255)
    v = img[..., 2].astype(f32) * f32(1.0 / 255)
    sector = np.floor(h)
    h = (h - sector).astype(f32)
    one = f32(1)
    s64 = s.astype(np.float64)
    tabs = np.stack([v, v * (one - s), v * (1.0 - s64 * h).astype(f32),
                     v * (1.0 - s64 * (one - h)).astype(f32)], -1)
    out = np.take_along_axis(tabs, _HSV_SECTORS[sector.astype(np.int64) % 6], -1)
    out = np.where((img[..., 1] == 0)[..., None], v[..., None], out)
    return np.clip(np.trunc(out * f32(255)), 0, 255).astype(np.uint8)


# --- filters ------------------------------------------------------------------


def _reflect101(n: int, pad: int) -> np.ndarray:
    """Indices of BORDER_REFLECT_101 for any pad (reflected again past the
    far edge, as ``cv::borderInterpolate`` does)."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(i)
    while ((i < 0) | (i >= n)).any():
        i = np.where(i < 0, -i, np.where(i >= n, 2 * (n - 1) - i, i))
    return i


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(img, (k, k))`` for odd k: the k x k sum over the image
    reflected at its border (BORDER_REFLECT_101) over k^2, rounded (k^2 is
    odd, so there are no ties)."""
    h, w = img.shape[:2]
    p = k // 2
    x = img.reshape(h, w, -1).astype(np.int64)[_reflect101(h, p)][:, _reflect101(w, p)]
    c = np.pad(x, ((1, 0), (1, 0), (0, 0))).cumsum(0).cumsum(1)
    s = c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
    return ((2 * s + k * k) // (2 * k * k)).astype(np.uint8).reshape(img.shape)


def median_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.medianBlur(img, k)``: each channel's k x k median over the
    image with its border pixels repeated (BORDER_REPLICATE)."""
    h, w = img.shape[:2]
    p = k // 2
    x = np.pad(img.reshape(h, w, -1), ((p, p), (p, p), (0, 0)), mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(x, (k, k), axis=(0, 1))
    win = win.reshape(h, w, -1, k * k)
    return np.partition(win, k * k // 2, axis=-1)[..., k * k // 2].reshape(img.shape)


# --- Lab and CLAHE --------------------------------------------------------------

# OpenCV's sRGB <-> XYZ matrices and the D65 white point
SRGB2XYZ = (0.412453, 0.357580, 0.180423, 0.212671, 0.715160, 0.072169,
            0.019334, 0.119193, 0.950227)
XYZ2SRGB = (3.240479, -1.53715, -0.498535, -0.969256, 1.875991, 0.041556,
            0.055648, -0.204043, 1.057311)
D65 = (0.950456, 1.0, 1.088754)
LAB_SHIFT, GAMMA_SHIFT = 12, 3
LAB_SHIFT2 = LAB_SHIFT + GAMMA_SHIFT
LAB_BASE_SHIFT, INV_GAMMA_SHIFT = 14, 12
LAB_BASE = 1 << LAB_BASE_SHIFT
MIN_AB = -8145


def _descale(v, n: int):
    return (v + (1 << (n - 1))) >> n


@functools.lru_cache(maxsize=None)
def _lab_tables():
    """OpenCV's tables of the 8-bit Lab conversions (``initLabTabs``):
    the sRGB gamma (x8), the cube root (x2^15, its argument in double, the
    root rounded to float32), the BGR -> XYZ / white and XYZ * white -> BGR
    coefficients (x2^12), L -> (Y, f(Y)) and f -> X, Z (x2^14), and the
    inverse gamma over 4096 steps (float32)."""
    i = np.arange(256) / 255.0
    gamma = np.where(i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4)
    gtab = np.rint(255.0 * gamma * (1 << GAMMA_SHIFT)).astype(np.int64)
    x = np.arange(256 * 3 // 2 * (1 << GAMMA_SHIFT)) / (255.0 * (1 << GAMMA_SHIFT))
    root = np.cbrt(x).astype(f32).astype(np.float64)
    cbrt = np.rint((1 << LAB_SHIFT2) * np.where(x < 216 / 24389, x * (841 / 108) + 16 / 116, root))
    fwd = np.zeros(9, np.int64)
    inv = np.zeros(9, np.int64)
    for r in range(3):  # BGR order: blue takes the third column
        for c in range(3):
            fwd[r * 3 + 2 - c] = round((1 << LAB_SHIFT) * SRGB2XYZ[r * 3 + c] / D65[r])
            inv[r + (2 - c) * 3] = round((1 << LAB_SHIFT) * XYZ2SRGB[r + c * 3] * D65[r])
    li = np.arange(256, dtype=np.float64)
    ll = li * 100 / 255
    fy = (ll + 16) / 116
    small = li <= 20
    y = np.where(small, np.rint(ll / 903.3 * LAB_BASE), np.rint(LAB_BASE * fy ** 3))
    ify = np.where(small, np.rint(LAB_BASE * (16 / 116 + 7.787 * ll / 903.3)),
                   np.rint(LAB_BASE * fy))
    ab = np.arange(MIN_AB, LAB_BASE * 9 // 4 + MIN_AB)

    def tdiv(a, b):  # C's integer division, toward zero
        return np.sign(a) * (np.abs(a) // b)

    abtab = np.where(ab <= 3390, tdiv(ab * 108, 841) - LAB_BASE * 16 // 116 * 108 // 841,
                     tdiv(tdiv(ab * ab, LAB_BASE) * ab, LAB_BASE))
    xg = np.arange(1 << INV_GAMMA_SHIFT).astype(f32) * (f32(1) / f32(1 << INV_GAMMA_SHIFT))
    p = np.power(xg.astype(np.float64), float(f32(1) / f32(2.4))).astype(f32)
    g = np.where(xg <= f32(0.0031308), xg * f32(12.92), (f32(1.055) * p).astype(f32) - f32(0.055))
    invg = np.rint((f32(255) * g.astype(f32)).astype(f32)).astype(np.int64)
    return (gtab, cbrt.astype(np.int64), fwd, inv, y.astype(np.int64), ify.astype(np.int64),
            abtab, invg)


def bgr_to_lab(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2LAB)`` on uint8 BGR, OpenCV's
    integer path: gamma table, the XYZ sums descaled by 2^12, the cube-root
    table, then L, a and b descaled by 2^15."""
    gtab, cbrt, fwd, *_ = _lab_tables()
    s = img.astype(np.int64)
    b, g, r = gtab[s[..., 0]], gtab[s[..., 1]], gtab[s[..., 2]]
    fx, fy, fz = (cbrt[_descale(b * fwd[k] + g * fwd[k + 1] + r * fwd[k + 2], LAB_SHIFT)]
                  for k in (0, 3, 6))
    lscale = (116 * 255 + 50) // 100
    lshift = -((16 * 255 * (1 << LAB_SHIFT2) + 50) // 100)
    L = _descale(lscale * fy + lshift, LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + 128 * (1 << LAB_SHIFT2), LAB_SHIFT2)
    bb = _descale(200 * (fy - fz) + 128 * (1 << LAB_SHIFT2), LAB_SHIFT2)
    return np.clip(np.stack([L, a, bb], -1), 0, 255).astype(np.uint8)


def lab_to_bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_LAB2BGR)`` on uint8, OpenCV's integer
    path: Y and f(Y) from L's table, f(X) and f(Z) from a and b in fixed
    point, X and Z from their table, BGR as the descaled (2^14) sums clipped
    to the inverse gamma table's 4096 steps."""
    _, _, _, inv, ytab, iftab, abtab, invg = _lab_tables()
    s = img.astype(np.int64)
    y, ify = ytab[s[..., 0]], iftab[s[..., 0]]
    adiv = ((5 * s[..., 1] * 53687 + (1 << 7)) >> 13) - 128 * LAB_BASE // 500
    bdiv = ((s[..., 2] * 41943 + (1 << 4)) >> 9) - 128 * LAB_BASE // 200 + 1
    x, z = abtab[ify + adiv - MIN_AB], abtab[ify - bdiv - MIN_AB]
    shift = LAB_SHIFT + LAB_BASE_SHIFT - INV_GAMMA_SHIFT
    out = [invg[np.clip(_descale(inv[k] * x + inv[k + 1] * y + inv[k + 2] * z, shift),
                        0, (1 << INV_GAMMA_SHIFT) - 1)] for k in (0, 3, 6)]
    return np.stack(out, -1).astype(np.uint8)


def clahe(gray: np.ndarray, clip: float = 4.0, tiles: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """``cv2.createCLAHE(clipLimit=clip, tileGridSize=tiles).apply(gray)`` on
    a uint8 (H, W) image. The image is extended by BORDER_REFLECT_101 to a
    multiple of the tiles when it is not one; each tile's histogram is
    clipped at ``max(int(clip * tile_area / 256), 1)``, the excess spread
    evenly and its remainder one by one at a stride of ``256 // rest``; the
    LUT is the running sum times ``255 / tile_area`` (float32, rounded); the
    pixel blends the four nearest tiles' LUTs bilinearly in float32."""
    h, w = gray.shape
    tx, ty = tiles
    ext = gray
    if w % tx or h % ty:
        rows = np.arange(h + ty - h % ty)
        cols = np.arange(w + tx - w % tx)
        ext = gray[np.where(rows >= h, 2 * (h - 1) - rows, rows)][
            :, np.where(cols >= w, 2 * (w - 1) - cols, cols)]
    tw, th = ext.shape[1] // tx, ext.shape[0] // ty
    area = tw * th
    limit = max(int(clip * area / 256), 1)
    tiles_px = ext[:th * ty, :tw * tx].reshape(ty, th, tx, tw).transpose(0, 2, 1, 3)
    tiles_px = tiles_px.reshape(ty * tx, area).astype(np.int64)
    hist = np.zeros((ty * tx, 256), np.int64)
    np.add.at(hist, (np.arange(ty * tx)[:, None], tiles_px), 1)
    clipped = np.maximum(hist - limit, 0).sum(1)
    hist = np.minimum(hist, limit) + (clipped // 256)[:, None]
    for t, rest in enumerate(clipped % 256):
        if rest:
            hist[t, np.arange(0, 256, max(256 // rest, 1))[:rest]] += 1
    lut = np.rint(hist.cumsum(1).astype(f32) * (f32(255) / f32(area))).clip(0, 255)
    lut = lut.astype(f32).reshape(ty, tx, 256)

    def axis(n, size, count):
        t = (np.arange(n, dtype=f32) * (f32(1) / f32(size)) - f32(0.5)).astype(f32)
        t1 = np.floor(t)
        a = (t - t1).astype(f32)
        t1 = t1.astype(np.int64)
        return np.maximum(t1, 0), np.minimum(t1 + 1, count - 1), a, (f32(1) - a).astype(f32)

    x1, x2, xa, xa1 = axis(w, tw, tx)
    y1, y2, ya, ya1 = axis(h, th, ty)
    v = gray.astype(np.int64)
    r1 = (lut[y1[:, None], x1[None], v] * xa1 + lut[y1[:, None], x2[None], v] * xa).astype(f32)
    r2 = (lut[y2[:, None], x1[None], v] * xa1 + lut[y2[:, None], x2[None], v] * xa).astype(f32)
    res = (r1 * ya1[:, None]).astype(f32) + (r2 * ya[:, None]).astype(f32)
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


# --- INTER_AREA ---------------------------------------------------------------


def _area_taps(src: int, dst: int, scale: float):
    """``computeResizeAreaTab``: per output index the source indices it
    covers and their float32 weights (a partial first and last cell by the
    covered fraction of the cell width)."""
    taps = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            taps.append((d, s1 - 1, f32((s1 - f1) / cell)))
        for s in range(s1, s2):
            taps.append((d, s, f32(1.0 / cell)))
        if f2 - s2 > 1e-3:
            taps.append((d, s2, f32(min(min(f2 - s2, 1.0), cell) / cell)))
    return taps


def resize_area(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)`` of a
    uint8 image to a smaller or equal size. Integer ratios on both axes take
    OpenCV's fast path: the block sum, ``(s + 2) >> 2`` for 2x2 blocks, else
    ``s * (1 / area)`` in float32 rounded half to even. Other ratios take
    the general path: float32 sums over ``_area_taps`` in tap order, each
    source row's horizontal sum weighted into its output row."""
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1)
    sx, sy = 1.0 / (nw / w), 1.0 / (nh / h)
    ix, iy = int(round(sx)), int(round(sy))
    eps = np.finfo(np.float64).eps
    if abs(sx - ix) < eps and abs(sy - iy) < eps:
        s = src[:nh * iy, :nw * ix].reshape(nh, iy, nw, ix, -1).astype(np.int64).sum((1, 3))
        if ix == 2 and iy == 2:
            out = (s + 2) >> 2
        else:
            out = np.rint(s.astype(f32) * f32(1.0 / (ix * iy)))
        return np.clip(out, 0, 255).astype(np.uint8).reshape((nh, nw) + img.shape[2:])
    x = src.astype(f32)
    rows = np.zeros((h, nw, src.shape[2]), f32)
    for d, s, a in _area_taps(w, nw, sx):
        rows[:, d] += x[:, s] * a
    out = np.zeros((nh, nw, src.shape[2]), f32)
    for d, s, b in _area_taps(h, nh, sy):
        out[d] += b * rows[s]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8).reshape((nh, nw) + img.shape[2:])



# --- camera-motion estimation (BOT-SORT's sparseOptFlow) ------------------------
# OpenCV 5.0's CPU kernels as its x86-64 wheel runs them on an AVX-512 CPU: the float filters'
# vector code fuses multiply-adds (FMA) and takes AVX-512 rows of 32 columns
# (``CORNER_ROW_LANES``), with a plain tail; images whose width is a multiple
# of 32 have no tail.

CORNER_ROW_LANES = 32
MAX_CORNERS, QUALITY_LEVEL = 1000, 0.01  # goodFeaturesToTrack as BOT-SORT calls it
LK_WIN, LK_LEVELS, LK_ITERS, LK_EPS, LK_MIN_EIG = 21, 3, 30, 0.01, 1e-4
W_BITS = 14
# estimateAffinePartial2D's RANSAC defaults: reprojection threshold (px),
# iterations, confidence
RANSAC_THRESH, RANSAC_ITERS, RANSAC_CONFIDENCE = 3.0, 2000, 0.99
# its refinement: OpenCV 5's LevMarq with geodesic acceleration, at most
# refineIters = 10 iterations, LevMarq::Settings' defaults otherwise
LM_ITERS, LM_LAMBDA, LM_UP, LM_DOWN = 10, 1e-4, 2.0, 3.0
LM_GEO_STEP, LM_GEO_SCALE = 1e-4, 0.5
LM_STEP_TOL = LM_ENERGY_TOL = LM_GRAD_TOL = 1e-6
LM_MIN_DIAG, LM_MAX = 1e-6, 1e32  # damping clamp; the cap on the damping and lambda
# cv::gemm hands a product to OpenBLAS from 100 rows of A; OpenBLAS sums
# blocks of 128 rows
GEMM_BLAS_ROWS, GEMM_BLAS_BLOCK = 100, 128


def corner_min_eigen_val(gray: np.ndarray) -> np.ndarray:
    """``cv2.cornerMinEigenVal(gray, blockSize=3, ksize=3)`` of a uint8
    image (float32): 3x3 Sobel derivatives scaled by 1 / (4 * 3 * 255) in
    float32 (dx: [-1, 0, 1] across, then [s, 2s, s] down as one fused
    multiply-add on the pair sum; dy: [s, 2s, s] across as a chain of fused
    multiply-adds in the vector columns, plain in the tail, then [-1, 0, 1]
    down), the products summed over 3x3 boxes in float64 (row sums, then a
    running column sum) and rounded to float32, and the smaller eigenvalue
    ``(a + c) - sqrt((a - c)^2 + b^2)`` of the halved sums; reflect-101
    borders throughout."""
    h, w = gray.shape
    s, s2 = f32(1.0 / 3060.0), f32(2.0 / 3060.0)
    ci, ri = _reflect101(w, 1), _reflect101(h, 1)
    p = gray.astype(f32)[ri][:, ci]
    rx = p[:, 2:] - p[:, :-2]
    dx = _fma32(rx[:-2] + rx[2:], s, rx[1:-1] * s2)
    fused = _fma32(p[:, 2:], s, _fma32(p[:, 1:-1], s2, p[:, :-2] * s))
    plain = p[:, :-2] * s + p[:, 1:-1] * s2 + p[:, 2:] * s
    tail = w // CORNER_ROW_LANES * CORNER_ROW_LANES
    ry = np.concatenate([fused[:, :tail], plain[:, tail:]], 1)
    dy = ry[2:] - ry[:-2]
    sums = []
    for prod in (dx * dx, dx * dy, dy * dy):
        q = prod.astype(np.float64)[:, ci]
        rows = ((q[:, :-2] + q[:, 1:-1]) + q[:, 2:])[ri]
        out = np.empty((h, w), f32)
        run = rows[0] + rows[1]
        for y in range(h):
            s0 = run + rows[y + 2]
            out[y] = s0
            run = s0 - rows[y]
        sums.append(out)
    a, b, c = sums[0] * f32(0.5), sums[1], sums[2] * f32(0.5)
    t = a - c
    return (a + c) - np.sqrt(t * t + b * b)


def good_features_to_track(gray: np.ndarray):
    """``cv2.goodFeaturesToTrack(gray, maxCorners=1000, qualityLevel=0.01,
    minDistance=1, blockSize=3)``: (n, 1, 2) float32 corners or None.
    Responses (``corner_min_eigen_val``) at or below ``QUALITY_LEVEL`` of
    the largest (float32) are zeroed; a corner is an inner pixel whose
    response is nonzero and the largest of its 3x3 block; corners are
    sorted by response, descending, ties by position, the later pixel in
    raster order first (OpenCV's comparator); the first ``MAX_CORNERS``
    are kept. The grid check at minDistance 1 drops no corner (two pixels
    are never closer than 1), so there is none."""
    e = corner_min_eigen_val(gray)
    h, w = e.shape
    e = np.where(e > f32(float(e.max()) * QUALITY_LEVEL), e, f32(0))
    inner = e[1:-1, 1:-1]
    local_max = np.max([e[1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]
                        for dy in (-1, 0, 1) for dx in (-1, 0, 1)], 0)
    ys, xs = np.nonzero((inner != 0) & (inner == local_max))
    if not len(ys):
        return None
    ys, xs = ys + 1, xs + 1
    order = np.lexsort((-(ys * w + xs), -e[ys, xs]))[:MAX_CORNERS]
    return np.stack([xs[order], ys[order]], 1).astype(f32).reshape(-1, 1, 2)


def pyr_down(img: np.ndarray) -> np.ndarray:
    """``cv2.pyrDown`` of a one-channel uint8 image: the 5x5 kernel
    [1 4 6 4 1]^2 over the image reflected at its border, (sum + 128) >> 8,
    every second pixel."""
    h, w = img.shape
    dh, dw = (h + 1) // 2, (w + 1) // 2
    p = img.astype(np.int32)[_reflect101(h, 2)][:, _reflect101(w, 2)]
    c = [p[:, 2 * np.arange(dw) + k] for k in range(5)]
    row = c[0] + c[4] + (c[1] + c[3]) * 4 + c[2] * 6
    r = [row[2 * np.arange(dh) + k] for k in range(5)]
    return ((r[0] + r[4] + (r[1] + r[3]) * 4 + r[2] * 6 + 128) >> 8).astype(np.uint8)


def scharr_deriv(img: np.ndarray):
    """The LK tracker's int16 Scharr derivatives (OpenCV's ``calcSharrDeriv``,
    unscaled): ``(Ix, Iy)`` int32 arrays, reflect-101 borders."""
    h, w = img.shape
    p = img.astype(np.int32)[_reflect101(h, 1)]
    t0 = ((p[:-2] + p[2:]) * 3 + p[1:-1] * 10)[:, _reflect101(w, 1)]
    t1 = (p[2:] - p[:-2])[:, _reflect101(w, 1)]
    return t0[:, 2:] - t0[:, :-2], (t1[:, 2:] + t1[:, :-2]) * 3 + t1[:, 1:-1] * 10


def _lk_pyramid(img: np.ndarray) -> list:
    """``cv::buildOpticalFlowPyramid`` at the LK defaults: level 0 and
    ``pyr_down``s of it, stopping at a level whose next would be no wider
    or taller than the window."""
    levels = [img]
    for _ in range(LK_LEVELS):
        h, w = levels[-1].shape
        if (w + 1) // 2 <= LK_WIN or (h + 1) // 2 <= LK_WIN:
            break
        levels.append(pyr_down(levels[-1]))
    return levels


def _bilinear_weights(frac: np.ndarray):
    """The four 14-bit bilinear weights of ``(a, b)`` rows, as OpenCV's LK
    rounds them (float32 products, half to even; the fourth takes the rest),
    shaped to broadcast over (n, win, win) windows."""
    a, b = frac[:, 0], frac[:, 1]
    one, scale = f32(1), f32(1 << W_BITS)
    w00 = np.rint((one - a) * (one - b) * scale).astype(np.int32)
    w01 = np.rint(a * (one - b) * scale).astype(np.int32)
    w10 = np.rint((one - a) * b * scale).astype(np.int32)
    w11 = (1 << W_BITS) - w00 - w01 - w10
    return [x[:, None, None] for x in (w00, w01, w10, w11)]


def _window(padded: np.ndarray, corner: np.ndarray, weights, shift: int) -> np.ndarray:
    """(n, win, win) int32 windows of ``padded`` (the level padded by the
    window on each side, int32) at integer top-left ``corner`` (n, 2) x, y,
    interpolated in fixed point: the weighted four neighbours + 2^(shift -
    1), >> shift. One gather of the (win + 1)^2 patch serves the four."""
    stride = padded.shape[1]
    k = np.arange(LK_WIN + 1)
    at = (((corner[:, 1, None] + LK_WIN + k) * stride)[:, :, None]
          + (corner[:, 0, None] + LK_WIN + k)[:, None, :])
    q = padded.reshape(-1).take(at)
    w00, w01, w10, w11 = weights
    v = (q[:, :-1, :-1] * w00 + q[:, :-1, 1:] * w01 + q[:, 1:, :-1] * w10
         + q[:, 1:, 1:] * w11)
    return (v + (1 << (shift - 1))) >> shift


# OpenCV's LK adds its window products in float32, in 128-bit SIMD lanes: the
# columns up to the last whole vector step (LK_VEC_COLS) in lanes, the rest in a
# scalar tail, each accumulator row after row; np.cumsum adds in that order
LK_VEC_COLS = 16


def _in_order(values: np.ndarray) -> np.ndarray:
    """Float32 sums over the last axis, added one value after another."""
    return np.cumsum(values, axis=-1, dtype=f32)[..., -1]


def _window_tail(prod: np.ndarray) -> np.ndarray:
    """The scalar tail: each window's products past ``LK_VEC_COLS``,
    rounded to float32 one by one, added row by row."""
    return _in_order(prod[:, :, LK_VEC_COLS:].reshape(len(prod), -1).astype(f32))


def _window_gram(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The gradient matrix's sums over each (win, win) window of ``a * b``
    as OpenCV adds them: 8 pixels a step, each product rounded to float32
    and added into one 4-lane accumulator (the step's first 4 pixels, then
    its last 4), the lanes reduced as (0 + 2) + (1 + 3) and added to the
    tail."""
    prod = a.astype(np.int64) * b
    n = len(prod)
    vec = prod[:, :, :LK_VEC_COLS].astype(f32).reshape(n, LK_WIN, -1, 4)  # (n, y, step-half, lane)
    lanes = _in_order(vec.transpose(0, 3, 1, 2).reshape(n, 4, -1))
    return _window_tail(prod) + ((lanes[:, 0] + lanes[:, 2]) + (lanes[:, 1] + lanes[:, 3]))


def _window_mismatch(diff: np.ndarray, grad: np.ndarray) -> np.ndarray:
    """The mismatch vector's sums over each window of ``diff * grad`` as
    OpenCV adds them: 8 pixels a step, pixels k and k + 4 of a step paired
    in exact int32 dot products, each rounded to float32 into two
    accumulators of two lanes (pairs 0 and 1, pairs 2 and 3), those added
    lane by lane and then the two lanes, and added to the tail."""
    prod = diff.astype(np.int64) * grad
    n = len(prod)
    vec = prod[:, :, :LK_VEC_COLS].reshape(n, LK_WIN, -1, 8)
    pairs = (vec[..., :4] + vec[..., 4:]).astype(f32)  # (n, y, step, pair)
    lanes = _in_order(pairs.transpose(0, 3, 1, 2).reshape(n, 4, -1))
    both = lanes[:, :2] + lanes[:, 2:]
    return _window_tail(prod) + (both[:, 0] + both[:, 1])


def calc_optical_flow_pyr_lk(prev: np.ndarray, nxt: np.ndarray, pts: np.ndarray):
    """``cv2.calcOpticalFlowPyrLK(prev, nxt, pts, None)`` at its defaults
    (21x21 window, maxLevel 3, (COUNT | EPS, 30, 0.01), minEigThreshold
    1e-4) on one-channel uint8 images: ``(next_pts (n, 1, 2) float32,
    status (n, 1) uint8)``. OpenCV's fixed point is kept: the pyramids
    (``pyr_down``, reflect-101 padding by the window), the int16 Scharr
    derivatives padded with zeros, 14-bit bilinear weights, the window at
    5 extra bits; the window sums in float32 in OpenCV's SIMD order
    (``_window_gram``, ``_window_mismatch``), the Newton steps in float32,
    the stop at a squared
    step of 0.01^2 or on an oscillation (then half the step back). Status 0
    for a point whose window leaves the image or whose gradient matrix's
    smaller eigenvalue is under the threshold at level 0."""
    prev_levels, next_levels = _lk_pyramid(prev), _lk_pyramid(nxt)
    top = min(len(prev_levels), len(next_levels)) - 1
    start = np.asarray(pts, f32).reshape(-1, 2)
    n = len(start)
    status = np.ones(n, bool)
    out = np.zeros((n, 2), f32)
    half, fscale = f32((LK_WIN - 1) * 0.5), f32(1.0 / (1 << 20))

    def outside(corner, h, w):
        return ((corner[:, 0] < -LK_WIN) | (corner[:, 0] >= w) | (corner[:, 1] < -LK_WIN)
                | (corner[:, 1] >= h))

    for level in range(top, -1, -1):
        img, nimg = prev_levels[level], next_levels[level]
        h, w = img.shape
        ri, ci = _reflect101(h, LK_WIN), _reflect101(w, LK_WIN)
        ipad = img.astype(np.int32)[ri][:, ci]
        jpad = nimg.astype(np.int32)[ri][:, ci]
        ix, iy = scharr_deriv(img)
        dpad = [np.pad(d, LK_WIN) for d in (ix, iy)]
        prev_pt = start * f32(1.0 / (1 << level))
        guess = prev_pt.copy() if level == top else out * f32(2)
        out = guess.copy()
        pt = prev_pt - half
        corner = np.floor(pt).astype(np.int64)
        bad = outside(corner, h, w)
        if level == 0:
            status &= ~bad
        idx = np.nonzero(~bad)[0]
        if not len(idx):
            continue
        weights = _bilinear_weights(pt[idx] - corner[idx].astype(f32))
        iwin = _window(ipad, corner[idx], weights, W_BITS - 5)
        gx = _window(dpad[0], corner[idx], weights, W_BITS)
        gy = _window(dpad[1], corner[idx], weights, W_BITS)
        a11 = _window_gram(gx, gx) * fscale
        a12 = _window_gram(gx, gy) * fscale
        a22 = _window_gram(gy, gy) * fscale
        det = a11 * a22 - a12 * a12
        t = a11 - a22
        min_eig = ((a22 + a11) - np.sqrt(t * t + f32(4) * a12 * a12)) / f32(2 * LK_WIN * LK_WIN)
        ok = ~((min_eig < f32(LK_MIN_EIG)) | (det < np.finfo(f32).eps))
        if level == 0:
            status[idx[~ok]] = False
        idx, iwin, gx, gy = idx[ok], iwin[ok], gx[ok], gy[ok]
        a11, a12, a22 = a11[ok], a12[ok], a22[ok]
        inv = f32(1) / det[ok]
        cur = guess[idx] - half
        last = np.zeros_like(cur)
        live = np.ones(len(idx), bool)
        for j in range(LK_ITERS):
            act = np.nonzero(live)[0]
            corner = np.floor(cur[act]).astype(np.int64)
            gone = outside(corner, h, w)
            if level == 0:
                status[idx[act[gone]]] = False
            live[act[gone]] = False
            act, corner = act[~gone], corner[~gone]
            if not len(act):
                break
            weights = _bilinear_weights(cur[act] - corner.astype(f32))
            diff = _window(jpad, corner, weights, W_BITS - 5) - iwin[act]
            b1 = _window_mismatch(diff, gx[act]) * fscale
            b2 = _window_mismatch(diff, gy[act]) * fscale
            delta = np.stack([(a12[act] * b2 - a22[act] * b1) * inv[act],
                              (a12[act] * b1 - a11[act] * b2) * inv[act]], 1)
            cur[act] = cur[act] + delta
            out[idx[act]] = cur[act] + half
            small = (delta.astype(np.float64) ** 2).sum(1) <= LK_EPS * LK_EPS
            back = np.zeros(len(act), bool)
            if j > 0:
                swing = np.abs(delta + last[act])
                back = ~small & (swing[:, 0] < LK_EPS) & (swing[:, 1] < LK_EPS)
                out[idx[act[back]]] -= delta[back] * f32(0.5)
            live[act[small | back]] = False
            last[act] = delta
        if level == 0:
            end = np.floor(out[idx] - half).astype(np.int64)
            status[idx[outside(end, h, w)]] = False
    return out.reshape(-1, 1, 2), status.astype(np.uint8).reshape(-1, 1)


class CvRNG:
    """OpenCV's ``cv::RNG`` as RANSAC seeds it (``RNG((uint64)-1)``): a
    64-bit multiply-with-carry state, ``next`` = the low 32 bits after
    ``state = low32 * 4164903690 + high32``; ``uniform(a, b)`` = ``next %
    (b - a) + a``."""

    def __init__(self):
        self.state = (1 << 64) - 1

    def next(self) -> int:
        s = self.state
        self.state = ((s & 0xFFFFFFFF) * 4164903690 + (s >> 32)) & 0xFFFFFFFFFFFFFFFF
        return self.state & 0xFFFFFFFF

    def uniform(self, a: int, b: int) -> int:
        return a if a == b else self.next() % (b - a) + a


def _similarity_of_pair(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """OpenCV's two-point similarity (AffinePartial2DEstimatorCallback::
    runKernel), float64 (2, 3), same operation order."""
    x1, y1, x2, y2 = (float(v) for v in src.reshape(-1))
    X1, Y1, X2, Y2 = (float(v) for v in dst.reshape(-1))
    dd = (x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2)
    d = 1.0 / dd if dd else math.inf
    s0 = d * ((X1 - X2) * (x1 - x2) + (Y1 - Y2) * (y1 - y2))
    s1 = d * ((Y1 - Y2) * (x1 - x2) - (X1 - X2) * (y1 - y2))
    s2 = d * ((Y1 - Y2) * (x1 * y2 - x2 * y1) - (X1 * y2 - X2 * y1) * (y1 - y2)
              - (X1 * x2 - X2 * x1) * (x1 - x2))
    s3 = d * (-(X1 - X2) * (x1 * y2 - x2 * y1) - (Y1 * x2 - Y2 * x1) * (x1 - x2)
              - (Y1 * y2 - Y2 * y1) * (y1 - y2))
    return np.array([[s0, -s1, s2], [s1, s0, s3]])


def _ransac_iters(confidence: float, outlier_share: float, max_iters: int) -> int:
    """``cv::RANSACUpdateNumIters`` for 2-point models."""
    num = math.log(max(1.0 - confidence, 2.2250738585072014e-308))
    denom = 1.0 - (1.0 - outlier_share) ** 2
    if denom < 2.2250738585072014e-308:
        return 0
    denom = math.log(denom)
    if denom >= 0 or -num >= max_iters * (-denom):
        return max_iters
    return int(np.rint(num / denom))


def _fma64(a: float, b: float, c: float) -> float:
    """``fma(a, b, c)`` in float64, rounded once."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _jt_times(jac: np.ndarray, r: np.ndarray) -> np.ndarray:
    """``cv::gemm(J, r, 1, noArray(), 0, out, GEMM_1_T)``, J^T r, added as
    cv2 5.0's wheel adds it. Under ``GEMM_BLAS_ROWS`` rows, OpenCV's loop:
    four running sums over the rows by index mod 4 (the rows past the last
    whole four into the first), then added in order. From there, OpenBLAS:
    blocks of ``GEMM_BLAS_BLOCK`` rows, each summed in order and added to the
    result in turn, the last 129-255 rows split in two (the first a multiple
    of 4 near half)."""
    prod = jac * r[:, None]
    n = len(r)
    if n < GEMM_BLAS_ROWS:
        m = n - n % 4
        lanes = np.zeros((4, jac.shape[1]))
        if m:
            lanes = np.cumsum(prod[:m].reshape(-1, 4, jac.shape[1]), axis=0)[-1]
        first = lanes[0]
        for row in prod[m:]:
            first = first + row
        return ((first + lanes[1]) + lanes[2]) + lanes[3]
    out = np.zeros(jac.shape[1])
    k = 0
    while k < n:
        left = n - k
        size = (min(left, GEMM_BLAS_BLOCK) if left >= 2 * GEMM_BLAS_BLOCK or left <= GEMM_BLAS_BLOCK
                else (left // 2 + 3) // 4 * 4)
        out = out + np.cumsum(prod[k:k + size], axis=0)[-1]
        k += size
    return out


def _cv_hypot(a: float, b: float) -> float:
    """OpenCV's own ``hypot`` in its Jacobi SVD."""
    a, b = abs(a), abs(b)
    if a > b:
        b /= a
        return a * math.sqrt(1 + b * b)
    if b > 0:
        a /= b
        return b * math.sqrt(1 + a * a)
    return 0.0


def _solve_svd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``cv::solve(a, b, x, DECOMP_SVD)`` for a small square float64 ``a``:
    OpenCV's one-sided Jacobi SVD of a^T (``JacobiSVDImpl_``: rotations of
    row pairs until none is needed, sums in order, its ``hypot``; the rows
    sorted by singular value and normalized) and its back-substitution
    (``SVBkSb``, singular values under 2 eps of their sum skipped)."""
    at = [[float(v) for v in row] for row in np.asarray(a, np.float64).T]
    n = len(at)
    eps, tiny = np.finfo(np.float64).eps, np.finfo(np.float64).tiny

    def sum_sq(row):
        sd = 0.0
        for t in row:
            sd += t * t
        return sd

    w = [sum_sq(row) for row in at]
    vt = [[float(i == k) for k in range(n)] for i in range(n)]
    for _ in range(max(n, 30)):
        changed = False
        for i in range(n - 1):
            for j in range(i + 1, n):
                ai, aj = at[i], at[j]
                p = 0.0
                for x, y in zip(ai, aj):
                    p += x * y
                if abs(p) <= 10 * eps * math.sqrt(w[i] * w[j]):
                    continue
                p *= 2
                beta = w[i] - w[j]
                gamma = _cv_hypot(p, beta)
                if beta < 0:
                    s = math.sqrt((gamma - beta) * 0.5 / gamma)
                    c = p / (gamma * s * 2)
                else:
                    c = math.sqrt((gamma + beta) / (gamma * 2))
                    s = p / (gamma * c * 2)
                for row_i, row_j in ((ai, aj), (vt[i], vt[j])):
                    for k in range(n):
                        row_i[k], row_j[k] = row_i[k] * c + row_j[k] * s, row_j[k] * c - row_i[k] * s
                w[i], w[j] = sum_sq(ai), sum_sq(aj)
                changed = True
        if not changed:
            break
    w = [math.sqrt(sum_sq(row)) for row in at]
    for i in range(n - 1):
        j = i
        for k in range(i + 1, n):
            if w[j] < w[k]:
                j = k
        w[i], w[j] = w[j], w[i]
        at[i], at[j] = at[j], at[i]
        vt[i], vt[j] = vt[j], vt[i]
    rhs = [float(v) for v in np.asarray(b, np.float64).reshape(-1)]
    threshold = 0.0
    for wi in w:
        threshold += wi
    threshold *= 2 * eps
    x = [0.0] * n
    for i in range(n):
        if abs(w[i]) <= threshold:
            continue
        norm = 1 / w[i] if w[i] > tiny else 0.0
        proj = 0.0
        for uk, bk in zip(at[i], rhs):
            proj += (uk * norm) * bk
        proj *= 1 / w[i]
        for k in range(n):
            x[k] = x[k] + proj * vt[i][k]
    return np.array(x)


def _refine_similarity(src: np.ndarray, dst: np.ndarray, model: np.ndarray) -> np.ndarray:
    """estimateAffinePartial2D's refinement of a similarity (a, b, tx, ty) on
    its inliers, as OpenCV 5's ``LevMarq`` runs it with its dense backend:
    residuals (a x - b y + tx - x', b x + a y + ty - y') in float64, J^T J
    summed in order, J^T r by ``_jt_times``, the energy |r|^2; each
    iteration damps the diagonal d of J^T J to d + clamp(lambda d), solves by
    ``_solve_svd``, adds the geodesic acceleration (the residual at
    ``LM_GEO_STEP`` along the step, in J^T form, with the fused multiply-adds
    of ``scaleAdd`` and ``addWeighted``) when it is under the step's size,
    and keeps the step if the energy did not rise: lambda then shrinks by the
    step's quality (at most ``LM_DOWN`` fold), else grows by a factor that
    doubles. It stops after ``LM_ITERS`` iterations, or on a gradient, a
    step or a relative energy change under its tolerance."""
    s = np.asarray(src, np.float64)
    d = np.asarray(dst, np.float64)
    k = len(s)
    jac = np.zeros((2 * k, 4))
    jac[0::2] = np.stack([s[:, 0], -s[:, 1], np.ones(k), np.zeros(k)], 1)
    jac[1::2] = np.stack([s[:, 1], s[:, 0], np.zeros(k), np.ones(k)], 1)
    jtj = np.cumsum(jac[:, :, None] * jac[:, None, :], axis=0)[-1]
    diag = np.diag(jtj).copy()

    def residual(p):
        a, b, tx, ty = p
        return np.stack([a * s[:, 0] - b * s[:, 1] + tx - d[:, 0],
                         b * s[:, 0] + a * s[:, 1] + ty - d[:, 1]], 1).reshape(-1)

    x = np.array([model[0, 0], model[1, 0], model[0, 2], model[1, 2]])
    r = residual(x)
    energy = np.cumsum(r * r)[-1]
    lam, up = LM_LAMBDA, LM_UP
    h = LM_GEO_STEP
    scale = 1.0 * (1.0 / (h * h))
    moved = True
    for _ in range(LM_ITERS):
        if moved:
            jtb = _jt_times(jac, r)
            grad = np.abs(jtb).max()
        lm_diag = np.minimum(np.maximum(diag * lam, LM_MIN_DIAG), LM_MAX)
        damped = jtj.copy()
        damped[np.diag_indices(4)] = lm_diag + diag
        v = _solve_svd(damped, -jtb)
        pv = v * (jtb - lm_diag * v)
        predicted = ((pv[0] + pv[1]) + pv[2]) + pv[3]
        step_norm = np.cumsum(v * v)[-1]
        jtb_geo = _jt_times(jac, residual(x + v * h))
        part = [_fma64(jtb[i], h - 1.0, jtb_geo[i]) for i in range(4)]
        lmv = (h * lm_diag) * v
        accel = _solve_svd(damped, -np.array([_fma64(part[i], scale, lmv[i] * scale)
                                              for i in range(4)]))
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            if np.sqrt((accel @ accel) / (v @ v)) < 1.0:
                v = np.array([_fma64(accel[i], LM_GEO_SCALE, v[i]) for i in range(4)])
            xn = x + v
            rn = residual(xn)
            en = np.cumsum(rn * rn)[-1]
            drop = energy - en
            moved = not drop < 0
            if moved:
                rho = drop / (predicted * -0.5)
                shrink = 1.0 - np.power(rho + rho - 1.0, 3.0)
                lam = (shrink if shrink > 1.0 / LM_DOWN else 1.0 / LM_DOWN) * lam
                x, r, energy, up = xn, rn, en, LM_UP
                if (LM_GRAD_TOL > grad or LM_STEP_TOL > step_norm
                        or LM_ENERGY_TOL > drop / en):
                    break
            else:
                lam, up = lam * up, up + up
        if not lam < LM_MAX:
            break
    a, b, tx, ty = x
    return np.array([[a, -b, tx], [b, a, ty]])


def estimate_affine_partial_2d(src: np.ndarray, dst: np.ndarray):
    """``cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)`` at its
    defaults: ``(M (2, 3) float64 or None, inliers (n, 1) uint8)``.

    RANSAC as OpenCV runs it: ``CvRNG`` seeded with 2^64 - 1 draws two
    distinct points (the second redrawn while equal to the first), their
    similarity (``_similarity_of_pair``) scores the points by float32
    squared reprojection error against ``RANSAC_THRESH``^2, a model with more
    inliers than the best so far (and at least 2) wins and shrinks the
    iteration count (``_ransac_iters``). The winner is then refined on its
    inliers by OpenCV 5's Levenberg-Marquardt (``_refine_similarity``)."""
    src = np.asarray(src, f32).reshape(-1, 2)
    dst = np.asarray(dst, f32).reshape(-1, 2)
    n = len(src)
    if n < 2:
        return None, np.zeros((n, 1), np.uint8)
    if n == 2:
        return _similarity_of_pair(src, dst), np.ones((2, 1), np.uint8)
    rng = CvRNG()
    limit, best_count, best, best_mask = RANSAC_ITERS, 0, None, None
    thr = f32(RANSAC_THRESH * RANSAC_THRESH)
    it = 0
    while it < limit:
        i0 = rng.uniform(0, n)
        i1 = rng.uniform(0, n)
        while i1 == i0:
            i1 = rng.uniform(0, n)
        m = _similarity_of_pair(src[[i0, i1]], dst[[i0, i1]])
        F = m.reshape(-1).astype(f32)
        with np.errstate(all="ignore"):
            ex = F[0] * src[:, 0] + F[1] * src[:, 1] + F[2] - dst[:, 0]
            ey = F[3] * src[:, 0] + F[4] * src[:, 1] + F[5] - dst[:, 1]
            mask = ex * ex + ey * ey <= thr
        count = int(mask.sum())
        if count > max(best_count, 1):
            best_count, best, best_mask = count, m, mask
            limit = _ransac_iters(RANSAC_CONFIDENCE, (n - count) / n, limit)
        it += 1
    if best is None:
        return None, np.zeros((n, 1), np.uint8)
    return (_refine_similarity(src[best_mask], dst[best_mask], best),
            best_mask.astype(np.uint8).reshape(-1, 1))
