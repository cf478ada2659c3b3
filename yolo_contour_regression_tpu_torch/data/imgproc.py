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
    i = np.abs(np.arange(-pad, n + pad))
    return np.where(i >= n, 2 * (n - 1) - i, i)


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

