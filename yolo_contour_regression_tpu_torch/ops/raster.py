"""Polygon rasterization: contour -> binary mask, by two rules.

- ``fill_polygons``: the even-odd rule of the JAX package's ``ops/raster.py``
  and, for the kernel, ``ops/pallas_raster.py``. Pixels are sampled at
  integer coordinates; each invalid vertex collapses onto the previous valid
  one (zero-length edges add no crossings, so the fill equals the polygon
  over the valid vertices); a polygon with no valid vertex gives an empty
  mask. The validator's ``polygon_mask_iou`` and the segment_ori loss use
  this rule.
- ``fill_polygons_cv2``: the rule of the JAX facade's ``Results.masks``
  (``engine/results.py:contours_to_masks_host``), which is
  ``cv2.fillPoly(mask, [round(valid_points * 8)], 1, shift=3)`` with
  LINE_8, reproduced without cv2; fewer than 3 valid vertices give an empty
  mask. See ``fill_polygons_cv2_plain`` for the rule itself.

Each entry takes its plain PyTorch version for CPU tensors and launches its
hand-written kernel in ``csrc/raster.cu`` for CUDA tensors, or raises. The
kernels compact the valid vertices themselves; the plain versions are their
oracles.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build

# the kernels keep a polygon's vertices and a row's crossings per warp in
# shared memory; above 48 KB the launch opts in to more
MAX_VERTICES = 1024
MAX_GRID_Y = 65535

# cv2.fillPoly's fixed point: the facade's vertices carry SUBPIXEL_SHIFT
# fraction bits; OpenCV's edges carry XY_SHIFT
SUBPIXEL_SHIFT = 3
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_FAR = 1 << 62  # sorts after every crossing


def collapse_invalid_vertices(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Replace each invalid vertex with the nearest preceding valid vertex.

    points (..., V, 2), valid (..., V) bool. Invalid vertices before the first
    valid one wrap to the last valid vertex (circular). log2(V) doubling
    steps on a doubled ring, as the JAX version does.
    """
    V = points.shape[-2]
    dev = points.device
    idx = torch.arange(V, device=dev).expand(valid.shape)
    ar2 = torch.arange(2 * V, device=dev)
    ring_valid = torch.cat([valid, valid], dim=-1)
    ring_idx = torch.where(ring_valid, ar2.expand(ring_valid.shape), -1)
    step = 1
    while step < 2 * V:
        shifted = torch.roll(ring_idx, step, dims=-1)
        ring_idx = torch.where((ring_idx < 0) & (ar2 >= step), shifted, ring_idx)
        step *= 2
    tail = ring_idx[..., V:]
    src = torch.where(tail >= 0, tail, idx) % V
    return torch.gather(points, -2, src[..., None].expand(points.shape))


# elements of the (polygons, edges, rows, columns) crossing tests that
# ``_fill_rows`` takes at once
FILL_BLOCK_ELEMS = 1 << 24


def _fill_rows(pts: torch.Tensor, rows: torch.Tensor, width: int) -> torch.Tensor:
    """Even-odd fill of collapsed polygons pts (N, V, 2) sampled at the rows
    ``rows`` (R,) (float, the points' dtype) and columns 0..width-1 ->
    (N, R, width) bool. Each edge's span test and crossing ``xi`` per row
    are computed for all edges at once; the crossings left of each pixel
    are then counted in blocks of edges, a pixel being inside where the
    count is odd."""
    N, V = pts.shape[:2]
    px = torch.arange(width, dtype=pts.dtype, device=pts.device)
    x0, y0 = pts[..., 0, None], pts[..., 1, None]  # (N, V, 1)
    x1, y1 = torch.roll(x0, -1, dims=1), torch.roll(y0, -1, dims=1)
    cond = (y0 > rows) != (y1 > rows)  # (N, V, R)
    t = (rows - y0) / torch.where(y1 == y0, torch.ones_like(y0), y1 - y0)
    xi = x0 + t * (x1 - x0)  # (N, V, R)
    inside = torch.zeros((N, rows.shape[0], width), dtype=torch.bool, device=pts.device)
    step = max(1, FILL_BLOCK_ELEMS // max(N * rows.shape[0] * width, 1))
    for e0 in range(0, V, step):
        cross = cond[:, e0:e0 + step, :, None] & (px < xi[:, e0:e0 + step, :, None])
        # a uint8 count wraps at 256, which keeps its parity
        inside ^= cross[:, 0] if step == 1 else (cross.sum(1, dtype=torch.uint8) & 1).bool()
    return inside


def fill_polygon(points: torch.Tensor, valid: torch.Tensor, height: int, width: int):
    """One polygon: points (V, 2), valid (V,) -> (height, width) bool."""
    return fill_polygons_plain(points[None], valid[None], height, width)[0]


def fill_polygons_plain(points: torch.Tensor, valid: torch.Tensor, height: int, width: int):
    """The plain PyTorch version: points (N, V, 2), valid (N, V) ->
    (N, height, width) bool. The oracle of the even-odd kernel."""
    pts = collapse_invalid_vertices(points, valid)
    rows = torch.arange(height, dtype=points.dtype, device=points.device)
    return _fill_rows(pts, rows, width) & valid.any(-1)[:, None, None]


def polygon_mask_iou_plain(pts_a: torch.Tensor, valid_a: torch.Tensor, pts_b: torch.Tensor,
                           valid_b: torch.Tensor, height: int, width: int, block: int = 32,
                           eps: float = 1e-7) -> torch.Tensor:
    """The plain PyTorch version of ``polygon_mask_iou``, as the JAX package
    streams it: rows in blocks of ``block`` (rows past ``height`` masked),
    each block of both sets filled by the even-odd rule, and the
    intersections and areas summed in float32. The sums are pixel counts
    below 2^24, exact in any order, so this is the kernel path's oracle."""
    pa = collapse_invalid_vertices(pts_a, valid_a)
    pb = collapse_invalid_vertices(pts_b, valid_b)
    ok_a = valid_a.any(-1)[:, None, None]
    ok_b = valid_b.any(-1)[:, None, None]
    block = min(block, height)
    f = torch.float32
    inter = torch.zeros((pts_a.shape[0], pts_b.shape[0]), dtype=f, device=pts_a.device)
    aa = torch.zeros(pts_a.shape[0], dtype=f, device=pts_a.device)
    ab = torch.zeros(pts_b.shape[0], dtype=f, device=pts_a.device)
    for r0 in range(0, height, block):
        py = torch.arange(r0, r0 + block, device=pts_a.device).to(pts_a.dtype)
        row_ok = (py < height)[None, :, None]
        ma = (_fill_rows(pa, py, width) & row_ok & ok_a).to(f)
        mb = (_fill_rows(pb, py, width) & row_ok & ok_b).to(f)
        inter = inter + torch.einsum("nrw,mrw->nm", ma, mb)
        aa = aa + ma.sum((1, 2))
        ab = ab + mb.sum((1, 2))
    return inter / (aa[:, None] + ab[None, :] - inter + eps)


# --- cv2.fillPoly's rule ------------------------------------------------------


def _clip_lines(width: int, height: int, x1, y1, x2, y2):
    """OpenCV's ``clipLine`` on int64 tensors, elementwise: each segment cut
    to the image [0, width-1] x [0, height-1], the intercepts truncated from
    double as OpenCV truncates them. Returns (inside, x1, y1, x2, y2); a
    segment wholly outside comes back unchanged with inside False."""
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0).long() + (x > right).long() * 2 + (y < 0).long() * 4 + (y > bottom).long() * 8

    def step(num, a, b):  # (int64)((double)num * a / b)
        b = torch.where(b == 0, torch.ones_like(b), b)
        return torch.trunc(num.double() * a.double() / b.double()).long()

    c1, c2 = code(x1, y1), code(x2, y2)
    go = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    s = go & ((c1 & 12) != 0)
    a = torch.where(c1 < 8, 0, bottom)
    x1 = torch.where(s, x1 + step(a - y1, x2 - x1, y2 - y1), x1)
    y1 = torch.where(s, a, y1)
    c1 = torch.where(s, (x1 < 0).long() + (x1 > right).long() * 2, c1)
    s = go & ((c2 & 12) != 0)
    a = torch.where(c2 < 8, 0, bottom)
    x2 = torch.where(s, x2 + step(a - y2, x2 - x1, y2 - y1), x2)
    y2 = torch.where(s, a, y2)
    c2 = torch.where(s, (x2 < 0).long() + (x2 > right).long() * 2, c2)
    go = go & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    s = go & (c1 != 0)
    a = torch.where(c1 == 1, 0, right)
    y1 = torch.where(s, y1 + step(a - x1, y2 - y1, x2 - x1), y1)
    x1 = torch.where(s, a, x1)
    c1 = torch.where(s, 0, c1)
    s = go & (c2 != 0)
    a = torch.where(c2 == 1, 0, right)
    y2 = torch.where(s, y2 + step(a - x2, y2 - y1, x2 - x1), y2)
    x2 = torch.where(s, a, x2)
    c2 = torch.where(s, 0, c2)
    return (c1 | c2) == 0, x1, y1, x2, y2


def _cv2_edges(points: torch.Tensor, valid: torch.Tensor, height: int, width: int):
    """The edges of each polygon over its valid vertices, in OpenCV's fixed
    point: edge i runs from valid vertex i-1 (cyclic) to valid vertex i.
    Returns ``live`` (N, V), the outline endpoints (t0x, t0y, t1x, t1y) and
    the fill edges (y0, y1, x, dx), all int64 (N, V)."""
    n, v = valid.shape
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    pts = torch.gather(points, 1, order[..., None].expand(n, v, 2))
    cnt = valid.sum(-1, keepdim=True)
    idx = torch.arange(v, device=points.device).expand(n, v)
    prev = torch.where(idx == 0, cnt - 1, idx - 1).clamp_min(0)
    q1 = torch.round(pts * (1 << SUBPIXEL_SHIFT)).long()
    q0 = torch.gather(q1, 1, prev[..., None].expand(n, v, 2))
    live = (idx < cnt) & (cnt >= 3)
    half = 1 << (SUBPIXEL_SHIFT - 1)
    X0, X1 = q0[..., 0] << (XY_SHIFT - SUBPIXEL_SHIFT), q1[..., 0] << (XY_SHIFT - SUBPIXEL_SHIFT)
    Y0, Y1 = (q0[..., 1] + half) >> SUBPIXEL_SHIFT, (q1[..., 1] + half) >> SUBPIXEL_SHIFT
    t0x, t1x = (X0 + XY_ONE // 2) >> XY_SHIFT, (X1 + XY_ONE // 2) >> XY_SHIFT
    # an edge whose rounded outline leaves the image takes its x from the
    # clipped outline's integer endpoints, and its y from them too unless
    # they coincide (OpenCV's CollectPolyEdges)
    out = ((t0x < 0) | (t0x >= width) | (t1x < 0) | (t1x >= width)
           | (Y0 < 0) | (Y0 >= height) | (Y1 < 0) | (Y1 >= height))
    _, u0x, u0y, u1x, u1y = _clip_lines(width, height, t0x, Y0, t1x, Y1)
    cx0, cx1 = torch.where(out, u0x << XY_SHIFT, X0), torch.where(out, u1x << XY_SHIFT, X1)
    apart = out & (u0y != u1y)
    cy0, cy1 = torch.where(apart, u0y, Y0), torch.where(apart, u1y, Y1)
    den = cy1 - cy0
    dx = torch.div(cx1 - cx0, torch.where(den == 0, torch.ones_like(den), den),
                   rounding_mode="trunc")
    down = Y0 < Y1
    y0, y1 = torch.where(down, Y0, Y1), torch.where(down, Y1, Y0)
    x = torch.where(down, cx0 + (Y0 - cy0) * dx, cx1 + (Y1 - cy1) * dx)
    return live, (t0x, Y0, t1x, Y1), (y0, y1, x, dx)


def _cv2_outlines(out: torch.Tensor, live, t0x, t0y, t1x, t1y):
    """OR each live edge's outline into ``out`` (N, H, W): OpenCV's 8-connected
    ``LineIterator`` from (t0x, t0y) to (t1x, t1y), clipped to the image and
    run left to right. Its pixel k (major axis) steps the minor axis
    ceil((2 minor k - major) / (2 major)) times, the closed form of its
    error term."""
    n, h, w = out.shape
    ok, x1, y1, x2, y2 = _clip_lines(w, h, t0x, t0y, t1x, t1y)
    flip = x2 < x1
    x1, x2 = torch.where(flip, x2, x1), torch.where(flip, x1, x2)
    y1, y2 = torch.where(flip, y2, y1), torch.where(flip, y1, y2)
    ddx, ddy = x2 - x1, y2 - y1
    sy = torch.where(ddy < 0, -1, 1)
    vert = ddy.abs() > ddx
    major = torch.where(vert, ddy.abs(), ddx)
    minor = torch.where(vert, ddx, ddy.abs())
    draw = live & ok
    if not bool(draw.any()):
        return out
    k = torch.arange(int(major[draw].max()) + 1, device=out.device)
    major, minor = major[..., None], minor[..., None]
    m = torch.div(2 * minor * k + major - 1, (2 * major).clamp_min(1), rounding_mode="floor")
    m = torch.where(major == 0, 0, m)
    x = torch.where(vert[..., None], x1[..., None] + m, x1[..., None] + k)
    y = torch.where(vert[..., None], y1[..., None] + sy[..., None] * k,
                    y1[..., None] + sy[..., None] * m)
    on = draw[..., None] & (k <= major)
    poly = torch.arange(n, device=out.device)[:, None, None].expand_as(x)
    out.view(-1)[((poly * h + y) * w + x)[on]] = True
    return out


def fill_polygons_cv2_plain(points: torch.Tensor, valid: torch.Tensor, height: int,
                            width: int) -> torch.Tensor:
    """The plain PyTorch version of the facade's rule: points (N, V, 2) f32,
    valid (N, V) bool -> (N, height, width) bool. The oracle of the cv2
    kernel.

    For each polygon with at least 3 valid vertices, as ``cv2.fillPoly``
    draws ``round(valid_points * 8)`` at ``shift=3`` with LINE_8 (OpenCV's
    ``CollectPolyEdges`` and ``FillEdgeCollection``):
    - vertices in fixed point: ``X = x8 << 13``, ``Y = (y8 + 4) >> 3``;
    - an edge with Y0 != Y1 spans rows Y in [y0, y1) of its upper and lower
      ends, with ``dx = trunc((X1 - X0) / (Y1 - Y0))`` and x at its upper
      end; on row y its x is ``x + (y - y0) * dx``. An edge whose outline
      leaves the image takes X and dx from the clipped outline
      (``_cv2_edges``);
    - on each row the xs sorted and paired fill the columns
      ``(a + 0xFFFF) >> 16`` through ``b >> 16``, clipped to the image;
    - every edge's outline is drawn too (``_cv2_outlines``)."""
    n, v = valid.shape
    out = torch.zeros((n, height, width), dtype=torch.bool, device=points.device)
    if n == 0 or v == 0:
        return out
    live, ends, (y0, y1, x, dx) = _cv2_edges(points, valid, height, width)
    rows = torch.arange(height, device=points.device)[None, :, None]
    act = (live & (y0 != y1))[:, None, :] & (y0[:, None, :] <= rows) & (rows < y1[:, None, :])
    xs = torch.where(act, x[:, None, :] + (rows - y0[:, None, :]) * dx[:, None, :], _FAR)
    xs = xs.sort(-1).values[..., : v - v % 2]  # (N, H, 2k): the active count is even
    lo = (xs[..., 0::2] + (XY_ONE - 1)) >> XY_SHIFT
    hi = xs[..., 1::2] >> XY_SHIFT
    px = torch.arange(width, device=points.device)
    for k in range(lo.shape[-1]):
        if not bool((lo[..., k] < width).any()):
            break
        out |= (lo[..., k, None] <= px) & (px <= hi[..., k, None])
    return _cv2_outlines(out, live, *ends)


# --- the kernels --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _raster_lib():
    lib = cuda_build.load("raster")
    for name in ("raster_fill_polygons", "raster_fill_polygons_cv2"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.raster_tile_rows.argtypes = []
    lib.raster_tile_rows.restype = ctypes.c_int
    return lib


def _check(points: torch.Tensor, valid: torch.Tensor, height: int, width: int, tile_rows: int):
    if points.dim() != 3 or points.shape[-1] != 2:
        raise ValueError(f"points must be (N, V, 2), got {tuple(points.shape)}")
    if points.dtype != torch.float32:
        raise TypeError(f"points must be float32, got {points.dtype}")
    if valid.dtype != torch.bool or tuple(valid.shape) != tuple(points.shape[:2]):
        raise ValueError(
            f"valid must be bool (N, V) = {tuple(points.shape[:2])}, "
            f"got {valid.dtype} {tuple(valid.shape)}"
        )
    if valid.device != points.device:
        raise ValueError(f"points on {points.device} but valid on {valid.device}")
    if not (points.is_contiguous() and valid.is_contiguous()):
        raise ValueError("points and valid must be contiguous")
    n, v = points.shape[:2]
    if not 1 <= v <= MAX_VERTICES:
        raise ValueError(f"V must be in [1, {MAX_VERTICES}], got {v}")
    if height <= 0 or width <= 0 or height * width >= 2**31:
        raise ValueError(f"bad mask size {height}x{width}")
    if n >= 2**31 or (height + tile_rows - 1) // tile_rows > MAX_GRID_Y:
        raise ValueError(f"grid too large for N={n}, H={height}")


def _launch(wrapper, entry: str, plain, points, valid, height: int, width: int):
    """CPU tensors take ``plain``; CUDA tensors launch the C entry ``entry``
    of ``csrc/raster.cu`` on the current stream and count it in
    ``wrapper.launches``; any other device raises."""
    height, width = int(height), int(width)
    if points.device.type == "cpu":
        return plain(points, valid, height, width)
    if points.device.type != "cuda":
        raise ValueError(f"the polygon fill runs on cpu or cuda, not {points.device}")
    lib = _raster_lib()
    _check(points, valid, height, width, lib.raster_tile_rows())
    n, v = points.shape[:2]
    out = torch.empty((n, height, width), dtype=torch.bool, device=points.device)
    if n == 0:
        return out
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = getattr(lib, entry)(points.data_ptr(), valid.data_ptr(), out.data_ptr(), n, v,
                                  height, width, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def fill_polygons(points: torch.Tensor, valid: torch.Tensor, height: int, width: int):
    """Even-odd batch fill: points (N, V, 2) f32 pixel coords, valid (N, V)
    bool -> (N, height, width) bool masks, on the tensors' device.

    CPU tensors take ``fill_polygons_plain``; CUDA tensors launch the
    even-odd kernel of ``csrc/raster.cu`` (one launch, the collapse of
    invalid vertices folded in) on the current stream, and count it in
    ``fill_polygons.launches``. Any other device raises.
    """
    return _launch(fill_polygons, "raster_fill_polygons", fill_polygons_plain, points, valid,
                   height, width)


def fill_polygons_cv2(points: torch.Tensor, valid: torch.Tensor, height: int, width: int):
    """The facade's fill, ``cv2.fillPoly`` at ``shift=3`` (see
    ``fill_polygons_cv2_plain``): points (N, V, 2) f32, valid (N, V) bool ->
    (N, height, width) bool masks, on the tensors' device.

    CPU tensors take ``fill_polygons_cv2_plain``; CUDA tensors launch the
    cv2 entry of ``csrc/raster.cu`` on the current stream (the scanline
    fill, then the outlines) and count the call in
    ``fill_polygons_cv2.launches``. Any other device raises.
    """
    return _launch(fill_polygons_cv2, "raster_fill_polygons_cv2", fill_polygons_cv2_plain, points,
                   valid, height, width)


fill_polygons.launches = 0
fill_polygons_cv2.launches = 0

# elements of the 0/1 float32 blocks that ``polygon_mask_iou`` widens at
# once (64 MB)
IOU_BLOCK_ELEMS = 1 << 24


def mask_products(ma: torch.Tensor, mb: torch.Tensor):
    """Masks ma (N, H, W) and mb (M, H, W) bool -> (inter (N, M), area_a
    (N,), area_b (M,)), float32 pixel counts, exact below 2^24 in any order
    of the sums. The masks are widened to float32 in row blocks of at most
    ``IOU_BLOCK_ELEMS`` elements, each block cast once from its strided
    slice; a row of ones under A's block gives B's areas from the same
    product."""
    n, m, h, w = ma.shape[0], mb.shape[0], ma.shape[1], ma.shape[2]
    f = torch.float32
    rows = max(1, min(h, IOU_BLOCK_ELEMS // ((n + m + 1) * w)))
    acc = torch.zeros((n + 1, m), dtype=f, device=ma.device)
    area_a = torch.zeros(n, dtype=f, device=ma.device)
    ones = torch.ones((1, rows * w), dtype=f, device=ma.device)
    for r0 in range(0, h, rows):
        a = ma[:, r0:r0 + rows].to(f).reshape(n, -1)
        b = mb[:, r0:r0 + rows].to(f).reshape(m, -1)
        area_a += a.sum(1)
        acc += torch.cat([a, ones[:, :a.shape[1]]]) @ b.T
    return acc[:n], area_a, acc[n]


def polygon_mask_iou(pts_a: torch.Tensor, valid_a: torch.Tensor, pts_b: torch.Tensor,
                     valid_b: torch.Tensor, height: int, width: int,
                     eps: float = 1e-7) -> torch.Tensor:
    """Pairwise mask IoU of polygon sets A (N, Va, 2) / (N, Va) and B
    (M, Vb, 2) / (M, Vb) filled by the even-odd rule on a (height, width)
    grid (pixels at integer rows and columns; each invalid vertex collapsed
    onto the previous valid one; a set with no valid vertex has area 0) ->
    (N, M) float32, ``inter / (area_a + area_b - inter + eps)``.

    CPU tensors take ``polygon_mask_iou_plain``. CUDA tensors fill both sets
    with ``fill_polygons`` (the even-odd kernel, two launches counted in
    ``fill_polygons.launches``), then take the intersections and areas as a
    product of the 0/1 masks widened to float32 in row blocks
    (``mask_products``). The counts are exact in float32 (and in TF32), so
    the result equals the plain version's. The masks of one call are
    (N + M) * height * width bytes; a caller with many images calls once per
    image. Any other device raises.
    """
    height, width = int(height), int(width)
    if pts_a.device.type == "cpu":
        return polygon_mask_iou_plain(pts_a, valid_a, pts_b, valid_b, height, width, eps=eps)
    if pts_a.device.type != "cuda":
        raise ValueError(f"polygon_mask_iou runs on cpu or cuda, not {pts_a.device}")
    ma = fill_polygons(pts_a.contiguous(), valid_a.contiguous(), height, width)
    mb = fill_polygons(pts_b.contiguous(), valid_b.contiguous(), height, width)
    n, m = ma.shape[0], mb.shape[0]
    if not (n and m):
        return torch.zeros((n, m), dtype=torch.float32, device=ma.device)
    inter, aa, ab = mask_products(ma, mb)
    return inter / (aa[:, None] + ab[None, :] - inter + eps)
