"""Polygon rasterization: contour -> binary mask by the even-odd rule
(counterpart of the JAX package's ``ops/raster.py`` and, for the kernel,
``ops/pallas_raster.py``).

``fill_polygons`` is the entry point. For CPU tensors it takes the plain
PyTorch version ``fill_polygons_plain``; for CUDA tensors it launches the
hand-written kernel in ``csrc/raster.cu`` or raises. Both sample pixels at
integer coordinates and collapse each invalid vertex onto the previous valid
one (zero-length edges add no crossings, so the fill equals the polygon over
the valid vertices); a polygon with no valid vertex gives an empty mask.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build

MAX_VERTICES = 6144  # 2 * V floats of shared memory stay within 48 KB
MAX_GRID_Y = 65535


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


def _fill_rows(pts: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Even-odd fill of collapsed polygons pts (N, V, 2) at rows 0..height-1
    and columns 0..width-1 -> (N, height, width) bool."""
    N, V = pts.shape[:2]
    py = torch.arange(height, dtype=pts.dtype, device=pts.device)[None, :, None]  # (1, H, 1)
    px = torch.arange(width, dtype=pts.dtype, device=pts.device)[None, None, :]  # (1, 1, W)
    x0, y0 = pts[..., 0], pts[..., 1]
    x1, y1 = torch.roll(x0, -1, dims=-1), torch.roll(y0, -1, dims=-1)
    inside = torch.zeros((N, height, width), dtype=torch.bool, device=pts.device)
    for e in range(V):
        ex0, ey0 = x0[:, e, None, None], y0[:, e, None, None]
        ex1, ey1 = x1[:, e, None, None], y1[:, e, None, None]
        cond = (ey0 > py) != (ey1 > py)  # (N, H, 1)
        t = (py - ey0) / torch.where(ey1 == ey0, torch.ones_like(ey0), ey1 - ey0)
        xi = ex0 + t * (ex1 - ex0)  # (N, H, 1)
        inside ^= cond & (px < xi)
    return inside


def fill_polygon(points: torch.Tensor, valid: torch.Tensor, height: int, width: int):
    """One polygon: points (V, 2), valid (V,) -> (height, width) bool."""
    return fill_polygons_plain(points[None], valid[None], height, width)[0]


def fill_polygons_plain(points: torch.Tensor, valid: torch.Tensor, height: int, width: int):
    """The plain PyTorch version: points (N, V, 2), valid (N, V) ->
    (N, height, width) bool. The oracle of the CUDA kernel."""
    pts = collapse_invalid_vertices(points, valid)
    return _fill_rows(pts, height, width) & valid.any(-1)[:, None, None]


@functools.lru_cache(maxsize=None)
def _raster_lib():
    lib = cuda_build.load("raster")
    fn = lib.raster_fill_polygons
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


def fill_polygons(points: torch.Tensor, valid: torch.Tensor, height: int, width: int):
    """Batch fill: points (N, V, 2) f32 pixel coords, valid (N, V) bool ->
    (N, height, width) bool masks, on the tensors' device.

    CPU tensors take ``fill_polygons_plain``; CUDA tensors launch the kernel
    of ``csrc/raster.cu`` on the current stream, and count the launch in
    ``fill_polygons.launches``. Any other device raises.
    """
    height, width = int(height), int(width)
    if points.device.type == "cpu":
        return fill_polygons_plain(points, valid, height, width)
    if points.device.type != "cuda":
        raise ValueError(f"fill_polygons runs on cpu or cuda, not {points.device}")
    lib = _raster_lib()
    _check(points, valid, height, width, lib.raster_tile_rows())
    n, v = points.shape[:2]
    out = torch.empty((n, height, width), dtype=torch.bool, device=points.device)
    if n == 0:
        return out
    pts = collapse_invalid_vertices(points, valid).contiguous()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.raster_fill_polygons(
            pts.data_ptr(), valid.data_ptr(), out.data_ptr(), n, v, height, width, stream
        )
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: CUDA error {err}")
    fill_polygons.launches += 1
    return out


fill_polygons.launches = 0
