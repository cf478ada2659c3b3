"""GT polar rays for the assigner (counterpart of the JAX package's
``ops/pallas_polar.py``).

Two entry points, each with a plain PyTorch version beside it:

- ``gt_rays_rows_fast(contour_rows (R, 360, 2), centers (R, K, 2), valid
  (R, K)) -> (R, K, 36)``: the assigner's form, where the K candidate
  anchors of one GT row share its contour (counterpart of
  ``gt_rays_rows_fast`` and the kernel ``gt_rays_pallas3``). Plain version:
  ``gt_rays_rows_plain``.
- ``gt_rays_fast(contour (P, 360, 2), center (P, 2)) -> (P, 36)``: one
  contour per pair (counterpart of ``gt_rays_fast`` and the kernels
  ``gt_rays_pallas2`` and ``gt_rays_pallas``). Plain version:
  ``gt_rays_pairs_plain``.

For CPU tensors a wrapper takes the plain version; for CUDA tensors it
launches the kernel of ``csrc/gt_rays.cu`` on the current stream, or raises,
and counts the launch in its ``launches`` attribute. The ray math is
``ops/polar.py:_gt_rays_dense``.

Invalid pairs. The rows form writes ``RAY_EPS`` on every ray of a pair with
``valid == False`` and does no work for it, per pair; the plain version does
the same. The JAX versions differ there, and only there: its TPU kernel
computes an invalid pair when another pair of its 8-pair block is valid and
writes ``RAY_EPS`` otherwise, and its CPU route computes every pair. No value
at an invalid pair reaches the loss: the assigner multiplies the overlaps by
the pair's validity and adds the rays of winning (hence valid) pairs only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build
from .polar import NUM_CONTOUR_POINTS, NUM_RAYS, RAY_EPS, gt_rays_from_contour

MAX_GRID_Y = 65535


def gt_rays_pairs_plain(contour: torch.Tensor, center: torch.Tensor):
    """The plain version of the per-pair form: (P, 360, 2), (P, 2) -> (P, 36)."""
    return gt_rays_from_contour(contour, center)


def gt_rays_rows_plain(contour_rows: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor):
    """The plain version of the rows form: (R, 360, 2), (R, K, 2), (R, K) ->
    (R, K, 36); the valid pairs only are computed, the others are RAY_EPS."""
    R, K = centers.shape[:2]
    out = torch.full((R, K, NUM_RAYS), RAY_EPS, dtype=torch.float32, device=centers.device)
    r_idx, k_idx = valid.nonzero(as_tuple=True)
    if r_idx.numel():
        out[r_idx, k_idx] = gt_rays_from_contour(contour_rows[r_idx], centers[r_idx, k_idx])
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("gt_rays")
    lib.gt_rays_rows.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.gt_rays_rows.restype = ctypes.c_int
    lib.gt_rays_pairs.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    lib.gt_rays_pairs.restype = ctypes.c_int
    lib.gt_rays_max_warps.argtypes = []
    lib.gt_rays_max_warps.restype = ctypes.c_int
    return lib


def _device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"GT rays run on cpu or cuda, not {dev}")
    return dev


def _check_contours(contour: torch.Tensor, rows: int):
    if contour.dtype != torch.float32:
        raise TypeError(f"contours must be float32, got {contour.dtype}")
    if tuple(contour.shape) != (rows, NUM_CONTOUR_POINTS, 2):
        raise ValueError(f"contours must be ({rows}, {NUM_CONTOUR_POINTS}, 2), "
                         f"got {tuple(contour.shape)}")
    if contour.data_ptr() % 8:  # the kernel reads each point as one float2
        raise ValueError("contours must be 8-byte aligned")


def _launch(fn, out: torch.Tensor, *args):
    with torch.cuda.device(out.device):
        err = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"GT-ray kernel launch failed: CUDA error {err}")


def gt_rays_rows_fast(contour_rows: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor):
    """Row-shared GT rays: contour_rows (R, 360, 2) f32, centers (R, K, 2)
    f32, valid (R, K) bool -> (R, K, 36) f32, on the inputs' device."""
    if _device(contour_rows, centers, valid).type == "cpu":
        return gt_rays_rows_plain(contour_rows, centers, valid)
    if centers.dim() != 3 or centers.shape[-1] != 2:
        raise ValueError(f"centers must be (R, K, 2), got {tuple(centers.shape)}")
    if centers.dtype != torch.float32:
        raise TypeError(f"centers must be float32, got {centers.dtype}")
    R, K = centers.shape[:2]
    _check_contours(contour_rows, R)
    if valid.dtype != torch.bool or tuple(valid.shape) != (R, K):
        raise ValueError(f"valid must be bool ({R}, {K}), got {valid.dtype} {tuple(valid.shape)}")
    if not (contour_rows.is_contiguous() and centers.is_contiguous() and valid.is_contiguous()):
        raise ValueError("contour_rows, centers and valid must be contiguous")
    lib = _lib()
    # a block takes gt_rays_max_warps() (8) pairs of a row: ceil(K / 8) blocks a row
    if R >= 2**31 or R * K >= 2**31 or -(-K // lib.gt_rays_max_warps()) > MAX_GRID_Y:
        raise ValueError(f"grid too large for R={R}, K={K}")
    out = torch.empty((R, K, NUM_RAYS), dtype=torch.float32, device=centers.device)
    if R * K == 0:
        return out
    _launch(lib.gt_rays_rows, out, contour_rows.data_ptr(), centers.data_ptr(),
            valid.data_ptr(), out.data_ptr(), R, K)
    gt_rays_rows_fast.launches += 1
    return out


def gt_rays_fast(contour: torch.Tensor, center: torch.Tensor):
    """Per-pair GT rays: contour (P, 360, 2) f32, center (P, 2) f32 ->
    (P, 36) f32, on the inputs' device."""
    if _device(contour, center).type == "cpu":
        return gt_rays_pairs_plain(contour, center)
    if center.dim() != 2 or center.shape[-1] != 2:
        raise ValueError(f"center must be (P, 2), got {tuple(center.shape)}")
    if center.dtype != torch.float32:
        raise TypeError(f"center must be float32, got {center.dtype}")
    P = center.shape[0]
    _check_contours(contour, P)
    if not (contour.is_contiguous() and center.is_contiguous()):
        raise ValueError("contour and center must be contiguous")
    if P >= 2**31:
        raise ValueError(f"grid too large for P={P}")
    out = torch.empty((P, NUM_RAYS), dtype=torch.float32, device=center.device)
    if P == 0:
        return out
    _launch(_lib().gt_rays_pairs, out, contour.data_ptr(), center.data_ptr(), out.data_ptr(), P)
    gt_rays_fast.launches += 1
    return out


gt_rays_rows_fast.launches = 0
gt_rays_fast.launches = 0
