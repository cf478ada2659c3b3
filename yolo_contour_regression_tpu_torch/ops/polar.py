"""Polar contour geometry used at predict time (counterpart of the JAX
package's ``ops/polar.py``).

36 rays at 10 degree spacing, angles from the +x axis in the y-down image
frame. Rays are clamped to ``RAY_EPS``; a decoded ray is visible when it is
longer than ``VALID_RAY_THRESH`` pixels.
"""
from __future__ import annotations

import math

import torch

NUM_RAYS = 36
RAY_STEP_DEG = 360 // NUM_RAYS  # 10 degrees
NUM_CONTOUR_POINTS = 360
ANGLE_TOPK = 4  # nearest-angle contour points kept per ray bin
ANGLE_GAP_DEG = 3.0  # min-angle-gap cutoff: beyond this the ray is invisible
RAY_EPS = 1e-6  # invisible-ray sentinel / clamp
VALID_RAY_THRESH = 1.0  # decode-time visibility threshold


def ray_angles(dtype=torch.float32, device=None) -> torch.Tensor:
    """(36,) ray angles in radians: 0, 10deg, ..., 350deg."""
    return torch.arange(0, 360, RAY_STEP_DEG, dtype=dtype, device=device) * (math.pi / 180.0)


def ray_cos_sin(dtype=torch.float32, device=None):
    a = ray_angles(dtype, device)
    return torch.cos(a), torch.sin(a)


def make_anchors(feat_hw, strides, grid_cell_offset=0.5, dtype=torch.float32, device=None):
    """Anchor centers in grid units + per-anchor stride.

    feat_hw: list of (h, w) per FPN level; strides: list of ints. Returns
    anchor_points (A, 2) xy in grid units and stride_tensor (A, 1), flattened
    row-major (y then x) level by level.
    """
    points, stride_t = [], []
    for (h, w), s in zip(feat_hw, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=dtype, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        stride_t.append(torch.full((h * w, 1), float(s), dtype=dtype, device=device))
    return torch.cat(points, 0), torch.cat(stride_t, 0)


def _ray_xy(rays, anchor_points_px):
    rays = rays.clamp_min(RAY_EPS)
    cos, sin = ray_cos_sin(rays.dtype, rays.device)
    segx = rays * cos + anchor_points_px[..., 0:1]  # (..., A, 36)
    segy = rays * sin + anchor_points_px[..., 1:2]
    return rays, segx, segy


def _minmax_box(segx, segy):
    return torch.stack(
        [segx.amin(-1), segy.amin(-1), segx.amax(-1), segy.amax(-1)], dim=-1
    )


def decode_rays(rays, anchor_points_px):
    """Rays -> contour points, validity and enclosing box.

    rays: (..., A, 36) distances in pixels; anchor_points_px: (..., A, 2).
    Returns (points (..., A, 36, 2), valid (..., A, 36) bool, boxes (..., A, 4)
    xyxy over all 36 points, visible or not).
    """
    rays, segx, segy = _ray_xy(rays, anchor_points_px)
    valid = rays > VALID_RAY_THRESH
    return torch.stack([segx, segy], dim=-1), valid, _minmax_box(segx, segy)


def decode_ray_boxes(rays, anchor_points_px):
    """Boxes only from rays: the same math as ``decode_rays`` without the
    points tensor."""
    _, segx, segy = _ray_xy(rays, anchor_points_px)
    return _minmax_box(segx, segy)
