"""Polar contour geometry (counterpart of the JAX package's
``ops/polar.py``).

36 rays at 10 degree spacing, angles from the +x axis in the y-down image
frame. Rays are clamped to ``RAY_EPS``; a decoded ray is visible when it is
longer than ``VALID_RAY_THRESH`` pixels.

GT rays from a 360-point contour about an anchor: per ray angle take the 4
contour points nearest in circular angle, and the largest distance among
them; if even the nearest point is more than 3 degrees away the ray is
invisible (``RAY_EPS``). ``_gt_rays_dense`` spells this out op by op in f32;
it is the plain version of the CUDA kernel in ``csrc/gt_rays.cu``
(wrappers in ``ops/gt_rays.py``).
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


def _clip_min(x, eps: float):
    """max(x, eps) with jnp.clip's gradient: half to each side at equality
    (``torch.clamp_min`` passes all of it)."""
    return torch.maximum(x, x.new_full((), eps))


def point_angles_deg(points, center):
    """Angle in [0, 360) degrees of each point about center (y-down frame).

    points (..., N, 2), center (..., 2) -> (..., N).
    """
    v = points - center[..., None, :]
    ang = torch.atan2(v[..., 1], v[..., 0]) * (180.0 / math.pi)
    return torch.where(ang < 0, ang + 360.0, ang)


def _gt_rays_dense(contour, center):
    """Angle binning for a batch of (contour, center) pairs, op by op in f32:
    contour (..., 360, 2), center (..., 2) -> rays (..., 36).

    The 4 nearest points are taken by a stable sort, lowest index first on
    ties, as ``lax.top_k`` takes them in the JAX version.
    """
    ang = point_angles_deg(contour, center)  # (..., 360)
    theta = torch.arange(0, 360, RAY_STEP_DEG, dtype=ang.dtype, device=ang.device)
    diff = (ang[..., None, :] - theta[:, None]).abs()  # (..., 36, 360)
    diff = torch.where(diff > 180.0, 360.0 - diff, diff)
    top, idx = torch.sort(diff, dim=-1, stable=True)
    min_gap = top[..., 0]
    idx = idx[..., :ANGLE_TOPK]
    v = contour - center[..., None, :]
    dist = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])  # (..., 360)
    dist_k = torch.gather(dist[..., None, :].expand(diff.shape), -1, idx)  # (..., 36, 4)
    rays = torch.where(min_gap[..., None] > ANGLE_GAP_DEG, RAY_EPS, dist_k).amax(-1)
    return rays.clamp_min(RAY_EPS)


def gt_rays_from_contour(contour, center, chunk: int = 4096):
    """GT rays, memory-bounded: contour (P, 360, 2), center (P, 2) ->
    (P, 36), in slabs of ``chunk`` pairs so the (chunk, 36, 360) angle
    differences are the peak intermediate."""
    if contour.shape[0] <= chunk:
        return _gt_rays_dense(contour, center)
    return torch.cat([_gt_rays_dense(contour[i : i + chunk], center[i : i + chunk])
                      for i in range(0, contour.shape[0], chunk)])


def polar_mask_iou(rays_a, rays_b, eps: float = RAY_EPS):
    """sum(min) / sum(max) over the rays: (..., 36) x (..., 36) -> (...,);
    the min is clamped to ``eps`` first."""
    mx = torch.maximum(rays_a, rays_b)
    mn = _clip_min(torch.minimum(rays_a, rays_b), eps)
    return mn.sum(-1) / mx.sum(-1)


def polar_centerness(rays, eps: float = 0.0):
    """sqrt(min / max) of the GT rays."""
    return torch.sqrt(rays.amin(-1) / (rays.amax(-1) + eps))


def mask_iou_loss(pred_rays, target_rays, weight, norm, eps: float = RAY_EPS):
    """Polar IoU loss: log(sum(max) / sum(min)) * weight, summed / norm.
    pred_rays/target_rays (..., 36), weight (...,) zero outside fg."""
    mx = torch.maximum(pred_rays, target_rays)
    mn = _clip_min(torch.minimum(pred_rays, target_rays), eps)
    per = torch.log(mx.sum(-1) / mn.sum(-1))
    return (per * weight).sum() / norm
