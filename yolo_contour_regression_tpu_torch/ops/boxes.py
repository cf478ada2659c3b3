"""Box geometry of the predict and val paths (counterpart of the JAX package's
``ops/boxes.py``). Vectorized over any leading dims."""
from __future__ import annotations

import torch

EPS = 1e-7


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) center-xywh -> corner-xyxy."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], dim=-1)


def box_area(box: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> area."""
    return (box[..., 2] - box[..., 0]).clamp_min(0) * (box[..., 3] - box[..., 1]).clamp_min(0)


def box_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Pairwise IoU. box1 (..., N, 4), box2 (..., M, 4) xyxy -> (..., N, M)."""
    a = box1[..., :, None, :]
    b = box2[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(box1)[..., :, None] + box_area(box2)[..., None, :] - inter
    return inter / (union + eps)


def scale_boxes(boxes: torch.Tensor, ratio_pad: torch.Tensor, ori_shape: torch.Tensor
                ) -> torch.Tensor:
    """Inverse letterbox: xyxy boxes (..., M, 4) in letterbox pixels -> the
    image's own frame, clipped to it. ratio_pad (..., 3) = (gain, pad_x,
    pad_y), ori_shape (..., 2) = (h0, w0), float32, over the same leading
    dims."""
    gain = ratio_pad[..., 0][..., None, None]
    pad = ratio_pad[..., 1:3]
    pad4 = torch.cat([pad, pad], -1)[..., None, :]
    out = (boxes - pad4) / gain
    wh0 = ori_shape.flip(-1)
    lim = torch.cat([wh0, wh0], -1)[..., None, :]
    return torch.minimum(out.clamp_min(0.0), lim)


def scale_coords(coords: torch.Tensor, ratio_pad: torch.Tensor) -> torch.Tensor:
    """Inverse letterbox of point sets (..., P, 2), not clipped: a contour's
    vertices may lie off the image. ratio_pad (..., 3) broadcasts over the
    leading dims of ``coords`` (a (B, 3) batch pairs with (B, N, P, 2))."""
    extra = coords.dim() - ratio_pad.dim() - 1
    lead = ratio_pad.shape[:-1]
    gain = ratio_pad[..., 0].reshape(lead + (1,) * (extra + 2))
    pad = ratio_pad[..., 1:3].reshape(lead + (1,) * (extra + 1) + (2,))
    return (coords - pad) / gain
