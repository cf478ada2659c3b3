"""Box geometry used at predict time (counterpart of the JAX package's
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
