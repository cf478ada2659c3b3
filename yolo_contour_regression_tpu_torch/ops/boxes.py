"""Box geometry (counterpart of the JAX package's ``ops/boxes.py``):
conversions, IoU and the CIoU of the detect loss and assigner, the DFL
distance maps, and the letterbox inverses. Vectorized over any leading
dims."""
from __future__ import annotations

import math

import torch

EPS = 1e-7


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) center-xywh -> corner-xyxy."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner-xyxy -> center-xywh."""
    tl, br = x[..., :2], x[..., 2:4]
    return torch.cat([(tl + br) * 0.5, br - tl], dim=-1)


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


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, GIoU: bool = False,
             DIoU: bool = False, CIoU: bool = False, eps: float = EPS) -> torch.Tensor:
    """Elementwise IoU, GIoU, DIoU or CIoU of broadcastable (..., 4) boxes ->
    (...,). CIoU's ``alpha`` is a constant of the gradient (computed on
    detached terms), as the JAX version stops its gradient."""
    if xywh:
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1
    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp_min(0)
             * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp_min(0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (GIoU or DIoU or CIoU):
        return iou
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)  # enclosing width
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    if GIoU:
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    c2 = cw ** 2 + ch ** 2 + eps  # enclosing diagonal squared
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    if DIoU:
        return iou - rho2 / c2
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True,
              dim: int = -1) -> torch.Tensor:
    """ltrb distances + anchor points -> xywh (or xyxy) boxes."""
    lt, rb = distance.chunk(2, dim)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim)
    return torch.cat([x1y1, x2y2], dim)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max) -> torch.Tensor:
    """xyxy boxes -> ltrb distances from the anchor points, clipped to
    [0, reg_max - 0.01] (the loss passes ``reg_max - 1``: 14.99 at 16 bins)."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1).clamp(0, reg_max - 0.01)


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
