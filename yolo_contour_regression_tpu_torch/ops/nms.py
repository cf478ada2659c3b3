"""Batched fixed-shape NMS in plain PyTorch (counterpart of the JAX
package's ``ops/nms.py``; there is no torchvision here).

Per image: best class per anchor (or, for val, every class above the gate:
``multi_label``), confidence gate, top-``pre_nms`` candidates, class-offset
boxes (``MAX_WH`` trick), then exact greedy suppression solved as a
fixpoint over the (k, k) IoU matrix, and the top ``max_det`` survivors,
padded, with a ``valid`` mask. Rankings use a stable descending sort, so
ties go to the lower index as ``lax.top_k`` does.
"""
from __future__ import annotations

import math

import torch

from .boxes import box_iou

MAX_WH = 7680.0  # class-offset magnitude


def _top(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last dim: descending, ties by lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    extras: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.7,
    pre_nms: int = 1024,
    max_det: int = 300,
    agnostic: bool = False,
):
    """Fixed-shape NMS over a batch of images.

    boxes (B, A, 4) xyxy, scores (B, A), classes (B, A) int, extras (B, A, E).
    Returns a dict of (B, max_det, ...) outputs and ``valid`` (B, max_det).
    """
    B, A = scores.shape
    k = min(pre_nms, A)
    gated = torch.where(scores > conf_thres, scores, scores.new_tensor(-1.0))
    top_scores, order = _top(gated, k)  # (B, k) descending
    top_scores = top_scores.float()
    # promote the k candidates to f32 before the MAX_WH offset: in a narrow
    # type the offset would eat the coordinate mantissa
    cand_boxes = torch.gather(boxes, 1, order[..., None].expand(B, k, 4)).float()
    cand_cls = torch.gather(classes, 1, order)
    cand_alive = top_scores > 0
    offset = torch.where(cand_alive, cand_cls.float(), cand_boxes.new_tensor(-1.0))
    shifted = cand_boxes + (offset * (0.0 if agnostic else MAX_WH))[..., None]
    iou = box_iou(shifted, shifted)  # (B, k, k)

    # Greedy NMS as a fixpoint: box i survives iff no higher-ranked SURVIVOR
    # suppresses it. keep <- alive & ~any_j(keep[j] & sup[j, i]) settles one
    # suppression-chain level per sweep and stops at the sequential result.
    rank = torch.arange(k, device=scores.device)
    sup = (iou > iou_thres) & (rank[:, None] < rank[None, :])  # sup[j, i], j < i
    keep = cand_alive
    for _ in range(k):
        new = cand_alive & ~(keep[..., :, None] & sup).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new

    final_scores = torch.where(keep, top_scores, top_scores.new_tensor(-1.0))
    out_scores, sel = _top(final_scores, min(max_det, k))
    valid = out_scores > 0
    pick = torch.gather(order, 1, sel)  # (B, m) anchor indices
    m = pick.shape[1]
    vb = valid[..., None]
    out = {
        "boxes": torch.where(
            vb, torch.gather(boxes, 1, pick[..., None].expand(B, m, 4)).float(), 0.0
        ),
        "scores": torch.where(valid, out_scores, 0.0),
        "classes": torch.where(valid, torch.gather(classes, 1, pick), -1),
        "extras": torch.where(
            vb, torch.gather(extras, 1, pick[..., None].expand(B, m, extras.shape[-1])), 0.0
        ),
        "valid": valid,
    }
    if max_det > k:  # pad up (tiny inputs)
        pad = max_det - k
        for name, v in out.items():
            fill = -1 if name == "classes" else 0
            out[name] = torch.cat([v, v.new_full((B, pad) + v.shape[2:], fill)], dim=1)
    return out


def logit_threshold(conf_thres: float, device=None) -> torch.Tensor:
    """The confidence gate on logits: ``logit(c)`` in float32 with ``c``
    clipped to [1e-12, 1 - 1e-7], and ``-inf`` when ``conf_thres <= 0`` (then
    every score passes)."""
    c = torch.tensor(conf_thres, dtype=torch.float32, device=device)
    safe = c.clamp(1e-12, 1.0 - 1e-7)
    thr = torch.log(safe) - torch.log1p(-safe)
    return torch.where(c > 0, thr, thr.new_tensor(-math.inf))


def non_max_suppression_parts(
    boxes: torch.Tensor,
    cls_scores: torch.Tensor,
    extras: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.7,
    pre_nms: int = 1024,
    max_det: int = 300,
    agnostic: bool = False,
    multi_label: bool = False,
    scores_are_logits: bool = False,
):
    """NMS over unconcatenated (B, A, .) components.

    Best class per anchor by default. ``multi_label`` (the val protocol):
    every (anchor, class) pair above the gate is a candidate; the top
    ``k = min(pre_nms, A * nc)`` of the flattened (B, A * nc) scores (a
    stable descending sort, so ties go to the lower flat index) give
    ``anchor = idx // nc`` and ``class = idx % nc``, and the boxes and
    extras are gathered by anchor. With one class it is the best-class path.

    ``scores_are_logits``: cls_scores are raw logits and the sigmoid runs
    after the reduction (the per-anchor max, or the top-k), on (B, A) or
    (B, k) instead of (B, A, nc); sigmoid is monotonic, so the selection is
    the same. Multi-label gates the logits themselves at
    ``logit_threshold(conf_thres)``, gated entries becoming ``-inf``.
    """
    nc = cls_scores.shape[-1]
    if multi_label and nc > 1:
        B, A = cls_scores.shape[:2]
        k = min(pre_nms, A * nc)
        flat = cls_scores.reshape(B, A * nc)
        if scores_are_logits:
            thr = logit_threshold(conf_thres, flat.device)
            gated = torch.where(flat > thr, flat, flat.new_tensor(-math.inf))
            scores, idx = _top(gated, k)
            scores = torch.sigmoid(scores)  # sigmoid(-inf) == 0: stays gated
        else:
            gated = torch.where(flat > conf_thres, flat, flat.new_tensor(-1.0))
            scores, idx = _top(gated, k)
        anchor = torch.div(idx, nc, rounding_mode="floor")
        classes = idx % nc
        boxes = torch.gather(boxes, 1, anchor[..., None].expand(B, k, boxes.shape[-1]))
        extras = torch.gather(extras, 1, anchor[..., None].expand(B, k, extras.shape[-1]))
    else:
        scores, classes = cls_scores.max(-1)  # first index wins ties
        if scores_are_logits:
            scores = torch.sigmoid(scores)
    return batched_nms(
        boxes, scores, classes, extras, conf_thres=conf_thres, iou_thres=iou_thres,
        pre_nms=pre_nms, max_det=max_det, agnostic=agnostic,
    )


def non_max_suppression(
    prediction: torch.Tensor,
    nc: int,
    conf_thres: float = 0.25,
    iou_thres: float = 0.7,
    pre_nms: int = 1024,
    max_det: int = 300,
    agnostic: bool = False,
    multi_label: bool = False,
):
    """NMS over a head output in the reference layout (B, 4 + nc + E, A):
    xyxy boxes, ``nc`` scores as probabilities (gated at ``conf_thres``
    itself, as the JAX detect path gates them), then E extras.
    ``non_max_suppression_parts`` of the transposed pieces."""
    pred = prediction.transpose(1, 2)  # (B, A, C)
    return non_max_suppression_parts(
        pred[..., :4], pred[..., 4:4 + nc], pred[..., 4 + nc:], conf_thres=conf_thres,
        iou_thres=iou_thres, pre_nms=pre_nms, max_det=max_det, agnostic=agnostic,
        multi_label=multi_label,
    )
