"""The polar segmentation loss (counterpart of ``segmentation_loss`` in the
JAX package's ``utils/loss.py``; its detect, pose and classify losses are
not ported yet): polar-IoU ray loss plus BCE class loss, with the polar
task-aligned assignment.

GT batches arrive dense: (B, N_max) padded instances with a validity mask.
Contour GT is scaled per point (x * w, y * h), the JAX package's deliberate
fix of the reference, which scaled the flattened halves and was right only
for square images.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..nn.modules.head import flatten_levels
from ..ops import polar as polar_ops
from ..ops.boxes import xywh2xyxy
from .tal import AssignResult, polar_task_aligned_assign, resolve_cand


class LossOut(NamedTuple):
    total: torch.Tensor
    items: Dict[str, torch.Tensor]


class PolarTargets(NamedTuple):
    pred_rays_px: torch.Tensor  # (B, A, 36) predicted rays, px (with grad)
    pred_scores: torch.Tensor  # (B, A, nc) class logits (with grad)
    assign: AssignResult  # the assigner's targets (no grad)


def polar_targets(
    feats: Sequence[torch.Tensor],  # per-level (B, 36 + nc, H, W) raw maps
    batch: Dict[str, torch.Tensor],  # cls (B, N), bboxes (B, N, 4) xywh norm,
    #                                  segments (B, N, 360, 2) norm, mask_gt (B, N)
    strides: Sequence[int],
    nc: int,
    hyp,
    cand=128,
    mark=None,
) -> PolarTargets:
    """The first half of ``segmentation_loss``: the head maps flattened to
    (B, A, .) in f32, the GT in pixels, and the polar assignment. ``mark``
    goes to the assigner (``engine/step.py`` says what it is)."""
    nm = polar_ops.NUM_RAYS
    dt = torch.float32
    dev = feats[0].device

    x = flatten_levels(feats).to(dt)  # (B, A, nm + nc)
    pred_rays, pred_scores = x[..., :nm], x[..., nm:]
    cand = resolve_cand(cand, x.shape[1], n_pad=batch["cls"].shape[1],
                        balance=bool(getattr(hyp, "cand_balance", True)))

    feat_hw = [(f.shape[2], f.shape[3]) for f in feats]
    anchor_points, stride_t = polar_ops.make_anchors(feat_hw, strides, dtype=dt, device=dev)
    img_h = feat_hw[0][0] * strides[0]
    img_w = feat_hw[0][1] * strides[0]

    # GT to pixel space, per point
    scale4 = torch.tensor([img_w, img_h, img_w, img_h], dtype=dt, device=dev)
    gt_bboxes = xywh2xyxy(batch["bboxes"].to(dt) * scale4)
    gt_contours = batch["segments"].to(dt) * torch.tensor([img_w, img_h], dtype=dt, device=dev)

    pred_rays_px = pred_rays * stride_t[None]  # (B, A, 36)
    assign = polar_task_aligned_assign(
        torch.sigmoid(pred_scores).detach(),
        pred_rays_px.detach(),
        anchor_points * stride_t,
        batch["cls"].long(), gt_bboxes, gt_contours, batch["mask_gt"].bool(),
        alpha=0.5, beta=4.0, topk=10, cand=cand, mark=mark,
    )
    return PolarTargets(pred_rays_px, pred_scores, assign)


def polar_loss(targets: PolarTargets, hyp) -> LossOut:
    """The second half of ``segmentation_loss``: BCE class loss and polar
    IoU ray loss against the assigned targets, scaled by the batch size."""
    pred_rays_px, pred_scores, assign = targets
    target_scores_sum = assign.target_scores.sum().clamp_min(1.0)
    loss_cls = F.binary_cross_entropy_with_logits(
        pred_scores, assign.target_scores, reduction="none").sum() / target_scores_sum

    weight = assign.target_scores.sum(-1) * assign.fg_mask  # (B, A)
    loss_ray = polar_ops.mask_iou_loss(pred_rays_px, assign.target_rays, weight,
                                       target_scores_sum)

    total = (loss_ray * hyp.box + loss_cls * hyp.cls) * pred_scores.shape[0]
    return LossOut(total, {"seg_loss": loss_ray * hyp.box, "cls_loss": loss_cls * hyp.cls})


def segmentation_loss(feats, batch, strides, nc: int, hyp, cand=128) -> LossOut:
    """Polar segmentation loss: ``polar_loss(polar_targets(...))``. ``cand``
    None/0/'auto' takes the imgsz-adaptive cap (``tal.resolve_cand``). Math
    in f32."""
    return polar_loss(polar_targets(feats, batch, strides, nc, hyp, cand=cand), hyp)
