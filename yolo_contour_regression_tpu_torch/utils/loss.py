"""The training losses of the segment and detect tasks (counterparts of
``segmentation_loss`` and ``detection_loss`` in the JAX package's
``utils/loss.py``; its pose and classify losses are not ported yet):
polar-IoU ray loss plus BCE class loss with the polar task-aligned
assignment; CIoU box loss, DFL and BCE class loss with the stock one.

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
from ..ops.boxes import bbox2dist, bbox_iou, dist2bbox, xywh2xyxy
from .tal import AssignResult, polar_task_aligned_assign, resolve_cand, task_aligned_assign


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


class DetectTargets(NamedTuple):
    pred_dist: torch.Tensor  # (B, A, 4, reg_max) box-bin logits (with grad)
    pred_scores: torch.Tensor  # (B, A, nc) class logits (with grad)
    pred_bboxes: torch.Tensor  # (B, A, 4) xyxy in grid units (with grad)
    anchor_points: torch.Tensor  # (A, 2) grid units
    stride_t: torch.Tensor  # (A, 1)
    assign: AssignResult  # the assigner's targets (no grad)


def detect_targets(
    feats: Sequence[torch.Tensor],  # per-level (B, 4 * reg_max + nc, H, W) raw maps
    batch: Dict[str, torch.Tensor],  # cls (B, N), bboxes (B, N, 4) xywh norm, mask_gt (B, N)
    strides: Sequence[int],
    nc: int,
    reg_max: int = 16,
) -> DetectTargets:
    """The first half of ``detection_loss``: the head maps flattened to
    (B, A, .) in f32, the DFL expectation decoded to boxes, the GT in
    pixels, and the stock assignment (alpha 0.5, beta 6, top 10)."""
    dt = torch.float32
    dev = feats[0].device
    x = flatten_levels(feats).to(dt)
    pred_dist, pred_scores = x[..., :4 * reg_max], x[..., 4 * reg_max:]

    feat_hw = [(f.shape[2], f.shape[3]) for f in feats]
    anchor_points, stride_t = polar_ops.make_anchors(feat_hw, strides, dtype=dt, device=dev)
    img_h = feat_hw[0][0] * strides[0]
    img_w = feat_hw[0][1] * strides[0]
    scale4 = torch.tensor([img_w, img_h, img_w, img_h], dtype=dt, device=dev)
    gt_bboxes = xywh2xyxy(batch["bboxes"].to(dt) * scale4)

    b, a, _ = pred_dist.shape
    pred_dist = pred_dist.reshape(b, a, 4, reg_max)
    proj = torch.arange(reg_max, dtype=dt, device=dev)
    ltrb = torch.einsum("bakr,r->bak", pred_dist.softmax(-1), proj)
    pred_bboxes = dist2bbox(ltrb, anchor_points[None], xywh=False)  # grid units

    assign = task_aligned_assign(
        torch.sigmoid(pred_scores).detach(), (pred_bboxes * stride_t[None]).detach(),
        anchor_points * stride_t, batch["cls"].long(), gt_bboxes, batch["mask_gt"].bool(),
        alpha=0.5, beta=6.0, topk=10,
    )
    return DetectTargets(pred_dist, pred_scores, pred_bboxes, anchor_points, stride_t, assign)


def _df_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: pred_dist (..., 4, reg_max) logits, target
    (..., 4) in [0, reg_max - 1) -> (...,), the mean over the 4 sides of the
    cross-entropies at the two bins around the target, weighted by
    nearness. The bins are picked by ``gather``, which gives the JAX
    version's one-hot multiply-reduce exactly."""
    reg_max = pred_dist.shape[-1]
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist, -1)
    ce_l = -logp.gather(-1, tl.clamp(0, reg_max - 1)[..., None])[..., 0]
    ce_r = -logp.gather(-1, tr.clamp(0, reg_max - 1)[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(-1)


def detect_loss(targets: DetectTargets, hyp) -> LossOut:
    """The second half of ``detection_loss``: BCE class loss, CIoU box loss
    and DFL against the assigned targets, scaled by the batch size."""
    pred_dist, pred_scores, pred_bboxes, anchor_points, stride_t, assign = targets
    reg_max = pred_dist.shape[-1]
    target_scores_sum = assign.target_scores.sum().clamp_min(1.0)
    loss_cls = F.binary_cross_entropy_with_logits(
        pred_scores, assign.target_scores, reduction="none").sum() / target_scores_sum

    weight = assign.target_scores.sum(-1) * assign.fg_mask  # (B, A)
    target_bboxes = assign.target_bboxes / stride_t[None]  # grid units
    iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, CIoU=True)
    loss_iou = ((1.0 - iou) * weight).sum() / target_scores_sum

    target_ltrb = bbox2dist(anchor_points[None], target_bboxes, reg_max - 1)
    loss_dfl = (_df_loss(pred_dist, target_ltrb) * weight).sum() / target_scores_sum

    total = (loss_iou * hyp.box + loss_cls * hyp.cls + loss_dfl * hyp.dfl) * pred_scores.shape[0]
    return LossOut(total, {"box_loss": loss_iou * hyp.box, "cls_loss": loss_cls * hyp.cls,
                           "dfl_loss": loss_dfl * hyp.dfl})


def detection_loss(feats, batch, strides, nc: int, hyp, reg_max: int = 16,
                   return_assign: bool = False):
    """The stock detect loss: ``detect_loss(detect_targets(...))``. Math in
    f32. ``return_assign`` also returns the assignment, which the pose and
    proto-mask losses reuse."""
    targets = detect_targets(feats, batch, strides, nc, reg_max)
    out = detect_loss(targets, hyp)
    return (out, targets.assign) if return_assign else out
