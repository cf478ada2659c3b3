"""The training losses of the segment, detect, pose, segment_ori and
classify tasks (counterparts of ``segmentation_loss``, ``detection_loss``,
``pose_loss``, ``segmentation_ori_loss`` and ``classification_loss`` in the
JAX package's ``utils/loss.py``): polar-IoU ray loss plus BCE class loss
with the polar task-aligned assignment; CIoU box loss, DFL and BCE class
loss with the stock one; for pose, on the detect loss's assignment, the OKS
keypoint loss and the keypoint visibility BCE; for the proto-mask task, on
that assignment, the mask BCE of the top foreground anchors against the GT
masks filled at proto size; and the classify cross-entropy.

GT batches arrive dense: (B, N_max) padded instances with a validity mask.
In a process group (``parallel/mesh.py``) each rank's loss is its share of
the global batch's: the normalizers (the target-score sum, the keypoint
and mask counts) are summed over the ranks before their clamp, and the
``* B`` factors take the global batch, so the ranks' losses sum to the
one-device loss of the concatenated batch.
Contour GT is scaled per point (x * w, y * h), the JAX package's deliberate
fix of the reference, which scaled the flattened halves and was right only
for square images.

The assigner and loss math run in float32 on the head maps cast to it, as
JAX's (under bfloat16 and in a float64 network too). ``dtype`` (the step's
``hyp.loss_dtype``) may widen it to float64, so a float64 network's loss
holds to float64 rounding (the GT rays stay float32, the kernel's
contract).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..nn.modules.head import flatten_levels
from ..ops import polar as polar_ops
from ..ops.boxes import bbox2dist, bbox_iou, dist2bbox, xywh2xyxy
from ..ops.nms import _top
from ..ops.raster import fill_polygons
from ..parallel.mesh import all_sum, global_batch
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
    dtype=torch.float32,
) -> PolarTargets:
    """The first half of ``segmentation_loss``: the head maps flattened to
    (B, A, .) in f32 (``dtype``: see the module docstring), the GT in
    pixels, and the polar assignment. ``mark`` goes to the assigner
    (``engine/step.py`` says what it is)."""
    nm = polar_ops.NUM_RAYS
    dt = dtype
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
    target_scores_sum = all_sum(assign.target_scores.sum()).clamp_min(1.0)
    loss_cls = F.binary_cross_entropy_with_logits(
        pred_scores, assign.target_scores, reduction="none").sum() / target_scores_sum

    weight = assign.target_scores.sum(-1) * assign.fg_mask  # (B, A)
    loss_ray = polar_ops.mask_iou_loss(pred_rays_px, assign.target_rays, weight,
                                       target_scores_sum)

    total = (loss_ray * hyp.box + loss_cls * hyp.cls) * global_batch(pred_scores.shape[0])
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
    dtype=torch.float32,
) -> DetectTargets:
    """The first half of ``detection_loss``: the head maps flattened to
    (B, A, .) in f32 (``dtype``), the DFL expectation decoded to boxes, the
    GT in pixels, and the stock assignment (alpha 0.5, beta 6, top 10)."""
    dt = dtype
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
    target_scores_sum = all_sum(assign.target_scores.sum()).clamp_min(1.0)
    loss_cls = F.binary_cross_entropy_with_logits(
        pred_scores, assign.target_scores, reduction="none").sum() / target_scores_sum

    weight = assign.target_scores.sum(-1) * assign.fg_mask  # (B, A)
    target_bboxes = assign.target_bboxes / stride_t[None]  # grid units
    iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, CIoU=True)
    loss_iou = ((1.0 - iou) * weight).sum() / target_scores_sum

    target_ltrb = bbox2dist(anchor_points[None], target_bboxes, reg_max - 1)
    loss_dfl = (_df_loss(pred_dist, target_ltrb) * weight).sum() / target_scores_sum

    total = ((loss_iou * hyp.box + loss_cls * hyp.cls + loss_dfl * hyp.dfl)
             * global_batch(pred_scores.shape[0]))
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


# OKS sigmas of COCO's 17 keypoints (the reference v8PoseLoss's), float32 as
# the JAX constant; another keypoint count takes a uniform 1 / K
OKS_SIGMA = torch.tensor([.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
                          .87, .87, .89, .89], dtype=torch.float32) / 10.0


def pose_loss(feats, batch, strides, nc: int, hyp, kpt_shape: Tuple[int, int] = (17, 3),
              reg_max: int = 16, mark: Optional[Callable[[str], None]] = None,
              dtype=torch.float32) -> LossOut:
    """The pose loss (JAX ``pose_loss``): the detect loss on the maps'
    detect channels (``detection_loss``'s two halves), and on its shared
    assignment the keypoint terms. ``batch`` adds ``keypoints`` (B, N, K, 3),
    xy normalized and a visibility. Keypoint loss: ``1 - exp(-e)``, ``e =
    d^2 / (2 sigma)^2 / (area + 1e-9) / 2``, over the visible keypoints of
    the foreground anchors, ``area`` the assigned GT box's in pixels;
    visibility loss (D = 3): a BCE of the visibility logits against "this
    keypoint is visible" over the foreground anchors x K. The total adds
    ``(kpt * pose + kobj * kobj) * B``. Math in f32. ``mark("loss")`` is
    called between the assignment and the losses."""
    nk = kpt_shape[0] * kpt_shape[1]
    targets = detect_targets([f[:, :-nk] for f in feats], batch, strides, nc, reg_max, dtype)
    if mark is not None:
        mark("loss")
    det = detect_loss(targets, hyp)
    assign, anchor_points, stride_t = targets.assign, targets.anchor_points, targets.stride_t
    dt = dtype
    dev = feats[0].device

    kpt_raw = flatten_levels([f[:, -nk:] for f in feats]).to(dt)  # (B, A, nk)
    b, a = kpt_raw.shape[:2]
    img_h = feats[0].shape[2] * strides[0]
    img_w = feats[0].shape[3] * strides[0]
    k = kpt_raw.reshape(b, a, kpt_shape[0], kpt_shape[1])
    kxy = (k[..., :2] * 2.0 + (anchor_points[None, :, None, :] - 0.5)) * stride_t[None, :, None, :]

    gt_kpts = batch["keypoints"].to(dt)  # (B, N, K, 3)
    gt_kxy = gt_kpts[..., :2] * torch.tensor([img_w, img_h], dtype=dt, device=dev)
    idx = assign.target_gt_idx[:, :, None, None].expand(b, a, kpt_shape[0], 2)
    sel_kxy = torch.gather(gt_kxy, 1, idx)  # (B, A, K, 2)
    sel_vis = torch.gather(gt_kpts[..., 2], 1, idx[..., 0])  # (B, A, K)
    kpt_mask = (sel_vis > 0) & assign.fg_mask[..., None]

    area = (assign.target_bboxes[..., 2:] - assign.target_bboxes[..., :2]).prod(-1)[..., None]
    d2 = ((kxy - sel_kxy) ** 2).sum(-1)  # (B, A, K)
    sigmas = (OKS_SIGMA.to(dev) if kpt_shape[0] == OKS_SIGMA.shape[0]
              else torch.full((kpt_shape[0],), 1.0 / kpt_shape[0], dtype=dt, device=dev))
    e = d2 / ((2 * sigmas) ** 2) / (area + 1e-9) / 2
    loss_kpt = (((1 - torch.exp(-e)) * kpt_mask).sum()
                / all_sum(kpt_mask.sum()).clamp_min(1).to(dt))
    fg = assign.fg_mask.to(dt)
    if kpt_shape[1] == 3:
        bce = F.binary_cross_entropy_with_logits(k[..., 2], kpt_mask.to(dt), reduction="none")
        loss_kobj = (bce * fg[..., None]).sum() / (all_sum(fg.sum()) * kpt_shape[0]).clamp_min(1.0)
    else:
        loss_kobj = torch.zeros((), dtype=dt, device=dev)

    total = det.total + (loss_kpt * hyp.pose + loss_kobj * hyp.kobj) * global_batch(b)
    return LossOut(total, {**det.items, "pose_loss": loss_kpt * hyp.pose,
                           "kobj_loss": loss_kobj * hyp.kobj})


def gt_masks_at(segments: torch.Tensor, mask_gt: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """GT masks (B, N, hp, wp) bool from the normalized contours (B, N, V,
    2): points ``segments * [wp, hp]``, every vertex of an instance valid
    where ``mask_gt`` is, filled by the even-odd ``fill_polygons`` (the CUDA
    kernel on the card, one launch; the plain version on the CPU), as the
    JAX loss and validator fill them with the jnp ``fill_polygons``."""
    b, n, v, _ = segments.shape
    dt = torch.float32
    pts = segments.to(dt) * torch.tensor([wp, hp], dtype=dt, device=segments.device)
    valid = mask_gt.bool()[..., None].expand(b, n, v)
    return fill_polygons(pts.reshape(b * n, v, 2).contiguous(),
                         valid.reshape(b * n, v).contiguous(), hp, wp).reshape(b, n, hp, wp)


def in_box_grid(boxes: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """boxes (..., 4) xyxy on the proto grid -> (..., hp, wp) bool, the
    half-open test ``x1 <= px < x2`` and ``y1 <= py < y2`` at integer pixels,
    as JAX crops (float32 pixel indices)."""
    py = torch.arange(hp, dtype=boxes.dtype, device=boxes.device)[:, None]
    px = torch.arange(wp, dtype=boxes.dtype, device=boxes.device)[None, :]
    b = boxes[..., None, None, :]
    return ((px >= b[..., 0]) & (px < b[..., 2]) & (py >= b[..., 1]) & (py < b[..., 3]))


def segmentation_ori_loss(outs, batch, strides, nc: int, hyp, nm: int = 32, reg_max: int = 16,
                          max_fg: int = 64, mark: Optional[Callable[[str], None]] = None,
                          dtype=torch.float32) -> LossOut:
    """The proto-mask segmentation loss (JAX ``segmentation_ori_loss``).
    ``outs`` = (levels, proto): per level (B, 4 * reg_max + nc + nm, H, W)
    and the prototypes (B, nm, hp, wp); ``batch`` as the polar loss takes it
    (``segments`` (B, N, V, 2) normalized, ``mask_gt``).

    The detect loss and its assignment on the detect channels; the GT masks
    at proto size (``gt_masks_at``); the top ``max_fg`` anchors of each
    image by ``target_scores.sum(-1) * fg_mask`` (a stable descending sort:
    ties go to the lowest anchor index, as ``lax.top_k``), each carrying
    the mask loss if it is foreground with a positive score: the BCE of
    ``mc @ proto`` against its GT's mask, summed inside its target box on
    the proto grid (``in_box_grid``) and divided by the box's area there,
    clipped at 1; averaged over those anchors. The total adds ``mask *
    box * B``. Math in f32; ``mark("loss")`` is called between the
    assignment and the losses."""
    levels, proto = outs
    dt = dtype
    dev = levels[0].device
    targets = detect_targets([o[:, :o.shape[1] - nm] for o in levels], batch, strides, nc,
                             reg_max, dtype)
    if mark is not None:
        mark("loss")
    det = detect_loss(targets, hyp)
    assign = targets.assign
    b = levels[0].shape[0]
    img_h = levels[0].shape[2] * strides[0]
    img_w = levels[0].shape[3] * strides[0]
    hp, wp = proto.shape[2], proto.shape[3]

    mc = flatten_levels([o[:, -nm:] for o in levels]).to(dt)  # (B, A, nm)
    gt_masks = gt_masks_at(batch["segments"], batch["mask_gt"], hp, wp)  # (B, N, hp, wp)

    fg_score = assign.target_scores.sum(-1) * assign.fg_mask  # (B, A)
    topv, topi = _top(fg_score, min(max_fg, fg_score.shape[1]))  # (B, K)
    k = topi.shape[1]
    sel_mc = torch.gather(mc, 1, topi[..., None].expand(b, k, nm))
    sel_gt_idx = torch.gather(assign.target_gt_idx, 1, topi)
    sel_fg = torch.gather(assign.fg_mask, 1, topi) & (topv > 0)
    sel_boxes = torch.gather(assign.target_bboxes, 1, topi[..., None].expand(b, k, 4))
    sel_gt_masks = gt_masks[torch.arange(b, device=dev)[:, None], sel_gt_idx].to(dt)

    pred_masks = torch.einsum("bkm,bmhw->bkhw", sel_mc, proto.to(dt))
    bce = F.binary_cross_entropy_with_logits(pred_masks, sel_gt_masks, reduction="none")
    bx = sel_boxes * torch.tensor([wp / img_w, hp / img_h, wp / img_w, hp / img_h], dtype=dt,
                                  device=dev)
    area = ((bx[..., 2] - bx[..., 0]) * (bx[..., 3] - bx[..., 1])).clamp_min(1.0)
    per_inst = (bce * in_box_grid(bx, hp, wp)).sum((-2, -1)) / area  # (B, K)
    loss_mask = (per_inst * sel_fg).sum() / all_sum(sel_fg.sum()).to(dt).clamp_min(1.0)

    total = det.total + loss_mask * hyp.box * global_batch(b)
    return LossOut(total, {**det.items, "mask_loss": loss_mask * hyp.box})


def classification_loss(preds: torch.Tensor, batch: Dict[str, torch.Tensor]) -> LossOut:
    """The classify loss (JAX ``classification_loss``): on the head's
    sigmoid outputs ``p`` (B, nc), ``log(clip(p, 1e-7, 1))`` renormalized by
    its ``logsumexp``, the negative log-likelihood of each int label, summed
    and divided by 64. In the outputs' dtype, as JAX. The clip is JAX's
    ``min(max(p, lo), hi)``: a ``p`` at a bound (a saturated sigmoid's 1)
    gets half the gradient, as ``lax.max`` and ``torch.maximum`` split ties;
    ``clamp`` would pass all of it."""
    labels = batch["cls"].long().reshape(-1)
    lo, hi = preds.new_tensor(1e-7), preds.new_tensor(1.0)
    logp = torch.log(torch.minimum(torch.maximum(preds, lo), hi))
    logp = logp - torch.logsumexp(logp, -1, keepdim=True)
    loss = -logp.gather(-1, labels[:, None]).sum() / 64.0
    return LossOut(loss, {"cls_loss": loss})
