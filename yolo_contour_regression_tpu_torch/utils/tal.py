"""Task-aligned assignment, polar and stock (counterpart of the JAX
package's ``utils/tal.py``).

``polar_task_aligned_assign``: candidate anchors inside the GT box, GT rays
per (gt, anchor) pair from the 360-point contour, overlaps = polar MaskIoU,
align = score^alpha * iou^beta, top-10 per GT, dedupe per anchor by the
largest overlap, normalized target scores. Every tensor is statically
shaped: the polar metric is computed for a top-``cand`` candidate set per GT
(all in-box anchors first, the predicted class score breaking ties), and
the results are scattered back to dense (B, A) target maps.

Ties follow the JAX version: the candidate pick is a stable descending sort
(``lax.top_k`` takes the lowest index first among equals), and an anchor
claimed by several GTs with the same overlap goes to the lowest GT index.
The whole assigner runs under ``torch.no_grad()``, as JAX stops gradients
at its inputs.

``task_aligned_assign``: the stock YOLOv8 assigner of the detect task,
dense over (B, N, A): CIoU overlaps of GT and predicted boxes, align =
score^0.5 * iou^6, top-10 per GT, the same dedupe and normalized scores.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import polar as polar_ops
from ..ops.boxes import bbox_iou
from ..ops.gt_rays import gt_rays_rows_fast

EPS = 1e-9
INF = 1e9


def resolve_cand(cand, A: int, n_pad=None, balance: bool = True) -> int:
    """The assigner's candidate cap. ``cand`` None/0/'auto' scales with the
    anchor count (A // 16, floored at 128, capped at 512); ``balance`` then
    narrows it for crowded padded GT counts (``balance_cand``)."""
    if cand in (None, 0, "auto"):
        base = min(A, max(128, min(A // 16, 512)))
    else:
        base = min(int(cand), A)
    if n_pad is not None and balance:
        base = balance_cand(base, n_pad)
    return base


def balance_cand(base: int, n_pad: int, floor: int = 48) -> int:
    """Work-balanced candidate budget: the GT-ray work is about N_pad x K
    pairs, so K ~ base * 8 / N_pad above 8 GT rows, floored."""
    if n_pad <= 8:
        return base
    return max(floor, min(base, (base * 8) // n_pad))


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (B, A) int64
    target_bboxes: torch.Tensor  # (B, A, 4) xyxy, the units of gt_bboxes
    target_scores: torch.Tensor  # (B, A, nc) normalized soft targets
    fg_mask: torch.Tensor  # (B, A) bool
    target_gt_idx: torch.Tensor  # (B, A) int64
    target_rays: torch.Tensor  # (B, A, 36) GT ray distances
    centerness: torch.Tensor  # (B, A) polar centerness of the GT rays


def select_candidates_in_gts(anc_points, gt_bboxes, eps: float = EPS):
    """(A, 2), (B, N, 4) -> (B, N, A) bool: anchor center strictly inside
    the box."""
    x, y = anc_points[:, 0], anc_points[:, 1]
    lt_x = x[None, None, :] - gt_bboxes[..., 0:1]
    lt_y = y[None, None, :] - gt_bboxes[..., 1:2]
    rb_x = gt_bboxes[..., 2:3] - x[None, None, :]
    rb_y = gt_bboxes[..., 3:4] - y[None, None, :]
    return torch.minimum(torch.minimum(lt_x, lt_y), torch.minimum(rb_x, rb_y)) > eps


def _topk_mask(metrics, topk: int, valid):
    """(..., K) metric -> (..., K) bool mask of the top-``topk`` entries
    among ``valid``; of entries tied at the k-th value, the first ones in
    order are kept."""
    gated = torch.where(valid, metrics, torch.full_like(metrics, -INF))
    kth = torch.topk(gated, topk, dim=-1).values[..., -1:]
    mask = (gated >= kth) & valid
    ranked = torch.cumsum(mask.int(), dim=-1)
    return mask & (ranked <= topk)


def _dedupe_by_overlap(mask_pos, overlaps, n_max: int):
    """Anchors claimed by several GTs keep the GT of largest overlap
    (lowest index on ties). (B, N, A) -> target_gt_idx (B, A), fg_mask
    (B, A), mask_final (B, N, A)."""
    fg_count = mask_pos.sum(1)  # (B, A)
    gated = torch.where(mask_pos > 0, overlaps, torch.full_like(overlaps, -INF))
    best_gt = gated.argmax(1)  # (B, A), first maximum
    onehot = F.one_hot(best_gt, n_max).permute(0, 2, 1).to(mask_pos.dtype)  # (B, N, A)
    mask_final = torch.where((fg_count > 1)[:, None, :], onehot, mask_pos)
    fg_mask = mask_final.sum(1) > 0
    target_gt_idx = mask_final.argmax(1)
    return target_gt_idx, fg_mask, mask_final


def _normalized_target_scores(gt_labels, target_gt_idx, fg_mask, align_dense, overlaps_dense,
                              mask_final, nc: int):
    """One-hot targets scaled by the per-GT normalized align metric."""
    target_labels = torch.gather(gt_labels, 1, target_gt_idx).clamp_min(0)  # (B, A)
    onehot = F.one_hot(target_labels, nc).to(align_dense.dtype) * fg_mask[..., None]
    align_pos = align_dense * mask_final  # (B, N, A)
    pos_align_max = align_pos.amax(-1, keepdim=True)  # (B, N, 1)
    pos_overlap_max = (overlaps_dense * mask_final).amax(-1, keepdim=True)
    norm = (align_pos * pos_overlap_max / (pos_align_max + EPS)).amax(1)  # (B, A)
    return target_labels, onehot * norm[..., None]


@torch.no_grad()
def polar_task_aligned_assign(
    pd_scores: torch.Tensor,  # (B, A, nc) sigmoid scores
    pd_rays: torch.Tensor,  # (B, A, 36) predicted ray distances, px
    anc_points: torch.Tensor,  # (A, 2) anchor centers, px
    gt_labels: torch.Tensor,  # (B, N) int
    gt_bboxes: torch.Tensor,  # (B, N, 4) xyxy px
    gt_contours: torch.Tensor,  # (B, N, 360, 2) px
    mask_gt: torch.Tensor,  # (B, N) bool
    alpha: float = 0.5,
    beta: float = 4.0,
    topk: int = 10,
    cand: int = 128,
    impl: str = "sparse",
    mark=None,
) -> AssignResult:
    """The polar assigner. ``impl="sparse"`` (the default) resolves each
    anchor's winning GT in candidate space with (B, A) scatter-max/min;
    ``impl="dense"`` scatters the candidates to (B, N, A) maps first, as the
    reference does, and serves as its equivalence check. ``mark``, when
    given, is called with "gt_rays" just before the GT-ray kernel's wrapper
    and with "assigner" just after it."""
    if impl not in ("sparse", "dense"):
        raise ValueError(f"impl must be 'sparse' or 'dense', got {impl!r}")
    B, A, nc = pd_scores.shape
    N = gt_labels.shape[1]
    K = min(cand, A)
    dt = pd_scores.dtype
    dev = pd_scores.device
    gt_labels = gt_labels.long()

    mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes)  # (B, N, A)
    valid_pair = mask_in_gts & mask_gt[..., None]

    # candidate selection: all in-box anchors first, the score as tiebreak
    score_gt = torch.gather(pd_scores.transpose(1, 2), 1,
                            gt_labels.clamp(0, nc - 1)[:, :, None].expand(B, N, A))  # (B, N, A)
    cand_key = valid_pair.to(dt) * (1.0 + score_gt)
    cand_idx = torch.sort(cand_key, dim=-1, descending=True, stable=True).indices[..., :K]

    valid_cand = torch.gather(valid_pair, 2, cand_idx)  # (B, N, K)
    score_cand = torch.gather(score_gt, 2, cand_idx)
    anc_cand = anc_points[cand_idx]  # (B, N, K, 2)
    b_ix = torch.arange(B, device=dev)[:, None, None]
    rays_cand = pd_rays[b_ix, cand_idx]  # (B, N, K, 36)

    # GT rays per candidate pair (the hot loop): the K candidates of a GT row
    # share its contour, and the valid candidates come first in each row
    if mark is not None:
        mark("gt_rays")
    f32 = torch.float32  # the kernel's contract, whatever dt is
    gt_rays_cand = gt_rays_rows_fast(
        gt_contours.reshape(B * N, polar_ops.NUM_CONTOUR_POINTS, 2).to(f32).contiguous(),
        anc_cand.reshape(B * N, K, 2).to(f32).contiguous(),
        valid_cand.reshape(B * N, K).contiguous(),
    ).reshape(B, N, K, polar_ops.NUM_RAYS).to(dt)
    if mark is not None:
        mark("assigner")

    overlaps_cand = polar_ops.polar_mask_iou(gt_rays_cand, rays_cand) * valid_cand
    align_cand = score_cand.clamp_min(0).pow(alpha) * overlaps_cand.clamp_min(0).pow(beta)

    # top-k per GT among the candidates
    mask_topk = _topk_mask(align_cand, topk,
                           mask_gt[..., None] & (cand_key.amax(-1, keepdim=True) >= 0))
    mask_pos_cand = (mask_topk & valid_cand).to(dt)

    flat_idx = cand_idx.reshape(B, N * K)
    if impl == "dense":
        zeros = torch.zeros((B, N, A), dtype=dt, device=dev)

        def scatter_max(vals):
            return zeros.scatter_reduce(2, cand_idx, vals, "amax", include_self=True)

        overlaps_dense = scatter_max(overlaps_cand)
        align_dense = scatter_max(align_cand)
        mask_pos_dense = scatter_max(mask_pos_cand)
        target_gt_idx, fg_mask, mask_final = _dedupe_by_overlap(mask_pos_dense, overlaps_dense, N)
        mask_cand_final = torch.gather(mask_final, 2, cand_idx) * mask_pos_cand
        target_labels, target_scores = _normalized_target_scores(
            gt_labels, target_gt_idx, fg_mask, align_dense, overlaps_dense, mask_final, nc)
    else:
        # each (gt, anchor) pair lives at exactly one (b, n, k) slot, so the
        # per-anchor winner comes from (B, A) scatters over the B*N*K slots
        claim = mask_pos_cand > 0  # (B, N, K)
        n_col = torch.arange(N, device=dev)[None, :, None].expand(B, N, K)

        def gather_a(d):  # (B, A) -> (B, N, K)
            return torch.gather(d, 1, flat_idx).reshape(B, N, K)

        def scatter_a(init, vals, reduce):  # (B, N, K) -> (B, A)
            return init.scatter_reduce(1, flat_idx, vals.reshape(B, N * K), reduce,
                                       include_self=True)

        best_ov = scatter_a(torch.zeros((B, A), dtype=dt, device=dev),
                            torch.where(claim, overlaps_cand, 0.0), "amax")
        fg_mask = best_ov > 0
        is_best = claim & (overlaps_cand >= gather_a(best_ov))
        best_n = scatter_a(torch.full((B, A), N, dtype=torch.long, device=dev),
                           torch.where(is_best, n_col, N), "amin")
        winner = (is_best & (n_col == gather_a(best_n))).to(dt)
        target_gt_idx = torch.where(fg_mask, best_n, 0)

        # per-GT normalizers over that GT's winning anchors, then one
        # scatter-max lands the per-anchor score
        row_al_max = (align_cand * winner).amax(-1)  # (B, N)
        row_ov_max = (overlaps_cand * winner).amax(-1)
        norm_val = align_cand * winner * (row_ov_max / (row_al_max + EPS))[..., None]
        norm = scatter_a(torch.zeros((B, A), dtype=dt, device=dev), norm_val, "amax")

        target_labels = torch.gather(gt_labels, 1, target_gt_idx).clamp_min(0)
        onehot = F.one_hot(target_labels, nc).to(dt) * fg_mask[..., None]
        target_scores = onehot * norm[..., None]
        mask_cand_final = winner

    # per-anchor targets: the GT rays of the surviving pairs (one per anchor)
    vals = (gt_rays_cand * mask_cand_final[..., None]).reshape(B, N * K, polar_ops.NUM_RAYS)
    target_rays = torch.zeros((B, A, polar_ops.NUM_RAYS), dtype=dt, device=dev).scatter_add(
        1, flat_idx[..., None].expand(B, N * K, polar_ops.NUM_RAYS), vals)
    centerness = polar_ops.polar_centerness(target_rays.clamp_min(polar_ops.RAY_EPS))
    centerness = torch.where(fg_mask, centerness, 0.0)
    target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(B, A, 4))
    return AssignResult(target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx,
                        target_rays, centerness)


@torch.no_grad()
def task_aligned_assign(
    pd_scores: torch.Tensor,  # (B, A, nc) sigmoid scores
    pd_bboxes: torch.Tensor,  # (B, A, 4) xyxy px
    anc_points: torch.Tensor,  # (A, 2) anchor centers, px
    gt_labels: torch.Tensor,  # (B, N) int
    gt_bboxes: torch.Tensor,  # (B, N, 4) xyxy px
    mask_gt: torch.Tensor,  # (B, N) bool
    alpha: float = 0.5,
    beta: float = 6.0,
    topk: int = 10,
) -> AssignResult:
    """The stock assigner: overlaps = CIoU(gt, pred) clipped at 0, over
    every (gt, anchor) pair with the anchor inside the GT box. Its
    ``target_rays`` and ``centerness`` are zeros (no contour)."""
    B, A, nc = pd_scores.shape
    N = gt_labels.shape[1]
    dt, dev = pd_scores.dtype, pd_scores.device
    gt_labels = gt_labels.long()

    valid_pair = select_candidates_in_gts(anc_points, gt_bboxes) & mask_gt[..., None]
    score_gt = torch.gather(pd_scores.transpose(1, 2), 1,
                            gt_labels.clamp(0, nc - 1)[:, :, None].expand(B, N, A))  # (B, N, A)
    overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], xywh=False,
                        CIoU=True)
    overlaps = overlaps.clamp_min(0) * valid_pair
    align = score_gt.clamp_min(0).pow(alpha) * overlaps.pow(beta) * valid_pair

    mask_pos = (_topk_mask(align, topk, mask_gt[..., None]) & valid_pair).to(dt)
    target_gt_idx, fg_mask, mask_final = _dedupe_by_overlap(mask_pos, overlaps, N)
    target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(B, A, 4))
    target_labels, target_scores = _normalized_target_scores(
        gt_labels, target_gt_idx, fg_mask, align, overlaps, mask_final, nc)
    return AssignResult(target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx,
                        torch.zeros((B, A, polar_ops.NUM_RAYS), dtype=dt, device=dev),
                        torch.zeros((B, A), dtype=dt, device=dev))
