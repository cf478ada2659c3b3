"""The RT-DETR criterion (counterpart of the JAX package's
``models/utils/loss.py``): the Hungarian matching cost, the assignment by
a Jacobi auction, the per-layer varifocal + L1 + GIoU losses, the
contrastive-denoising losses on the known dn assignment, and their sum over
the decoder layers and the encoder proposals at full gain (no 1 / L).

The auction is JAX's (``_auction_one``): persons are GTs, objects are
queries, one phase at a fixed ``eps = spread / (200 G)`` with G the padded
GT width, zero initial prices, every unassigned GT bidding each round, the
first index on every argmax, at most 600 rounds and then a greedy
completion in GT order. A round in which every valid GT holds a query
changes nothing, so the port solves every image of every layer of a step as
one batch and asks the host whether all are done only every
``CHECK_EVERY`` rounds: the answer is JAX's, bit for bit on the same cost.
``hungarian_assign.rounds``, ``.syncs`` and ``.solves`` count the rounds
run, the host syncs and the solves (the caller zeroes them). In a process
group (``parallel/mesh.py``) the GT counts that normalize the losses are
summed over the ranks.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops.boxes import bbox_iou, xywh2xyxy
from ...parallel.mesh import all_sum

_NEG = -1e9
MAX_ROUNDS = 600
CHECK_EVERY = 10


def _no_mark(stage: str):
    pass


def _auction_round(value, eps, valid, prices, p2o, o2p):
    """One Jacobi round over a batch: value (N, G, Q) person benefit, eps
    (N,), valid (N, G); prices (N, Q), p2o (N, G), o2p (N, Q) updated in
    place."""
    N, G, Q = value.shape
    bidders = valid & (p2o < 0)
    net = value - prices[:, None, :]
    i1 = net.argmax(-1)  # (N, G), the first best object
    b1 = net.gather(-1, i1[..., None])[..., 0]
    b2 = net.scatter(-1, i1[..., None], _NEG).amax(-1)
    bid = prices.gather(1, i1) + (b1 - b2) + eps[:, None]
    bid = torch.where(bidders, bid, torch.full_like(bid, _NEG))
    bids = torch.full_like(value, _NEG).scatter_(-1, i1[..., None], bid[..., None])
    obj_bid, obj_winner = bids.amax(1), bids.argmax(1)  # (N, Q): the first best bidder
    won = obj_bid > _NEG
    # the previous owners of the re-priced objects lose them
    lost = torch.zeros((N, G + 1), dtype=torch.bool, device=value.device)
    lost.scatter_(1, torch.where(won & (o2p >= 0), o2p, G), True)
    p2o.masked_fill_(lost[:, :G], -1)
    o2p.copy_(torch.where(won, obj_winner, o2p))
    p2o_ext = torch.cat([p2o, p2o.new_full((N, 1), -1)], 1)
    arange_q = torch.arange(Q, device=value.device).expand(N, Q)
    p2o_ext.scatter_(1, torch.where(won, obj_winner, G), arange_q)
    p2o.copy_(p2o_ext[:, :G])
    prices.copy_(torch.where(won, obj_bid, prices))


def hungarian_assign(cost: torch.Tensor, n_valid: torch.Tensor,
                     max_rounds: int = MAX_ROUNDS) -> torch.Tensor:
    """cost (N, Q, G), n_valid (N,) -> assignment (N, G), the query of each
    GT, -1 for padded GTs (see the module docstring)."""
    N, Q, G = cost.shape
    hungarian_assign.solves += 1
    if G == 0 or N == 0:
        return torch.full((N, G), -1, dtype=torch.long, device=cost.device)
    dev = cost.device
    value = -cost.transpose(1, 2).float()  # (N, G, Q)
    valid = torch.arange(G, device=dev)[None] < n_valid[:, None]
    v_real = torch.where(valid[..., None], value, torch.zeros_like(value))
    spread = (v_real.amax((1, 2)) - v_real.amin((1, 2))).clamp_min(1e-6)
    eps = spread / (200.0 * G)
    prices = torch.zeros((N, Q), dtype=torch.float32, device=dev)
    p2o = torch.full((N, G), -1, dtype=torch.long, device=dev)
    o2p = torch.full((N, Q), -1, dtype=torch.long, device=dev)
    rounds = 0
    while rounds < max_rounds:
        n = min(CHECK_EVERY, max_rounds - rounds)
        for _ in range(n):
            _auction_round(value, eps, valid, prices, p2o, o2p)
        rounds += n
        hungarian_assign.syncs += 1
        if not bool((valid & (p2o < 0)).any()):
            break
    hungarian_assign.rounds += rounds
    if rounds >= max_rounds and bool((valid & (p2o < 0)).any()):
        # greedy completion: each still unassigned valid GT, in order, takes
        # its best free query
        for g in range(G):
            need = valid[:, g] & (p2o[:, g] < 0)
            o = torch.where(o2p < 0, value[:, g], torch.full_like(value[:, g], _NEG)).argmax(-1)
            p2o[:, g] = torch.where(need, o, p2o[:, g])
            cur = o2p.gather(1, o[:, None])[:, 0]
            o2p.scatter_(1, o[:, None], torch.where(need, torch.full_like(cur, g), cur)[:, None])
    return torch.where(valid, p2o, torch.full_like(p2o, -1))


hungarian_assign.rounds = hungarian_assign.syncs = hungarian_assign.solves = 0


def match_cost(pred_boxes, pred_logits, gt_boxes, gt_labels, mask_gt, cost_class: float = 2.0,
               cost_bbox: float = 5.0, cost_giou: float = 2.0, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    """(B, Q, 4) normalized cxcywh, (B, Q, nc) logits, (B, G, 4), (B, G),
    (B, G) -> cost (B, Q, G): the focal class cost, L1 and 1 - GIoU; 1e6
    for padded GTs."""
    prob = torch.sigmoid(pred_logits)
    idx = gt_labels.long().clamp(0, prob.shape[-1] - 1)[:, None, :].expand(-1, prob.shape[1], -1)
    sel = prob.gather(2, idx)  # (B, Q, G)
    pos_cost = alpha * ((1 - sel) ** gamma) * (-torch.log(sel + 1e-8))
    neg_cost = (1 - alpha) * (sel ** gamma) * (-torch.log(1 - sel + 1e-8))
    c_class = pos_cost - neg_cost
    c_l1 = (pred_boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    giou = bbox_iou(xywh2xyxy(pred_boxes)[:, :, None, :], xywh2xyxy(gt_boxes)[:, None, :, :],
                    xywh=False, GIoU=True)
    cost = cost_class * c_class + cost_bbox * c_l1 + cost_giou * (1.0 - giou)
    return torch.where(mask_gt[:, None, :], cost, torch.full_like(cost, 1e6))


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)``: ``minimum(maximum(x, 0), 1)``, whose gradient
    is halved at a bound, as JAX's."""
    return torch.minimum(torch.maximum(x, x.new_tensor(0.0)), x.new_tensor(1.0))


def _vfl(logits, t, onehot, alpha: float, gamma: float):
    """The varifocal loss (reference ``VarifocalLoss``), summed: weight
    ``alpha * p^gamma`` off the label, the IoU score on it."""
    prob = torch.sigmoid(logits)
    weight = alpha * (prob ** gamma) * (1 - onehot) + t * onehot
    bce = -(t * torch.log(prob + 1e-8) + (1 - t) * torch.log(1 - prob + 1e-8))
    return (bce * weight).sum()


def detr_layer_loss(pred_boxes, pred_logits, gt_boxes, gt_labels, mask_gt, assign, nc: int,
                    alpha: float = 0.75, gamma: float = 2.0):
    """One layer's (class, L1, GIoU) losses given the (B, G) GT -> query
    assignment. Padded GTs scatter to the out-of-range query Q and are
    dropped (clipped to 0 they would overwrite query 0's target)."""
    B, Q, _ = pred_logits.shape
    n_gt = all_sum(mask_gt.sum()).to(pred_logits.dtype).clamp_min(1.0)
    assign_safe = assign.clamp(0, Q - 1)
    drop_idx = torch.where(mask_gt, assign_safe, torch.full_like(assign_safe, Q))
    tgt_cls = torch.full((B, Q + 1), nc, dtype=torch.long, device=pred_logits.device)
    tgt_cls = tgt_cls.scatter(1, drop_idx, gt_labels.long())[:, :Q]
    matched = pred_boxes.gather(1, assign_safe[..., None].expand(-1, -1, 4))  # (B, G, 4)
    iou_g = bbox_iou(xywh2xyxy(matched), xywh2xyxy(gt_boxes), xywh=False)
    iou_q = torch.zeros((B, Q), dtype=iou_g.dtype, device=iou_g.device).scatter_add(
        1, assign_safe, torch.where(mask_gt, _clip01(iou_g), torch.zeros_like(iou_g)))
    onehot = F.one_hot(tgt_cls, nc + 1)[..., :nc].to(pred_logits.dtype)
    t_score = onehot * iou_q[..., None]
    loss_cls = _vfl(pred_logits, t_score, onehot, alpha, gamma) / n_gt
    m = mask_gt[..., None]
    loss_l1 = (torch.where(m, matched, torch.zeros_like(matched))
               - torch.where(m, gt_boxes, torch.zeros_like(gt_boxes))).abs().sum() / n_gt
    giou = bbox_iou(xywh2xyxy(matched), xywh2xyxy(gt_boxes), xywh=False, GIoU=True)
    loss_giou = torch.where(mask_gt, 1.0 - giou, torch.zeros_like(giou)).sum() / n_gt
    return loss_cls, loss_l1, loss_giou


def detr_dn_layer_loss(pb, pl, gt_boxes, gt_labels, mask_gt, nc: int, alpha: float = 0.75,
                       gamma: float = 2.0):
    """One layer's denoising losses on the known assignment: dn query
    (group g, positive slot, GT n) is GT n's, the negative slot is
    background. pb (B, G, 2, N, 4), pl (B, G, 2, N, nc)."""
    B, G, _, N, _ = pb.shape
    n_gt = (all_sum(mask_gt.sum()) * G).to(pl.dtype).clamp_min(1.0)
    gt_b = gt_boxes[:, None].expand(B, G, N, 4)
    gt_c = gt_labels.long()[:, None].expand(B, G, N)
    m = mask_gt[:, None].expand(B, G, N)
    pos_b, pos_l, neg_l = pb[:, :, 0], pl[:, :, 0], pl[:, :, 1]
    iou = _clip01(bbox_iou(xywh2xyxy(pos_b), xywh2xyxy(gt_b), xywh=False))
    onehot_pos = F.one_hot(gt_c, nc).to(pl.dtype) * m[..., None]
    t_pos = onehot_pos * iou[..., None]
    zeros = torch.zeros_like(t_pos)
    loss_cls = (_vfl(pos_l, t_pos, onehot_pos, alpha, gamma)
                + _vfl(neg_l, zeros, zeros, alpha, gamma)) / n_gt
    loss_l1 = ((pos_b - gt_b).abs().sum(-1) * m).sum() / n_gt
    giou = bbox_iou(xywh2xyxy(pos_b), xywh2xyxy(gt_b), xywh=False, GIoU=True)
    loss_giou = ((1.0 - giou) * m).sum() / n_gt
    return loss_cls, loss_l1, loss_giou


def _gt(batch):
    return batch["bboxes"].float(), batch["cls"].long(), batch["mask_gt"].bool()


def rtdetr_assign(outs: Tuple, batch: Dict[str, torch.Tensor], dn_q: int = 0) -> torch.Tensor:
    """The matching of every decoder layer and of the encoder proposals:
    (L + 1, B, G), each layer's matching queries (those after the ``dn_q``
    dn queries) against the GTs on detached predictions, one auction for
    all."""
    dec_bboxes, dec_scores, enc_bboxes, enc_scores = outs
    gt_boxes, gt_labels, mask_gt = _gt(batch)
    with torch.no_grad():
        pb = torch.cat([dec_bboxes[:, :, dn_q:], enc_bboxes[None]])  # (L + 1, B, Q, 4)
        pl = torch.cat([dec_scores[:, :, dn_q:], enc_scores[None]])
        L1, B = pb.shape[:2]
        rep = lambda t: t.repeat(L1, *([1] * (t.dim() - 1)))  # noqa: E731
        cost = match_cost(pb.flatten(0, 1), pl.flatten(0, 1), rep(gt_boxes), rep(gt_labels),
                          rep(mask_gt))
        assign = hungarian_assign(cost, rep(mask_gt.sum(-1)))
    return assign.reshape(L1, B, -1)


def rtdetr_loss(outs: Tuple, batch: Dict[str, torch.Tensor], nc: int,
                dn: Optional[Dict[str, torch.Tensor]] = None, gain_class: float = 1.0,
                gain_bbox: float = 5.0, gain_giou: float = 2.0,
                mark: Optional[Callable[[str], None]] = None, assign=None):
    """The criterion over every decoder layer and the encoder proposals,
    and with ``dn`` (``get_cdn_group``'s dict; the decoder's first G * 2 *
    N queries are its groups) the denoising losses; boxes are normalized
    cxcywh. ``mark`` is called with "matching" and "loss" as each starts;
    ``assign`` (``rtdetr_assign``'s) skips the matching. Returns (total,
    items)."""
    mark = mark or _no_mark
    dec_bboxes, dec_scores, enc_bboxes, enc_scores = outs
    gt_boxes, gt_labels, mask_gt = _gt(batch)
    dn_q = 0
    if dn is not None:
        _, G, two, N = dn["labels"].shape
        dn_q = G * two * N
    mark("matching")
    if assign is None:
        assign = rtdetr_assign(outs, batch, dn_q)
    mark("loss")
    L, B = dec_bboxes.shape[:2]
    totals = {"cls_loss": 0.0, "l1_loss": 0.0, "giou_loss": 0.0}
    dn_totals = {"dn_cls_loss": 0.0, "dn_l1_loss": 0.0, "dn_giou_loss": 0.0}
    for i in range(L):
        parts = detr_layer_loss(dec_bboxes[i][:, dn_q:], dec_scores[i][:, dn_q:], gt_boxes,
                                gt_labels, mask_gt, assign[i], nc)
        for k, v in zip(totals, parts):
            totals[k] = totals[k] + v
        if dn_q:
            pb = dec_bboxes[i][:, :dn_q].reshape(B, G, two, N, 4)
            pl = dec_scores[i][:, :dn_q].reshape(B, G, two, N, nc)
            for k, v in zip(dn_totals, detr_dn_layer_loss(pb, pl, gt_boxes, gt_labels, mask_gt,
                                                          nc)):
                dn_totals[k] = dn_totals[k] + v
    parts = detr_layer_loss(enc_bboxes, enc_scores, gt_boxes, gt_labels, mask_gt, assign[L], nc)
    for k, v in zip(totals, parts):
        totals[k] = totals[k] + v
    gains = (gain_class, gain_bbox, gain_giou)
    items = {k: v * g for (k, v), g in zip(totals.items(), gains)}
    if dn_q:
        items.update({k: v * g for (k, v), g in zip(dn_totals.items(), gains)})
    total = sum(items.values())
    return total, items
