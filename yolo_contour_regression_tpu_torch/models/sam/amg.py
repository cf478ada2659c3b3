"""Everything-mode helpers (counterpart of the JAX package's
``models/sam/amg.py``): the point grids, crop boxes, mask boxes, the
crop-edge filter and box NMS, host numpy as in JAX (the NMS keeps
``np.argsort(-scores)``, so ties break as JAX's do); the stability score
in torch on the logits' device, as JAX's device filter; and the
small-region cleanup, whose ``cv2.connectedComponentsWithStats`` is an
8-connected labelling in numpy here (``label_components``, cv2's label
order). ``resize_bilinear`` is ``jax.image.resize(..., "bilinear")``
written out in torch: the triangle kernel, widened when it shrinks
(antialiased), as separable weight matrices.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) evenly spaced normalized points."""
    offset = 1 / (2 * n_per_side)
    side = np.linspace(offset, 1 - offset, n_per_side)
    gx, gy = np.meshgrid(side, side)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def build_all_layer_point_grids(n_per_side: int, n_layers: int, scale_per_layer: int):
    return [point_grid(int(n_per_side / (scale_per_layer ** i))) for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int,
                        overlap_ratio: float = 512 / 1500):
    """The whole image, then 2^(i+1) x 2^(i+1) overlapping crops a layer, as
    [x0, y0, x1, y1] lists with their layer indices."""
    boxes, layer_idxs = [], []
    h, w = im_size
    boxes.append([0, 0, w, h])
    layer_idxs.append(0)

    def crop_len(orig, n_crops, overlap):
        return int(np.ceil((overlap * (n_crops - 1) + orig) / n_crops))

    for i in range(n_layers):
        n = 2 ** (i + 1)
        overlap = int(overlap_ratio * min(h, w) * (2 / n))
        cw = crop_len(w, n, overlap)
        ch = crop_len(h, n, overlap)
        x0s = [int((cw - overlap) * k) for k in range(n)]
        y0s = [int((ch - overlap) * k) for k in range(n)]
        for x0 in x0s:
            for y0 in y0s:
                boxes.append([x0, y0, min(x0 + cw, w), min(y0 + ch, h)])
                layer_idxs.append(i + 1)
    return boxes, layer_idxs


def stability_score(masks: torch.Tensor, mask_threshold, offset) -> torch.Tensor:
    """Logits (..., H, W) -> the pixels above ``threshold + offset`` over
    the pixels above ``threshold - offset``, float32 on the logits' device
    (the thresholds floats or float32 tensors, as JAX's device filter)."""
    hi = (masks > mask_threshold + offset).sum((-1, -2)).float()
    lo = (masks > mask_threshold - offset).sum((-1, -2)).float()
    return hi / torch.clamp(lo, min=1.0)


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) bool -> (N, 4) xyxy, half-open; an empty mask gives zeros."""
    n, h, w = masks.shape
    if n == 0:
        return np.zeros((0, 4), np.float32)
    rows = masks.any(2)
    cols = masks.any(1)
    y0 = rows.argmax(1)
    y1 = h - rows[:, ::-1].argmax(1)
    x0 = cols.argmax(1)
    x1 = w - cols[:, ::-1].argmax(1)
    out = np.stack([x0, y0, x1, y1], -1).astype(np.float32)
    out[~rows.any(1)] = 0.0
    return out


def is_box_near_crop_edge(boxes_xyxy: np.ndarray, crop_box, orig_box,
                          atol: float = 20.0) -> np.ndarray:
    """True where a box (image coordinates) lies within ``atol`` of its
    crop's edge but not of the image's: a partial object."""
    crop = np.asarray(crop_box, np.float32)
    orig = np.asarray(orig_box, np.float32)
    boxes = np.asarray(boxes_xyxy, np.float32)
    near_crop = np.abs(boxes - crop[None]) <= atol
    near_orig = np.abs(boxes - orig[None]) <= atol
    return (near_crop & ~near_orig).any(1)


def nms_boxes(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float) -> np.ndarray:
    """Greedy box NMS on the host; kept indices in descending-score order."""
    if len(boxes) == 0:
        return np.zeros(0, np.int64)
    boxes = np.asarray(boxes, np.float32)
    areas = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    order = np.argsort(-np.asarray(scores))
    keep = []
    while len(order):
        i = order[0]
        keep.append(i)
        rest = order[1:]
        x0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        y0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        x1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        y1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        order = rest[iou <= iou_thresh]
    return np.asarray(keep, np.int64)


def label_components(mask: np.ndarray) -> Tuple[int, np.ndarray, np.ndarray]:
    """8-connected components of a 2-D mask, as ``cv2.connectedComponents
    WithStats(mask, 8)`` numbers them: background 0, then the components in
    the order cv2's block scan (Spaghetti, 2x2 blocks) meets them, the
    raster order of their first 2x2 block (the pixels of one block are all
    8-connected, so no two components share a first block). Returns (n
    labels with the background, labels (H, W) int32, areas (n,)).

    Each foreground pixel points at a parent (first itself); every round
    hooks each root to the smallest root among its pixels' 8 neighbours'
    and then flattens the pointer chains. At the fixed point each pixel
    points at its component's first pixel in raster order."""
    m = np.asarray(mask, bool)
    h, w = m.shape
    fg = np.flatnonzero(m)
    if fg.size == 0:
        return 1, np.zeros((h, w), np.int32), np.asarray([h * w], np.int64)
    big = h * w
    parent = np.arange(h * w + 1)
    parent[big] = big
    pad = np.full((h + 2, w + 2), big, np.int64)
    inner = np.where(m, np.arange(h * w).reshape(h, w), big)
    while True:
        pad[1:-1, 1:-1] = np.where(m, parent[inner], big)
        low = pad[1:-1, 1:-1].copy()
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                np.minimum(low, pad[dy:dy + h, dx:dx + w], out=low)
        roots = parent[fg]
        lows = low.reshape(-1)[fg]
        before = parent.copy()
        np.minimum.at(parent, roots, lows)
        while True:
            nxt = parent[parent]
            if np.array_equal(nxt, parent):
                break
            parent = nxt
        if np.array_equal(parent, before):
            break
    roots = parent[fg]
    uniq, inv = np.unique(roots, return_inverse=True)
    ys, xs = np.divmod(fg, w)
    block = (ys // 2) * ((w + 1) // 2) + xs // 2
    first = np.full(len(uniq), block.max() + 1)
    np.minimum.at(first, inv, block)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first)] = np.arange(len(uniq))
    labels = np.zeros(h * w, np.int32)
    labels[fg] = rank[inv].astype(np.int32) + 1
    areas = np.concatenate([[h * w - fg.size],
                            np.bincount(rank[inv], minlength=len(uniq))])
    return len(uniq) + 1, labels.reshape(h, w), areas.astype(np.int64)


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str):
    """Remove connected holes (``mode="holes"``) or islands (``"islands"``)
    smaller than ``area_thresh`` from one bool mask; in islands mode, when
    every island is small the largest is kept (the lowest label on a tie).
    Returns (mask, changed)."""
    assert mode in ("holes", "islands")
    invert = mode == "holes"
    n, regions, areas = label_components(np.asarray(mask, bool) ^ invert)
    sizes = areas[1:]
    small = [i + 1 for i, sz in enumerate(sizes) if sz < area_thresh]
    if not small:
        return mask.astype(bool), False
    fill = [0] + small
    if not invert:
        fill = [i for i in range(n) if i not in fill] or [int(np.argmax(sizes)) + 1]
    return np.isin(regions, fill), True


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """JAX ``compute_weight_mat`` for the triangle kernel, antialiased: the
    (n_in, n_out) float32 weights of one axis (its ``1 / scale`` taken in
    double and rounded to float32, as JAX's Python scalars are)."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    weights = torch.clamp(1.0 - x.abs(), min=0.0)
    total = weights.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``jax.image.resize(x, (n, height, width), "bilinear")`` of float32
    (n, h, w) on x's device: antialiased where it shrinks, as JAX's (plain
    ``F.interpolate`` is not, and differs by whole logits there); an axis
    whose size stays is left alone, as JAX leaves it."""
    if x.shape[1] != height:
        x = torch.einsum("nhw,hH->nHw", x, _resize_weights(x.shape[1], height, x.device))
    if x.shape[2] != width:
        x = torch.einsum("nhw,wW->nhW", x, _resize_weights(x.shape[2], width, x.device))
    return x
