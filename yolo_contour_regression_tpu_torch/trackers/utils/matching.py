"""Association costs and the gated assignment of the trackers (counterpart
of the JAX package's ``trackers/utils/matching.py``): ``bbox_ious``,
``iou_distance``, ``embedding_distance``, ``fuse_score`` and
``linear_assignment``, whose solver is ``lsa.linear_sum_assignment``
(scipy's assignment, ties included, without scipy).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .lsa import linear_sum_assignment


def bbox_ious(a: np.ndarray, b: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU, numpy."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / (area_a[:, None] + area_b[None, :] - inter + eps)


def iou_distance(atracks: List, btracks: List) -> np.ndarray:
    """1 - IoU between track xyxy boxes."""
    a = np.asarray([t.xyxy for t in atracks], np.float32).reshape(-1, 4)
    b = np.asarray([t.xyxy for t in btracks], np.float32).reshape(-1, 4)
    return 1.0 - bbox_ious(a, b)


def embedding_distance(tracks: List, detections: List, metric: str = "cosine") -> np.ndarray:
    """Appearance cosine distance (BoT-SORT ReID branch)."""
    n, m = len(tracks), len(detections)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    tf = np.asarray([t.smooth_feat for t in tracks], np.float32)
    df = np.asarray([d.curr_feat for d in detections], np.float32)
    tf = tf / (np.linalg.norm(tf, axis=1, keepdims=True) + 1e-9)
    df = df / (np.linalg.norm(df, axis=1, keepdims=True) + 1e-9)
    return np.clip(1.0 - tf @ df.T, 0.0, None)


def fuse_score(cost_matrix: np.ndarray, detections: List) -> np.ndarray:
    """Blend the detections' confidence into the IoU cost."""
    if cost_matrix.size == 0:
        return cost_matrix
    iou_sim = 1.0 - cost_matrix
    det_scores = np.asarray([d.score for d in detections], np.float32)
    fused = iou_sim * det_scores[None, :]
    return 1.0 - fused


def linear_assignment(
    cost_matrix: np.ndarray, thresh: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hungarian with cost gate. Returns (matches (K,2), unmatched_a, unmatched_b)."""
    if cost_matrix.size == 0:
        return (
            np.zeros((0, 2), int),
            np.arange(cost_matrix.shape[0]),
            np.arange(cost_matrix.shape[1]),
        )
    gated = np.where(cost_matrix > thresh, thresh + 1e-4, cost_matrix)
    rows, cols = linear_sum_assignment(gated)
    matches = [(r, c) for r, c in zip(rows, cols) if cost_matrix[r, c] <= thresh]
    matched_a = {r for r, _ in matches}
    matched_b = {c for _, c in matches}
    unmatched_a = np.asarray([i for i in range(cost_matrix.shape[0]) if i not in matched_a], int)
    unmatched_b = np.asarray([j for j in range(cost_matrix.shape[1]) if j not in matched_b], int)
    return np.asarray(matches, int).reshape(-1, 2), unmatched_a, unmatched_b
