"""Label geometry (a numpy copy of the JAX package's ``data/instance.py``):
boxes, 360-point contours and keypoints scaled, translated, flipped, clipped,
selected and concatenated together, so the host transforms cannot desync
them."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..ops.polar import NUM_CONTOUR_POINTS


def resample_segment(seg: np.ndarray, n: int = NUM_CONTOUR_POINTS) -> np.ndarray:
    """(m, 2) polygon -> (n, 2) closed polyline resampled uniformly in vertex
    index (every label is resampled to 360 points at load)."""
    seg = np.asarray(seg, np.float32).reshape(-1, 2)
    if seg.shape[0] == 0:
        return np.zeros((n, 2), np.float32)
    s = np.concatenate([seg, seg[0:1]], 0)
    x = np.linspace(0, s.shape[0] - 1, n)
    xp = np.arange(s.shape[0])
    return np.stack([np.interp(x, xp, s[:, i]) for i in range(2)], -1).astype(np.float32)


def segments2boxes(segments: np.ndarray) -> np.ndarray:
    """(N, P, 2) -> (N, 4) xywh of each contour's extent."""
    if segments.shape[0] == 0:
        return np.zeros((0, 4), np.float32)
    x1 = segments[..., 0].min(1)
    y1 = segments[..., 1].min(1)
    x2 = segments[..., 0].max(1)
    y2 = segments[..., 1].max(1)
    return np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


class Instances:
    """cls (N,), bboxes (N, 4) xyxy, segments (N, 360, 2) and optional
    keypoints (N, K, 3), in pixels, float32 (the geometry leaves a
    keypoint's visibility as it is)."""

    def __init__(self, cls: np.ndarray, bboxes: np.ndarray, segments: np.ndarray,
                 keypoints: Optional[np.ndarray] = None):
        self.cls = np.asarray(cls, np.float32).reshape(-1)
        self.bboxes = np.asarray(bboxes, np.float32).reshape(-1, 4)
        if segments.size == 0:
            segments = np.zeros((len(self.cls), NUM_CONTOUR_POINTS, 2), np.float32)
        self.segments = np.asarray(segments, np.float32)
        self.keypoints = None if keypoints is None else np.asarray(keypoints, np.float32)

    def __len__(self):
        return self.cls.shape[0]

    def copy(self) -> "Instances":
        return Instances(self.cls.copy(), self.bboxes.copy(), self.segments.copy(),
                         None if self.keypoints is None else self.keypoints.copy())

    def scale(self, sx: float, sy: float):
        self.bboxes[:, [0, 2]] *= sx
        self.bboxes[:, [1, 3]] *= sy
        self.segments[..., 0] *= sx
        self.segments[..., 1] *= sy
        if self.keypoints is not None:
            self.keypoints[..., 0] *= sx
            self.keypoints[..., 1] *= sy

    def translate(self, dx: float, dy: float):
        self.bboxes[:, [0, 2]] += dx
        self.bboxes[:, [1, 3]] += dy
        self.segments[..., 0] += dx
        self.segments[..., 1] += dy
        if self.keypoints is not None:
            self.keypoints[..., 0] += dx
            self.keypoints[..., 1] += dy

    def fliplr(self, w: int, flip_idx=None):
        """Mirror about x = w/2; with ``flip_idx`` the keypoints also swap
        identity (left <-> right) by that permutation."""
        x1 = self.bboxes[:, 0].copy()
        self.bboxes[:, 0] = w - self.bboxes[:, 2]
        self.bboxes[:, 2] = w - x1
        self.segments[..., 0] = w - self.segments[..., 0]
        if self.keypoints is not None:
            self.keypoints[..., 0] = w - self.keypoints[..., 0]
            if flip_idx is not None:
                self.keypoints = self.keypoints[:, list(flip_idx), :]

    def flipud(self, h: int):
        y1 = self.bboxes[:, 1].copy()
        self.bboxes[:, 1] = h - self.bboxes[:, 3]
        self.bboxes[:, 3] = h - y1
        self.segments[..., 1] = h - self.segments[..., 1]
        if self.keypoints is not None:
            self.keypoints[..., 1] = h - self.keypoints[..., 1]

    def clip(self, w: int, h: int):
        """Boxes and contours clipped to [0, w] x [0, h] (keypoints kept)."""
        self.bboxes[:, [0, 2]] = self.bboxes[:, [0, 2]].clip(0, w)
        self.bboxes[:, [1, 3]] = self.bboxes[:, [1, 3]].clip(0, h)
        self.segments[..., 0] = self.segments[..., 0].clip(0, w)
        self.segments[..., 1] = self.segments[..., 1].clip(0, h)

    def sync_boxes_from_segments(self):
        """Each instance with a contour (any nonzero point) takes its box
        from the contour's extent."""
        has_seg = self.segments.reshape(len(self), -1).any(1)
        if has_seg.any():
            xywh = segments2boxes(self.segments[has_seg])
            self.bboxes[has_seg] = np.concatenate(
                [xywh[:, :2] - xywh[:, 2:] / 2, xywh[:, :2] + xywh[:, 2:] / 2], -1)

    def remove_degenerate(self, min_wh: float = 2.0) -> "Instances":
        """The instances whose box is wider and taller than ``min_wh``."""
        w = self.bboxes[:, 2] - self.bboxes[:, 0]
        h = self.bboxes[:, 3] - self.bboxes[:, 1]
        return self.select((w > min_wh) & (h > min_wh))

    def select(self, keep) -> "Instances":
        return Instances(self.cls[keep], self.bboxes[keep], self.segments[keep],
                         None if self.keypoints is None else self.keypoints[keep])

    @staticmethod
    def concatenate(items: List["Instances"]) -> "Instances":
        """One set of all the instances, in order; keypoints only if every
        part has them."""
        if not items:
            return Instances(np.zeros(0), np.zeros((0, 4)), np.zeros((0, NUM_CONTOUR_POINTS, 2)))
        kpts = None
        if all(i.keypoints is not None for i in items):
            kpts = np.concatenate([i.keypoints for i in items])
        return Instances(np.concatenate([i.cls for i in items]),
                         np.concatenate([i.bboxes for i in items]),
                         np.concatenate([i.segments for i in items]), kpts)
