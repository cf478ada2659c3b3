"""Evaluation metrics: TP matching, AP and the metric containers (a numpy
copy of the JAX package's ``utils/metrics.py``, without plots; the confusion
matrix takes its box IoU from ``ops/boxes.py``).

``match_predictions`` is the reference's dedupe (candidate pairs sorted by
IoU, one per detection, then one per label); ``compute_ap`` the 101-point
interpolated AP; ``ap_per_class`` per-class P, R and AP at the 10 IoU
thresholds; ``kpt_iou`` the keypoints' OKS; ``Metric``, ``DetMetrics``,
``SegmentMetrics`` and ``PoseMetrics`` accumulate per-image TP tables and
give ``results_dict``; ``ClassifyMetrics`` counts top-1 and top-5 hits.
Host-side numpy: the tables are small.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.boxes import box_iou

IOU_THRESHES = np.linspace(0.5, 0.95, 10)

# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def kpt_iou(kpt1: np.ndarray, kpt2: np.ndarray, area: np.ndarray, sigma: np.ndarray,
            eps: float = 1e-7) -> np.ndarray:
    """OKS of GT keypoints (N, K, 3) against predicted ones (M, K, 3), given
    the GT areas (N,) and the sigmas (K,) -> (N, M): ``exp(-d^2 / (2
    sigma)^2 / (area + eps) / 2)`` averaged over each GT's visible
    keypoints."""
    d = (kpt1[:, None, :, 0] - kpt2[None, :, :, 0]) ** 2 + (
        kpt1[:, None, :, 1] - kpt2[None, :, :, 1]) ** 2
    kpt_mask = kpt1[..., 2] != 0  # (N, K)
    e = d / (2 * sigma) ** 2 / (area[:, None, None] + eps) / 2
    return (np.exp(-e) * kpt_mask[:, None]).sum(-1) / (kpt_mask.sum(-1)[:, None] + eps)


def match_predictions(
    pred_classes: np.ndarray,  # (M,)
    true_classes: np.ndarray,  # (N,)
    iou: np.ndarray,  # (N, M) gt x pred
    thresholds: np.ndarray = IOU_THRESHES,
) -> np.ndarray:
    """TP matching at each IoU threshold with the reference's dedupe:
    candidate pairs at or above the threshold, sorted by IoU descending
    (``np.argsort``'s default sort, whose order among ties is the
    reference's), deduped to one pair per detection (its highest-IoU pair),
    then to one per label. Classes must agree. A detection whose best pair
    loses the label dedupe does not fall back to its next pair. Returns
    (M, T) bool."""
    correct = np.zeros((pred_classes.shape[0], thresholds.shape[0]), bool)
    correct_class = true_classes[:, None] == pred_classes[None, :]
    iou = np.where(correct_class, iou, 0.0)
    for ti, t in enumerate(thresholds):
        gi, pi = np.nonzero(iou >= t)
        if gi.size == 0:
            continue
        if gi.size > 1:
            order = np.argsort(-iou[gi, pi])
            gi, pi = gi[order], pi[order]
            _, first = np.unique(pi, return_index=True)
            gi, pi = gi[first], pi[first]
            _, first = np.unique(gi, return_index=True)
            gi, pi = gi[first], pi[first]
        correct[pi, ti] = True
    return correct


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP; returns (ap, envelope precision, recall)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return float(ap), mpre, mrec


def ap_per_class(
    tp: np.ndarray,  # (M, T) bool
    conf: np.ndarray,  # (M,)
    pred_cls: np.ndarray,  # (M,)
    target_cls: np.ndarray,  # (Ngt,)
    eps: float = 1e-16,
) -> Dict[str, np.ndarray]:
    """Per-class precision, recall and AP at every IoU threshold; P and R are
    taken at the confidence of the best F1 on the 0.5 curve."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]
    T = tp.shape[1] if tp.ndim == 2 else 1
    ap = np.zeros((nc, T))
    p = np.zeros(nc)
    r = np.zeros(nc)
    rx = np.linspace(0, 1, 101)
    p_curve = np.zeros((nc, 101))  # precision at IoU 0.5 over the recall grid
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = nt[ci]
        n_p = int(sel.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        for ti in range(T):
            ap[ci, ti], mpre, mrec = compute_ap(recall[:, ti], precision[:, ti])
            if ti == 0:
                p_curve[ci] = np.interp(rx, mrec, mpre)
        f1 = 2 * precision[:, 0] * recall[:, 0] / (precision[:, 0] + recall[:, 0] + eps)
        i = int(f1.argmax())
        p[ci] = precision[i, 0]
        r[ci] = recall[i, 0]
    return {
        "classes": unique_classes,
        "precision": p,
        "recall": r,
        "ap": ap,  # (nc, T)
        "ap50": ap[:, 0],
        "map50": float(ap[:, 0].mean()) if nc else 0.0,
        "map": float(ap.mean()) if nc else 0.0,
        "mp": float(p.mean()) if nc else 0.0,
        "mr": float(r.mean()) if nc else 0.0,
        "pr_curve": (rx, p_curve),
    }


class ConfusionMatrix:
    """Detection confusion matrix: rows predicted class, columns true class,
    index ``nc`` the background."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1), np.int64)

    def process_batch(self, pred_boxes, pred_cls, pred_conf, gt_boxes, gt_cls):
        keep = pred_conf > self.conf
        pred_boxes, pred_cls = pred_boxes[keep], pred_cls[keep].astype(int)
        gt_cls = gt_cls.astype(int)
        if gt_boxes.shape[0] == 0:
            for c in pred_cls:
                self.matrix[c, self.nc] += 1  # false positive
            return
        if pred_boxes.shape[0] == 0:
            for c in gt_cls:
                self.matrix[self.nc, c] += 1  # false negative
            return
        iou = box_iou(torch.from_numpy(gt_boxes), torch.from_numpy(pred_boxes)).numpy()
        gi, pi = np.nonzero(iou > self.iou_thres)
        matched_g, matched_p = set(), set()
        order = np.argsort(-iou[gi, pi])
        for g, p in zip(gi[order], pi[order]):
            if g in matched_g or p in matched_p:
                continue
            matched_g.add(g)
            matched_p.add(p)
            self.matrix[pred_cls[p], gt_cls[g]] += 1
        for g in range(gt_boxes.shape[0]):
            if g not in matched_g:
                self.matrix[self.nc, gt_cls[g]] += 1
        for p in range(pred_boxes.shape[0]):
            if p not in matched_p:
                self.matrix[pred_cls[p], self.nc] += 1


class Metric:
    """Accumulates (tp, conf, cls, target_cls) rows; ``process`` gives P, R
    and mAP."""

    def __init__(self):
        self.stats: List[Tuple] = []
        self.results: Dict[str, np.ndarray] = {}

    def update(self, tp, conf, pred_cls, target_cls):
        self.stats.append((tp, conf, pred_cls, target_cls))

    def process(self):
        if not self.stats:
            self.results = {}
            return self.results
        tp = np.concatenate([s[0] for s in self.stats])
        conf = np.concatenate([s[1] for s in self.stats])
        pcls = np.concatenate([s[2] for s in self.stats])
        tcls = np.concatenate([s[3] for s in self.stats])
        self.results = ap_per_class(tp, conf, pcls, tcls)
        return self.results

    @property
    def map(self):
        return self.results.get("map", 0.0)

    @property
    def map50(self):
        return self.results.get("map50", 0.0)

    @property
    def mp(self):
        return self.results.get("mp", 0.0)

    @property
    def mr(self):
        return self.results.get("mr", 0.0)


class DetMetrics:
    """Box metrics."""

    def __init__(self, names=None):
        self.box = Metric()
        self.names = names or {}
        self.speed = {}

    def process(self):
        return self.box.process()

    @property
    def results_dict(self):
        return {
            "metrics/precision(B)": self.box.mp,
            "metrics/recall(B)": self.box.mr,
            "metrics/mAP50(B)": self.box.map50,
            "metrics/mAP50-95(B)": self.box.map,
            "fitness": self.fitness,
        }

    @property
    def fitness(self):
        return 0.1 * self.box.map50 + 0.9 * self.box.map


class SegmentMetrics(DetMetrics):
    """Box and mask metrics."""

    def __init__(self, names=None):
        super().__init__(names)
        self.seg = Metric()

    def process(self):
        return super().process(), self.seg.process()

    @property
    def results_dict(self):
        d = super().results_dict
        d.update(
            {
                "metrics/precision(M)": self.seg.mp,
                "metrics/recall(M)": self.seg.mr,
                "metrics/mAP50(M)": self.seg.map50,
                "metrics/mAP50-95(M)": self.seg.map,
            }
        )
        d["fitness"] = self.fitness
        return d

    @property
    def fitness(self):
        box_f = 0.1 * self.box.map50 + 0.9 * self.box.map
        seg_f = 0.1 * self.seg.map50 + 0.9 * self.seg.map
        return box_f + seg_f


class PoseMetrics(DetMetrics):
    """Box and keypoint (OKS) metrics. Its fitness is the box metrics' alone,
    as the JAX package's ``PoseMetrics`` keeps ``DetMetrics.fitness``."""

    def __init__(self, names=None):
        super().__init__(names)
        self.pose = Metric()

    def process(self):
        return super().process(), self.pose.process()

    @property
    def results_dict(self):
        d = super().results_dict
        d.update(
            {
                "metrics/precision(P)": self.pose.mp,
                "metrics/recall(P)": self.pose.mr,
                "metrics/mAP50(P)": self.pose.map50,
                "metrics/mAP50-95(P)": self.pose.map,
            }
        )
        return d


class ClassifyMetrics:
    """Top-1 and top-5 accuracy (JAX ``ClassifyMetrics``): the classes
    ranked by ``np.argsort(-preds)`` (ties by lower class index), fitness
    their mean."""

    def __init__(self):
        self.top1 = 0.0
        self.top5 = 0.0
        self._correct1 = 0
        self._correct5 = 0
        self._n = 0

    def update(self, preds: np.ndarray, labels: np.ndarray):
        top5 = np.argsort(-preds, axis=1)[:, :5]
        self._correct1 += int((top5[:, 0] == labels).sum())
        self._correct5 += int((top5 == labels[:, None]).any(1).sum())
        self._n += labels.shape[0]

    def process(self):
        if self._n:
            self.top1 = self._correct1 / self._n
            self.top5 = self._correct5 / self._n
        return {"metrics/accuracy_top1": self.top1, "metrics/accuracy_top5": self.top5}

    @property
    def fitness(self) -> float:
        return (self.top1 + self.top5) / 2

    @property
    def results_dict(self) -> Dict[str, float]:
        d = self.process()
        d["fitness"] = self.fitness
        return d
