"""Validators of the detect, segment, pose and segment_ori tasks: box (and
mask or keypoint) mAP in each image's own frame; and of the classify task:
top-1 and top-5 accuracy (counterparts of ``DetectionValidator``,
``SegmentationValidator``, ``PoseValidator``, ``SegmentationOriValidator``
and ``ClassificationValidator`` in the JAX package's
``engine/validator.py``; COCO JSON, plots, rect val and the dispatch
grouping are not ported).

Per batch, on the model's device (``eval_batch``). Detect: ``decode_detect``
and ``xywh2xyxy``, multi-label NMS in float32 with the scores as
probabilities, predicted and GT boxes mapped back through the letterbox
(``scale_boxes``) and their IoU. Segment: the conv graph and
``decode_polar_parts``, multi-label NMS on the logits, the boxes as for
detect, then the predicted 36-gons and GT 360-gons mapped back
(``scale_coords``), scaled by one factor per image onto an R x R grid and
compared by ``polygon_mask_iou`` (the even-odd fill kernel and a product of
the masks). Pose: as detect, with the decoded keypoints riding through NMS
as its extras and mapped back by ``scale_coords``; on the host the GT
keypoints go to the image's frame and the OKS (``kpt_iou``, the GT box area
x 0.53 as the object's area) decides the keypoint matches. Segment_ori: as
detect, NMS carrying the 32 mask coefficients; ``sigmoid(mc @ proto) >
0.5`` kept inside each box on the proto grid (the half-open test), the GT
masks filled there by the even-odd fill kernel (``gt_masks_at``), and the
mask IoUs by a product of the masks, in the letterbox frame at proto size.
On the host: the reference's TP matching at 10 IoU thresholds,
``DetMetrics``, ``SegmentMetrics`` or ``PoseMetrics`` and the confusion
matrix. Classify: the eval transform on the host, the model's
probabilities on the device, ``ClassifyMetrics`` on the host.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.build import ValLoader
from ..data.dataset import ClassificationDataset, ValDataset
from ..nn.modules.head import finalize_polar_extras
from ..ops.boxes import box_iou, scale_boxes, scale_coords, xywh2xyxy
from ..ops.nms import non_max_suppression, non_max_suppression_parts
from ..ops.polar import NUM_RAYS
from ..ops.raster import mask_products, polygon_mask_iou
from ..utils.loss import OKS_SIGMA, gt_masks_at, in_box_grid
from ..utils.metrics import (ClassifyMetrics, ConfusionMatrix, DetMetrics, PoseMetrics,
                             SegmentMetrics, kpt_iou, match_predictions)
from .predictor import _as_float, detect_xyxy

EVAL_KEYS = ("img", "bboxes", "segments", "mask_gt", "ori_shape", "ratio_pad")
DETECT_EVAL_KEYS = ("img", "bboxes", "mask_gt", "ori_shape", "ratio_pad")


def _no_mark(stage: str):
    pass


def grid_scale(ori_shape: torch.Tensor, grid: int) -> torch.Tensor:
    """The factor per image (B,) that maps its own frame onto the R x R mask
    grid: ``grid / max(h0, w0, 1)``, in float32 as the JAX package takes it."""
    return grid / ori_shape.max(-1).values.clamp_min(1.0)


class DetectionValidator:
    """Box mAP of a detect model over decoded images.

    ``conf``, ``iou``, ``max_det`` and ``pre_nms`` set the multi-label NMS;
    ``single_cls`` reads every label as class 0 (``ValDataset``).
    ``mark``, if given, is called with each device stage's name as it
    starts ("forward_nms", "scale_box_iou", and the segment task's
    "mask_iou") and "end" last, so that a caller can time the stages (a
    CUDA event per mark). After a call, ``speed`` holds ms per image: host
    preprocess, device eval (the copy of its outputs to the host included)
    and host matching with the metrics.
    """

    task = "detect"
    eval_keys = DETECT_EVAL_KEYS
    confusion = True  # the confusion matrix (JAX's RT-DETR validator keeps none)

    def __init__(self, imgsz: int = 640, batch: int = 16, conf: float = 0.001,
                 iou: float = 0.7, max_det: int = 300, pre_nms: int = 1024,
                 max_instances: int = 48, mark: Optional[Callable[[str], None]] = None,
                 single_cls: bool = False):
        self.imgsz, self.batch = int(imgsz), max(int(batch), 1)
        self.single_cls = bool(single_cls)
        self.nms_kw = dict(conf_thres=conf, iou_thres=iou, pre_nms=pre_nms, max_det=max_det)
        self.max_instances = int(max_instances)
        self.mark = mark or _no_mark
        self.speed: Dict[str, float] = {}

    def _scale_box_iou(self, boxes, batch):
        """Predicted boxes (letterbox px, xyxy) -> the image's frame, clipped
        to it; GT boxes (normalized letterbox xywh) -> the image's frame; and
        their IoU (B, N, max_det)."""
        img, ratio_pad, ori_shape = batch["img"], batch["ratio_pad"], batch["ori_shape"]
        H, W = img.shape[1:3]
        boxes_nat = scale_boxes(boxes, ratio_pad, ori_shape)
        wh = torch.tensor([W, H], dtype=torch.float32, device=img.device)
        gt_nat = scale_boxes(xywh2xyxy(batch["bboxes"]) * wh.repeat(2), ratio_pad, ori_shape)
        return boxes_nat, gt_nat, box_iou(gt_nat, boxes_nat)

    @torch.inference_mode()
    def eval_batch(self, model, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One collated batch (``eval_keys`` as tensors on the model's device;
        ``img`` (B, H, W, 3) uint8 RGB) -> the JAX eval function's outputs:
        ``boxes`` (B, max_det, 4) in the image's frame, ``scores``,
        ``classes``, ``valid``, ``ious_box`` (B, N, max_det) of GT against
        detections and ``gt_boxes`` (B, N, 4)."""
        mark = self.mark
        mark("forward_nms")
        pred = detect_xyxy(model.predict(_as_float(batch["img"]).permute(0, 3, 1, 2).contiguous()))
        out = non_max_suppression(pred.float(), nc=model.nc, multi_label=True, **self.nms_kw)
        mark("scale_box_iou")
        boxes_nat, gt_nat, ious_box = self._scale_box_iou(out["boxes"], batch)
        mark("end")
        return {"boxes": boxes_nat, "scores": out["scores"], "classes": out["classes"],
                "valid": out["valid"], "ious_box": ious_box, "gt_boxes": gt_nat}

    def new_metrics(self, names):
        return DetMetrics(names=names)

    def update(self, metrics, out: Dict[str, np.ndarray], bi: int, keep, gt_keep, pred_cls,
               conf, tcls, batch: Dict[str, np.ndarray]):
        """Image ``bi``'s TP tables into ``metrics`` (``batch`` is the
        collated host batch)."""
        tp = match_predictions(pred_cls, tcls, out["ious_box"][bi][gt_keep][:, keep])
        metrics.box.update(tp, conf, pred_cls, tcls)

    def loader(self, images, labels) -> ValLoader:
        return ValLoader(ValDataset(images, labels, self.imgsz, self.max_instances,
                                    single_cls=self.single_cls), self.batch)

    def __call__(self, model, images, labels=None, names=None
                 ) -> Dict[str, float]:
        """Validate ``model`` on ``images`` (HWC uint8 BGR, or a split on
        disk) and ``labels`` (see ``data/dataset.py:ValDataset``) -> the JAX
        ``results_dict``:
        precision, recall, mAP50 and mAP50-95 of boxes (B) (and for the
        segment task of masks (M)), and fitness."""
        device = next(model.parameters()).device
        names = names if names is not None else getattr(model, "names", {})
        metrics = self.new_metrics(names)
        cm = ConfusionMatrix(model.nc) if self.confusion else None
        t = dict.fromkeys(("preprocess", "eval", "matching"), 0.0)
        n_img = 0
        batches = iter(self.loader(images, labels))
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            dev = {k: torch.from_numpy(batch[k]).to(device) for k in self.eval_keys}
            t1 = time.perf_counter()
            out = {k: v.cpu().numpy() for k, v in self.eval_batch(model, dev).items()}
            t2 = time.perf_counter()
            for bi in range(batch["img"].shape[0]):
                keep = out["valid"][bi]
                gt_keep = batch["mask_gt"][bi]
                pred_cls = out["classes"][bi][keep]
                conf = out["scores"][bi][keep]
                tcls = batch["cls"][bi][gt_keep]
                self.update(metrics, out, bi, keep, gt_keep, pred_cls, conf, tcls, batch)
                if cm is not None:
                    cm.process_batch(out["boxes"][bi][keep], pred_cls, conf,
                                     out["gt_boxes"][bi][gt_keep], tcls)
            n_img += batch["img"].shape[0]
            t3 = time.perf_counter()
            t["preprocess"] += t1 - t0
            t["eval"] += t2 - t1
            t["matching"] += t3 - t2
        t0 = time.perf_counter()
        metrics.process()
        t["matching"] += time.perf_counter() - t0
        self.confusion_matrix = cm
        self.speed = {k: v * 1e3 / max(n_img, 1) for k, v in t.items()}
        return metrics.results_dict


class SegmentationValidator(DetectionValidator):
    """Box and mask mAP of a polar segmentation model over decoded images;
    masks are compared on an R x R grid, ``R = max(imgsz // mask_ratio,
    8)``."""

    task = "segment"
    eval_keys = EVAL_KEYS

    def __init__(self, imgsz: int = 640, batch: int = 16, conf: float = 0.001,
                 iou: float = 0.7, max_det: int = 300, pre_nms: int = 1024,
                 mask_ratio: int = 1, max_instances: int = 48,
                 mark: Optional[Callable[[str], None]] = None, single_cls: bool = False):
        super().__init__(imgsz, batch, conf, iou, max_det, pre_nms, max_instances, mark,
                         single_cls)
        self.grid = max(self.imgsz // max(int(mask_ratio or 1), 1), 8)

    @torch.inference_mode()
    def eval_batch(self, model, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One collated batch (``EVAL_KEYS`` as tensors on the model's device;
        ``img`` (B, H, W, 3) uint8 RGB) -> the JAX eval function's outputs:
        ``boxes`` (B, max_det, 4) in the image's frame, ``scores``,
        ``classes``, ``valid``, ``ious_box`` and ``ious_mask`` (B, N,
        max_det) of GT against detections, ``gt_boxes`` (B, N, 4),
        ``pred_pts`` (B, max_det, 36, 2) and ``pred_pts_valid``. A model
        without ``predict_parts`` (an exported artifact's wrapper) is read
        through its ``predict``, the scores gated as probabilities."""
        mark = self.mark
        img, ratio_pad, ori_shape = batch["img"], batch["ratio_pad"], batch["ori_shape"]
        H, W = img.shape[1:3]
        mark("forward_nms")
        x = _as_float(img).permute(0, 3, 1, 2).contiguous()
        if hasattr(model, "predict_parts"):
            boxes_p, logits_p, extras_p = model.predict_parts(x, sigmoid=False)
            out = non_max_suppression_parts(boxes_p, logits_p, extras_p, multi_label=True,
                                            scores_are_logits=True, **self.nms_kw)
            ex = finalize_polar_extras(out["extras"])
        else:  # an artifact's predict (utils/benchmarks.py): scores and points decoded
            p, nc = model.predict(x).transpose(1, 2), model.nc
            out = non_max_suppression_parts(p[..., :4], p[..., 4:4 + nc], p[..., 4 + nc:],
                                            multi_label=True, **self.nms_kw)
            ex = out["extras"]
        mark("scale_box_iou")
        boxes_nat, gt_nat, ious_box = self._scale_box_iou(out["boxes"], batch)
        wh = torch.tensor([W, H], dtype=torch.float32, device=img.device)
        ppts = scale_coords(torch.stack([ex[..., :NUM_RAYS], ex[..., NUM_RAYS:2 * NUM_RAYS]], -1),
                            ratio_pad)
        pvalid = (ex[..., 2 * NUM_RAYS:] > 0.5) & out["valid"][..., None]
        gpts = scale_coords(batch["segments"] * wh, ratio_pad)
        gvalid = batch["mask_gt"][..., None].expand(gpts.shape[:-1])
        mark("mask_iou")
        s = grid_scale(ori_shape, self.grid)[:, None, None, None]
        R = self.grid
        ious_mask = torch.stack([
            polygon_mask_iou(gpts[b] * s[b], gvalid[b], ppts[b] * s[b], pvalid[b], R, R)
            for b in range(img.shape[0])])
        mark("end")
        return {"boxes": boxes_nat, "scores": out["scores"], "classes": out["classes"],
                "valid": out["valid"], "ious_box": ious_box, "ious_mask": ious_mask,
                "gt_boxes": gt_nat, "pred_pts": ppts, "pred_pts_valid": pvalid}

    def new_metrics(self, names):
        return SegmentMetrics(names=names)

    def update(self, metrics, out, bi, keep, gt_keep, pred_cls, conf, tcls, batch):
        super().update(metrics, out, bi, keep, gt_keep, pred_cls, conf, tcls, batch)
        tp = match_predictions(pred_cls, tcls, out["ious_mask"][bi][gt_keep][:, keep])
        metrics.seg.update(tp, conf, pred_cls, tcls)


class PoseValidator(DetectionValidator):
    """Box and keypoint mAP of a pose model over decoded images whose labels
    carry keypoints (``ValDataset`` with the model's ``kpt_shape``: label
    files, or ``(cls, bboxes, segments, keypoints)`` arrays). The OKS sigmas
    are COCO's for 17 keypoints, else 1 / K (float64, as JAX's validator
    takes them). Fitness is the box metrics' (``PoseMetrics``)."""

    task = "pose"

    @torch.inference_mode()
    def eval_batch(self, model, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """As ``DetectionValidator.eval_batch``, NMS carrying the decoded
        keypoints, plus ``kpts`` (B, max_det, K, D): each detection's
        keypoints in the image's frame (``scale_coords``, the visibility
        kept)."""
        mark = self.mark
        mark("forward_nms")
        pred = detect_xyxy(model.predict(_as_float(batch["img"]).permute(0, 3, 1, 2).contiguous()))
        out = non_max_suppression(pred.float(), nc=model.nc, multi_label=True, **self.nms_kw)
        mark("scale_box_iou")
        boxes_nat, gt_nat, ious_box = self._scale_box_iou(out["boxes"], batch)
        k = out["extras"].reshape(*out["extras"].shape[:2], *model.kpt_shape)
        kpts = torch.cat([scale_coords(k[..., :2], batch["ratio_pad"]), k[..., 2:]], -1)
        mark("end")
        return {"boxes": boxes_nat, "scores": out["scores"], "classes": out["classes"],
                "valid": out["valid"], "ious_box": ious_box, "gt_boxes": gt_nat, "kpts": kpts}

    def new_metrics(self, names):
        return PoseMetrics(names=names)

    def update(self, metrics, out, bi, keep, gt_keep, pred_cls, conf, tcls, batch):
        """The box tables, then the keypoints': the GT keypoints (normalized
        to the letterbox) to the image's frame per axis, ``(k * size - pad) /
        gain``, and their OKS with the detections' keypoints."""
        super().update(metrics, out, bi, keep, gt_keep, pred_cls, conf, tcls, batch)
        gain, (padx, pady) = batch["ratio_pad"][bi][0], batch["ratio_pad"][bi][1:3]
        gk = batch["keypoints"][bi][gt_keep].copy()
        bh, bw = batch["img"].shape[1:3]
        gk[..., 0] = (gk[..., 0] * bw - padx) / gain
        gk[..., 1] = (gk[..., 1] * bh - pady) / gain
        gb = out["gt_boxes"][bi][gt_keep]
        area = np.clip((gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1]) * 0.53, 1, None)
        oks = kpt_iou(gk, out["kpts"][bi][keep], area, self.sigma)
        metrics.pose.update(match_predictions(pred_cls, tcls, oks), conf, pred_cls, tcls)

    def loader(self, images, labels) -> ValLoader:
        return ValLoader(ValDataset(images, labels, self.imgsz, self.max_instances,
                                    kpt_shape=self.kpt_shape, single_cls=self.single_cls),
                         self.batch)

    def __call__(self, model, images, labels=None, names=None
                 ) -> Dict[str, float]:
        """As ``DetectionValidator.__call__``, with the pose metrics (P)
        beside the box ones (B)."""
        self.kpt_shape = tuple(model.kpt_shape)
        k = self.kpt_shape[0]
        self.sigma = OKS_SIGMA.numpy() if k == OKS_SIGMA.shape[0] else np.full(k, 1.0 / k)
        return super().__call__(model, images, labels, names=names)


class SegmentationOriValidator(DetectionValidator):
    """Box and mask mAP of a proto-mask segmentation model over decoded
    images (see the module docstring). Masks are compared at proto size in
    the letterbox frame, as JAX compares them; the mask IoUs' counts are
    exact in float32, so they equal JAX's on the same masks."""

    task = "segment_ori"
    eval_keys = EVAL_KEYS

    @torch.inference_mode()
    def eval_batch(self, model, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """As ``DetectionValidator.eval_batch``, NMS carrying the mask
        coefficients, plus ``ious_mask`` (B, N, max_det) of the GT masks
        against the detections' masks."""
        mark = self.mark
        img = batch["img"]
        mark("forward_nms")
        pred, proto = model.predict(_as_float(img).permute(0, 3, 1, 2).contiguous())
        out = non_max_suppression(detect_xyxy(pred).float(), nc=model.nc, multi_label=True,
                                  **self.nms_kw)
        mark("scale_box_iou")
        boxes_nat, gt_nat, ious_box = self._scale_box_iou(out["boxes"], batch)
        mark("mask_iou")
        hp, wp = proto.shape[2:]
        pm = torch.sigmoid(torch.einsum("bdm,bmhw->bdhw", out["extras"].float(), proto.float()))
        pm = ((pm > 0.5) & in_box_grid(out["boxes"] * (hp / img.shape[1]), hp, wp)
              & out["valid"][..., None, None])
        gm = gt_masks_at(batch["segments"], batch["mask_gt"], hp, wp)
        ious = []
        for b in range(img.shape[0]):
            inter, area_g, area_p = mask_products(gm[b], pm[b])
            ious.append(inter / (area_g[:, None] + area_p[None, :] - inter + 1e-7))
        mark("end")
        return {"boxes": boxes_nat, "scores": out["scores"], "classes": out["classes"],
                "valid": out["valid"], "ious_box": ious_box, "ious_mask": torch.stack(ious),
                "gt_boxes": gt_nat}

    def new_metrics(self, names):
        return SegmentMetrics(names=names)

    def update(self, metrics, out, bi, keep, gt_keep, pred_cls, conf, tcls, batch):
        super().update(metrics, out, bi, keep, gt_keep, pred_cls, conf, tcls, batch)
        tp = match_predictions(pred_cls, tcls, out["ious_mask"][bi][gt_keep][:, keep])
        metrics.seg.update(tp, conf, pred_cls, tcls)


class ClassificationValidator:
    """Top-1 and top-5 accuracy of a classify model over decoded images
    (HWC uint8 BGR) and their class indices: the eval transform on the host
    (``ClassificationDataset``), ``batch`` images a forward on the model's
    device, ``ClassifyMetrics`` on the host. ``mark`` and ``speed`` as
    ``DetectionValidator``'s (its one device stage is "forward")."""

    task = "classify"

    def __init__(self, imgsz: int = 224, batch: int = 16,
                 mark: Optional[Callable[[str], None]] = None):
        self.imgsz, self.batch = int(imgsz), max(int(batch), 1)
        self.mark = mark or _no_mark
        self.speed: Dict[str, float] = {}

    @torch.inference_mode()
    def eval_batch(self, model, images: torch.Tensor) -> torch.Tensor:
        """images (B, S, S, 3) float32 on the model's device -> (B, nc)."""
        self.mark("forward")
        preds = model.predict(images.permute(0, 3, 1, 2).contiguous())
        self.mark("end")
        return preds

    def __call__(self, model, images, labels=None, names=None
                 ) -> Dict[str, float]:
        """Validate ``model`` -> the JAX ``results_dict``: top-1, top-5 and
        fitness (their mean)."""
        device = next(model.parameters()).device
        metrics = ClassifyMetrics()
        loader = ValLoader(ClassificationDataset(images, labels, self.imgsz), self.batch)
        t = dict.fromkeys(("preprocess", "eval", "matching"), 0.0)
        n_img = 0
        batches = iter(loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            x = torch.from_numpy(batch["img"]).to(device)
            t1 = time.perf_counter()
            preds = self.eval_batch(model, x).float().cpu().numpy()
            t2 = time.perf_counter()
            metrics.update(preds, batch["cls"])
            n_img += len(preds)
            t["preprocess"] += t1 - t0
            t["eval"] += t2 - t1
            t["matching"] += time.perf_counter() - t2
        self.speed = {k: v * 1e3 / max(n_img, 1) for k, v in t.items()}
        return metrics.results_dict
