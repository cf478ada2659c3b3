"""The RT-DETR validator (counterpart of the JAX package's
``models/rtdetr/val.py``): box mAP with no NMS. On the device, every one of
the nq queries: its box (normalized cxcywh, scaled by the input's size, made
xyxy) and the GT boxes mapped back to each image's own frame through the
letterbox (``scale_boxes``), their IoU, each query's best score and class;
on the host, the queries scoring at least ``conf`` are matched to the GT
(``match_predictions``) into ``DetMetrics``. As JAX's, no confusion
matrix."""
from __future__ import annotations

from typing import Dict

import torch

from ...engine.predictor import _as_float
from ...engine.validator import DetectionValidator
from ...ops.boxes import box_iou, scale_boxes, xywh2xyxy


class RTDETRValidator(DetectionValidator):
    task = "rtdetr"
    confusion = False

    @torch.inference_mode()
    def eval_batch(self, model, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One collated batch (``eval_keys`` on the model's device) ->
        ``boxes`` (B, nq, 4) in each image's frame, ``scores`` and
        ``classes`` (B, nq) the best class's, ``valid`` (B, nq) where the
        score is at least ``conf``, ``ious_box`` (B, N, nq) of GT against
        queries and ``gt_boxes`` (B, N, 4)."""
        mark = self.mark
        img, ratio_pad, ori_shape = batch["img"], batch["ratio_pad"], batch["ori_shape"]
        mark("forward")
        pred = model.predict(_as_float(img).permute(0, 3, 1, 2).contiguous()).float()
        mark("scale_box_iou")
        H, W = img.shape[1:3]
        wh2 = torch.tensor([W, H, W, H], dtype=torch.float32, device=img.device)
        boxes = scale_boxes(xywh2xyxy(pred[..., :4]) * wh2, ratio_pad, ori_shape)
        gt = scale_boxes(xywh2xyxy(batch["bboxes"]) * wh2, ratio_pad, ori_shape)
        scores, classes = pred[..., 4:].max(-1)
        out = {"boxes": boxes, "scores": scores, "classes": classes,
               "valid": scores >= self.nms_kw["conf_thres"], "ious_box": box_iou(gt, boxes),
               "gt_boxes": gt}
        mark("end")
        return out
