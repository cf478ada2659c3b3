"""The RT-DETR predictor (counterpart of the JAX package's
``models/rtdetr/predict.py``): no NMS. The decoder's (B, nq, 4 + nc) on the
device, then on the host, as JAX's postprocess: the queries whose best
score is at least ``conf`` (0.25 when ``conf`` is 0 or None) are kept, their
normalized cxcywh boxes scaled by imgsz, made xyxy, unpadded, ungained and
clipped to the image."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...engine.predictor import BasePredictor, _as_float
from ...engine.results import Results


class RTDETRPredictor(BasePredictor):
    task = "rtdetr"

    @torch.inference_mode()
    def eval_batch(self, model, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) uint8 on the model's device -> ``pred`` (B,
        nq, 4 + nc) float32."""
        return {"pred": model.predict(_as_float(images).permute(0, 3, 1, 2).contiguous()).float()}

    def postprocess(self, out: Dict[str, np.ndarray], bi: int, orig, path, gain, pad, names,
                    device) -> Results:
        p = out["pred"][bi]  # (nq, 4 + nc)
        boxes_n, scores_all = p[:, :4], p[:, 4:]
        conf = scores_all.max(-1)
        cls = scores_all.argmax(-1)
        keep = conf >= (self.nms_kw["conf_thres"] or 0.25)
        h, w = orig.shape[:2]
        cxcywh = boxes_n[keep] * self.imgsz
        xyxy = np.concatenate(
            [cxcywh[:, :2] - cxcywh[:, 2:] / 2, cxcywh[:, :2] + cxcywh[:, 2:] / 2], -1)
        xyxy = (xyxy - np.array([pad[0], pad[1], pad[0], pad[1]])) / gain
        xyxy = np.clip(xyxy, 0, [w, h, w, h])
        data = np.concatenate([xyxy, conf[keep, None], cls[keep, None]], -1)
        return Results(orig, path, names, boxes=data, device=device)
