"""The ``YOLO`` facade for polar segmentation checkpoints (counterpart of
the JAX package's ``engine/model.py``)::

    model = YOLO("runs/floor_seg160/best.ckpt", device="cuda")
    results = model.predict([img_bgr_u8, ...], imgsz=160)
    metrics = model.val([img_bgr_u8, ...], ["a.txt", ...], imgsz=160, batch=4)

Only checkpoints of the JAX package's polar ``segment`` task, in their
training (unfused) form, are ported.
"""
from __future__ import annotations

from pathlib import Path
from typing import Union

from ..nn.tasks import SegmentationModel
from ..utils.checkpoint import checkpoint_variables, load_checkpoint, load_jax_variables
from .predictor import SegmentationPredictor
from .validator import SegmentationValidator


class YOLO:
    """User-facing model handle: a checkpoint's weights on ``device``."""

    def __init__(self, model: Union[str, Path], device="cuda"):
        ckpt = load_checkpoint(model)
        if ckpt.get("deploy"):
            raise NotImplementedError(f"deploy={ckpt['deploy']!r} checkpoints are not ported")
        task = (ckpt.get("train_args") or {}).get("task", "segment")
        if task != "segment":
            raise NotImplementedError(f"task={task!r} is not ported; only 'segment'")
        self.model = SegmentationModel(ckpt["model_yaml"])
        self.model.names = dict(ckpt.get("names") or self.model.names)
        load_jax_variables(self.model, *checkpoint_variables(ckpt))
        self.model.to(device).eval()
        # the JAX facade takes the training imgsz as the predict default
        self.imgsz = int((ckpt.get("train_args") or {}).get("imgsz", 640))

    @property
    def names(self):
        return self.model.names

    def predict(self, source, imgsz=None, conf: float = 0.25, iou: float = 0.7,
                max_det: int = 300, pre_nms: int = 1024, batch: int = 1):
        """Images (HWC uint8 BGR numpy, or a list) -> list of ``Results``,
        ``batch`` images per forward."""
        predictor = SegmentationPredictor(
            imgsz=imgsz or self.imgsz, conf=conf, iou=iou, max_det=max_det,
            pre_nms=pre_nms, batch=batch,
        )
        return predictor(self.model, source, names=self.names)

    def val(self, images, labels, imgsz=None, batch: int = 16, conf: float = 0.001,
            iou: float = 0.7, max_det: int = 300, pre_nms: int = 1024, mask_ratio: int = 1):
        """Box and mask mAP on decoded images (HWC uint8 BGR numpy) with their
        labels (YOLO label-file paths, or the ``(cls, bboxes, segments)``
        arrays ``data/dataset.py:parse_label_file`` gives), on the model's
        device -> the JAX ``results_dict`` keys. The validator, with its
        ``speed``, stays at ``self.validator``."""
        self.validator = SegmentationValidator(
            imgsz=imgsz or self.imgsz, batch=batch, conf=conf, iou=iou, max_det=max_det,
            pre_nms=pre_nms, mask_ratio=mask_ratio,
        )
        return self.validator(self.model, images, labels, names=self.names)
