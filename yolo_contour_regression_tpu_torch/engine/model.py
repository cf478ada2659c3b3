"""The ``YOLO`` facade for polar segmentation (counterpart of the JAX
package's ``engine/model.py``)::

    model = YOLO("yolov8n-seg.yaml", device="cuda")     # a fresh model
    metrics = model.train(data={"train": (images, labels), "val": (images, labels),
                                "names": {0: "circle", 1: "rect"}}, epochs=100, imgsz=640)
    model = YOLO("runs/floor_seg160/best.ckpt", device="cuda")
    results = model.predict([img_bgr_u8, ...], imgsz=160)
    metrics = model.val([img_bgr_u8, ...], ["a.txt", ...], imgsz=160, batch=4)

A name ending in ``.yaml`` names a fresh model (``nn/tasks.py``:
``yaml_model_load``) that has no weights until ``train`` builds and
initializes it from ``seed`` and adopts its ``best.ckpt``; anything else is
a checkpoint of the JAX package's polar ``segment`` task, in its training
(unfused) form, or one the port's trainer wrote.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Union

import torch

from ..nn.tasks import SegmentationModel, yaml_model_load
from ..utils.checkpoint import checkpoint_variables, load_checkpoint, load_jax_variables
from .predictor import SegmentationPredictor
from .trainer import SegmentationTrainer
from .validator import SegmentationValidator


class YOLO:
    """User-facing model handle: a model's weights on ``device``."""

    def __init__(self, model: Union[str, Path], device="cuda"):
        self.device = torch.device(device)
        self.ckpt_path: Optional[Path] = None
        if str(model).endswith((".yaml", ".yml")):
            self._new(str(model))
        else:
            self._load(model)

    def _new(self, name: str):
        yaml_model_load(name)  # raises for a model that is not ported
        self.model: Optional[SegmentationModel] = None  # the trainer builds it
        self.imgsz = 640
        self.overrides = {"model": name, "task": "segment"}

    def _load(self, path):
        ckpt = load_checkpoint(path)
        if ckpt.get("deploy"):
            raise NotImplementedError(f"deploy={ckpt['deploy']!r} checkpoints are not ported")
        train_args = ckpt.get("train_args") or {}
        task = train_args.get("task", "segment")
        if task != "segment":
            raise NotImplementedError(f"task={task!r} is not ported; only 'segment'")
        self.model = SegmentationModel(ckpt["model_yaml"])
        self.model.names = dict(ckpt.get("names") or self.model.names)
        load_jax_variables(self.model, *checkpoint_variables(ckpt))
        self.model.to(self.device).eval()
        # the JAX facade takes the training imgsz as the predict default
        self.imgsz = int(train_args.get("imgsz", 640))
        self.overrides = {k: v for k, v in train_args.items() if k in ("imgsz", "task")}
        self.ckpt_path = Path(path)

    @property
    def names(self):
        return self._weights().names

    def _weights(self) -> SegmentationModel:
        if self.model is None:
            raise RuntimeError(f"{self.overrides['model']} has no weights yet: train it, or "
                               f"load a checkpoint")
        return self.model

    def train(self, data: Dict, mark: Optional[Callable[[str], None]] = None, **overrides
              ) -> Dict[str, float]:
        """Train a fresh model of this facade's config on ``data`` (see
        ``engine/trainer.py``) on the facade's device, with the
        ``cfg/__init__.py:DEFAULT_CFG`` settings and ``overrides``; then
        adopt ``best.ckpt`` (or ``last.ckpt``). Returns the final validation
        of ``best.ckpt``. The trainer stays at ``self.trainer``; ``mark`` is
        its stage hook."""
        if self.ckpt_path is not None:
            raise NotImplementedError("training starts from a model config (YOLO('yolov8n-seg"
                                      ".yaml')); from a checkpoint's weights it is not ported")
        self.trainer = SegmentationTrainer(overrides={**self.overrides, **overrides,
                                                      "mode": "train"},
                                           device=self.device, mark=mark)
        metrics = self.trainer.train(data)
        best, last = self.trainer.wdir / "best.ckpt", self.trainer.wdir / "last.ckpt"
        src = best if best.exists() else last
        if src.exists():
            self._load(src)
        return metrics

    def predict(self, source, imgsz=None, conf: float = 0.25, iou: float = 0.7,
                max_det: int = 300, pre_nms: int = 1024, batch: int = 1):
        """Images (HWC uint8 BGR numpy, or a list) -> list of ``Results``,
        ``batch`` images per forward."""
        predictor = SegmentationPredictor(
            imgsz=imgsz or self.imgsz, conf=conf, iou=iou, max_det=max_det,
            pre_nms=pre_nms, batch=batch,
        )
        return predictor(self._weights(), source, names=self.names)

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
        return self.validator(self._weights(), images, labels, names=self.names)
