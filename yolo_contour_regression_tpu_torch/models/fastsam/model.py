"""The FastSAM facade (counterpart of the JAX package's
``models/fastsam/model.py``)."""
from __future__ import annotations

from ...engine.model import YOLO


class FastSAM(YOLO):
    """``YOLO`` bound to the polar segment task, run class-agnostic:
    ``predict`` defaults to ``agnostic_nms=True`` and ``conf=0.4``; its
    results feed ``FastSAMPrompt``. The default config is
    ``yolov8s-seg.yaml``, FastSAM's published width (a config has no
    weights until it is trained)."""

    def __init__(self, model: str = "yolov8s-seg.yaml", device="cuda"):
        super().__init__(model, device=device, task="segment")

    def predict(self, source, **kwargs):
        kwargs.setdefault("agnostic_nms", True)
        kwargs.setdefault("conf", 0.4)
        return super().predict(source, **kwargs)
