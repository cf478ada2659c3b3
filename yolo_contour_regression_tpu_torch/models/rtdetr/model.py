"""The RT-DETR facade (counterpart of the JAX package's
``models/rtdetr/model.py``)."""
from __future__ import annotations

from ...engine.model import YOLO


class RTDETR(YOLO):
    """``YOLO`` bound to the rtdetr task. Of the RT-DETR configs only
    ``yolov8n-rtdetr.yaml`` (any scale letter) is ported; the default
    ``rtdetr-l.yaml``, as JAX's, raises ``NotImplementedError``."""

    def __init__(self, model: str = "rtdetr-l.yaml", device="cuda"):
        super().__init__(model, device=device, task="rtdetr")
