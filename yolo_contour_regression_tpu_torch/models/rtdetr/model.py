"""The RT-DETR facade (counterpart of the JAX package's
``models/rtdetr/model.py``)."""
from __future__ import annotations

from ...engine.model import YOLO


class RTDETR(YOLO):
    """``YOLO`` bound to the rtdetr task: ``rtdetr-l.yaml`` (the default, as
    JAX's: PPHGNetV2 backbone, AIFI, RepC3 neck), ``yolov8n-rtdetr.yaml``
    (any scale letter), or a checkpoint of either. Each predicts,
    validates, trains (on the host train chain) and fuses."""

    def __init__(self, model: str = "rtdetr-l.yaml", device="cuda"):
        super().__init__(model, device=device, task="rtdetr")
