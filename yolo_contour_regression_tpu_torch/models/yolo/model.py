"""The facade and its task map (``engine/model.py``), re-exported here as
the JAX package's ``models/yolo/model.py`` does."""
from ...engine.model import TASK_MAP, YOLO

__all__ = ["YOLO", "TASK_MAP"]
