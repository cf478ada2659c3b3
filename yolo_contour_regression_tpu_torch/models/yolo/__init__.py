"""The YOLO task packages (counterpart of the JAX package's
``models/yolo/``): the facade and each task's predictor, trainer and
validator, re-exported from ``engine/``."""
from . import classify, detect, pose, segment
from .model import TASK_MAP, YOLO

__all__ = ["classify", "detect", "pose", "segment", "YOLO", "TASK_MAP"]
