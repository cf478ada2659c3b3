"""The polar-contour segment task's predictor, trainer and validator."""
from ....engine.predictor import SegmentationPredictor
from ....engine.trainer import SegmentationTrainer
from ....engine.validator import SegmentationValidator

__all__ = ["SegmentationPredictor", "SegmentationTrainer", "SegmentationValidator"]
