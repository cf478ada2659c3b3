"""The detect task's predictor, trainer and validator."""
from ....engine.predictor import DetectionPredictor
from ....engine.trainer import DetectionTrainer
from ....engine.validator import DetectionValidator

__all__ = ["DetectionPredictor", "DetectionTrainer", "DetectionValidator"]
