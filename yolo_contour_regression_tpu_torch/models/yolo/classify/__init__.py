"""The classify task's predictor, trainer and validator."""
from ....engine.predictor import ClassificationPredictor
from ....engine.trainer import ClassificationTrainer
from ....engine.validator import ClassificationValidator

__all__ = ["ClassificationPredictor", "ClassificationTrainer", "ClassificationValidator"]
