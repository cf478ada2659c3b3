"""The pose task's predictor, trainer and validator."""
from ....engine.predictor import PosePredictor
from ....engine.trainer import PoseTrainer
from ....engine.validator import PoseValidator

__all__ = ["PosePredictor", "PoseTrainer", "PoseValidator"]
