"""The RT-DETR task (counterpart of the JAX package's ``models/rtdetr/``).
Attributes load lazily: ``model.py`` imports ``engine/model.py``, which
imports the predictor and validator."""


def __getattr__(name):
    if name == "RTDETR":
        from .model import RTDETR

        return RTDETR
    if name == "RTDETRPredictor":
        from .predict import RTDETRPredictor

        return RTDETRPredictor
    if name == "RTDETRValidator":
        from .val import RTDETRValidator

        return RTDETRValidator
    raise AttributeError(name)


__all__ = ["RTDETR", "RTDETRPredictor", "RTDETRValidator"]
