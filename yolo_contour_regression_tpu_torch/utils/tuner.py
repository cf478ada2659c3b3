"""Hyperparameter tuning (counterpart of the JAX package's
``utils/tuner.py``): the evolutionary ``Tuner``, mutation-based search over
the augmentation and lr hyperparameters, with the same search space and
draws: for the same seed and the same history of fitnesses it mutates to
the same hyperparameters as JAX's. Ray Tune (JAX's ``run_ray_tune``) needs
``ray``, which this port does without: not ported.
"""
from __future__ import annotations

import logging
import random
from typing import Dict

import numpy as np

LOGGER = logging.getLogger(__name__)

# search space: (min, max, gain) per hyperparameter (JAX's SPACE)
SPACE: Dict[str, tuple] = {
    "lr0": (1e-5, 1e-1, 1.0),
    "lrf": (0.01, 1.0, 1.0),
    "momentum": (0.6, 0.98, 0.3),
    "weight_decay": (0.0, 0.001, 1.0),
    "warmup_epochs": (0.0, 5.0, 1.0),
    "warmup_momentum": (0.0, 0.95, 1.0),
    "box": (0.02, 0.2, 1.0),
    "cls": (0.2, 4.0, 1.0),
    "hsv_h": (0.0, 0.1, 1.0),
    "hsv_s": (0.0, 0.9, 1.0),
    "hsv_v": (0.0, 0.9, 1.0),
    "degrees": (0.0, 45.0, 1.0),
    "translate": (0.0, 0.9, 1.0),
    "scale": (0.0, 0.9, 1.0),
    "shear": (0.0, 10.0, 1.0),
    "perspective": (0.0, 0.001, 1.0),
    "flipud": (0.0, 1.0, 1.0),
    "fliplr": (0.0, 1.0, 1.0),
    "mosaic": (0.0, 1.0, 1.0),
    "mixup": (0.0, 1.0, 1.0),
    "copy_paste": (0.0, 1.0, 1.0),
}


class Tuner:
    """Evolutionary mutation search: the first iteration trains at the
    middle of the space (lr0 0.01), each later one a mutation of the best
    so far; a failed training scores 0. ``device`` goes to each fresh
    ``YOLO``."""

    def __init__(self, model_path="yolov8n-seg.yaml", space=None, seed: int = 0, device="cuda"):
        self.model_path = model_path
        self.space = space or SPACE
        self.rng = random.Random(seed)
        self.history = []  # (fitness, hyp)
        self.device = device

    def _mutate(self, parent: Dict[str, float], mutation: float = 0.8, sigma: float = 0.2):
        hyp = dict(parent)
        keys = list(self.space.keys())
        while True:
            changed = False
            for k in keys:
                if self.rng.random() < mutation:
                    lo, hi, gain = self.space[k]
                    v = hyp.get(k, (lo + hi) / 2)
                    v *= 1.0 + self.rng.gauss(0, 1) * sigma * gain
                    hyp[k] = float(np.clip(v, lo, hi))
                    changed = True
            if changed:
                return hyp

    def __call__(self, data, iterations: int = 10, epochs: int = 10, **train_kwargs):
        """``iterations`` trainings on ``data`` -> (best hyperparameters,
        best fitness)."""
        from ..engine.model import YOLO

        base = {k: (lo + hi) / 2 if k != "lr0" else 0.01
                for k, (lo, hi, _) in self.space.items()}
        best_hyp, best_fit = dict(base), -1.0
        for i in range(iterations):
            hyp = self._mutate(best_hyp) if self.history else dict(base)
            model = YOLO(self.model_path, device=self.device)
            try:
                metrics = model.train(data=data, epochs=epochs, **{**hyp, **train_kwargs})
                fit = float(metrics.get("fitness", 0.0))
            except Exception as e:
                LOGGER.warning(f"tuner iteration {i} failed: {e}")
                fit = 0.0
            self.history.append((fit, hyp))
            if fit > best_fit:
                best_fit, best_hyp = fit, hyp
            LOGGER.info(f"tune {i + 1}/{iterations}: fitness {fit:.4f} (best {best_fit:.4f})")
        return best_hyp, best_fit
