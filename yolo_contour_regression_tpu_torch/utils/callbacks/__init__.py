"""The callback bus (counterpart of the JAX package's
``utils/callbacks/__init__.py``): a dict of event -> callables on a
trainer-like object, each called with the object.

The trainers fire ``on_train_start``, ``on_train_epoch_start``,
``on_fit_epoch_end``, ``on_model_save`` and ``on_train_end``, where and in
the order the JAX trainer does. A callback that raises is logged and
training goes on, as in JAX. JAX's nine integration sinks (tensorboard,
wandb, mlflow, comet, clearml, neptune, dvclive, raytune, hub) need packages
and a network this port does without: ``add_integration_callbacks`` attaches
none of them.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List

from .. import DEFAULT_CALLBACK_EVENTS, get_default_callbacks

LOGGER = logging.getLogger(__name__)
__all__ = ["DEFAULT_CALLBACK_EVENTS", "get_default_callbacks", "add_integration_callbacks",
           "run_callbacks"]


def add_integration_callbacks(instance) -> Dict[str, List[Callable]]:
    """The JAX package attaches each integration whose package imports;
    none is ported, so nothing is attached. Returns ``instance.callbacks``."""
    return instance.callbacks


def run_callbacks(instance, event: str):
    """Call each callback of ``event`` with ``instance``; one that raises is
    logged, never fatal."""
    for fn in instance.callbacks.get(event, []):
        try:
            fn(instance)
        except Exception as e:  # a callback never stops training
            LOGGER.warning(f"callback {event} failed: {e}")
