"""Subpackage of the PyTorch port; see the package docstring.

``DEFAULT_CALLBACK_EVENTS`` are the events of the callback bus, in the JAX
package's order (its ``utils/__init__.py``); ``utils/callbacks`` holds the
bus."""
from typing import Callable, Dict, List

DEFAULT_CALLBACK_EVENTS = [
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end", "on_fit_epoch_end", "on_model_save",
    "on_train_end", "on_params_update", "teardown",
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    "on_predict_start", "on_predict_batch_start", "on_predict_batch_end",
    "on_predict_postprocess_end", "on_predict_end",
    "on_export_start", "on_export_end",
]


def get_default_callbacks() -> Dict[str, List[Callable]]:
    """Every event with no callback."""
    return {e: [] for e in DEFAULT_CALLBACK_EVENTS}
