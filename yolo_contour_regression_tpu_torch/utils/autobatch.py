"""AutoBatch: the training batch size from the card's memory (counterpart of
the JAX package's ``utils/autobatch.py``).

The eval forward's bytes are measured at batch 2 and batch 4 on the card
(``torch.cuda.max_memory_allocated`` around it, less what was allocated
before: its temporaries and outputs, where JAX read XLA's memory analysis);
``fit_batch_size`` fits JAX's line through them (a fixed part and a part an
image), takes JAX's x4 for training (gradients, optimizer state, slack),
and returns the largest power of two whose estimate fits ``fraction`` of
the card's memory (``torch.cuda.mem_get_info``'s total). A CPU device has no
such memory to fit, and raises.
"""
from __future__ import annotations

import logging
from typing import Dict

import torch
from torch import nn

LOGGER = logging.getLogger(__name__)

TRAIN_FACTOR = 4  # training takes about 4x the eval activations (JAX's estimate)


def fit_batch_size(total_bytes: float, b2: float, b4: float, fraction: float = 0.6) -> Dict:
    """JAX's fit on the byte counts: the eval bytes at batch 2 (``b2``) and
    4 (``b4``), the device's ``total_bytes`` -> ``batch`` (the largest power
    of two, at least 1), ``per_sample_train`` and ``fixed`` bytes and the
    ``budget``."""
    budget = total_bytes * fraction
    per_sample = max((b4 - b2) / 2, 1.0)
    fixed = max(b2 - 2 * per_sample, 0.0)
    per_sample_train = per_sample * TRAIN_FACTOR
    batch = int((budget - fixed) / per_sample_train)
    batch = max(1, 2 ** max(int(batch).bit_length() - 1, 0))
    return {"batch": batch, "per_sample_train": per_sample_train, "fixed": fixed,
            "budget": budget}


def _cuda_device(model: nn.Module) -> torch.device:
    device = next(model.parameters()).device
    if device.type != "cuda":
        raise ValueError(f"AutoBatch fits a batch to the card's memory (torch.cuda); the model is "
                         f"on {device}, which has none to fit: move it to a card, or give the "
                         "batch size yourself")
    return device


def device_memory_bytes(device) -> int:
    """The card's total memory in bytes."""
    return int(torch.cuda.mem_get_info(device)[1])


def estimate_activation_bytes(model: nn.Module, imgsz: int, batch: int) -> int:
    """Peak bytes the eval forward (``predict``) allocates at ``batch``
    beyond what was allocated before it (the weights and the input)."""
    device = _cuda_device(model)
    x = torch.zeros(batch, 3, imgsz, imgsz, device=device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    with torch.inference_mode():
        out = model.predict(x)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    del out
    return int(peak - before)


def train_batch_fit(model, imgsz: int = 640, fraction: float = 0.6) -> Dict:
    """``fit_batch_size`` on ``model`` (a ``YOLO`` facade or a task model
    on a card) at ``imgsz``, with the measured ``b2``, ``b4`` and
    ``total_bytes``."""
    model = model._weights() if hasattr(model, "_weights") else model
    device = _cuda_device(model)
    was_training = model.training
    model.eval()
    try:
        b2 = estimate_activation_bytes(model, imgsz, 2)
        b4 = estimate_activation_bytes(model, imgsz, 4)
    finally:
        model.train(was_training)
    total = device_memory_bytes(device)
    return {**fit_batch_size(total, b2, b4, fraction), "b2": b2, "b4": b4, "total_bytes": total}


def check_train_batch_size(model, imgsz: int = 640, fraction: float = 0.6) -> int:
    """Largest power-of-two batch whose estimated training memory fits
    ``fraction`` of the card's memory (JAX's ``check_train_batch_size``)."""
    fit = train_batch_fit(model, imgsz, fraction)
    LOGGER.info(f"AutoBatch: ~{fit['per_sample_train'] / 1e6:.0f} MB/img (train est.), "
                f"budget {fit['budget'] / 1e9:.1f} GB -> batch {fit['batch']}")
    return fit["batch"]
