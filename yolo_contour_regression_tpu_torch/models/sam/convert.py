"""SAM weights: official checkpoints.

The port names its parameters by the official segment-anything and
MobileSAM keys, so an official state dict (``sam_vit_b.pth``,
``mobile_sam.pt``) loads as it is (``load_official``), less the TinyViT
classifier head (``image_encoder.norm_head``, ``image_encoder.head``),
which SAM never runs.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# the TinyViT classifier head of mobile_sam.pt; SAM never runs it
SKIPPED = ("image_encoder.norm_head.", "image_encoder.head.")


def official_state(source) -> Dict[str, torch.Tensor]:
    """A checkpoint path (``torch.load(weights_only=True)``) or a mapping of
    names to arrays or tensors -> the state dict SAM loads: a wrapped dict
    (``{"model": ...}`` or ``{"state_dict": ...}``) unwrapped, the TinyViT
    classifier head dropped, arrays made tensors."""
    if not isinstance(source, Mapping):
        source = torch.load(str(source), map_location="cpu", weights_only=True)
    for wrap in ("model", "state_dict"):
        if isinstance(source.get(wrap), Mapping):
            source = source[wrap]
    return {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
            for k, v in source.items() if not k.startswith(SKIPPED)}


def load_official(model: torch.nn.Module, source, strict: bool = True) -> Dict[str, Any]:
    """Load an official SAM or MobileSAM state dict into ``model``
    (``load_state_dict(strict=strict)``: a partial dict raises). BatchNorm
    counters missing from the source keep the model's. Returns a report of
    what was loaded and skipped."""
    sd = official_state(source)
    own = model.state_dict()
    for k in own:
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = own[k]
    res = model.load_state_dict(sd, strict=strict)
    return {"converted": len(sd), "missing": list(res.missing_keys),
            "unexpected": list(res.unexpected_keys)}


def num_weights(model: torch.nn.Module) -> int:
    """The entries of the JAX variables ``model`` stands for: every tensor
    of its state dict (parameters, the Fourier matrix, BatchNorm running
    statistics), BatchNorm counters left out."""
    return sum(v.numel() for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))
