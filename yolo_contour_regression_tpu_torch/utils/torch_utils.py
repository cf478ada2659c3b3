"""Runtime utilities (counterpart of the JAX package's ``utils/jax_utils.py``,
itself standing for the reference's ``utils/torch_utils.py``): seeding,
the one-cycle ramp, DDP unwrapping, FLOPs and model info, op timing and a
profiler trace. EMA and the fuse live in ``utils/optim.py`` and
``nn/fuse.py``.

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode``: 2 per
multiply-add of the convolutions, matmuls and attention the forward runs
(elementwise work is not counted). JAX counted with XLA's cost analysis,
which also counts elementwise operations and what its fusions keep, so the
two GFLOPs figures differ in kind and are not held to each other.
"""
from __future__ import annotations

import logging
import math
import random
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

LOGGER = logging.getLogger(__name__)


def init_seeds(seed: int = 0) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; returns a
    ``torch.Generator`` seeded the same (JAX returned a PRNG key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def one_cycle(y1: float = 0.0, y2: float = 1.0, steps: int = 100) -> Callable:
    """The cosine ramp from y1 to y2 over ``steps``."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def de_parallel(model: nn.Module) -> nn.Module:
    """The module inside a ``DistributedDataParallel`` or ``DataParallel``
    wrapper, else the model itself."""
    wrapped = (nn.parallel.DistributedDataParallel, nn.DataParallel)
    return model.module if isinstance(model, wrapped) else model


def model_flops(fn: Callable, *example_args) -> Optional[float]:
    """FLOPs of one call ``fn(*example_args)`` by ``FlopCounterMode`` (see
    the module docstring); None if the count fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn(*example_args)
        return float(counter.get_total_flops())
    except Exception as e:  # the count is informative, never fatal
        LOGGER.warning(f"FLOP count failed: {e}")
        return None


def model_info(model: nn.Module, imgsz: int = 640, verbose: bool = True) -> Dict:
    """Layers, parameters and GFLOPs of the forward at (1, 3, imgsz, imgsz)
    on the model's device (JAX's ``model_info``; its GFLOPs are XLA's)."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        flops = model_flops(model, torch.zeros(1, 3, imgsz, imgsz, device=device))
    finally:
        model.train(was_training)
    info = {"layers": len(model.specs), "parameters": model.num_params,
            "GFLOPs": round(flops / 1e9, 2) if flops else None}
    if verbose:
        LOGGER.info(f"{type(model).__name__}: {info['layers']} layers, {info['parameters']:,} "
                    f"parameters, {info['GFLOPs']} GFLOPs @ {imgsz}px")
    return info


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def profile(fns: Dict[str, Callable], *args, n: int = 10) -> Dict[str, float]:
    """ms a call of each named function on ``args``, after one warm-up
    call: CUDA events around the ``n`` calls when an argument is on a card
    (the card synchronized), the host clock otherwise."""
    device = _device_of(args)
    out = {}
    for name, fn in fns.items():
        with torch.no_grad():
            fn(*args)
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    fn(*args)
                end.record()
                end.synchronize()
                out[name] = start.elapsed_time(end) / n
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn(*args)
                out[name] = (time.perf_counter() - t0) / n * 1e3
        LOGGER.info(f"profile {name}: {out[name]:.3f} ms")
    return out


class trace:
    """A ``torch.profiler`` trace of what runs inside it, the card's kernels
    too when one is present, written as a Chrome trace
    (``<log_dir>/trace.json``)::

        with torch_utils.trace("runs/profile"):
            step_fn(...)
    """

    def __init__(self, log_dir: str = "runs/profile"):
        self.log_dir = str(log_dir)
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile as _profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = _profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        path = Path(self.log_dir) / "trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(path))
        LOGGER.info(f"profiler trace written to {path}")

