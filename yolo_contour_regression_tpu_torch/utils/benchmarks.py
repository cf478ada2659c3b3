"""Benchmark harness (counterpart of the JAX package's
``utils/benchmarks.py``): ``benchmark`` exports, reloads, times and (given
``data``) validates every format, one row a format; ``profile_models``
times the fused predict of each model, sigma-clipped.

Timing: the native, fused and int8 rows time preprocess (uint8 -> float),
predict and NMS of one random uint8 batch, repeated on the device. On a card
each run of ``n`` iterations is timed with CUDA events around it (JAX's
in-graph ``fori_loop``), on the CPU with the host clock; the per-iteration
time is JAX's ``(T(10) - T(2)) / 8``, the least of three.
"""
from __future__ import annotations

import copy
import logging
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

LOGGER = logging.getLogger(__name__)

FORMATS = ("native", "fused", "int8", "pt2", "onnx", "saved_model", "tflite", "pb")
_NMS_TASKS = ("segment", "detect", "pose")


def _run_seconds(fn: Callable, n: int, device: torch.device) -> float:
    """Seconds of ``n`` calls of ``fn``: CUDA events around them on a card,
    the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return time.perf_counter() - t0


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_loop_throughput(model: nn.Module, raw: torch.Tensor) -> Dict:
    """imgs/sec of preprocess + predict + NMS of ``raw`` ((B, H, W, 3)
    uint8 on the model's device)."""
    from ..engine.predictor import detect_xyxy
    from ..ops.nms import non_max_suppression

    device = raw.device

    @torch.inference_mode()
    def body():
        x = raw.permute(0, 3, 1, 2).float() / 255.0
        pred = model.predict(x)
        if model.task in _NMS_TASKS:
            pred = pred if model.task == "segment" else detect_xyxy(pred)
            out = non_max_suppression(pred.float(), nc=model.nc, conf_thres=0.25, iou_thres=0.7,
                                      pre_nms=1024, max_det=300)
            return out["scores"].sum()
        return pred.float().sum()

    _run_seconds(body, 2, device)  # warm-up
    per_iter = min(_run_seconds(body, 10, device) - _run_seconds(body, 2, device)
                   for _ in range(3)) / 8
    per_iter = max(per_iter, 1e-9)
    return {"latency_ms_per_batch": round(per_iter * 1e3, 3),
            "imgs_per_sec": round(raw.shape[0] / per_iter, 1)}


class _BackendModel(nn.Module):
    """An ``AutoBackend`` artifact as the validators' model: its ``predict``
    is the artifact's; the task's attributes come from ``template``. Its one
    empty parameter tells the validator the backend's device."""

    def __init__(self, backend, template: nn.Module):
        super().__init__()
        self._backend = backend
        self.task, self.nc, self.strides = template.task, template.nc, template.strides
        self.names = getattr(template, "names", {})
        self.kpt_shape = getattr(template, "kpt_shape", None)
        self._device = nn.Parameter(torch.zeros(0, device=backend.device), requires_grad=False)

    def predict(self, x):
        return self._backend(x)


def _val_data(data):
    """``data`` (a dataset yaml, or an (images, labels) pair) -> (images,
    labels) for a validator."""
    if isinstance(data, (tuple, list)):
        return data[0], data[1]
    from ..data.utils import check_det_dataset

    return check_det_dataset(data)["val"], None


def _val_metric(model, data, task: str, imgsz: int, batch: int = 4) -> Optional[float]:
    """mAP50-95 (of masks for segment, else of boxes) of ``model`` on
    ``data``'s val split (JAX's: the segment validator for segment, the
    detect validator otherwise)."""
    from ..engine.validator import DetectionValidator, SegmentationValidator

    cls = SegmentationValidator if task == "segment" else DetectionValidator
    images, labels = _val_data(data)
    res = cls(imgsz=imgsz, batch=batch)(model, images, labels)
    key = "metrics/mAP50-95(M)" if task == "segment" else "metrics/mAP50-95(B)"
    return float(res.get(key, res.get("metrics/mAP50-95(B)", 0.0)))


def benchmark(model, data=None, imgsz: int = 640, batch: int = 16,
              formats: Optional[List[str]] = None, project: Optional[str] = None,
              verbose: bool = True) -> List[Dict]:
    """Export, reload, time and, given ``data`` (a dataset yaml, or decoded
    images and their labels), validate every format of a ``YOLO`` facade:
    one row a format with ``format``, ``imgsz``, ``batch``, ``status`` and
    its figures (JAX's ``benchmark``).

    ``native`` (the facade's model), ``fused`` (a fold on the CPU, moved to
    the device; the model itself if it is fused) and ``int8`` (that fold
    calibrated on one uniform batch of 2, or the model itself if it is
    int8) give ``latency_ms_per_batch`` and ``imgs_per_sec`` (preprocess,
    predict and NMS of a uint8 batch) and ``mAP50-95``. The file formats go
    through ``YOLO.export`` and ``nn/autobackend.py`` on one uniform image:
    ``cold_latency_ms``, ``latency_ms_per_img`` (3 calls) and
    ``consistency_maxabs`` against the fused predict; ``pt2`` (where JAX has
    ``stablehlo``) is also validated (batch 1, the artifact's). A format
    that fails carries its error in ``status``: ONNX is written but not run
    (the port has no ONNX runtime), TensorFlow's formats raise with their
    recipes; a failing format does not stop the table."""
    from ..nn.autobackend import AutoBackend
    from ..nn.fuse import fuse_model
    from ..nn.quant import quantize_variables

    base = model._weights()
    device = model.device
    formats = list(formats or FORMATS)
    out_dir = Path(project or "runs/benchmark")
    rows: List[Dict] = []
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.integers(0, 255, (batch, imgsz, imgsz, 3), dtype=np.uint8))
    raw = raw.to(device)
    x1 = torch.from_numpy(rng.uniform(0, 1, (1, imgsz, imgsz, 3)).astype(np.float32))
    x1 = x1.permute(0, 3, 1, 2).contiguous().to(device)

    fused = base if base.fused else fuse_model(copy.deepcopy(base).cpu()).to(device)
    with torch.inference_mode():
        native_pred = fused.predict(x1)

    for fmt in formats:
        row: Dict = {"format": fmt, "imgsz": imgsz, "batch": batch, "status": "ok"}
        try:
            if fmt in ("native", "fused", "int8"):
                m = base if fmt == "native" else fused
                if fmt == "int8" and not getattr(fused, "quantized", False):
                    calib = [rng.uniform(0, 1, (2, imgsz, imgsz, 3)).astype(np.float32)]
                    m, _, _ = quantize_variables(copy.deepcopy(fused), calib)
                row.update(_device_loop_throughput(m, raw))
                if data is not None:
                    row["mAP50-95"] = _val_metric(m, data, m.task, imgsz)
            else:
                path = model.export(format=fmt, imgsz=imgsz, project=str(out_dir))
                backend = AutoBackend(path, device=device)
                t0 = time.perf_counter()
                pred = backend(x1)
                _sync(device)
                row["cold_latency_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
                t0 = time.perf_counter()
                for _ in range(3):
                    pred = backend(x1)
                _sync(device)
                row["latency_ms_per_img"] = round((time.perf_counter() - t0) / 3 * 1e3, 2)
                row["consistency_maxabs"] = float((pred.float() - native_pred.float()).abs().max())
                if fmt == "pt2" and data is not None:
                    shim = _BackendModel(backend, base)
                    row["mAP50-95"] = _val_metric(shim, data, shim.task, imgsz, batch=1)
        except Exception as e:  # a failing format must not kill the table
            row["status"] = f"fail: {type(e).__name__}: {e}"
        rows.append(row)
        if verbose:
            LOGGER.info(f"benchmark {fmt}: {row}")
    return rows


def _sigma_clip(ts: np.ndarray) -> np.ndarray:
    """JAX's three rounds of a 2-sigma clip (the reference's
    ``iterative_sigma_clipping``)."""
    for _ in range(3):
        keep = np.abs(ts - ts.mean()) <= 2 * ts.std() + 1e-9
        ts = ts[keep] if keep.any() else ts
    return ts


def profile_models(models: List[str], imgsz: int = 640, batch: int = 1,
                   num_timed_runs: int = 10, verbose: bool = True, device="cuda") -> List[Dict]:
    """A row a model (a config or checkpoint name): its parameters (of the
    unfused model, in millions) and the fused predict's ms a call on
    ``device`` (CUDA events on a card), sigma-clipped mean and std over
    ``num_timed_runs`` calls after one warm-up (JAX's ``profile_models``)."""
    from ..engine.model import YOLO
    from ..nn.fuse import fuse_model

    dev = torch.device(device)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (batch, imgsz, imgsz, 3))
                         .astype(np.float32)).permute(0, 3, 1, 2).contiguous().to(dev)
    rows = []
    for name in models:
        handle = YOLO(name, device=dev)
        m = handle._weights()
        fused = m if m.fused else fuse_model(copy.deepcopy(m))

        @torch.inference_mode()
        def call(fused=fused):
            fused.predict(x)

        call()
        _sync(dev)
        ts = _sigma_clip(np.asarray([_run_seconds(call, 1, dev) * 1e3
                                     for _ in range(num_timed_runs)]))
        rows.append({"model": str(name), "params_M": round(m.num_params / 1e6, 2),
                     "latency_ms": round(float(ts.mean()), 2),
                     "latency_std_ms": round(float(ts.std()), 2), "imgsz": imgsz})
        if verbose:
            LOGGER.info(f"profile {name}: {rows[-1]}")
    return rows
