"""AutoBackend: one ``forward`` over the artifacts a user holds (counterpart
of the JAX package's ``nn/autobackend.py``), picked by the file's suffix:

  - ``.ckpt``  a checkpoint (the JAX package's format) -> the fused predict
    (an int8 one's as it is)
  - ``.yaml``  a fresh config -> its predict, the weights drawn as the
    facade draws them (``init_weights`` from seed 0)
  - ``.pt``    an Ultralytics checkpoint, converted to a ``.ckpt`` beside it
    (``utils/torch_convert.py``; the config from the sidecar's
    ``model_yaml``, else ``yolov8n-seg.yaml``), then as ``.ckpt``
  - ``.pt2``   the exporter's ``torch.export`` program, on the device it was
    exported on (``engine/exporter.py:load_pt2``); another ``device`` raises

``.onnx`` raises: the JAX package runs it with onnxruntime or OpenCV's
``cv2.dnn``, neither of which the port imports. The TensorFlow artifacts
(``_saved_model``, ``.pb``, ``.tflite``) and ``.stablehlo`` raise too.
A ``<stem>.metadata.json`` beside the file is read into ``metadata``.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict

import numpy as np
import torch

LOGGER = logging.getLogger(__name__)

_FORMATS = {".ckpt": "ckpt", ".yaml": "yaml", ".yml": "yaml", ".pt": "pt", ".pt2": "pt2",
            ".onnx": "onnx", ".stablehlo": "stablehlo", ".tflite": "tflite", ".pb": "pb"}
_NOT_RUN = {
    "onnx": "running ONNX needs onnxruntime (InferenceSession) or OpenCV's "
            "cv2.dnn.readNetFromONNX, the two consumers the JAX package's AutoBackend uses; the "
            "port imports neither. Load the model's .pt2 or .ckpt instead, or run the graph "
            "with the numpy executor of onnx/builder.py (export_onnx returns it)",
    "stablehlo": "StableHLO is the JAX package's artifact (its AutoBackend loads it); the "
                 "port's own is .pt2",
    "saved_model": "TensorFlow artifacts need tensorflow, which the port does not import",
    "tflite": "TensorFlow artifacts need tensorflow, which the port does not import",
    "pb": "TensorFlow artifacts need tensorflow, which the port does not import",
}


class AutoBackend:
    """``AutoBackend(weights, device)(im)``: ``im`` (B, 3, H, W) float RGB in
    [0, 1] (an array or a tensor) -> the predict's output, tensors on the
    backend's device. ``fuse`` fuses a checkpoint's model (the deploy
    form)."""

    def __init__(self, weights, device="cuda", fuse: bool = True):
        self.path = str(weights)
        self.device = torch.device(device)
        self.fuse = fuse
        p = Path(self.path)
        self.metadata: Dict = {}
        self.fmt = ("saved_model" if p.name.endswith("_saved_model") or (p / "saved_model.pb").exists()
                    else _FORMATS.get(p.suffix.lower()))
        if self.fmt is None:
            raise ValueError(f"unsupported artifact '{weights}': supported are .ckpt, .yaml, .pt "
                             "(converted by utils/torch_convert.py) and .pt2 (the exporter's)")
        if self.fmt in _NOT_RUN:
            raise NotImplementedError(f"{weights}: {_NOT_RUN[self.fmt]}")
        for cand in (p.parent / f"{p.stem}.metadata.json", Path(self.path + ".metadata.json")):
            if cand.exists():
                self.metadata = json.loads(cand.read_text())
                break
        getattr(self, f"_init_{self.fmt}")()
        LOGGER.info(f"AutoBackend: {self.fmt} <- {weights}")

    def _init_ckpt(self):
        from ..engine.model import YOLO
        from .fuse import fuse_model

        handle = YOLO(self.path, device=self.device)
        # an int8 checkpoint's model is fused already and stays as it is
        quantized = getattr(handle.model, "quantized", False)
        model = fuse_model(handle.model) if self.fuse and not quantized else handle.model
        self.names = handle.names
        self._fn = model.predict

    def _init_yaml(self):
        from ..engine.model import YOLO

        handle = YOLO(self.path, device=self.device)
        self.names = handle.names  # draws the weights
        self._fn = handle.model.predict

    def _init_pt(self):
        from ..utils.torch_convert import convert_torch_checkpoint

        yaml_guess = self.metadata.get("model_yaml") or "yolov8n-seg.yaml"
        self.path, _ = convert_torch_checkpoint(self.path, yaml_guess)
        self._init_ckpt()

    def _init_pt2(self):
        from ..engine.exporter import load_pt2

        exported = torch.device(self.metadata.get("device", self.device))
        # "cuda" (the current card) stands for any card index
        if exported.type != self.device.type or (
                None not in (exported.index, self.device.index) and exported != self.device):
            raise ValueError(f"{self.path} was exported for {exported}, and AutoBackend was asked "
                             f"for {self.device}: a pt2 program runs on the device it was "
                             f"exported on; export it again with device={str(self.device)!r}")
        self.device = exported
        self._fn = load_pt2(self.path, device=self.device)
        self.names = self.metadata.get("names", {})

    def forward(self, im):
        """``im`` (B, 3, H, W) float32 RGB in [0, 1] -> the prediction."""
        if isinstance(im, np.ndarray):
            im = torch.from_numpy(np.ascontiguousarray(im, np.float32))
        with torch.no_grad():
            return self._fn(im.to(self.device))

    __call__ = forward
