"""Exporter: the deploy form of a model as a file (counterpart of the JAX
package's ``engine/exporter.py``).

Two formats are written, each from the fused model (``nn/fuse.py``; the
caller's model is left as it is), each with the decode in the graph and a
``<name>.metadata.json`` sidecar:

  - ``pt2`` (the default): a ``torch.export`` program of the fused predict,
    weights included (``torch.export.save``). It stands where JAX writes
    ``stablehlo`` (``jax.export`` and a ``.weights.pkl``): the framework's
    own artifact, reloaded by ``load_pt2`` or ``nn/autobackend.py`` on the
    device it was exported on.
  - ``onnx``: opset 12 by the port's copy of JAX's writer (``onnx/``), NCHW
    input, no NMS, from the model fused on the CPU; the same bytes as JAX's
    export of the same weights, but the metadata's ``description``.

Every other format of JAX's table raises ``NotImplementedError`` with the
offline recipe of ``OFFLINE_RECIPES``: TensorFlow's (``saved_model``,
``tflite``, ``pb``, ``edgetpu``, ``tfjs``) and the vendors' SDKs are not
imported by the port, and ``stablehlo`` and ``torchscript`` point at
``pt2``. ``dump_prediction`` writes one prediction for the C++ example
(``examples/polar-seg-cpp``).
"""
from __future__ import annotations

import copy
import json
import logging
import struct
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..cfg import get_cfg
from ..nn.fuse import fuse_model

LOGGER = logging.getLogger(__name__)

EXPORT_FORMATS = ("pt2", "onnx")

# the formats of the JAX exporter's table that the port does not write: each
# raises with the recipe that makes it offline from an artifact written here
# (the JAX package's texts where it has one)
OFFLINE_RECIPES = {
    "stablehlo": "the port's own artifact is format='pt2' (a torch.export program, weights "
                 "included); JAX's StableHLO comes from the JAX package's exporter",
    "saved_model": "needs TensorFlow: export format='onnx', then: pip install onnx2tf; "
                   "onnx2tf -i <name>.onnx -o <name>_saved_model",
    "tflite": "needs TensorFlow: export format='onnx', then: pip install onnx2tf; "
              "onnx2tf -i <name>.onnx -o <name>_saved_model (its .tflite files)",
    "pb": "needs TensorFlow: convert format='onnx' to a saved_model (onnx2tf), then freeze it "
          "with convert_variables_to_constants_v2",
    "edgetpu": "needs TensorFlow and the Coral compiler: an int8 .tflite from format='onnx' "
               "(onnx2tf -oiqt), then: edgetpu_compiler -s <name>_int8.tflite",
    "tfjs": "pip install tensorflowjs; export format='saved_model', then: "
            "tensorflowjs_converter --input_format=tf_saved_model "
            "<name>_saved_model <out_dir>",
    "openvino": "pip install openvino; export format='onnx', then: "
                "ovc <name>.onnx --output_model <name>_openvino/",
    "coreml": "pip install coremltools (macOS); export format='saved_model', "
              "then: ct.convert('<name>_saved_model', source='tensorflow')",
    "engine": "on a CUDA machine with TensorRT: export format='onnx', then: "
              "trtexec --onnx=<name>.onnx --saveEngine=<name>.engine --fp16",
    "paddle": "pip install x2paddle; export format='onnx', then: x2paddle "
              "--framework=onnx --model=<name>.onnx --save_dir=<name>_paddle",
    "ncnn": "build ncnn's onnx2ncnn, then: onnx2ncnn <name>.onnx "
            "<name>.param <name>.bin",
    "torchscript": "no equivalent: the deploy-portable artifact here is "
                   "format='pt2' (a torch.export program, loadable from C++ by AOTInductor)",
}


class _Predict(nn.Module):
    """The model's predict as a module's forward (what ``torch.export``
    traces)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model.predict(x)


class Exporter:
    """``Exporter(args)(model)``: ``args`` a ``get_cfg`` namespace (its
    ``format``, ``imgsz``, ``batch``, ``model``, ``project``, ``nms``);
    returns the artifact's path."""

    def __init__(self, args=None):
        self.args = args if args is not None else get_cfg()

    def __call__(self, model: nn.Module, fmt: Optional[str] = None) -> str:
        fmt = (fmt or self.args.format or "pt2").lower()
        if fmt in OFFLINE_RECIPES:
            raise NotImplementedError(
                f"format '{fmt}' is not written by this package. Offline recipe: "
                f"{OFFLINE_RECIPES[fmt]}"
            )
        if fmt not in EXPORT_FORMATS:
            raise ValueError(f"format '{fmt}' not in {EXPORT_FORMATS}")
        if getattr(model, "quantized", False):
            raise RuntimeError(
                "export of a native-int8 handle is not supported: format "
                "emitters expect f32 deploy kernels. Export the fp32 "
                "checkpoint instead."
            )
        t0 = time.time()
        imgsz = self.args.imgsz
        batch = getattr(self.args, "batch", 1) or 1
        # the ONNX writer is numpy: it takes the CPU's fold, whose file is the same on
        # any device (the card's fold may round a BatchNorm otherwise)
        model = fuse_model(copy.deepcopy(model).cpu() if fmt == "onnx" else copy.deepcopy(model))
        include_nms = bool(getattr(self.args, "nms", False))
        name = Path(str(self.args.model or f"yolov8-{model.task}")).stem
        out_dir = Path(self.args.project or ".")
        out_dir.mkdir(parents=True, exist_ok=True)
        metadata = export_metadata(model, name, imgsz, batch, include_nms)
        if fmt == "pt2":
            if include_nms:
                raise NotImplementedError(
                    "nms=True in a pt2 artifact is not ported (ROADMAP Queue 1 item 3.4b): the "
                    "port's NMS ends its fixpoint on a host test, which torch.export cannot "
                    "trace; export without NMS and run ops/nms.py on its output")
            path = out_dir / f"{name}.pt2"
            device = next(model.parameters()).device
            x = torch.zeros(batch, 3, imgsz, imgsz, device=device)
            with torch.no_grad():
                # a real predict first fills the per-shape caches (RT-DETR's anchors, AIFI's
                # positions) with real tensors: filled under the trace, they would keep its fakes
                model.predict(x)
                program = torch.export.export(_Predict(model).eval(), (x,))
            torch.export.save(program, str(path))
            metadata["layout"] = "NCHW, RGB, float32 in [0,1]"
            metadata["device"] = str(device)
        else:
            if include_nms:
                LOGGER.warning("onnx export carries decode in-graph but not NMS; ignoring "
                               "nms=True")
            from ..onnx.export import export_onnx

            path = out_dir / f"{name}.onnx"
            try:
                export_onnx(model, str(path), imgsz=imgsz,
                            metadata={k: json.dumps(v, default=str) for k, v in metadata.items()})
            except NotImplementedError as e:
                raise NotImplementedError(
                    f"native onnx export does not cover this model ({e}); JAX's fallback "
                    "converts its TensorFlow saved_model with tf2onnx (python -m "
                    "tf2onnx.convert --saved-model <dir> --output m.onnx --opset 12), which "
                    "needs TensorFlow") from e
            metadata["layout"] = "NCHW, RGB, float32 in [0,1]"
        with open(out_dir / f"{name}.metadata.json", "w") as fh:
            json.dump(metadata, fh, indent=2, default=str)
        LOGGER.info(f"export {fmt} -> {path} ({time.time() - t0:.1f}s)")
        return str(path)


def export_metadata(model: nn.Module, name: str, imgsz: int, batch: int,
                    include_nms: bool) -> dict:
    """The metadata of an export: the JAX exporter's keys and values, in its
    order, but the ``description``; its layout text is NHWC (its predict's)
    until a format sets its own."""
    return {
        "description": f"{name} ({model.task}) PyTorch export",
        "task": model.task,
        "imgsz": imgsz,
        "batch": batch,
        "nc": model.nc,
        "names": getattr(model, "names", {}),
        "strides": list(model.strides),
        "decode_in_graph": True,
        "nms_in_graph": include_nms,
        "layout": "NHWC, RGB, float32 in [0,1]",
        "output": (
            "(B, 4+nc+108, A): xyxy box | nc scores | 36 seg-x | 36 seg-y | 36 valid"
            if model.task == "segment"
            else "(B, 4+nc, A): xywh box | nc scores"
        ),
    }


def dump_prediction(pred, nc: int, height: int, width: int, path: str,
                    conf: float = 0.25, iou: float = 0.7):
    """Write one image's raw polar prediction (a (4 + nc + 108, A) or (1,
    ...) array or tensor) in the C++ example's binary format
    (``examples/polar-seg-cpp/main.cpp``): int32 [nc, A, h, w], float32
    [conf, iou], then the prediction channel-major in float32."""
    if isinstance(pred, torch.Tensor):
        pred = pred.detach().cpu().numpy()
    pred = np.asarray(pred, np.float32)
    if pred.ndim == 3:
        pred = pred[0]
    C, A = pred.shape
    assert C == 4 + nc + 108, f"expected polar layout, got C={C} nc={nc}"
    with open(path, "wb") as fh:
        fh.write(struct.pack("<iiii", nc, A, height, width))
        fh.write(struct.pack("<ff", conf, iou))
        fh.write(pred.tobytes())
    return path


def load_pt2(path, device=None):
    """Reload a ``pt2`` artifact (the counterpart of JAX's
    ``load_stablehlo``): ``fn(x)`` -> the exported predict's output. It runs
    on the device it was exported on (``device`` moves its input there)."""
    module = torch.export.load(str(path)).module()

    def fn(x):
        x = torch.as_tensor(x)
        if device is not None:
            x = x.to(device)
        with torch.no_grad():
            return module(x)

    return fn
