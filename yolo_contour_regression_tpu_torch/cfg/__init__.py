"""Config: the default train/val/predict settings and their merge
(counterpart of ``get_cfg`` in the JAX package's ``cfg/__init__.py``).

``DEFAULT_CFG`` is a copy of the JAX package's ``cfg/default.yaml`` as a
Python dict, key for key, as ``yaml.safe_load`` reads it: the port reads no
yaml. ``get_cfg`` merges defaults, a config and overrides, coerces strings
to the keys' types as the JAX version does, and returns a
``SimpleNamespace``. The CLI is not ported.
"""
from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Optional, Union

# the port's copies of the JAX package's dataset yamls (``check_det_dataset``
# looks a yaml up here by name)
DATASETS_DIR = Path(__file__).resolve().parent / "datasets"

DEFAULT_CFG: Dict[str, Any] = {
    "task": "detect",
    "mode": "train",
    "model": None,
    "data": None,
    "epochs": 100,
    "patience": 50,
    "batch": 16,
    "imgsz": 640,
    "save": True,
    "save_period": -1,
    "save_last_every": 1,
    "cache": False,
    "device": None,
    "tp": 1,
    "workers": 8,
    "project": None,
    "name": None,
    "exist_ok": False,
    "pretrained": True,
    "optimizer": "auto",
    "verbose": True,
    "seed": 0,
    "deterministic": True,
    "single_cls": False,
    "rect": False,
    "cos_lr": False,
    "close_mosaic": 15,
    "resume": False,
    "amp": True,
    "fraction": 1.0,
    "profile": False,
    "overlap_mask": True,
    "mask_ratio": 4,
    "val_mask_ratio": 1,
    "dropout": 0.3,
    "val": True,
    "split": "val",
    "save_json": False,
    "save_hybrid": False,
    "conf": None,
    "iou": 0.7,
    "max_det": 300,
    "half": False,
    "dnn": False,
    "plots": True,
    "source": None,
    "show": False,
    "save_txt": False,
    "save_conf": False,
    "save_crop": False,
    "show_labels": True,
    "show_conf": True,
    "vid_stride": 1,
    "line_width": None,
    "visualize": False,
    "augment": False,
    "agnostic_nms": False,
    "classes": None,
    "retina_masks": False,
    "boxes": True,
    "format": "onnx",
    "keras": False,
    "optimize": False,
    "int8": False,
    "dynamic": False,
    "simplify": False,
    "opset": None,
    "workspace": 4,
    "nms": False,
    "lr0": 0.01,
    "lrf": 0.01,
    "momentum": 0.937,
    "weight_decay": 0.0005,
    "warmup_epochs": 3.0,
    "warmup_momentum": 0.8,
    "warmup_bias_lr": 0.1,
    "box": 7.5,
    "cls": 0.5,
    "dfl": 1.5,
    "pose": 12.0,
    "kobj": 1.0,
    "label_smoothing": 0.0,
    "nbs": 64,
    "hsv_h": 0.015,
    "hsv_s": 0.7,
    "hsv_v": 0.4,
    "degrees": 0.0,
    "translate": 0.1,
    "scale": 0.5,
    "shear": 0.0,
    "perspective": 0.0,
    "flipud": 0.0,
    "fliplr": 0.5,
    "mosaic": 1.0,
    "mosaic9": 0.0,
    "mixup": 1.0,
    "copy_paste": 0.0,
    "cfg": None,
    "tracker": "botsort.yaml",
    "max_instances": 48,
    "device_augment": True,
    "cand_per_gt": 128,
    "cand_balance": True,
    "pre_nms": 1024,
    "mesh_axis": "batch",
    "donate": True,
    "steps_per_dispatch": "auto",
    "prebatch_augment": "auto",
    "val_dispatch_group": 8,
    "async_save": True,
}

CFG_FRACTION_KEYS = {
    "dropout", "iou", "lr0", "lrf", "momentum", "weight_decay", "warmup_momentum",
    "warmup_bias_lr", "label_smoothing", "hsv_h", "hsv_s", "hsv_v", "translate",
    "scale", "perspective", "flipud", "fliplr", "mosaic", "mosaic9", "mixup", "copy_paste",
    "conf", "fraction",
}
CFG_INT_KEYS = {
    "epochs", "patience", "workers", "seed", "close_mosaic", "mask_ratio", "val_mask_ratio",
    "max_det", "vid_stride", "workspace", "nbs", "save_period", "max_instances",
    "cand_per_gt", "pre_nms", "save_last_every",
}
CFG_BOOL_KEYS = {
    "save", "exist_ok", "verbose", "deterministic", "single_cls", "rect",
    "cos_lr", "resume", "amp", "profile", "overlap_mask", "val", "save_json",
    "save_hybrid", "half", "dnn", "plots", "show", "save_txt", "save_conf",
    "save_crop", "show_labels", "show_conf", "visualize", "augment",
    "agnostic_nms", "retina_masks", "boxes", "keras", "optimize", "int8",
    "dynamic", "simplify", "nms", "pretrained", "donate",
}
_DEPRECATED = {"boxes": "boxes", "hide_labels": "show_labels", "hide_conf": "show_conf"}


def _coerce(k: str, v: Any) -> Any:
    if v is None or isinstance(v, (dict, list)):
        return v
    if k in CFG_BOOL_KEYS and isinstance(v, str):
        if k in ("resume", "pretrained") and v.lower() not in (
                "0", "1", "true", "false", "yes", "no"):
            return v  # these accept a checkpoint path as well as a bool
        return v.lower() in ("1", "true", "yes")
    if k in CFG_INT_KEYS and isinstance(v, (str, float)):
        if k == "cand_per_gt" and isinstance(v, str) and v.lower() == "auto":
            return v  # imgsz-adaptive assigner cap (utils/tal.py:resolve_cand)
        return int(float(v))
    if k in CFG_FRACTION_KEYS and isinstance(v, str):
        return float(v)
    return v


def check_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Raises where a probability (``conf``, ``iou``, ``fraction``,
    ``mosaic``, ``mixup``, ``dropout``) lies outside [0, 1]."""
    for k in ("conf", "iou", "fraction", "mosaic", "mixup", "dropout"):
        v = cfg.get(k)
        if isinstance(v, (int, float)) and not 0.0 <= float(v) <= 1.0:
            raise ValueError(f"'{k}={v}' must be in [0, 1]")
    return cfg


def get_cfg(cfg: Union[Dict, SimpleNamespace, None] = None,
            overrides: Optional[Dict] = None) -> SimpleNamespace:
    """Defaults, then ``cfg`` (a dict or namespace), then ``overrides``,
    merged and coerced (the JAX ``get_cfg``; a yaml path is not read)."""
    if isinstance(cfg, SimpleNamespace):
        cfg = vars(cfg)
    merged = {**DEFAULT_CFG, **(cfg or {})}
    if overrides:
        merged.update({_DEPRECATED.get(k, k): v for k, v in overrides.items()})
    merged = {k: _coerce(k, v) for k, v in merged.items()}
    check_cfg(merged)
    return SimpleNamespace(**merged)
