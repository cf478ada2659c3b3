"""Config: the default train/val/predict settings and their merge
(counterpart of ``get_cfg`` in the JAX package's ``cfg/__init__.py``).

``DEFAULT_CFG`` is a copy of the JAX package's ``cfg/default.yaml`` as a
Python dict, key for key, as ``yaml.safe_load`` reads it: the port reads no
yaml but the subset of ``data/utils.py``. ``get_cfg`` merges defaults, a
config and overrides, coerces strings to the keys' types as the JAX version
does, and returns a ``SimpleNamespace``.

The CLI (``entrypoint``; ``python -m yolo_contour_regression_tpu_torch``)::

    yolo TASK MODE k=v ...      e.g. yolo segment val model=best.ckpt data=data.yaml
    yolo help | version | checks | settings [reset] | cfg | copy-cfg

``k=v`` values are typed as ``yaml.safe_load`` types them (numbers, yaml
1.1 booleans, null, lists, quoted strings; anything else stays a string).
TASK and MODE may also be given as ``task=`` and ``mode=``; without them
the mode is predict and the model's own task is taken; ``model=`` defaults
to ``TASK2MODEL``, ``device=`` to ``cuda``. train, val, predict and serve
go to the ``YOLO`` facade, each with the keys its method takes (others are
logged and dropped); metrics are printed, the exit code is 0. export, track
and benchmark are not ported; ``hub`` needs the network and raises. ``cfg``
prints ``DEFAULT_CFG`` as yaml (``default_cfg_yaml``, which
``yaml.safe_load`` reads back to the dict); ``copy-cfg`` writes it to
``default_copy.yaml`` in the working directory.
"""
from __future__ import annotations

import inspect
import logging
import math
import sys
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


LOGGER = logging.getLogger(__name__)
TASKS = ("detect", "segment", "segment_ori", "classify", "pose")
MODES = ("train", "val", "predict", "export", "track", "benchmark", "serve")
TASK2MODEL = {
    "detect": "yolov8n.yaml",
    "segment": "yolov8n-seg.yaml",
    "segment_ori": "yolov8-segori.yaml",
    "classify": "yolov8n-cls.yaml",
    "pose": "yolov8n-pose.yaml",
}
# the modes the port's facade does not have, and where they wait (ROADMAP.md)
NOT_PORTED = {"export": "export (ROADMAP Queue 1 item 3.4)",
              "track": "tracking (ROADMAP Queue 1 item 3.2)",
              "benchmark": "utils/benchmarks.py (ROADMAP Queue 1 item 5)"}
HELP = (
    "usage: yolo TASK MODE [k=v ...]\n"
    f"  TASK in {TASKS}\n  MODE in {MODES}\n"
    "example: yolo segment train model=yolov8n-seg.yaml data=coco8-seg.yaml epochs=1\n"
    "special: yolo checks | version | settings [reset] | cfg | copy-cfg"
)


def parse_key_value_args(args) -> Dict[str, Any]:
    """``['k=v', ...]`` -> a dict, each value typed as ``yaml.safe_load``
    types it (``data/utils.py:parse_yaml``); a value outside that reader's
    subset stays the string it is. Arguments without ``=`` are skipped."""
    from ..data.utils import YamlSubsetError, parse_yaml

    out = {}
    for a in args:
        if "=" not in a:
            continue
        k, v = a.split("=", 1)
        try:
            v = parse_yaml(v)
        except YamlSubsetError:
            pass
        out[k.strip()] = v
    return out


def _yaml_scalar(v) -> str:
    """``v`` as a yaml scalar that ``yaml.safe_load`` reads back to ``v``."""
    from ..data.utils import YamlSubsetError, parse_yaml

    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r:  # yaml 1.1 floats need the dot: 1e-05 -> 1.0e-05
            mantissa, _, exp = r.partition("e")
            r = f"{mantissa}.0" + (f"e{exp}" if exp else "")
        return r
    s = str(v)
    try:
        if parse_yaml(s) == s and s == s.strip():
            return s
    except YamlSubsetError:
        pass
    return "'" + s.replace("'", "''") + "'"


def default_cfg_yaml() -> str:
    """``DEFAULT_CFG`` as yaml text, a ``key: value`` line a key."""
    return "".join(f"{k}: {_yaml_scalar(v)}\n" for k, v in DEFAULT_CFG.items())


def _call(method, overrides: Dict[str, Any], mode: str):
    """``method`` with the overrides it takes; the others are logged."""
    params = inspect.signature(method).parameters
    if any(p.kind is p.VAR_KEYWORD for p in params.values()):
        return method(**overrides)
    taken = {k: v for k, v in overrides.items() if k in params}
    dropped = sorted(set(overrides) - set(taken))
    if dropped:
        LOGGER.warning(f"yolo {mode}: ignoring {dropped} (not arguments of {mode})")
    return method(**taken)


def entrypoint(argv=None) -> int:
    """The ``yolo`` CLI: see the module docstring. Returns the exit code."""
    argv = list(argv if argv is not None else sys.argv[1:])
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(HELP)
        return 0
    head = argv[0].lower().lstrip("-")
    if head in ("check", "checks"):
        from ..utils.checks import check_yolo

        for k, v in check_yolo(verbose=False).items():
            print(f"{k}: {v}")
        return 0
    if head == "version":
        from .. import __version__

        print(__version__)
        return 0
    if head in ("setting", "settings"):
        from ..utils.settings import get_settings

        s = get_settings()
        if len(argv) > 1 and argv[1] == "reset":
            s.reset()
            print("settings reset")
        for k, v in s.items():
            print(f"{k}={v}")
        return 0
    if head == "cfg":
        print(default_cfg_yaml(), end="")
        return 0
    if head == "copy-cfg":
        dst = Path.cwd() / "default_copy.yaml"
        dst.write_text(default_cfg_yaml())
        print(f"copied default config to {dst}\nusage example: yolo cfg={dst} imgsz=320")
        return 0
    if head in ("hub", "login", "logout"):
        raise RuntimeError("yolo hub needs the network (Ultralytics HUB), which this port does "
                           "not use")
    task = mode = None
    kv = []
    for a in argv:
        if a in TASKS:
            task = a
        elif a in MODES:
            mode = a
        else:
            kv.append(a)
    overrides = parse_key_value_args(kv)
    task = task or overrides.pop("task", None)
    mode = mode or overrides.pop("mode", None) or "predict"
    if mode not in MODES:
        raise ValueError(f"mode '{mode}' not in {MODES}")
    if mode in NOT_PORTED:
        raise NotImplementedError(f"yolo {mode} is not ported: {NOT_PORTED[mode]}")
    from ..engine.model import YOLO

    device = overrides.pop("device", None)
    device = f"cuda:{device}" if isinstance(device, int) else str(device or "cuda")
    model = YOLO(overrides.pop("model", None) or TASK2MODEL[task or "detect"], device=device,
                 task=task)
    result = _call(getattr(model, mode), overrides, mode)
    if isinstance(result, dict):  # metrics
        print(result)
    elif mode == "predict" and result is not None:
        for r in result if isinstance(result, (list, tuple)) else [result]:
            print(r)
    return 0
