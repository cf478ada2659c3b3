"""Checkpoints of the JAX package, read without JAX (counterpart of its
``utils/checkpoint.py``), and its weight trees carried into PyTorch.

A ``.ckpt`` is one pickle of plain dicts of numpy arrays: ``params``,
``batch_stats``, ``ema_params``, ``model_yaml``, ``names``, ``train_args``, ...
``save_checkpoint`` writes the same format, ``strip_optimizer`` turns a
training checkpoint into its deployable form, and ``from_jax_variables``
inverts the name map of the JAX package's
``utils/torch_convert.py``, and ``to_jax_variables`` inverts it back:

  this port (reference .pt keys)       JAX tree
  -----------------------------------  ------------------------------------
  model.{i}.conv.weight (OIHW)         params.layer{i}.conv.kernel (HWIO)
  model.{i}.bn.{weight,bias}           params.layer{i}.bn.{scale,bias}
  model.{i}.bn.running_{mean,var}      batch_stats.layer{i}.bn.{mean,var}
  model.{i}.{r}....   (repeats)        layer{i}_{r}....
  model.{i}.cv2.{a}.{b}....  (heads)   layer{i}.cv2_{a}_{b}....
  model.{i}.m.{j}....  (C2f)           layer{i}.m{j}....
  model.{i}.detect.cv2.{a}.{b}....     layer{i}.detect.cv2_{a}_{b}....
    (Pose and Segmentori: the head keeps JAX's nested ``detect`` child,
    beside its ``cv4.{a}.{b}`` = ``cv4_{a}_{b}`` and Segmentori's
    ``proto.cv{1,2,3}``; no rule of their own is needed)
  model.{i}.linear.weight (out, in)    params.layer{i}.linear.kernel (in, out)
    (Classify's Dense, transposed; its ``conv`` is a Conv like any other)
  RepConv conv1.conv/conv1.bn/         RepConv conv1/bn1/
          conv2.conv/conv2.bn/bn               conv2/bn2/bn_id
    (a RepConv is told by its 3x3 conv1 and 1x1 conv2: LightConv's
    conv1/conv2 are Convs of their own, 1x1 then depthwise kxk)
  model.{i}.{...}.norm1.weight         params.layer{i}.{...}.norm1.scale
    (LayerNorm: its 1-D weight is the scale, as BatchNorm's)
  model.{i}.{...}.embedding            params.layer{i}.{...}.embedding
    (nn.Embed's table, as it is)
  model.{i}.{...}.query.kernel         params.layer{i}.{...}.query.kernel
    (the attention's DenseGeneral kernels, (C, nh, hd) and (nh, hd, C),
    and their biases, in JAX's shapes)
  model.{i}.conv_transpose.weight      params.layer{i}.conv_transpose.kernel
    (in, out, kh, kw), flipped          (kh, kw, in, out)
    (flax applies a transposed kernel as it is, torch flips it)
  (none)                               params.layer{i}.detect = {}
    (RT-DETR: JAX's anchor-head bias pass leaves an empty ``detect``
    subtree in the decoder head; ``to_jax_variables`` puts it back)
"""
from __future__ import annotations

import pickle
import re
from collections import OrderedDict
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# JAX module name holding the leaves -> the reference's dotted path
_REPCONV_MAP = {
    "conv1": ("conv1", "conv"),
    "bn1": ("conv1", "bn"),
    "conv2": ("conv2", "conv"),
    "bn2": ("conv2", "bn"),
    "bn_id": ("bn",),
}
_LEAF_MAP = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "kernel"): "weight",
    ("params", "embedding"): "embedding",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
_REPCONV_INV = {("conv1", "conv"): "conv1", ("conv1", "bn"): "bn1",
                ("conv2", "conv"): "conv2", ("conv2", "bn"): "bn2"}
# the version string written into checkpoints, the JAX package's format
CKPT_VERSION = "0.1.0"


def plain(v):
    """A value as plain Python (numpy scalars, paths, tuples and devices
    converted), so that the JAX package can unpickle a checkpoint without
    this port."""
    if isinstance(v, dict):
        return {plain(k): plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (Path, torch.device)):
        return str(v)
    return v


def load_checkpoint(path) -> Dict[str, Any]:
    """Unpickle a checkpoint written by the JAX package (trusted files only:
    unpickling can run code)."""
    with open(path, "rb") as fh:
        return pickle.load(fh)


def checkpoint_variables(ckpt: Dict[str, Any]) -> Tuple[dict, dict]:
    """(params, batch_stats) of a checkpoint: EMA weights when present, fp16
    deploy checkpoints cast to fp32."""
    params = ckpt.get("ema_params") or ckpt["params"]
    return _upcast(params), _upcast(ckpt.get("batch_stats") or {})


def _upcast(tree):
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    return arr.astype(np.float32) if arr.dtype == np.float16 else arr


def _module_path(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """JAX module path (layer{i}[_{r}], ...) -> reference dotted tokens."""
    m = re.fullmatch(r"layer(\d+)(?:_(\d+))?", path[0])
    if m is None:
        raise KeyError(f"not a graph layer: {'/'.join(path)}")
    out = ["model", m.group(1)] + ([m.group(2)] if m.group(2) is not None else [])
    for tok in path[1:]:
        head = re.fullmatch(r"(cv\d)_(\d+)_(\d+)|(m)(\d+)", tok)
        out += [g for g in head.groups() if g is not None] if head else [tok]
    return tuple(out[:-1]) + _REPCONV_MAP.get(out[-1], (out[-1],))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(params: dict, batch_stats: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``params``/``batch_stats`` numpy trees -> a state dict with the
    reference's ``model.{i}....`` keys. Conv kernels go HWIO -> OIHW,
    transposed-conv kernels (kh, kw, in, out) -> (in, out, kh, kw) flipped;
    every leaf maps to exactly one key (a collision raises); Dense kernels
    go (in, out) -> (out, in)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for coll, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, arr in _leaves(tree):
            leaf = _LEAF_MAP.get((coll, path[-1]))
            if leaf is None:
                raise KeyError(f"no mapping for {coll}/{'/'.join(path)}")
            arr = np.asarray(arr, np.float32)
            if path[-1] == "kernel" and arr.ndim == 3:  # DenseGeneral: kept as it is
                leaf = "kernel"
            elif path[-1] == "kernel":
                if arr.ndim not in (2, 4):
                    raise ValueError(f"{'/'.join(path)}: expected an HWIO, a Dense or a "
                                     f"DenseGeneral kernel, got {arr.shape}")
                if arr.ndim == 2:
                    arr = arr.T
                elif path[-2] == "conv_transpose":
                    arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1].copy()
                else:
                    arr = arr.transpose(3, 2, 0, 1)
            key = ".".join(_module_path(path[:-1]) + (leaf,))
            if key in sd:
                raise KeyError(f"two JAX leaves map to {key}")
            sd[key] = torch.tensor(arr)
    return sd


def load_jax_variables(model: torch.nn.Module, params: dict, batch_stats: dict):
    """Load JAX weight trees into ``model``; raises unless every parameter
    and running statistic of the model is set, with matching shapes, and
    every JAX leaf is used. (BatchNorm's ``num_batches_tracked`` counter has
    no JAX counterpart and keeps its value.)"""
    sd = from_jax_variables(params, batch_stats)
    want = {k: v.shape for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    missing = sorted(set(want) - set(sd))
    unused = sorted(set(sd) - set(want))
    if missing or unused:
        raise KeyError(f"weights do not fit the model: missing {missing[:5]}, unused {unused[:5]}")
    bad = [k for k in sd if tuple(sd[k].shape) != tuple(want[k])]
    if bad:
        raise ValueError(f"shape mismatch for {bad[:5]}")
    model.load_state_dict(sd, strict=False)
    return model


def _is_repconv(prefix: str, keys: Mapping[str, Tuple[int, ...]]) -> bool:
    """Whether the module at ``prefix`` is a RepConv: a 3x3 ``conv1`` and a
    1x1 ``conv2`` (a LightConv's are the other way round)."""
    return (tuple(keys.get(f"{prefix}.conv1.conv.weight", ()))[-2:] == (3, 3)
            and tuple(keys.get(f"{prefix}.conv2.conv.weight", ()))[-2:] == (1, 1))


def _jax_module_path(tokens, keys) -> Tuple[str, ...]:
    """Reference dotted module tokens (model.{i}[.{r}]...) -> JAX module
    path, the inverse of ``_module_path``. ``keys`` (every key of the state
    dict with its shape) tells a RepConv's branches and identity BN
    (``bn_id``) from a LightConv's or a Conv's."""
    if len(tokens) < 2 or tokens[0] != "model" or not tokens[1].isdigit():
        raise KeyError(f"not a graph layer: {'.'.join(tokens)}")
    rest = list(tokens[2:])
    layer = f"layer{tokens[1]}"
    if rest and rest[0].isdigit():
        layer += f"_{rest.pop(0)}"
    out = []
    while rest:
        tok = rest.pop(0)
        if re.fullmatch(r"cv\d", tok) and len(rest) >= 2 and rest[0].isdigit() and rest[1].isdigit():
            tok = f"{tok}_{rest.pop(0)}_{rest.pop(0)}"
        elif tok == "m" and rest and rest[0].isdigit():
            tok = f"m{rest.pop(0)}"
        out.append(tok)
    if tuple(out[-2:]) in _REPCONV_INV and _is_repconv(".".join(tokens[:-2]), keys):
        out = out[:-2] + [_REPCONV_INV[tuple(out[-2:])]]
    elif out and out[-1] == "bn" and _is_repconv(".".join(tokens[:-1]), keys):
        out[-1] = "bn_id"
    return (layer, *out)


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]) -> Tuple[dict, dict]:
    """A state dict with the reference's keys (or a dict of parameters
    only, such as the EMA) -> JAX ``(params, batch_stats)`` numpy trees; the
    exact inverse of ``from_jax_variables``. Conv kernels go OIHW -> HWIO
    (a transposed conv's unflipped to (kh, kw, in, out)), Linear weights
    (out, in) -> Dense kernels (in, out), LayerNorm weights -> scales,
    DenseGeneral kernels and Embed tables as they are, and an
    RT-DETR head (one with ``enc_score_head``) gets JAX's empty ``detect``
    subtree; BatchNorm's ``num_batches_tracked`` has no JAX counterpart and
    is dropped."""
    keys = {k: tuple(v.shape) for k, v in state_dict.items()}
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        tokens = key.split(".")
        leaf = tokens[-1]
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "running_mean":
            coll, jleaf = "batch_stats", "mean"
        elif leaf == "running_var":
            coll, jleaf = "batch_stats", "var"
        elif leaf in ("bias", "kernel", "embedding"):
            coll, jleaf = "params", leaf
        elif leaf == "weight" and arr.ndim == 4 and tokens[-2] == "conv_transpose":
            coll, jleaf = "params", "kernel"
            arr = arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        elif leaf == "weight" and arr.ndim == 4:
            coll, jleaf = "params", "kernel"
            arr = arr.transpose(2, 3, 1, 0)
        elif leaf == "weight" and arr.ndim == 2:
            coll, jleaf = "params", "kernel"
            arr = arr.T
        elif leaf == "weight" and arr.ndim == 1:
            coll, jleaf = "params", "scale"
        else:
            raise KeyError(f"no mapping for {key} {tuple(arr.shape)}")
        node = trees[coll]
        for tok in _jax_module_path(tokens[:-1], keys):
            node = node.setdefault(tok, {})
        if jleaf in node:
            raise KeyError(f"two keys map to {coll}/{key}")
        node[jleaf] = np.ascontiguousarray(arr)
    for layer in trees["params"].values():
        if "enc_score_head" in layer:
            layer.setdefault("detect", {})
    return trees["params"], trees["batch_stats"]


def save_checkpoint(path, params: dict, batch_stats: dict, ema_params: Optional[dict],
                    step: int, epoch: int, best_fitness: float, train_args: Dict[str, Any],
                    model_yaml: Dict[str, Any], names: Dict[int, str]):
    """Write a checkpoint in the JAX package's format (the keys of its
    ``save_checkpoint``; ``opt_state`` is None: the optimizer state of this
    port has no JAX form). The trees are numpy, as ``to_jax_variables``
    gives them, and the rest plain Python (``plain``)."""
    ckpt = {
        "deploy": None,
        "epoch": int(epoch),
        "best_fitness": float(best_fitness),
        "params": params,
        "batch_stats": batch_stats,
        "ema_params": ema_params,
        "opt_state": None,
        "step": int(step),
        "train_args": plain(dict(train_args)),
        "model_yaml": plain(dict(model_yaml)),
        "names": plain(dict(names)),
        "date": datetime.now().isoformat(),
        "version": CKPT_VERSION,
    }
    return _write(path, ckpt)


def _write(path, ckpt: Dict[str, Any]) -> Path:
    """Pickle to a temporary file, then rename: a crash never leaves a
    half-written checkpoint."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        pickle.dump(ckpt, fh, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)
    return path


def strip_optimizer(path, out_path=None) -> Path:
    """A training checkpoint -> its deployable form, as the JAX
    ``strip_optimizer`` makes it: the EMA weights become ``params``, and
    ``ema_params`` and ``opt_state`` are set to None. Written over ``path``
    unless ``out_path`` is given."""
    ckpt = load_checkpoint(path)
    if ckpt.get("ema_params") is not None:
        ckpt["params"] = ckpt["ema_params"]
    ckpt["ema_params"] = None
    ckpt["opt_state"] = None
    return _write(out_path or path, ckpt)
