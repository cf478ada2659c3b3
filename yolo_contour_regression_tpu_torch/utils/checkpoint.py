"""Checkpoints of the JAX package, read without JAX (counterpart of its
``utils/checkpoint.py``), and its weight trees carried into PyTorch.

A ``.ckpt`` is one pickle of plain dicts of numpy arrays: ``params``,
``batch_stats``, ``ema_params``, ``model_yaml``, ``names``, ``train_args``, ...
and, in a checkpoint taken during training, ``opt_state``: optax's optimizer
state, a tree of optax NamedTuples (``EmptyState``, ``PartitionState``,
``MaskedState``, ``MaskedNode``, ``ScaleByAdamState``, ...) over numpy
leaves. This port has no optax: ``load_checkpoint`` maps each optax class
to a stand-in NamedTuple with the same fields (``OPTAX_STATES``; a class
not listed there is read positionally, an object of JAX itself raises), and
the writer pickles the stand-ins under optax's module paths, so the JAX
package unpickles its own classes (``utils/optim.py`` maps the state to the
port's optimizers and back). ``save_checkpoint`` writes the format,
``AsyncCheckpointSaver`` writes it from a snapshot in a process of its own
while training goes on, ``strip_optimizer`` turns a training checkpoint into its
deployable form, and ``from_jax_variables``
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

import collections
import functools
import math
import pickle
import os
import re
import subprocess
import sys
import threading
import time
from collections import OrderedDict
from datetime import datetime
from multiprocessing import resource_tracker, shared_memory
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

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


# (module, class) -> fields of each optax class that the JAX package's
# optimizers (its utils/optim.py:build_optimizer, under optax 0.2) put into
# ``opt_state``: the set its own pickle of every optimizer it builds refers to
OPTAX_STATES: Dict[Tuple[str, str], Tuple[str, ...]] = {
    ("optax._src.base", "EmptyState"): (),
    ("optax.transforms._combining", "PartitionState"): ("inner_states",),
    ("optax.transforms._masking", "MaskedState"): ("inner_state",),
    ("optax.transforms._masking", "MaskedNode"): (),
    ("optax._src.transform", "ScaleByAdamState"): ("count", "mu", "nu"),
    ("optax._src.transform", "ScaleByScheduleState"): ("count",),
    ("optax._src.transform", "ScaleByRmsState"): ("nu",),
    ("optax.transforms._accumulation", "TraceState"): ("trace",),
    ("optax.schedules._inject", "InjectStatefulHyperparamsState"):
        ("count", "hyperparams", "hyperparams_states", "inner_state"),
    ("optax.schedules._inject", "WrappedScheduleState"): ("count",),
}
# the stand-ins by class name, and each stand-in's (module, class) in a pickle
OPTAX = {name: collections.namedtuple(name, fields, module=module)
         for (module, name), fields in OPTAX_STATES.items()}
_OPTAX_GLOBALS: Dict[type, Tuple[str, str]] = {cls: (cls.__module__, cls.__name__)
                                              for cls in OPTAX.values()}
_JAX_ROOTS = ("jax", "jaxlib", "flax")


class OptaxUnknown(tuple):
    """An optax class not in ``OPTAX_STATES`` (another optax release or
    optimizer), read positionally; written back under its own path."""

    def __new__(cls, *args):
        return tuple.__new__(cls, args)


def optax_class(module: str, name: str) -> type:
    """The stand-in of optax's ``module.name``."""
    if (module, name) in OPTAX_STATES:
        return OPTAX[name]
    for cls, where in _OPTAX_GLOBALS.items():
        if where == (module, name):
            return cls
    cls = type(name, (OptaxUnknown,), {"__module__": module})
    _OPTAX_GLOBALS[cls] = (module, name)
    return cls


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "optax":
            return optax_class(module, name)
        if root in _JAX_ROOTS:
            raise pickle.UnpicklingError(
                f"{module}.{name}: the checkpoint holds an object of JAX itself, which this "
                f"port reads without JAX (the JAX package writes numpy leaves)")
        return super().find_class(module, name)


class _Pickler(pickle._Pickler):
    """The standard library's Python pickler, which writes the optax
    stand-ins as optax's own classes (``STACK_GLOBAL`` of their module and
    name, without importing optax: the C pickler imports a class's module to
    check it)."""

    def save_global(self, obj, name=None):
        where = _OPTAX_GLOBALS.get(obj) if isinstance(obj, type) else None
        if where is None:
            return super().save_global(obj, name)
        self.save(where[0])
        self.save(where[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def load_checkpoint(path) -> Dict[str, Any]:
    """Unpickle a checkpoint written by the JAX package or this port, with
    optax's classes read as their stand-ins (trusted files only: unpickling
    can run code)."""
    with open(path, "rb") as fh:
        return _Unpickler(fh).load()


def dump_checkpoint(ckpt: Dict[str, Any], fh):
    """Pickle ``ckpt`` to the open file ``fh`` in the format above
    (protocol 5, optax's classes under their own names)."""
    _Pickler(fh, protocol=pickle.HIGHEST_PROTOCOL).dump(ckpt)


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


def _jax_leaf(key: str, shape: Tuple[int, ...], keys) -> Tuple[str, Tuple[str, ...], str]:
    """A state-dict key -> (its JAX collection, its JAX path (the leaf's
    name last), the layout change: "", "hwio", "flip_hwio" or "t"); None
    for BatchNorm's ``num_batches_tracked``."""
    tokens = key.split(".")
    leaf, ndim, layout = tokens[-1], len(shape), ""
    if leaf == "num_batches_tracked":
        return None
    if leaf == "running_mean":
        coll, jleaf = "batch_stats", "mean"
    elif leaf == "running_var":
        coll, jleaf = "batch_stats", "var"
    elif leaf in ("bias", "kernel", "embedding"):
        coll, jleaf = "params", leaf
    elif leaf == "weight" and ndim == 4 and tokens[-2] == "conv_transpose":
        coll, jleaf, layout = "params", "kernel", "flip_hwio"
    elif leaf == "weight" and ndim == 4:
        coll, jleaf, layout = "params", "kernel", "hwio"
    elif leaf == "weight" and ndim == 2:
        coll, jleaf, layout = "params", "kernel", "t"
    elif leaf == "weight" and ndim == 1:
        coll, jleaf = "params", "scale"
    else:
        raise KeyError(f"no mapping for {key} {tuple(shape)}")
    return coll, _jax_module_path(tokens[:-1], keys) + (jleaf,), layout


@functools.lru_cache(maxsize=16)
def _jax_layout(signature: Tuple[Tuple[str, Tuple[int, ...]], ...]):
    """``_jax_leaf`` of every key of a state dict, by its keys and shapes
    (cached: a trainer saves the same model many times)."""
    keys = dict(signature)
    return tuple((k, _jax_leaf(k, shape, keys)) for k, shape in signature)


def to_jax_layout(arr: np.ndarray, layout: str) -> np.ndarray:
    """A port leaf in JAX's layout (``_jax_leaf``'s layout change): a new
    C-contiguous float32 array, made in one copy."""
    if layout == "hwio":
        arr = arr.transpose(2, 3, 1, 0)
    elif layout == "flip_hwio":
        arr = arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    elif layout == "t":
        arr = arr.T
    return np.array(arr, dtype=np.float32, order="C")


def jax_paths(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Tuple[Tuple[str, ...], str]]:
    """Each key of ``state_dict`` (but ``num_batches_tracked``) -> (its JAX
    path in its collection, its layout change)."""
    sig = tuple((k, tuple(v.shape)) for k, v in state_dict.items())
    return {k: (m[1], m[2]) for k, m in _jax_layout(sig) if m is not None}


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
    sig = tuple((k, tuple(v.shape)) for k, v in state_dict.items())
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, where in _jax_layout(sig):
        if where is None:
            continue
        coll, path, layout = where
        arr = to_jax_layout(state_dict[key].detach().cpu().numpy(), layout)
        node = trees[coll]
        for tok in path[:-1]:
            node = node.setdefault(tok, {})
        if path[-1] in node:
            raise KeyError(f"two keys map to {coll}/{key}")
        node[path[-1]] = arr
    for layer in trees["params"].values():
        if "enc_score_head" in layer:
            layer.setdefault("detect", {})
    return trees["params"], trees["batch_stats"]


def checkpoint_dict(params: dict, batch_stats: dict, ema_params: Optional[dict], step: int,
                    epoch: int, best_fitness: float, train_args: Dict[str, Any],
                    model_yaml: Dict[str, Any], names: Dict[int, str], opt_state=None,
                    deploy: Optional[str] = None) -> Dict[str, Any]:
    """The checkpoint's dict, with the keys of the JAX package's
    ``save_checkpoint``: the trees numpy, as ``to_jax_variables`` gives
    them, ``opt_state`` optax's tree (``utils/optim.py:jax_opt_state``) or
    None, the rest plain Python (``plain``)."""
    return {
        "deploy": deploy,
        "epoch": int(epoch),
        "best_fitness": float(best_fitness),
        "params": params,
        "batch_stats": batch_stats,
        "ema_params": ema_params,
        "opt_state": opt_state,
        "step": int(step),
        "train_args": plain(dict(train_args)),
        "model_yaml": plain(dict(model_yaml)),
        "names": plain(dict(names)),
        "date": datetime.now().isoformat(),
        "version": CKPT_VERSION,
    }


def save_checkpoint(path, params: dict, batch_stats: dict, ema_params: Optional[dict],
                    step: int, epoch: int, best_fitness: float, train_args: Dict[str, Any],
                    model_yaml: Dict[str, Any], names: Dict[int, str], opt_state=None,
                    deploy: Optional[str] = None):
    """Write a checkpoint in the JAX package's format (``checkpoint_dict``)
    to ``path``, or to each of a list of paths (pickled once). Returns the
    (first) path."""
    ckpt = checkpoint_dict(params, batch_stats, ema_params, step, epoch, best_fitness,
                           train_args, model_yaml, names, opt_state=opt_state, deploy=deploy)
    return write_checkpoint(path, ckpt)


def write_checkpoint(paths: Union[str, Path, Sequence], ckpt: Dict[str, Any]) -> Path:
    """Pickle ``ckpt`` to a temporary file beside the first path, then
    rename it there (a crash never leaves a half-written checkpoint); each
    further path gets a hard link to that file, renamed into place the same
    way (no checkpoint is written in place, so the names stay independent).
    Returns the first path."""
    paths = [Path(p) for p in ([paths] if isinstance(paths, (str, Path)) else paths)]
    first = paths[0]
    for p in paths:
        p.parent.mkdir(parents=True, exist_ok=True)
    tmp = first.with_suffix(first.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        dump_checkpoint(ckpt, fh)
    tmp.replace(first)
    for p in paths[1:]:
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.unlink(missing_ok=True)
        os.link(first, tmp)  # the same file under each name; every write renames a new one in
        tmp.replace(p)
    return first


def strip_optimizer(path, out_path=None, half: bool = False) -> Path:
    """A training checkpoint -> its deployable form, as the JAX
    ``strip_optimizer`` makes it: the EMA weights become ``params``, and
    ``ema_params`` and ``opt_state`` are set to None; ``half`` stores the
    float32 leaves of ``params`` and ``batch_stats`` as float16 (the loaders
    cast them back). Written over ``path`` unless ``out_path`` is given."""
    ckpt = load_checkpoint(path)
    if ckpt.get("ema_params") is not None:
        ckpt["params"] = ckpt["ema_params"]
    ckpt["ema_params"] = None
    ckpt["opt_state"] = None
    if half:
        ckpt["params"] = _to_half(ckpt["params"])
        ckpt["batch_stats"] = _to_half(ckpt["batch_stats"])
    return write_checkpoint(out_path or path, ckpt)


def _to_half(tree):
    if isinstance(tree, dict):
        return {k: _to_half(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == np.float32:
        return tree.astype(np.float16)
    return tree


class AsyncCheckpointSaver:
    """Checkpoints written by a process of their own while training goes on
    (the JAX package's ``AsyncCheckpointSaver``, with its order and error
    contract).

    ``submit(paths, tensors, build, *args)`` first joins the pending save
    (saves stay ordered), then snapshots ``tensors`` (a dict of dicts of
    tensors) on the calling thread: one device-side copy of them all into a
    flat buffer on their device (``torch._foreach_copy_``; an event recorded
    after it), kept for the next save of the same shapes. A worker thread
    waits for the event, copies the buffer to shared memory and hands the
    save to the writer process (``_WriterProcess``), which calls
    ``build(tensors, *args)`` on the shared copy (a module-level function:
    the name mapping, ``to_jax_variables``, happens there) and writes the
    checkpoint it returns to every path (``write_checkpoint``). The name
    mapping, the pickle and the writes hold the writer's interpreter, not the
    training thread's: done by a thread of the training process (on an H100
    host, 0.3-1 s a save), they slowed the host-bound steps around them.

    ``wait()`` joins the pending save and re-raises a failure of the worker
    or the writer as ``RuntimeError``, which ``submit`` does too: a lost
    checkpoint never passes for a saved one. ``close()`` waits and frees the
    shared memory. ``write_s`` holds each save's seconds in the writer."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._flat: Optional[tuple] = None  # (signature, device buffer, views, layout)
        self._shm = None
        self._pinned: dict = {}  # to_host's buffer
        self._writer = _WriterProcess.get()  # started now: ready by the first save
        self.write_s: List[float] = []

    def _snapshot(self, tensors: Dict[str, Dict[str, torch.Tensor]]):
        srcs = [t.detach() for d in tensors.values() for t in d.values()]
        sig = tuple((g, k, tuple(t.shape), t.dtype, t.device)
                    for (g, d) in tensors.items() for k, t in d.items())
        if self._flat is None or self._flat[0] != sig:
            layout, offset = [], 0
            for g, k, shape, dtype, _ in sig:
                nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
                layout.append((g, k, str(dtype).split(".")[1], shape, offset, nbytes))
                offset += -(-nbytes // 16) * 16  # 16-byte aligned
            flat = torch.empty(max(offset, 16), dtype=torch.uint8, device=srcs[0].device)
            views = [flat[o:o + n].view(t.dtype).view(t.shape)
                     for (_, _, _, _, o, n), t in zip(layout, srcs)]
            self._flat = (sig, flat, views, layout)
        _, flat, views, layout = self._flat
        torch._foreach_copy_(views, srcs)
        event = None
        if flat.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(flat.device))
        return flat, layout, event

    def _start(self, nbytes: int):
        """A shared-memory segment of ``nbytes``, and the writer."""
        if self._shm is None or self._shm.size < nbytes:
            if self._shm is not None:
                self._shm.close()
                self._shm.unlink()
            self._shm = shared_memory.SharedMemory(create=True, size=nbytes)
        self._writer = _WriterProcess.get()  # a new one if it has died

    def submit(self, paths: Sequence, tensors: Dict[str, Dict[str, torch.Tensor]],
               build: Callable[..., Dict[str, Any]], *args):
        self.wait()
        flat, layout, event = self._snapshot(tensors)
        self._start(flat.numel())
        job = (self._shm.name, layout, build, args, [str(p) for p in paths])

        def run():
            try:
                host = torch.frombuffer(self._shm.buf, dtype=torch.uint8, count=flat.numel())
                host.copy_(to_host(flat, event, self._pinned))
                del host  # the segment's buffer is no longer exported
                error, seconds = self._writer.run(job)
                if error:
                    raise OSError(f"the checkpoint writer failed: {error}")
                self.write_s.append(seconds)
            except BaseException as e:  # raised again by the next submit() or wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True, name="checkpoint-saver")
        self._thread.start()

    def wait(self):
        """Join the pending save; a failure of its worker raises here."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from e

    def close(self):
        """Wait for the pending save, then free the shared memory (a failed
        save raises after that). The writer stays for the process's next
        saver."""
        try:
            self.wait()
        finally:
            if self._shm is not None:
                self._shm.close()
                self._shm.unlink()
                self._shm = None


def to_host(flat: torch.Tensor, event, cache: dict) -> torch.Tensor:
    """A flat device buffer's bytes on the host, after ``event``: copied on
    a side stream into a pinned buffer of the same size (kept in the
    caller's ``cache`` for its next call), while the device goes on. (CUDA
    stages a copy into pageable memory, and the training thread's launches
    wait behind it for its whole length.) A CPU buffer is returned as it
    is."""
    if not flat.is_cuda:
        return flat
    key = (flat.device, flat.numel())
    if key not in cache:
        cache.clear()
        cache[key] = (torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True),
                      torch.cuda.Stream(flat.device))
    pinned, side = cache[key]
    with torch.cuda.stream(side):
        if event is not None:
            side.wait_event(event)
        pinned.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    return pinned


class _WriterProcess:
    """The checkpoint writer: one interpreter a training process, started at
    its first save and kept for every saver after (starting one, with torch
    and this package, takes seconds). A fresh ``python -c`` (not
    multiprocessing's spawn, which imports the caller's main module again,
    as a script read from stdin cannot be); jobs are pickled to its stdin,
    one at a time, and its replies read from its stdout. It ends when this
    process does (its stdin closes)."""

    _one: Optional["_WriterProcess"] = None
    _lock = threading.Lock()

    def __init__(self):
        env = dict(os.environ)
        root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(x for x in (root, env.get("PYTHONPATH")) if x)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "from yolo_contour_regression_tpu_torch.utils.checkpoint "
             "import _writer_main; _writer_main()"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        self.lock = threading.Lock()

    @classmethod
    def get(cls) -> "_WriterProcess":
        with cls._lock:
            if cls._one is None or cls._one.proc.poll() is not None:
                cls._one = cls()
            return cls._one

    def run(self, job) -> tuple:
        """Send a job, wait for its reply: (error or None, seconds)."""
        with self.lock:
            pickle.dump(job, self.proc.stdin, protocol=pickle.HIGHEST_PROTOCOL)
            self.proc.stdin.flush()
            try:
                return pickle.load(self.proc.stdout)
            except EOFError:
                raise OSError(f"the checkpoint writer exited ({self.proc.poll()})") from None


def _writer_main():
    """The checkpoint writer process: for each job read from stdin (pickled
    by its saver), the tensors from the shared-memory segment,
    ``build(tensors, *args)``, ``write_checkpoint``; replies on stdout
    (error or None, seconds)."""
    jobs, replies = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr  # stdout carries the replies alone
    torch.set_num_threads(1)
    shm = None
    while True:
        try:
            job = pickle.load(jobs)
        except EOFError:
            break
        if job is None:
            break
        name, layout, build, args, paths = job
        t = time.perf_counter()
        try:
            if shm is None or shm.name != name:
                if shm is not None:
                    shm.close()
                shm = shared_memory.SharedMemory(name=name)
                # the saver owns the segment: this process's tracker must not unlink it
                resource_tracker.unregister(shm._name, "shared_memory")
            write_checkpoint(paths, build(_shared_tensors(shm, layout), *args))
            reply = (None, time.perf_counter() - t)
        except Exception as e:  # the saver raises it in the training process
            reply = (f"{type(e).__name__}: {e}", time.perf_counter() - t)
        pickle.dump(reply, replies)
        replies.flush()
    if shm is not None:
        shm.close()


def _shared_tensors(shm, layout) -> Dict[str, Dict[str, torch.Tensor]]:
    """The tensors of ``layout`` (group, key, dtype, shape, offset, bytes),
    as views of the segment."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for g, k, dtype, shape, off, nbytes in layout:
        a = np.frombuffer(shm.buf, dtype=np.uint8, count=nbytes, offset=off)
        out.setdefault(g, {})[k] = torch.from_numpy(a.view(np.dtype(dtype)).reshape(shape))
    return out
