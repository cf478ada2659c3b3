"""Ultralytics ``.pt`` checkpoints -> this package (counterpart of the JAX
package's ``utils/torch_convert.py``).

A trained ``.pt`` of the reference (an Ultralytics 8.0.149 fork) is a
pickled torch ``DetectionModel``. It loads here without the ultralytics
package: a tolerant unpickler stands a stub in for each class it cannot
import, and the tensors still come through torch's own loader. The state
dict's names are then mapped onto the model's, by the JAX converter's rules
on the JAX package's tree form (``utils/checkpoint.py:to_jax_variables``),
so the same tensors land in the same places and the same ones are reported
missed or skipped:

  torch layout                          JAX tree form
  ------------------------------------  --------------------------------
  model.{i}.conv.weight (OIHW)          params.layer{i}.conv.kernel (HWIO)
  model.{i}.bn.{weight,bias}            params.layer{i}.bn.{scale,bias}
  model.{i}.bn.running_{mean,var}       batch_stats.layer{i}.bn.{mean,var}
  model.{i}.m.{j}.cv1...                layer{i}.m{j}.cv1...
  model.{i}.cv2.{a}.{b}...   (heads)    layer{i}[.detect].cv2_{a}_{b}...
  RepConv conv1.conv/conv1.bn/...,bn    conv1/bn1, conv2/bn2, bn_id
  Linear weight (O,I)                   kernel (I,O)
  model.{i}.dfl.conv.weight             (none: the DFL projection is arithmetic)

``convert_torch_checkpoint`` writes a checkpoint of the JAX package's format,
which both packages load. SAM's official state dicts need no map: the port's
SAM carries the official names (``convert_sam_state_dict``).
"""
from __future__ import annotations

import copy
import logging
import pickle
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

LOGGER = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# tolerant .pt loading
# ---------------------------------------------------------------------------

def _make_stub(module: str, name: str):
    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    return type(name, (), {"__setstate__": __setstate__, "_stub_origin": f"{module}.{name}"})


class _TolerantUnpickler(pickle.Unpickler):
    """Importable classes resolve as usual; the others become stubs that
    keep their pickled ``__dict__`` (enough to walk ``_modules`` and
    ``_parameters``)."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _make_stub(module, name)


class _PickleShim:
    Unpickler = _TolerantUnpickler
    load = staticmethod(pickle.load)
    loads = staticmethod(pickle.loads)


def load_torch_checkpoint(path) -> Dict[str, Any]:
    """``torch.load`` of a reference ``.pt`` without ultralytics installed:
    the checkpoint's dict (keys such as 'model', 'ema', 'train_args')."""
    obj = torch.load(str(path), map_location="cpu", pickle_module=_PickleShim,
                     weights_only=False)
    return obj if isinstance(obj, dict) else {"model": obj}


def _walk_module(obj, prefix: str, out: Dict[str, np.ndarray]):
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    for coll in ("_parameters", "_buffers"):
        for k, v in (d.get(coll) or {}).items():
            if v is None:
                continue
            arr = v.detach().cpu().float().numpy() if hasattr(v, "detach") else np.asarray(v)
            out[f"{prefix}{k}"] = arr
    for k, child in (d.get("_modules") or {}).items():
        _walk_module(child, f"{prefix}{k}.", out)


def extract_state_dict(ckpt: Dict[str, Any], prefer_ema: bool = True) -> Dict[str, np.ndarray]:
    """A flat name -> float32 numpy state dict of a stub-loaded checkpoint
    (the EMA weights where there are any, as the reference loads them)."""
    model = None
    if prefer_ema and ckpt.get("ema") is not None:
        model = ckpt["ema"]
    if model is None:
        model = ckpt.get("model", ckpt)
    out: Dict[str, np.ndarray] = {}
    if isinstance(model, dict):  # a plain state dict
        for k, v in model.items():
            out[k] = v.detach().cpu().float().numpy() if hasattr(v, "detach") else np.asarray(v)
        return out
    _walk_module(model, "", out)
    return out


# ---------------------------------------------------------------------------
# name mapping (the JAX converter's rules, on the JAX tree form)
# ---------------------------------------------------------------------------

# list attributes whose index joins without an underscore (m0, m1, ...)
_CONCAT_LISTS = {"m"}
# RepConv's torch submodules -> the JAX tree's flat names
_REPCONV_MAP = {
    ("conv1", "conv"): ("conv1",),
    ("conv1", "bn"): ("bn1",),
    ("conv2", "conv"): ("conv2",),
    ("conv2", "bn"): ("bn2",),
    ("bn",): ("bn_id",),
}


def _translate_tokens(tokens):
    """A torch dotted sub-path -> candidate JAX module paths, the most
    direct first; the RepConv renames are alternatives, tried against the
    target tree (a bare 'bn' is a Conv's BatchNorm in one layer and a
    RepConv's identity BatchNorm in another)."""
    outp = []
    for t in tokens:
        if t.isdigit() and outp:
            prev = outp[-1]
            outp[-1] = f"{prev}{t}" if prev in _CONCAT_LISTS else f"{prev}_{t}"
        else:
            outp.append(t)
    cands = [tuple(outp)]
    for pat, rep in _REPCONV_MAP.items():
        n = len(pat)
        if len(outp) >= n and tuple(outp[-n:]) == pat:
            cands.append(tuple(outp[:-n]) + rep)
    return cands


def _leaf_map(leaf: str, arr: np.ndarray, in_bn: bool):
    """A torch tensor name -> (the JAX leaf name, its collection, the array
    in JAX's layout), or None to skip it."""
    if leaf == "num_batches_tracked":
        return None
    if in_bn:
        return {
            "weight": ("scale", "params", arr),
            "bias": ("bias", "params", arr),
            "running_mean": ("mean", "batch_stats", arr),
            "running_var": ("var", "batch_stats", arr),
        }.get(leaf)
    if leaf == "weight":
        if arr.ndim == 4:  # conv OIHW -> HWIO
            return ("kernel", "params", np.transpose(arr, (2, 3, 1, 0)))
        if arr.ndim == 2:  # linear (O, I) -> (I, O)
            return ("kernel", "params", arr.T)
        return ("scale", "params", arr)  # LayerNorm and the like
    if leaf == "bias":
        return ("bias", "params", arr)
    return (leaf, "params", arr)


def _get(tree, path):
    cur = tree
    for p in path:
        if not isinstance(cur, dict) or p not in cur:
            return None
        cur = cur[p]
    return cur


def _set(tree, path, value):
    cur = tree
    for p in path[:-1]:
        cur = cur.setdefault(p, {})
    cur[path[-1]] = value


def convert_variables(state: Dict[str, np.ndarray], variables: Dict[str, Any],
                      strict: bool = False) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Map a torch state dict onto JAX-form ``variables`` ({"params",
    "batch_stats"} numpy trees), as the JAX ``convert_state_dict`` does:
    (the new trees, a report {converted, skipped, missed,
    unmatched_target}); ``strict`` raises when a tensor that has a mapping
    finds no place."""
    new_vars = {
        "params": copy.deepcopy(dict(variables["params"])),
        "batch_stats": copy.deepcopy(dict(variables.get("batch_stats", {}))),
    }
    converted, skipped, missed = [], [], []
    touched = set()

    for key, arr in state.items():
        tokens = key.split(".")
        if tokens and tokens[0] == "model":
            tokens = tokens[1:]
        if not tokens or not tokens[0].isdigit():
            skipped.append(key)
            continue
        layer = f"layer{tokens[0]}"
        sub, leaf = tokens[1:-1], tokens[-1]
        if sub and sub[-1] == "dfl" or (len(sub) >= 2 and sub[-2] == "dfl"):
            skipped.append(key)  # the DFL projection is arithmetic here
            continue
        in_bn = bool(sub) and sub[-1].startswith("bn")
        mapped = _leaf_map(leaf, arr, in_bn)
        if mapped is None:
            skipped.append(key)
            continue
        leaf_name, coll, new_arr = mapped
        candidates = []
        for path_mid in _translate_tokens(sub):
            candidates.append((layer,) + path_mid + (leaf_name,))
            # heads that nest the shared Detect branches (Pose, Segmentori)
            candidates.append((layer, "detect") + path_mid + (leaf_name,))
        placed = False
        for cand in candidates:
            tgt = _get(new_vars[coll], cand)
            if tgt is not None and tuple(tgt.shape) == tuple(new_arr.shape):
                _set(new_vars[coll], cand, new_arr.astype(np.asarray(tgt).dtype))
                touched.add((coll,) + cand)
                converted.append(key)
                placed = True
                break
        if not placed:
            missed.append(key)

    unmatched = []  # target leaves never written (their initial values kept)

    def scan(tree, coll, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                scan(v, coll, path + (k,))
            elif (coll,) + path + (k,) not in touched:
                unmatched.append("/".join((coll,) + path + (k,)))

    scan(new_vars["params"], "params")
    scan(new_vars["batch_stats"], "batch_stats")

    report = {
        "converted": len(converted),
        "skipped": skipped,
        "missed": missed,
        "unmatched_target": unmatched,
    }
    if missed:
        msg = f"{len(missed)} torch tensors found no home, e.g. {missed[:5]}"
        if strict:
            raise ValueError(msg)
        LOGGER.warning(msg)
    return new_vars, report


def convert_state_dict(state: Dict[str, np.ndarray], model: torch.nn.Module,
                       strict: bool = False) -> Tuple["Dict[str, torch.Tensor]", Dict[str, Any]]:
    """A torch state dict of the reference -> (the state dict of ``model``
    with its tensors in place (its own where none maps), the report of
    ``convert_variables``)."""
    from .checkpoint import from_jax_variables, to_jax_variables

    params, batch_stats = to_jax_variables(model.state_dict())
    new_vars, report = convert_variables(state, {"params": params, "batch_stats": batch_stats},
                                         strict=strict)
    return from_jax_variables(new_vars["params"], new_vars["batch_stats"]), report


def convert_sam_state_dict(state, model: torch.nn.Module, strict: bool = True):
    """An official SAM or MobileSAM state dict into the port's ``Sam``
    (``models/sam/convert.py:load_official``: the names are the official
    ones, so nothing is mapped; the TinyViT classifier head is skipped) ->
    (``model``, a report with the JAX converter's keys). ``strict`` raises on
    a missing or unexpected tensor."""
    from ..models.sam.convert import SKIPPED, load_official

    res = load_official(model, state, strict=strict)
    skipped = [k for k in state if k.startswith(SKIPPED)] if hasattr(state, "keys") else []
    return model, {"converted": res["converted"], "skipped": skipped,
                   "missed": res["unexpected"], "unmatched_target": res["missing"]}


def convert_torch_checkpoint(pt_path, model_yaml, out_path: Optional[str] = None,
                             nc: Optional[int] = None, imgsz: int = 640, strict: bool = False):
    """A reference ``.pt`` -> a checkpoint of the JAX package's format that
    ``YOLO(out_path)`` loads here and in the JAX package (default: the
    ``.pt``'s path with ``.ckpt``). ``model_yaml`` (a config name or path;
    its stem is looked up in ``nn/tasks.py:MODEL_CFGS``) must be the
    ``.pt``'s architecture; ``nc`` sets its classes. Tensors that find no
    place keep the weights drawn by ``init_weights`` from seed 0 (JAX keeps
    its own init's). ``imgsz`` is JAX's init size, unused here. Returns
    (the path, the report)."""
    from ..nn.tasks import build_model, init_weights, yaml_model_load
    from .checkpoint import save_checkpoint, to_jax_variables

    ckpt = load_torch_checkpoint(pt_path)
    state = extract_state_dict(ckpt)
    cfg = model_yaml if isinstance(model_yaml, dict) else yaml_model_load(model_yaml)
    model = init_weights(build_model(cfg, nc=nc), torch.Generator().manual_seed(0))
    params, batch_stats = to_jax_variables(model.state_dict())
    new_vars, report = convert_variables(state, {"params": params, "batch_stats": batch_stats},
                                         strict=strict)
    LOGGER.info(
        f"converted {report['converted']} tensors from {pt_path}; "
        f"{len(report['missed'])} missed, "
        f"{len(report['unmatched_target'])} target leaves kept their initial values"
    )
    train_args = ckpt.get("train_args") or {}
    if not isinstance(train_args, dict):
        train_args = {}
    out = Path(out_path or Path(pt_path).with_suffix(".ckpt"))
    save_checkpoint(
        out,
        params=new_vars["params"],
        batch_stats=new_vars["batch_stats"],
        ema_params=None,
        opt_state=None,
        step=0,
        epoch=int(ckpt.get("epoch", -1) or -1),
        best_fitness=float(ckpt.get("best_fitness") or 0.0),
        train_args={k: v for k, v in train_args.items() if isinstance(v, (int, float, str, bool))},
        model_yaml=model.yaml,
        names=getattr(model, "names", {}),
    )
    return str(out), report
