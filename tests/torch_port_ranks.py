"""Rank functions and trainers for the port's multi-rank tests
(``tests/test_torch_port_parallel.py``, ``tests/test_torch_port_ddp_trainer.py``).

Spawned ranks import this module, so it imports torch, numpy and the port
only (no JAX, no cv2): the rank functions must be importable by name in a
fresh interpreter. Each function also runs without a process group, as the
one-device reference."""
from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from yolo_contour_regression_tpu_torch.engine import trainer as ttrainer
from yolo_contour_regression_tpu_torch.engine.step import (init_train_state, make_loss_fn,
                                                           make_train_step)
from yolo_contour_regression_tpu_torch.nn.tasks import build_model
from yolo_contour_regression_tpu_torch.parallel import (all_reduce_grads, all_sum, rank,
                                                        rank_rows, world_size)
from yolo_contour_regression_tpu_torch.utils import loss as tloss
from yolo_contour_regression_tpu_torch.utils import optim
from yolo_contour_regression_tpu_torch.utils.checkpoint import load_jax_variables


def _tensors(tree: Dict[str, np.ndarray], device, dtype=None) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        t = torch.from_numpy(np.asarray(v)).to(device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[k] = t
    return out


def _model(job: Dict, device):
    model = build_model(job["cfg"])
    model.load_state_dict(job["state"])
    model.to(device=device, dtype=job["dtype"])
    return model


def step_job(job: Dict, device) -> Dict:
    """``job["steps"]`` steps of ``make_train_step`` on this rank's rows of
    the global batch ``job["images"]``, ``job["batch"]``: each step's
    metrics; after the first step every parameter's gradient (the summed,
    clipped one the update took) and every buffer; after the last the
    state dict."""
    model = _model(job, device)
    hyp = SimpleNamespace(**job["hyp"])
    opt = optim.build_optimizer(model, copy.copy(hyp), 10, 100)
    state = init_train_state(model, opt, device=device)
    step = make_train_step(model, opt, hyp, cand=job.get("cand", 128))
    r, world = rank(), world_size()
    images = rank_rows(torch.from_numpy(job["images"]), r, world).to(job["dtype"])
    batch = rank_rows(_tensors(job["batch"], "cpu"), r, world)
    out = {"metrics": []}
    for k in range(job["steps"]):
        m = step(state, images, batch)
        out["metrics"].append({n: float(v) for n, v in m.items()})
        if k == 0:
            out["grads"] = {n: p.grad.detach().cpu().clone()
                            for n, p in model.named_parameters() if p.grad is not None}
            out["buffers"] = {n: b.detach().cpu().clone() for n, b in model.named_buffers()}
    out["state"] = {n: t.detach().cpu().clone() for n, t in model.state_dict().items()}
    out["ema"] = {n: t.detach().cpu().clone() for n, t in state.ema.items()}
    return out


def polar_loss_job(job: Dict, device) -> Dict:
    """The polar loss and its gradient on this rank's rows (train mode, no
    update): the global loss and items, the summed gradients, and this
    rank's assignment (``fg_mask``, ``target_gt_idx``)."""
    model = _model(job, device).train()
    hyp = SimpleNamespace(**job["hyp"])
    r, world = rank(), world_size()
    images = rank_rows(torch.from_numpy(job["images"]), r, world).to(job["dtype"])
    batch = rank_rows(_tensors(job["batch"], "cpu"), r, world)
    got = {}
    orig = tloss.polar_task_aligned_assign

    def keep(*a, **kw):
        got["assign"] = orig(*a, **kw)
        return got["assign"]

    tloss.polar_task_aligned_assign = keep
    try:
        total, items = make_loss_fn(model, hyp, cand=job.get("cand", 128))(images, batch)
    finally:
        tloss.polar_task_aligned_assign = orig
    total.backward()
    all_reduce_grads(list(model.parameters()))
    a = got["assign"]
    return {"loss": float(all_sum(total.detach())),
            "items": {k: float(all_sum(v.detach())) for k, v in items.items()},
            "grads": {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "fg_mask": a.fg_mask.cpu().numpy(), "target_gt_idx": a.target_gt_idx.cpu().numpy()}


JOBS = {"step": step_job, "polar_loss": polar_loss_job}


def run_jobs(r: int, device, jobs: List[Dict]) -> List[Dict]:
    """``parallel.launch``'s target: each job of ``jobs`` in turn (its
    ``kind`` picks ``step_job`` or ``polar_loss_job``)."""
    return [JOBS[job["kind"]](job, device) for job in jobs]


def failing_rank(r: int, device, bad_rank: int) -> int:
    """Rank ``bad_rank`` raises; the others wait in an all-reduce that it
    never joins."""
    if r == bad_rank:
        raise ValueError(f"rank {r} fails on purpose")
    t = torch.ones(1)
    torch.distributed.all_reduce(t)
    return int(t.item())


class JaxInitSegmentationTrainer(ttrainer.SegmentationTrainer):
    """The seg trainer whose fresh model takes the variables that
    ``save_tree`` wrote to ``jax_init.npz`` in the trainer's project
    directory (JAX's init, carried into every rank)."""

    def build_model(self, nc, names, data=None):
        model = super().build_model(nc, names, data)
        return load_jax_variables(model, *load_tree(self.save_dir.parent / "jax_init.npz"))


def save_tree(path, params, batch_stats):
    """Nested dicts of arrays -> an ``.npz`` of ``params/a/b`` keys."""
    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}/{k}", v)
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v)

    walk("params", params)
    walk("batch_stats", batch_stats)
    np.savez(path, **flat)


def load_tree(path):
    """``save_tree``'s file -> (params, batch_stats) nested dicts."""
    out = {"params": {}, "batch_stats": {}}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            node = out[parts[0]]
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out["params"], out["batch_stats"]
