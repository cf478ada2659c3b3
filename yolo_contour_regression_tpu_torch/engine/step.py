"""The training step (counterpart of the JAX package's ``engine/step.py``):
forward in train mode, polar loss, backward, gradient clip, optimizer step
and EMA, for the segment task.

The public boundary keeps the JAX layouts: images (B, H, W, 3) f32 in
[0, 1]; batch ``cls`` (B, N), ``bboxes`` (B, N, 4) normalized xywh,
``segments`` (B, N, 360, 2) normalized, ``mask_gt`` (B, N). With
``accumulate > 1`` every input carries a leading micro-batch axis and the
micro-batch gradients are summed, as the reference's repeated
``loss.backward()`` sums them.

``init_train_state(..., device="cuda")`` moves the model to the device and
keeps the EMA there; the step moves its inputs to the state's device.
Unlike the JAX step, which returns a new state, ``step(state, images,
batch)`` updates the model, optimizer and EMA in place and returns the
metrics.

Stages: given ``mark``, the step calls ``mark(stage)`` as each stage starts,
in order "forward", "assigner" (split around the GT-ray kernel's wrapper
into "assigner", "gt_rays", "assigner"), "loss", "backward",
"clip_optimizer_ema", and ``mark("end")`` last, so that a caller can time
each stage of this very step (a CUDA event per mark).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..utils import optim as optim_mod
from ..utils.loss import polar_loss, polar_targets

Mark = Optional[Callable[[str], None]]


def _no_mark(stage: str):
    pass


@dataclass
class TrainState:
    model: nn.Module
    optimizer: optim_mod.Optimizer
    ema: Dict[str, torch.Tensor]  # f32 copies of the parameters, by name
    device: torch.device
    step: int = 0  # optimizer updates done


def init_train_state(model: nn.Module, optimizer: optim_mod.Optimizer,
                     device="cuda") -> TrainState:
    """Moves ``model`` to ``device`` (its parameters in place, so the
    optimizer built on them keeps them) and copies the EMA there."""
    device = torch.device(device)
    model.to(device)
    ema = {n: p.detach().to(torch.float32).clone() for n, p in model.named_parameters()}
    return TrainState(model=model, optimizer=optimizer, ema=ema, device=device, step=0)


def make_loss_fn(model: nn.Module, hyp, cand=128, mark: Mark = None) -> Callable:
    """(images (B, H, W, 3), batch) -> (total, items) for the segment task;
    the model runs as it is (train mode updates its BatchNorm statistics)."""
    if getattr(model, "task", "segment") != "segment":
        raise NotImplementedError(f"task {model.task!r} is not ported; only 'segment'")
    mark = mark or _no_mark

    def loss_fn(images, batch):
        mark("forward")
        feats = model(images.permute(0, 3, 1, 2).contiguous())
        mark("assigner")
        targets = polar_targets(feats, batch, model.strides, model.nc, hyp, cand=cand, mark=mark)
        mark("loss")
        res = polar_loss(targets, hyp)
        return res.total, res.items

    return loss_fn


def make_train_step(model: nn.Module, optimizer: optim_mod.Optimizer, hyp, cand=128,
                    accumulate: int = 1, mark: Mark = None) -> Callable:
    """The step: ``step(state, images, batch) -> metrics``, 0-dim tensors
    left on the device (reading them is the caller's sync). ``mark``: see
    the module docstring."""
    loss_fn = make_loss_fn(model, hyp, cand=cand, mark=mark)
    mark = mark or _no_mark

    def step(state: TrainState, images: torch.Tensor, batch: Dict[str, torch.Tensor]):
        images = images.to(state.device)
        batch = {k: v.to(state.device) for k, v in batch.items()}
        state.model.train()
        state.optimizer.zero_grad()
        if accumulate > 1:
            totals, items = [], []
            for i in range(accumulate):
                total, it = loss_fn(images[i], {k: v[i] for k, v in batch.items()})
                mark("backward")
                total.backward()
                totals.append(total.detach())
                items.append(it)
            total = torch.stack(totals).mean()
            items = {k: torch.stack([it[k].detach() for it in items]).mean() for k in items[0]}
        else:
            total, items = loss_fn(images, batch)
            mark("backward")
            total.backward()
        mark("clip_optimizer_ema")
        state.optimizer.step(state.step)
        optim_mod.ema_update(state.ema, state.model, state.step + 1)
        state.step += 1
        mark("end")
        metrics = {k: v.detach() for k, v in items.items()}
        metrics["loss"] = total.detach()
        return metrics

    return step
