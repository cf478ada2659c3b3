"""The training step (counterpart of the JAX package's ``engine/step.py``):
the augmentation on the device, forward in train mode, the loss,
backward, gradient clip, optimizer step and EMA, for the segment, detect,
pose, segment_ori, classify and rtdetr tasks (the loss by the model's
``task``: the polar loss, the stock detect loss, the pose or the
proto-mask loss on the detect loss's assignment, the classify
cross-entropy, or the RT-DETR criterion with contrastive denoising).

RT-DETR: each step draws its CDN groups (``models/utils/ops.py``) from a
generator seeded from ``(17, step)``, as the JAX step folds ``step`` into
``PRNGKey(17)`` (the draws are not JAX's); ``dn_fn(batch, step)``, if
given, makes the dn dict instead (a test hands the port JAX's). Its marks
are "forward" (the CDN draw included), "matching" (the cost and the
auction), "loss", "backward" and "clip_optimizer_ema".

The public boundary keeps the JAX layouts: images (B, H, W, 3) f32 in
[0, 1]; batch ``cls`` (B, N), ``bboxes`` (B, N, 4) normalized xywh,
``segments`` (B, N, 360, 2) normalized, ``mask_gt`` (B, N), and for pose
``keypoints`` (B, N, K, 3), xy normalized and a visibility; for classify
``cls`` (B,) alone (its host transforms give float images). With
``augment_fn`` (``data/device_augment.py:make_augment_fn``) the step takes
the loader's raw batches instead, images (B, S, S, 3) uint8 BGR with
``content_hw`` and ``pad_tl``, and augments them on the device first, with
draws from ``numpy.random.default_rng([aug_seed, step])`` (``[aug_seed,
step, micro]`` per micro-batch): the JAX step folds the same three numbers
into its key, so a run repeats itself (the draws are not JAX's). With
``accumulate > 1`` every input carries a leading micro-batch axis and the
micro-batch gradients are summed, as the reference's repeated
``loss.backward()`` sums them.

``amp=True`` runs the conv graph under ``torch.autocast`` in bfloat16, the
counterpart of the JAX model built with ``dtype=bfloat16`` (the trainer's
``amp``): parameters, gradients and BatchNorm statistics stay float32, and
the assigner and loss run in float32 on the head maps cast back, where the
JAX loss casts them (``utils/loss.py:polar_targets``, ``detect_targets``).

``init_train_state(..., device="cuda")`` moves the model to the device and
keeps the EMA there; the step moves its inputs to the state's device.
Unlike the JAX step, which returns a new state, ``step(state, images,
batch)`` updates the model, optimizer and EMA in place and returns the
metrics.

Data parallelism: in a process group of W > 1 ranks (``parallel/mesh.py``)
each rank steps on its rows of the global batch (of every micro-batch with
``accumulate > 1``). The BatchNorm statistics and the loss normalizers are
the global batch's (``nn/modules/conv.py``, ``utils/loss.py``), so each
rank's loss is its share of the one-device loss; after the last backward
the gradients are summed over the ranks in one flat buffer, before the
clip, so every rank applies the same update; the loss items returned are
the global ones. The augmentation draws of rank r come from
``default_rng([aug_seed, step, (micro,) r])`` (partners within the rank's
rows, as JAX's per-shard augmentation); RT-DETR's CDN draws are made for
the global batch and each rank takes its rows. At W = 1 nothing of this
runs.

Stages: given ``mark``, the step calls ``mark(stage)`` as each stage starts,
in order "augment" (with ``augment_fn``), "forward", "assigner" (split
around the GT-ray kernel's wrapper into "assigner", "gt_rays",
"assigner"), "loss", "backward", "all_reduce" (W > 1 only),
"clip_optimizer_ema", and ``mark("end")`` last, so that a caller can time
each stage of this very step (a CUDA event per mark).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.utils.loss import rtdetr_loss
from ..models.utils.ops import cdn_generator, get_cdn_group
from ..parallel.mesh import all_reduce_grads, all_sum, rank, world_size
from ..utils import optim as optim_mod
from ..utils.loss import (classification_loss, detect_loss, detect_targets, polar_loss,
                          polar_targets, pose_loss, segmentation_ori_loss)

Mark = Optional[Callable[[str], None]]
# the tasks whose loss the step takes
TASKS = ("segment", "detect", "pose", "segment_ori", "classify", "rtdetr")


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


def make_loss_fn(model: nn.Module, hyp, cand=128, mark: Mark = None, amp: bool = False,
                 dn_fn: Optional[Callable] = None) -> Callable:
    """(images (B, H, W, 3), batch, step=0) -> (total, items) for the
    model's task; the model runs as it is (train mode updates its BatchNorm
    statistics), under bfloat16 autocast with ``amp``. ``step`` seeds
    RT-DETR's CDN draws (``dn_fn``: see the module docstring). The assigner
    and loss math run in float32, or in ``hyp.loss_dtype`` where it is set
    (float64 for a float64 network's checks: ``utils/loss.py``). A fused
    (deploy) model does not train."""
    task = getattr(model, "task", "segment")
    if task not in TASKS:
        raise NotImplementedError(f"task {task!r} is not ported; only {TASKS}")
    if getattr(model, "fused", False):
        raise ValueError("a fused (deploy) model is inference-only")
    mark = mark or _no_mark
    dt = getattr(hyp, "loss_dtype", None) or torch.float32

    def loss_fn(images, batch, step: int = 0):
        mark("forward")
        if task == "rtdetr":
            dn = (dn_fn(batch, step) if dn_fn is not None
                  else get_cdn_group(batch, model.nc, cdn_generator(step),
                                     shard=(rank(), world_size())))
            with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=amp):
                outs = model(images.permute(0, 3, 1, 2).contiguous(), dn=dn)
            if amp:  # the criterion in float32 on the bfloat16 outputs
                outs = tuple(o.float() for o in outs)
            return rtdetr_loss(outs, batch, model.nc, dn=dn, mark=mark)
        with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=amp):
            feats = model(images.permute(0, 3, 1, 2).contiguous())
        mark("assigner")
        if task == "detect":
            targets = detect_targets(feats, batch, model.strides, model.nc, model.reg_max, dt)
            mark("loss")
            res = detect_loss(targets, hyp)
        elif task == "pose":
            res = pose_loss(feats, batch, model.strides, model.nc, hyp, model.kpt_shape,
                            model.reg_max, mark=mark, dtype=dt)
        elif task == "segment_ori":
            res = segmentation_ori_loss(feats, batch, model.strides, model.nc, hyp, nm=model.nm,
                                        reg_max=model.reg_max, mark=mark, dtype=dt)
        elif task == "classify":
            mark("loss")
            res = classification_loss(feats, batch)
        else:
            targets = polar_targets(feats, batch, model.strides, model.nc, hyp, cand=cand,
                                    mark=mark, dtype=dt)
            mark("loss")
            res = polar_loss(targets, hyp)
        return res.total, res.items

    return loss_fn


def make_train_step(model: nn.Module, optimizer: optim_mod.Optimizer, hyp, cand=128,
                    accumulate: int = 1, mark: Mark = None, augment_fn=None, aug_seed: int = 0,
                    amp: bool = False, dn_fn: Optional[Callable] = None) -> Callable:
    """The step: ``step(state, images, batch) -> metrics``, 0-dim tensors
    left on the device (reading them is the caller's sync). ``mark``,
    ``augment_fn``, ``amp`` and ``dn_fn``: see the module docstring."""
    loss_fn = make_loss_fn(model, hyp, cand=cand, mark=mark, amp=amp, dn_fn=dn_fn)
    mark = mark or _no_mark

    def micro_loss(state, images, batch, *micro):
        if augment_fn is not None:
            mark("augment")
            # a rank's draws are its own (JAX folds the shard index into its key)
            ranked = (rank(),) if world_size() > 1 else ()
            rng = np.random.default_rng([int(aug_seed), state.step, *micro, *ranked])
            images, batch = augment_fn(rng, images, batch)
        total, items = loss_fn(images, batch, state.step)
        mark("backward")
        total.backward()
        return total.detach(), {k: v.detach() for k, v in items.items()}

    def step(state: TrainState, images: torch.Tensor, batch: Dict[str, torch.Tensor]):
        images = images.to(state.device)
        batch = {k: v.to(state.device) for k, v in batch.items()}
        state.model.train()
        state.optimizer.zero_grad()
        if accumulate > 1:
            outs = [micro_loss(state, images[i], {k: v[i] for k, v in batch.items()}, i)
                    for i in range(accumulate)]
            total = torch.stack([t for t, _ in outs]).mean()
            items = {k: torch.stack([it[k] for _, it in outs]).mean() for k in outs[0][1]}
        else:
            total, items = micro_loss(state, images, batch)
        if world_size() > 1:  # the global batch's gradient and losses
            mark("all_reduce")
            all_reduce_grads(state.optimizer.params)
            total, items = all_sum(total), {k: all_sum(v) for k, v in items.items()}
        mark("clip_optimizer_ema")
        state.optimizer.step(state.step)
        optim_mod.ema_update(state.ema, state.model, state.step + 1)
        state.step += 1
        mark("end")
        return {**items, "loss": total}

    return step
