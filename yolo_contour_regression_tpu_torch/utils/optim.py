"""Optimizer, schedules and EMA (counterpart of the JAX package's
``utils/optim.py``).

- Three parameter groups, by the JAX leaf's path as JAX labels it: every
  ``.bias`` (BatchNorm, LayerNorm and attention biases included) is "bias"
  (no weight decay, its own warmup lr), the other BatchNorm leaves and
  every LayerNorm scale are "norm" (no decay), conv, Dense, attention
  kernels and Embed tables are "weight" (decayed by ``weight_decay *
  batch * accumulate / nbs``).
- ``auto`` picks SGD (lr 0.01, nesterov) for runs of more than 10,000
  iterations and AdamW (lr fit to nc) otherwise. AdamW and SGD-nesterov are
  ported; any other name raises ``NotImplementedError``.
- Warmup over the first max(warmup_epochs * nb, 100) updates ramps the lr
  from 0 (the bias group from ``warmup_bias_lr``) and the SGD momentum from
  ``warmup_momentum``; then a linear or cosine epoch decay.
- Update k (0-based) takes ``sched(k)``, as optax counts: with warmup the
  very first update has lr 0.
- Gradients are clipped to a global norm of 10 as optax's
  ``clip_by_global_norm`` does (scaled by 10/||g|| only when ||g|| >= 10).
- EMA of the parameters (not the BatchNorm statistics), decay
  ``0.9999 * (1 - exp(-updates / 2000))``.

``torch.optim.AdamW`` and ``torch.optim.SGD(nesterov=True)`` carry the
update; the lr and momentum of each group are set before each step.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn

GROUPS = ("weight", "bias", "norm")
CLIP_NORM = 10.0


def param_group_label(name: str, norm_scale: bool = False) -> str:
    """bias / norm / weight group of a parameter by its dotted name;
    ``norm_scale`` marks a LayerNorm weight (JAX's ``scale`` leaf)."""
    keys = name.split(".")
    if keys[-1] == "bias":
        return "bias"
    if norm_scale or any("bn" in k.lower() or "batchnorm" in k.lower() for k in keys[:-1]):
        return "norm"
    return "weight"


def layer_norm_scales(model: nn.Module) -> set:
    """The names of ``model``'s LayerNorm weights."""
    return {f"{n}.weight" if n else "weight" for n, m in model.named_modules()
            if isinstance(m, nn.LayerNorm)}


def _warmup_steps(hyp, steps_per_epoch: int) -> int:
    nb = max(steps_per_epoch, 1)
    return max(round(hyp.warmup_epochs * nb), 100) if hyp.warmup_epochs > 0 else 0


def _f32(x) -> float:
    return float(np.float32(x))


def lr_schedule(hyp, steps_per_epoch: int) -> Callable[[int], float]:
    """Epoch-level decay times step-level warmup, as one step -> lr fn."""
    lr0, lrf = hyp.lr0, hyp.lrf
    epochs = max(int(hyp.epochs), 1)
    nb = max(steps_per_epoch, 1)
    nw = _warmup_steps(hyp, steps_per_epoch)

    def lf(epoch):
        if getattr(hyp, "cos_lr", False):
            return ((1 - math.cos(epoch * math.pi / epochs)) / 2) * (lrf - 1) + 1
        return (1 - epoch / epochs) * (1.0 - lrf) + lrf

    def sched(step):
        base = lr0 * lf(math.floor(step / nb))
        if nw == 0 or step >= nw:
            return _f32(base)
        return _f32(base * min(max(step / nw, 0.0), 1.0))

    return sched


def bias_lr_schedule(hyp, steps_per_epoch: int) -> Callable[[int], float]:
    """The bias group warms from ``warmup_bias_lr`` to the scheduled lr."""
    base_sched = lr_schedule(hyp, steps_per_epoch)
    nw = _warmup_steps(hyp, steps_per_epoch)

    def sched(step):
        if nw == 0 or step >= nw:
            return base_sched(step)
        base = base_sched(max(step, nw))  # the post-warmup target
        frac = min(max(step / nw, 0.0), 1.0)
        return _f32(hyp.warmup_bias_lr + (base - hyp.warmup_bias_lr) * frac)

    return sched


def momentum_schedule(hyp, steps_per_epoch: int) -> Callable[[int], float]:
    """SGD momentum warmup: ``warmup_momentum`` -> ``momentum``."""
    nw = _warmup_steps(hyp, steps_per_epoch)
    mom = float(hyp.momentum)
    warm = float(getattr(hyp, "warmup_momentum", mom))
    if nw == 0:
        return lambda step: mom
    return lambda step: _f32(warm + (mom - warm) * min(max(step / nw, 0.0), 1.0))


class Optimizer:
    """A torch optimizer over the three groups, with the JAX schedules:
    ``step(k)`` clips the gradients, sets each group's lr (and momentum)
    for update k, and applies the update."""

    def __init__(self, opt: torch.optim.Optimizer, scheds: Dict[str, Callable],
                 mom_sched=None):
        self.opt = opt
        self.scheds = scheds
        self.mom_sched = mom_sched

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.opt.param_groups for p in g["params"]]

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def clip_grads(self, max_norm: float = CLIP_NORM):
        """optax ``clip_by_global_norm``: g / ||g|| * max_norm when
        ||g|| >= max_norm, unchanged otherwise. Returns ||g||. The
        elementwise work is grouped into ``torch._foreach_*`` calls (the
        same operation on each element as a call a tensor, so the same bits,
        in fewer launches); the squared sums are added tensor by tensor, in
        order."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum(s.sum() for s in torch._foreach_mul(grads, grads)))
        keep = norm < max_norm  # stays on the device: no host sync
        scaled = torch._foreach_mul(torch._foreach_div(grads, norm), max_norm)
        for g, s in zip(grads, scaled):
            torch.where(keep, g, s, out=g)
        return norm

    def step(self, k: int):
        self.clip_grads()
        for g in self.opt.param_groups:
            g["lr"] = self.scheds[g["name"]](k)
            if self.mom_sched is not None:
                g["momentum"] = self.mom_sched(k)
        self.opt.step()


def build_optimizer(model: nn.Module, hyp, steps_per_epoch: int, iterations: int) -> Optimizer:
    """'auto' optimizer selection and the three groups (reference
    trainer.py build_optimizer). ``hyp`` is updated in place by 'auto', as
    the JAX version does."""
    name = str(getattr(hyp, "optimizer", "auto"))
    nc = getattr(hyp, "nc", 80) or 80
    if name == "auto":
        if iterations > 10000:
            name, lr0, mom = "SGD", 0.01, 0.9
        else:
            name, lr0, mom = "AdamW", round(0.002 * 5 / (4 + nc), 6), 0.9
        hyp.lr0, hyp.momentum, hyp.warmup_bias_lr = lr0, mom, 0.0
    if name not in ("AdamW", "SGD"):
        raise NotImplementedError(f"optimizer {name!r} is not ported; only AdamW and SGD")
    wd = (hyp.weight_decay * getattr(hyp, "batch", 16) * getattr(hyp, "accumulate", 1)
          / getattr(hyp, "nbs", 64))
    groups = {g: [] for g in GROUPS}
    scales = layer_norm_scales(model)
    for pname, p in model.named_parameters():
        groups[param_group_label(pname, pname in scales)].append(p)
    param_groups = [{"params": groups[g], "name": g, "weight_decay": wd if g == "weight" else 0.0}
                    for g in GROUPS if groups[g]]
    sched = lr_schedule(hyp, steps_per_epoch)
    scheds = {"weight": sched, "norm": sched, "bias": bias_lr_schedule(hyp, steps_per_epoch)}
    if name == "AdamW":
        opt = torch.optim.AdamW(param_groups, lr=0.0, betas=(hyp.momentum, 0.999), eps=1e-8)
        return Optimizer(opt, scheds)
    mom_sched = momentum_schedule(hyp, steps_per_epoch)
    opt = torch.optim.SGD(param_groups, lr=0.0, momentum=mom_sched(0), nesterov=True)
    return Optimizer(opt, scheds, mom_sched)


def ema_decay(step: int, decay: float = 0.9999, tau: float = 2000.0) -> float:
    """ModelEMA ramp ``decay * (1 - exp(-step / tau))``, rounded to f32."""
    return _f32(decay * -math.expm1(-step / tau))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, step: int,
               decay: float = 0.9999, tau: float = 2000.0):
    """ema = ema * d + params * (1 - d), in place, over the parameters (in
    ``torch._foreach_*`` calls: the same bits as a call a tensor)."""
    d = ema_decay(step, decay, tau)
    rest = float(np.float32(1.0) - np.float32(d))
    es = [ema[name] for name, _ in model.named_parameters()]
    ps = [p.detach().to(e.dtype) for e, (_, p) in zip(es, model.named_parameters())]
    torch._foreach_mul_(es, d)
    torch._foreach_add_(es, torch._foreach_mul(ps, rest))
