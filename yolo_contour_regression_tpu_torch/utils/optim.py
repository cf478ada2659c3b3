"""Optimizer, schedules and EMA (counterpart of the JAX package's
``utils/optim.py``).

- Three parameter groups, by the JAX leaf's path as JAX labels it: every
  ``.bias`` (BatchNorm, LayerNorm and attention biases included) is "bias"
  (no weight decay, its own warmup lr), the other BatchNorm leaves and
  every LayerNorm scale are "norm" (no decay), conv, Dense, attention
  kernels and Embed tables are "weight" (decayed by ``weight_decay *
  batch * accumulate / nbs``).
- ``auto`` picks SGD (lr 0.01, nesterov) for runs of more than 10,000
  iterations and AdamW (lr fit to nc) otherwise. The names JAX builds:
  AdamW, SGD (nesterov), Adam, NAdam, RAdam, Adamax and RMSProp; any other
  raises ``NotImplementedError``. Adam, NAdam, RAdam and Adamax take
  ``b1 = momentum``, ``b2 = 0.999``, RMSProp optax's decay 0.9 and eps 1e-8
  inside the root with ``momentum`` as its trace; in the "weight" group of
  these and of SGD the weight decay is added to the gradient first (optax's
  ``add_decayed_weights`` chained before them), AdamW's is decoupled.
- Warmup over the first max(warmup_epochs * nb, 100) updates ramps the lr
  from 0 (the bias group from ``warmup_bias_lr``) and the SGD momentum from
  ``warmup_momentum``; then a linear or cosine epoch decay.
- Update k (0-based) takes ``sched(k)``, as optax counts: with warmup the
  very first update has lr 0.
- Gradients are clipped to a global norm of 10 as optax's
  ``clip_by_global_norm`` does (scaled by 10/||g|| only when ||g|| >= 10).
- EMA of the parameters (not the BatchNorm statistics), decay
  ``0.9999 * (1 - exp(-updates / 2000))``.

``torch.optim.AdamW`` and ``torch.optim.SGD(nesterov=True)`` carry those
two updates; the lr and momentum of each group are set before each step.
``OptaxRule`` carries the other five, written from optax's formulas (where
``torch.optim`` differs: torch's NAdam has a momentum-decay schedule, its
RAdam rectifies from another threshold, its RMSprop decays by 0.99, and
its Adamax adds eps elsewhere), in ``torch._foreach_*`` calls.

The optimizer state maps to optax's ``opt_state`` tree and back
(``jax_opt_state``, ``load_jax_opt_state``): ``chain(clip, partition)`` of
the three groups, each group's moments over the whole parameter tree with
``MaskedNode`` where the group owns no parameter, every moment in its
parameter's JAX layout (``utils/checkpoint.py:to_jax_variables``), every
count the step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .checkpoint import OPTAX, jax_paths, to_jax_layout

GROUPS = ("weight", "bias", "norm")
CLIP_NORM = 10.0
OPTAX_RULES = ("Adam", "NAdam", "RAdam", "Adamax", "RMSProp")
OPTIMIZERS = ("AdamW", "SGD") + OPTAX_RULES
# each optimizer's moments, by optax's names, and the torch state key of each
SLOTS = {"AdamW": {"mu": "exp_avg", "nu": "exp_avg_sq"}, "SGD": {"trace": "momentum_buffer"},
         "RMSProp": {"nu": "nu", "trace": "trace"},
         **{n: {"mu": "mu", "nu": "nu"} for n in ("Adam", "NAdam", "RAdam", "Adamax")}}


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


def _bias_correction(decay: float, count: int) -> np.float32:
    """optax's ``1 - decay ** count`` in float32."""
    return np.float32(1.0) - np.float32(decay) ** np.float32(count)


class OptaxRule(torch.optim.Optimizer):
    """Adam, NAdam, RAdam, Adamax or RMSProp as optax computes them, on
    each group's lr and ``weight_decay`` (added to the gradient, optax's
    ``add_decayed_weights``) and its ``count``, the updates done before
    this one (``Optimizer.step`` sets both)."""

    def __init__(self, param_groups, rule: str, b1: float, b2: float = 0.999,
                 eps: float = 1e-8, momentum: float = 0.0):
        if rule not in OPTAX_RULES:
            raise ValueError(f"not an optax rule of this port: {rule!r}")
        super().__init__(param_groups, dict(lr=0.0, weight_decay=0.0, count=0, rule=rule, b1=b1,
                                            b2=b2, eps=eps, momentum=momentum))

    def _slots(self, params, names):
        out = []
        for n in names:
            out.append([self.state[p].setdefault(n, torch.zeros_like(p)) for p in params])
        return out

    @torch.no_grad()
    def step(self):
        for g in self.param_groups:
            rule, b1, b2, eps = g["rule"], g["b1"], g["b2"], g["eps"]
            ps = [p for p in g["params"] if p.grad is not None]
            if not ps:
                continue
            grads = [p.grad for p in ps]
            if g["weight_decay"]:
                grads = torch._foreach_add(grads, ps, alpha=g["weight_decay"])
            k, lr = int(g["count"]), float(g["lr"])
            if rule == "RMSProp":  # scale_by_rms, then -lr, then trace
                nu, trace = self._slots(ps, ("nu", "trace"))
                torch._foreach_mul_(nu, 0.9)
                torch._foreach_addcmul_(nu, grads, grads, value=1.0 - 0.9)
                u = torch._foreach_mul(grads, torch._foreach_rsqrt(torch._foreach_add(nu, eps)))
                torch._foreach_mul_(u, -lr)
                torch._foreach_mul_(trace, g["momentum"])
                torch._foreach_add_(trace, u)
                torch._foreach_add_(ps, trace)
                continue
            mu, nu = self._slots(ps, ("mu", "nu"))
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            bc1 = float(_bias_correction(b1, k + 1))
            if rule == "Adamax":  # the infinity norm
                torch._foreach_mul_(nu, b2)
                torch._foreach_maximum_(nu, torch._foreach_add(torch._foreach_abs(grads), eps))
                u = torch._foreach_div(torch._foreach_div(mu, bc1), nu)
                torch._foreach_add_(ps, u, alpha=-lr)
                continue
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            if rule == "NAdam":
                m_hat = torch._foreach_mul(torch._foreach_div(mu, float(_bias_correction(b1, k + 2))),
                                           b1)
                torch._foreach_add_(m_hat, torch._foreach_div(grads, bc1), alpha=1.0 - b1)
            else:
                m_hat = torch._foreach_div(mu, bc1)
            v_hat = torch._foreach_div(nu, float(_bias_correction(b2, k + 1)))
            u = torch._foreach_div(m_hat, torch._foreach_add(torch._foreach_sqrt(v_hat), eps))
            if rule == "RAdam":  # rectified where the variance is tractable
                ro_inf = np.float32(2.0 / (1.0 - b2) - 1.0)
                b2t = np.float32(b2) ** np.float32(k + 1)
                ro = ro_inf - np.float32(2.0) * np.float32(k + 1) * b2t / (np.float32(1.0) - b2t)
                if ro >= 5.0:
                    r = np.sqrt((ro - 4) * (ro - 2) * ro_inf / ((ro_inf - 4) * (ro_inf - 2) * ro),
                                dtype=np.float32)
                    torch._foreach_mul_(u, float(r))
                else:
                    u = m_hat
            torch._foreach_add_(ps, u, alpha=-lr)


class Optimizer:
    """A torch optimizer over the three groups, with the JAX schedules:
    ``step(k)`` clips the gradients, sets each group's lr (and momentum, and
    an ``OptaxRule``'s count) for update k, and applies the update. ``name``
    is the optimizer's JAX name, ``weight_decay`` the weight group's decay
    and ``labels`` each parameter's group, by its name (the map to optax's
    state reads them)."""

    def __init__(self, opt: torch.optim.Optimizer, scheds: Dict[str, Callable],
                 mom_sched=None, name: str = "AdamW", weight_decay: float = 0.0,
                 labels: Mapping[str, str] = None):
        self.opt = opt
        self.scheds = scheds
        self.mom_sched = mom_sched
        self.name = name
        self.weight_decay = weight_decay
        self.labels = dict(labels or {})

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
            if "count" in g:
                g["count"] = k
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
    if name not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer {name!r} is not ported; only {OPTIMIZERS}")
    wd = (hyp.weight_decay * getattr(hyp, "batch", 16) * getattr(hyp, "accumulate", 1)
          / getattr(hyp, "nbs", 64))
    groups = {g: [] for g in GROUPS}
    labels = {}
    scales = layer_norm_scales(model)
    for pname, p in model.named_parameters():
        labels[pname] = param_group_label(pname, pname in scales)
        groups[labels[pname]].append(p)
    param_groups = [{"params": groups[g], "name": g, "weight_decay": wd if g == "weight" else 0.0}
                    for g in GROUPS if groups[g]]
    sched = lr_schedule(hyp, steps_per_epoch)
    scheds = {"weight": sched, "norm": sched, "bias": bias_lr_schedule(hyp, steps_per_epoch)}
    kw = dict(name=name, weight_decay=wd, labels=labels)
    if name == "AdamW":
        opt = torch.optim.AdamW(param_groups, lr=0.0, betas=(hyp.momentum, 0.999), eps=1e-8)
        return Optimizer(opt, scheds, **kw)
    if name in OPTAX_RULES:
        opt = OptaxRule(param_groups, name, b1=hyp.momentum, momentum=hyp.momentum)
        return Optimizer(opt, scheds, **kw)
    mom_sched = momentum_schedule(hyp, steps_per_epoch)
    opt = torch.optim.SGD(param_groups, lr=0.0, momentum=mom_sched(0), nesterov=True)
    return Optimizer(opt, scheds, mom_sched, **kw)


@dataclass(frozen=True)
class OptimizerSpec:
    """What optax's ``opt_state`` of an optimizer holds besides its moments
    and counts: its name, the weight group's decay, each parameter's group,
    and (SGD's ``inject_hyperparams``) the last update's lr by group and
    momentum. Plain values: a checkpoint writer in another process takes
    it."""

    name: str
    weight_decay: float
    labels: Dict[str, str]
    lr: Dict[str, float]
    momentum: Optional[float]


def optimizer_spec(optimizer: Optimizer, step: int) -> OptimizerSpec:
    """``OptimizerSpec`` of ``optimizer`` after ``step`` updates."""
    prev = max(step - 1, 0)  # optax keeps the hyperparameters of the last update
    return OptimizerSpec(optimizer.name, optimizer.weight_decay, dict(optimizer.labels),
                         {g: f(prev) for g, f in optimizer.scheds.items()},
                         optimizer.mom_sched(prev) if optimizer.mom_sched else None)


def moment_tensors(optimizer: Optimizer, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The optimizer's moments as ``{"slot/name": tensor}`` (optax's slot
    names: "mu", "nu", "trace"), for a snapshot; a parameter not stepped yet
    has none."""
    slots = SLOTS[optimizer.name]
    out = {}
    for pname, p in model.named_parameters():
        st = optimizer.opt.state.get(p, {})
        for slot, key in slots.items():
            if key in st:
                out[f"{slot}/{pname}"] = st[key]
    return out


def _masked_tree(params: Mapping[str, torch.Tensor], paths, leaf: Callable[[str], Any]) -> dict:
    """A tree of the parameters' JAX paths, ``leaf(name)`` at each (an
    RT-DETR head keeps JAX's empty ``detect`` subtree, as
    ``to_jax_variables``)."""
    tree: dict = {}
    for name in params:
        path = paths[name][0]
        node = tree
        for tok in path[:-1]:
            node = node.setdefault(tok, {})
        node[path[-1]] = leaf(name)
    for layer in tree.values():
        if "enc_score_head" in layer:
            layer.setdefault("detect", {})
    return tree


def jax_opt_state(spec: OptimizerSpec, params: Mapping[str, torch.Tensor],
                  moments: Mapping[str, torch.Tensor], step: int):
    """optax's ``opt_state`` of the JAX package's ``build_optimizer`` for
    the optimizer of ``spec`` (``optimizer_spec``), after ``step`` updates:
    ``params`` the model's parameters by name (for the paths, shapes and
    layouts) and ``moments`` as ``moment_tensors`` gives them (host copies
    are fine; a missing one is zeros). Numpy leaves, optax's classes as
    ``utils/checkpoint.py``'s stand-ins."""
    name, labels = spec.name, spec.labels
    paths = jax_paths(params)
    count = np.asarray(step, np.int32)
    masked = OPTAX["MaskedNode"]()

    def slot_tree(slot, group):
        def leaf(pname):
            if labels[pname] != group:
                return masked
            t = moments.get(f"{slot}/{pname}")
            arr = (np.zeros(tuple(params[pname].shape), np.float32) if t is None
                   else t.detach().cpu().numpy())
            return to_jax_layout(arr, paths[pname][1])
        return _masked_tree(params, paths, leaf)

    inner = {}
    for group in sorted(GROUPS):
        if name == "SGD":
            core = OPTAX["InjectStatefulHyperparamsState"](
                count=count,
                hyperparams={"learning_rate": np.asarray(spec.lr[group], np.float32),
                             "momentum": np.asarray(spec.momentum, np.float32)},
                hyperparams_states={"learning_rate": OPTAX["WrappedScheduleState"](count),
                                    "momentum": OPTAX["WrappedScheduleState"](count)},
                inner_state=(OPTAX["TraceState"](slot_tree("trace", group)), OPTAX["EmptyState"]()))
        elif name == "RMSProp":
            core = (OPTAX["ScaleByRmsState"](slot_tree("nu", group)),
                    OPTAX["ScaleByScheduleState"](count),
                    OPTAX["TraceState"](slot_tree("trace", group)))
        else:
            adam = OPTAX["ScaleByAdamState"](count, slot_tree("mu", group), slot_tree("nu", group))
            core = ((adam, OPTAX["EmptyState"](), OPTAX["ScaleByScheduleState"](count))
                    if name == "AdamW" else (adam, OPTAX["ScaleByScheduleState"](count)))
        if group == "weight" and name != "AdamW" and spec.weight_decay:
            core = (OPTAX["EmptyState"](), core)  # add_decayed_weights first
        inner[group] = OPTAX["MaskedState"](core)
    return (OPTAX["EmptyState"](), OPTAX["PartitionState"](inner))


def _kind(x) -> str:
    return type(x).__name__


def _from_jax_layout(arr: np.ndarray, layout: str) -> np.ndarray:
    """The inverse of ``utils/checkpoint.py:to_jax_layout``."""
    if layout == "hwio":
        arr = arr.transpose(3, 2, 0, 1)
    elif layout == "flip_hwio":
        arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    elif layout == "t":
        arr = arr.T
    return np.ascontiguousarray(arr)


def _group_slots(name: str, group: str, state, weight_decay: float, step: int) -> Dict[str, Any]:
    """One group's ``MaskedState`` -> {slot: moment tree}, after checking
    that its form is this optimizer's and every count is ``step``."""
    def fail(why):
        raise ValueError(f"opt_state does not map to {name} (group {group!r}): {why}")

    if _kind(state) != "MaskedState":
        fail(f"a {_kind(state)} in place of a MaskedState")
    core = state[0]
    if group == "weight" and name != "AdamW" and weight_decay:
        if not (isinstance(core, tuple) and len(core) == 2 and _kind(core[0]) == "EmptyState"):
            fail("no add_decayed_weights before the weight group's rule")
        core = core[1]
    counts, slots = [], {}
    if name == "SGD":
        if _kind(core) != "InjectStatefulHyperparamsState":
            fail(f"{_kind(core)} in place of InjectStatefulHyperparamsState")
        counts += [core.count] + [s.count for s in core.hyperparams_states.values()]
        trace = [s for s in core.inner_state if _kind(s) == "TraceState"]
        if len(trace) != 1:
            fail("no TraceState")
        slots["trace"] = trace[0].trace
    else:
        want = {"AdamW": ("ScaleByAdamState", "EmptyState", "ScaleByScheduleState"),
                "RMSProp": ("ScaleByRmsState", "ScaleByScheduleState", "TraceState")}.get(
                    name, ("ScaleByAdamState", "ScaleByScheduleState"))
        if not isinstance(core, tuple) or tuple(_kind(c) for c in core) != want:
            fail(f"{[_kind(c) for c in core] if isinstance(core, tuple) else _kind(core)} in "
                 f"place of {list(want)}")
        for c in core:
            if _kind(c) == "ScaleByAdamState":
                counts.append(c.count)
                slots["mu"], slots["nu"] = c.mu, c.nu
            elif _kind(c) == "ScaleByRmsState":
                slots["nu"] = c.nu
            elif _kind(c) == "TraceState":
                slots["trace"] = c.trace
            elif _kind(c) == "ScaleByScheduleState":
                counts.append(c.count)
    if any(int(np.asarray(c)) != step for c in counts):
        fail(f"counts {[int(np.asarray(c)) for c in counts]} are not the step {step}")
    return slots


def load_jax_opt_state(optimizer: Optimizer, model: nn.Module, opt_state, step: int):
    """Set the optimizer's state from optax's ``opt_state`` (the JAX
    package's or ``jax_opt_state``'s) after ``step`` updates: each moment
    taken from its parameter's JAX path in its group's tree, back to the
    parameter's layout, dtype and device. Raises ``ValueError`` where the
    tree is not this optimizer's (another optimizer, a missing or extra
    moment, another shape, a count that is not ``step``)."""
    name, labels = optimizer.name, optimizer.labels
    params = dict(model.named_parameters())
    paths = jax_paths(params)
    if not (isinstance(opt_state, tuple) and len(opt_state) == 2
            and _kind(opt_state[0]) == "EmptyState" and _kind(opt_state[1]) == "PartitionState"):
        raise ValueError(f"opt_state is not chain(clip_by_global_norm, partition) of {name}")
    inner = opt_state[1][0]
    if set(inner) != set(GROUPS):
        raise ValueError(f"opt_state's groups {sorted(inner)} are not {sorted(GROUPS)}")
    torch_slots = SLOTS[name]
    new_state: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
    for group in GROUPS:
        slots = _group_slots(name, group, inner[group], optimizer.weight_decay, step)
        for slot, tree in slots.items():
            n_leaves = [0]

            def walk(node):
                if isinstance(node, dict):
                    for v in node.values():
                        walk(v)
                elif _kind(node) != "MaskedNode":
                    n_leaves[0] += 1

            walk(tree)
            owned = [n for n in params if labels[n] == group]
            if n_leaves[0] != len(owned):
                raise ValueError(f"opt_state does not map to {name}: group {group!r} {slot} has "
                                 f"{n_leaves[0]} moments for {len(owned)} parameters")
            for pname in owned:
                node = tree
                for tok in paths[pname][0]:
                    if not isinstance(node, dict) or tok not in node:
                        raise ValueError(f"opt_state has no {slot} for {pname} "
                                         f"({'/'.join(paths[pname][0])})")
                    node = node[tok]
                p = params[pname]
                arr = _from_jax_layout(np.asarray(node), paths[pname][1])
                if arr.shape != tuple(p.shape):
                    raise ValueError(f"opt_state's {slot} of {pname} is {arr.shape}, the "
                                     f"parameter {tuple(p.shape)}")
                st = new_state.setdefault(p, {})
                st[torch_slots[slot]] = torch.tensor(arr, dtype=p.dtype, device=p.device)
    for p, st in new_state.items():
        if name == "AdamW":
            st["step"] = torch.tensor(float(step), dtype=torch.float32)
        optimizer.opt.state[p] = st


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
