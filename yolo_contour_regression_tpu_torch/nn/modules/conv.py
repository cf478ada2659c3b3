"""Convolution primitives in NCHW (counterpart of the JAX package's
``nn/modules/conv.py``): Conv (conv + BN + act, default act ReLU), Conv2
(parallel 1x1 branch added before the activation), RepConv (3x3 + 1x1 +
identity BN, unfused) and Concat.

Attribute names follow the reference's state-dict keys (``conv``, ``bn``,
``cv2``, ``conv1.conv``, ``conv1.bn``, ...). BatchNorm matches flax's
``momentum=0.97, epsilon=1e-3``, which is ``eps=1e-3, momentum=0.03`` here,
and updates its running statistics as flax does (``BatchNorm2d`` below).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.03

# The fork switched the default activation from SiLU to ReLU.
DEFAULT_ACT = "relu"

ACTS = {
    "relu": nn.ReLU,
    "silu": nn.SiLU,
    "swish": nn.SiLU,
    "gelu": nn.GELU,
    "identity": nn.Identity,
    "sigmoid": nn.Sigmoid,
    "leaky_relu": lambda: nn.LeakyReLU(0.01),
}


def get_act(act) -> nn.Module:
    if isinstance(act, nn.Module):
        return act
    if act is True or act is None:
        return ACTS[DEFAULT_ACT]()
    if act is False:
        return nn.Identity()
    return ACTS[act]()


def autopad(k: int, p=None, d: int = 1):
    """Same-shape padding for odd kernels."""
    k = d * (k - 1) + 1 if d > 1 else k
    return (k - 1) // 2 if p is None else p


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running statistics: in train mode it
    normalizes with the biased batch variance, as torch does, and updates
    ``ra = (1 - momentum) * ra + momentum * batch`` with the **biased**
    variance too (torch's own update takes the unbiased one). Eval mode is
    torch's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            # in float32 under bfloat16 autocast too, as flax reduces
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def batch_norm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class Conv(nn.Module):
    """conv2d + BN + act."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p=None, g: int = 1,
                 d: int = 1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=False)
        self.bn = batch_norm(c2)
        self.act = get_act(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Conv2(nn.Module):
    """Conv with a parallel 1x1 branch added before BN and the activation."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, p=None, g: int = 1,
                 d: int = 1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, bias=False)
        self.cv2 = nn.Conv2d(c1, c2, 1, s, 0, groups=g, bias=False)
        self.bn = batch_norm(c2)
        self.act = get_act(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x) + self.cv2(x)))


class RepConv(nn.Module):
    """RepVGG-style training block: 3x3 + 1x1 (+ identity BN when c1 == c2
    and s == 1), kept unfused."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1, d: int = 1,
                 act=True, use_id_bn: bool = True):
        super().__init__()
        if k != 3:
            raise ValueError(f"RepConv takes k=3, got {k}")
        self.conv1 = Conv(c1, c2, 3, s, p=1, g=g, act=False)
        self.conv2 = Conv(c1, c2, 1, s, p=0, g=g, act=False)
        self.bn = batch_norm(c1) if use_id_bn and c1 == c2 and s == 1 else None
        self.act = get_act(act)

    def forward(self, x):
        y = self.conv1(x) + self.conv2(x)
        if self.bn is not None:
            y = y + self.bn(x)
        return self.act(y)


class DWConv(nn.Module):
    """Depthwise conv: a ``Conv`` ``dw`` with ``groups = gcd(c1, c2)`` (the
    JAX module's child; the reference's signature (c2, k, s, d, act) has no
    padding or groups)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, d: int = 1, act=True):
        super().__init__()
        self.dw = Conv(c1, c2, k, s, None, math.gcd(c1, c2), d, act)

    def forward(self, x):
        return self.dw(x)


class LightConv(nn.Module):
    """A 1x1 ``Conv`` without activation (``conv1``), then a depthwise kxk
    ``Conv`` (``conv2``)."""

    def __init__(self, c1: int, c2: int, k: int = 3, act=True):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=False)
        self.conv2 = Conv(c2, c2, k, g=c2, act=act)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class Concat(nn.Module):
    """Concatenate a list of tensors along channels (dim 1 in NCHW)."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.d = dim

    def forward(self, xs: Sequence[torch.Tensor]):
        return torch.cat(list(xs), dim=self.d)
