"""Convolution primitives in NCHW (counterpart of the JAX package's
``nn/modules/conv.py``): Conv (conv + BN + act, default act ReLU), Conv2
(parallel 1x1 branch added before the activation), RepConv (3x3 + 1x1 +
identity BN, unfused), DWConv, LightConv, ConvTranspose, Focus, GhostConv,
the attention of CBAM and Concat.

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

from ...parallel.mesh import all_sum_grad, world_size

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
    torch's.

    In a process group of more than one rank (``parallel/mesh.py``) the
    batch is the global one, as flax's BatchNorm sees it under GSPMD: the
    per-channel sum, sum of squares and count, one tensor in float32 (or
    the input's wider dtype), are summed over the ranks by a differentiable
    all-reduce, and the mean and biased variance come from them."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if world_size() > 1:
            return self._global_forward(x)
        with torch.no_grad():
            # in float32 under bfloat16 autocast too, as flax reduces (a
            # float64 network's in float64)
            xs = x if x.dtype == torch.float64 else x.float()
            var, mean = torch.var_mean(xs, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _global_forward(self, x):
        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n = xf.numel() // c
        stats = all_sum_grad(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                                        xf.new_full((1,), float(n))]))
        mean = stats[:c] / stats[2 * c]
        var = stats[c:2 * c] / stats[2 * c] - mean * mean
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean.to(self.running_mean.dtype),
                                                             alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var.to(self.running_var.dtype),
                                                            alpha=self.momentum)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


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


class ConvTranspose(nn.Module):
    """Transposed conv (``conv_transpose``) + optional BN + act, as flax's
    ``nn.ConvTranspose`` computes it: with ``p`` 0 its "VALID" padding (out
    = in * s + max(k - s, 0)), else ``p`` on each side of the dilated
    input. Torch's kernel is flax's flipped (``utils/checkpoint.py``). The
    conv has a bias where there is no BN (the raw ``nn.ConvTranspose2d`` of
    a config is ``bn=False, act=False``)."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0, bn: bool = True,
                 act=True):
        super().__init__()
        # flax pads the dilated input by (lo, hi); torch's padding P stands
        # for k - 1 - P on both sides, its output_padding adds to hi
        lo, hi = (k - 1, s - 1 + max(k - s, 0)) if p == 0 else (p, p)
        self.extra = max(lo - (k - 1), 0)  # padding past what torch expresses
        self.conv_transpose = nn.ConvTranspose2d(c1, c2, k, s, k - 1 - lo + self.extra,
                                                 hi - lo, bias=not bn)
        self.bn = batch_norm(c2) if bn else None
        self.act = get_act(act)

    def forward(self, x):
        ct = self.conv_transpose
        if self.extra:  # zeros around the full output, then the bias
            y = F.pad(F.conv_transpose2d(x, ct.weight, None, ct.stride, ct.padding,
                                         ct.output_padding), [self.extra] * 4)
            y = y if ct.bias is None else y + ct.bias[:, None, None]
        else:
            y = ct(x)
        return self.act(y if self.bn is None else self.bn(y))


def conv_transpose_raw(c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0) -> ConvTranspose:
    """A config's raw ``nn.ConvTranspose2d``: no BN, no activation, a bias."""
    return ConvTranspose(c1, c2, k, s, p, bn=False, act=False)


class Focus(nn.Module):
    """Space-to-depth 2x (even rows and columns, odd rows, odd columns, both
    odd, concatenated in that order), then the Conv ``conv``."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p=None, act=True):
        super().__init__()
        self.conv = Conv(c1 * 4, c2, k, s, p, act=act)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                                    x[..., 1::2, 1::2]], 1))


class GhostConv(nn.Module):
    """A Conv ``cv1`` to c2 // 2, and beside it a 5x5 depthwise Conv
    ``cv2`` of its output, concatenated."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, act=act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class ChannelAttention(nn.Module):
    """The input scaled by ``sigmoid(fc(mean over H, W))``, ``fc`` a biased
    1x1 conv."""

    def __init__(self, c1: int):
        super().__init__()
        self.fc = nn.Conv2d(c1, c1, 1, bias=True)

    def forward(self, x):
        return x * torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """The input scaled by ``sigmoid(cv1([mean, max] over channels))``,
    ``cv1`` a kxk conv without bias."""

    def __init__(self, k: int = 7):
        super().__init__()
        self.cv1 = nn.Conv2d(2, 1, k, padding=k // 2, bias=False)

    def forward(self, x):
        return x * torch.sigmoid(self.cv1(torch.cat([x.mean(1, keepdim=True),
                                                     x.amax(1, keepdim=True)], 1)))


class CBAM(nn.Module):
    """``channel_attention``, then ``spatial_attention``; the width is kept."""

    def __init__(self, c1: int, k: int = 7):
        super().__init__()
        self.channel_attention = ChannelAttention(c1)
        self.spatial_attention = SpatialAttention(k)

    def forward(self, x):
        return self.spatial_attention(self.channel_attention(x))


class Concat(nn.Module):
    """Concatenate a list of tensors along channels (dim 1 in NCHW)."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.d = dim

    def forward(self, xs: Sequence[torch.Tensor]):
        return torch.cat(list(xs), dim=self.d)
