"""Composite blocks in NCHW (counterpart of the JAX package's
``nn/modules/block.py``): the fork's RepBlock and SPPF."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .conv import Conv, RepConv


def _maxpool_same(x, k: int, s: int = 1):
    """Max pool with -inf padding k // 2, as flax ``nn.max_pool`` pads."""
    return F.max_pool2d(x, k, s, k // 2)


class RepBlock(nn.Module):
    """The fork's RepBlock: despite taking ``n`` repeats from the yaml, its
    forward is a single RepConv(c1, c2); ``n`` and ``shortcut`` are accepted
    for config parity and unused."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        self.cv1 = RepConv(c1, c2)

    def forward(self, x):
        return self.cv1(x)


class SPPF(nn.Module):
    """Fast SPP: 3 chained kxk max pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        y1 = _maxpool_same(x, self.k)
        y2 = _maxpool_same(y1, self.k)
        y3 = _maxpool_same(y2, self.k)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))
