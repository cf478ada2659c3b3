"""Composite blocks in NCHW (counterpart of the JAX package's
``nn/modules/block.py``): the fork's RepBlock and SPPF, the stock
YOLOv8 blocks of the detect graph, DFL, Bottleneck and C2f, the mask
prototypes of the proto-mask head, Proto, rtdetr-l's PPHGNetV2 blocks
HGStem and HGBlock and its neck's RepC3, YOLO-NAS's SPP, NASBottleneck
and NASCSP, and the CSP blocks of the other configs: C1, C2, C3, C3x,
GhostBottleneck and C3Ghost."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .conv import Conv, GhostConv, LightConv, RepConv


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


class SPP(nn.Module):
    """Spatial pyramid pooling: cv1 to c1 // 2, max pools of each size in
    ``k`` (stride 1, -inf padded) beside it, concatenated into cv2."""

    def __init__(self, c1: int, c2: int, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [_maxpool_same(x, k) for k in self.k], 1))


class DFL(nn.Module):
    """Distribution Focal Loss integral: softmax over ``reg_max`` bins, then
    the expectation of the bin index, as the JAX module writes it (no frozen
    conv, no parameters). x (B, 4 * reg_max, A) -> (B, 4, A)."""

    def __init__(self, reg_max: int = 16):
        super().__init__()
        self.reg_max = reg_max

    def forward(self, x):
        b, _, a = x.shape
        probs = x.reshape(b, 4, self.reg_max, a).softmax(2)
        proj = torch.arange(self.reg_max, dtype=probs.dtype, device=probs.device)
        return torch.einsum("bkra,r->bka", probs, proj)


class Bottleneck(nn.Module):
    """Standard bottleneck: Conv(k[0]) -> Conv(k[1]), plus the input when
    ``shortcut`` and the widths agree."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3),
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Fast CSP bottleneck with 2 convs: cv1 to 2c channels, split in two
    halves (channel order kept: the first c channels, then the next c), n
    bottlenecks chained on the last piece, all pieces concatenated into
    cv2. The bottlenecks are ``m.{i}`` (the JAX ``m{i}``)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0)
                               for _ in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).split(self.c, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class Proto(nn.Module):
    """Mask prototypes of the proto-mask head: Conv 3x3 to ``c_``, a
    nearest 2x upsample (the JAX ``_resize2x``), Conv 3x3 to ``c_``, then
    Conv 1x1 to ``c2`` prototypes. The convs are ``cv1``, ``cv2``, ``cv3``,
    as in JAX."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2, 1)

    def forward(self, x):
        x = F.interpolate(self.cv1(x), scale_factor=2, mode="nearest")
        return self.cv3(self.cv2(x))


class RepC3(nn.Module):
    """C3 with ``n`` RepConv bottlenecks (``m``): ``cv1`` -> the RepConvs,
    plus ``cv2``, then ``cv3`` (no activation, as JAX's) where the hidden
    width ``c2 * e`` is not c2."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.m = nn.ModuleList(RepConv(c_, c_) for _ in range(n))
        self.cv3 = Conv(c_, c2, 1, 1, act=False) if c_ != c2 else None

    def forward(self, x):
        y = self.cv1(x)
        for m in self.m:
            y = m(y)
        y = y + self.cv2(x)
        return y if self.cv3 is None else self.cv3(y)


class HGStem(nn.Module):
    """PPHGNetV2's stem, ReLU throughout: ``stem1`` (3x3 s2), then two
    branches, 2x2 convs ``stem2a`` and ``stem2b`` (each on its input padded
    by one row and column below and right) and a 2x2 stride-1 max pool
    (padded the same way with -inf), concatenated (pool first), ``stem3``
    (3x3 s2) and ``stem4`` (1x1). Stride 4."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = Conv(c1, cm, 3, 2, act="relu")
        self.stem2a = Conv(cm, cm // 2, 2, 1, p=0, act="relu")
        self.stem2b = Conv(cm // 2, cm, 2, 1, p=0, act="relu")
        self.stem3 = Conv(cm * 2, c2, 3, 2, act="relu")
        self.stem4 = Conv(c2, c2, 1, 1, act="relu")

    def forward(self, x):
        x = self.stem1(x)
        x2 = self.stem2b(F.pad(self.stem2a(F.pad(x, (0, 1, 0, 1))), (0, 1, 0, 1)))
        x1 = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 2, 1)
        return self.stem4(self.stem3(torch.cat([x1, x2], 1)))


class HGBlock(nn.Module):
    """PPHGNetV2's HG block: ``n`` chained kxk blocks ``m`` (``LightConv``
    with ``lightconv``, else ``Conv``) of width cm, the input and every
    output concatenated, squeezed to c2 / 2 (``sc``, 1x1) and excited to c2
    (``ec``, 1x1); the input added back with ``shortcut`` where c1 == c2."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6,
                 lightconv: bool = False, shortcut: bool = False, act="relu"):
        super().__init__()
        block = LightConv if lightconv else Conv
        self.m = nn.ModuleList(block(c1 if i == 0 else cm, cm, k=k, act=act) for i in range(n))
        self.sc = Conv(c1 + n * cm, c2 // 2, 1, 1, act=act)
        self.ec = Conv(c2 // 2, c2, 1, 1, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        ys = [x]
        for m in self.m:
            ys.append(m(ys[-1]))
        y = self.ec(self.sc(torch.cat(ys, 1)))
        return y + x if self.add else y


class NASBottleneck(nn.Module):
    """YOLO-NAS's QARepVGG bottleneck: two RepConvs (``cv1``, ``cv2``), plus
    the input when ``shortcut`` and the widths agree."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = RepConv(c1, c2)
        self.cv2 = RepConv(c2, c2)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class NASCSP(nn.Module):
    """YOLO-NAS's CSP stage: cv1 (1x1 to c2 * e) through ``n`` chained
    NASBottlenecks (``m``), beside cv2 (1x1 to c2 * e), concatenated into
    cv3 (1x1 to c2)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.m = nn.ModuleList(NASBottleneck(c_, c_, shortcut) for _ in range(n))
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        for m in self.m:
            y = m(y)
        return self.cv3(torch.cat([y, self.cv2(x)], 1))


class C3(nn.Module):
    """CSP bottleneck with 3 convs: ``cv1`` (1x1 to c2 * e) through ``n``
    chained Bottlenecks ``m`` (kernels ``k``, e 1.0), beside ``cv2`` (1x1 to
    c2 * e), concatenated into ``cv3`` (1x1 to c2)."""

    k = (1, 3)

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.ModuleList(self._block(c_, shortcut, g) for _ in range(n))

    def _block(self, c_: int, shortcut: bool, g: int) -> nn.Module:
        return Bottleneck(c_, c_, shortcut, g, k=self.k, e=1.0)

    def forward(self, x):
        y = self.cv1(x)
        for m in self.m:
            y = m(y)
        return self.cv3(torch.cat([y, self.cv2(x)], 1))


class C3x(C3):
    """``C3`` with 3x3 kernels in both convs of its Bottlenecks (JAX's
    C3x, not the reference's cross convs)."""

    k = (3, 3)


class C1(nn.Module):
    """``cv1`` (1x1 to c2) through ``n`` chained 3x3 Convs ``m``, plus the
    ``cv1`` output."""

    def __init__(self, c1: int, c2: int, n: int = 1):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.m = nn.ModuleList(Conv(c2, c2, 3) for _ in range(n))

    def forward(self, x):
        y = z = self.cv1(x)
        for m in self.m:
            z = m(z)
        return z + y


class C2(nn.Module):
    """CSP bottleneck with 2 convs: ``cv1`` to 2c channels split in two
    halves, ``n`` chained Bottlenecks ``m`` (3x3, e 1.0) on the first,
    both concatenated into ``cv2``."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0)
                               for _ in range(n))

    def forward(self, x):
        a, b = self.cv1(x).split(self.c, 1)
        for m in self.m:
            a = m(a)
        return self.cv2(torch.cat([a, b], 1))


class GhostBottleneck(nn.Module):
    """Ghost bottleneck: GhostConv ``cv1`` (to c2 // 2), at ``s`` 2 a kxk
    depthwise Conv ``dw`` without activation, GhostConv ``cv2`` (to c2, no
    activation); plus the shortcut: at ``s`` 2 ``sc_dw`` (kxk depthwise)
    then ``sc_pw`` (1x1), else the input, or ``sc_pw`` where the widths
    differ; no activation on either."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = GhostConv(c1, c_, 1, 1)
        self.dw = Conv(c_, c_, k, s, g=c_, act=False) if s == 2 else None
        self.cv2 = GhostConv(c_, c2, 1, 1, act=False)
        self.sc_dw = Conv(c1, c1, k, s, g=c1, act=False) if s == 2 else None
        self.sc_pw = Conv(c1, c2, 1, 1, act=False) if s == 2 or c1 != c2 else None

    def forward(self, x):
        y = self.cv1(x)
        if self.dw is not None:
            y = self.dw(y)
        y = self.cv2(y)
        sc = x if self.sc_dw is None else self.sc_dw(x)
        return y + (sc if self.sc_pw is None else self.sc_pw(sc))


class C3Ghost(C3):
    """``C3`` with GhostBottlenecks (k 3, s 1) in ``m``; ``shortcut`` and
    ``g`` are accepted for config parity and unused, as in JAX."""

    def _block(self, c_: int, shortcut: bool, g: int) -> nn.Module:
        return GhostBottleneck(c_, c_)
