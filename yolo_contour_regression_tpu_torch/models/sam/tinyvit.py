"""MobileSAM's TinyViT-5M image encoder in NCHW (counterpart of the JAX
package's ``models/sam/tinyvit.py``), with the official ``mobile_sam.pt``
names (``image_encoder.patch_embed.seq.{0,2}``, ``layers.{i}.blocks.{j}``,
``layers.{i}.downsample``, ``neck.{0,1,2,3}``).

Conv + BatchNorm pairs are ``Conv2dBN`` (``c``, ``bn``; eps 1e-5, running
statistics, not the YOLO BatchNorm), GELU exact, the attention and MLP
LayerNorms eps 1e-5, the neck's eps 1e-6. The attention adds a learned
per-head bias over the unique absolute offsets, numbered in first-encounter
order (``bias_idxs``); the last PatchMerging has stride 1, so the encoder
ends at 1/16; a block whose input is exactly its window skips the window
partition. tiny_vit_5m: dims (64, 128, 160, 320), depths (2, 2, 6, 2),
heads (2, 4, 5, 10), windows (7, 7, 14, 7).
"""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .modules import gelu, sam_neck, window_partition, window_unpartition

TINYVIT_5M = {
    "embed_dims": (64, 128, 160, 320),
    "depths": (2, 2, 6, 2),
    "num_heads": (2, 4, 5, 10),
    "window_sizes": (7, 7, 14, 7),
}


class Conv2dBN(nn.Module):
    """Bias-free conv ``c`` then BatchNorm ``bn`` (eps 1e-5)."""

    def __init__(self, c1: int, c2: int, ks: int = 1, stride: int = 1, pad: int = 0,
                 groups: int = 1):
        super().__init__()
        self.c = nn.Conv2d(c1, c2, ks, stride, pad, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-5)

    def forward(self, x):
        return self.bn(self.c(x))


class PatchEmbed(nn.Module):
    """Two stride-2 Conv2dBN with a GELU between (``seq.0``, ``seq.2``): 1/4."""

    def __init__(self, in_chans: int, embed_dim: int):
        super().__init__()
        self.seq = nn.Sequential(Conv2dBN(in_chans, embed_dim // 2, 3, 2, 1), nn.GELU(),
                                 Conv2dBN(embed_dim // 2, embed_dim, 3, 2, 1))

    def forward(self, x):
        return self.seq(x)


class MBConv(nn.Module):
    """1x1 expand, 3x3 depthwise, 1x1 project, GELUs; GELU after the add."""

    def __init__(self, c: int, expand: float = 4.0):
        super().__init__()
        h = int(c * expand)
        self.conv1 = Conv2dBN(c, h)
        self.conv2 = Conv2dBN(h, h, 3, 1, 1, groups=h)
        self.conv3 = Conv2dBN(h, c)

    def forward(self, x):
        y = gelu(self.conv2(gelu(self.conv1(x))))
        return gelu(x + self.conv3(y))


class PatchMerging(nn.Module):
    """1x1 -> GELU -> depthwise 3x3 (``stride``) -> GELU -> 1x1."""

    def __init__(self, c1: int, c2: int, stride: int = 2):
        super().__init__()
        self.conv1 = Conv2dBN(c1, c2)
        self.conv2 = Conv2dBN(c2, c2, 3, stride, 1, groups=c2)
        self.conv3 = Conv2dBN(c2, c2)

    def forward(self, x):
        return self.conv3(gelu(self.conv2(gelu(self.conv1(x)))))


def bias_idxs(h: int, w: int) -> np.ndarray:
    """(N, N) index of each pair of an h x w window into the table of unique
    |offsets|, numbered in first-encounter order."""
    points = list(itertools.product(range(h), range(w)))
    offsets, idxs = {}, []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    return np.asarray(idxs, np.int64).reshape(len(points), len(points))


class TinyAttention(nn.Module):
    """Pre-LayerNorm attention on (B, N, C): a fused qkv split per head into
    q, k (key_dim) and v (attn_ratio * key_dim), and ``attention_biases``
    (nh, unique offsets) added through ``attention_bias_idxs``."""

    def __init__(self, dim: int, key_dim: int, num_heads: int, attn_ratio: float = 1.0,
                 resolution: Tuple[int, int] = (7, 7)):
        super().__init__()
        self.num_heads, self.key_dim = num_heads, key_dim
        self.d = int(attn_ratio * key_dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, num_heads * (2 * key_dim + self.d))
        self.proj = nn.Linear(num_heads * self.d, dim)
        idx = torch.from_numpy(bias_idxs(*resolution))
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, int(idx.max()) + 1))
        self.register_buffer("attention_bias_idxs", idx, persistent=False)

    def forward(self, x):
        b, n, _ = x.shape
        kd, nh = self.key_dim, self.num_heads
        qkv = self.qkv(self.norm(x)).reshape(b, n, nh, -1)
        q, k, v = qkv[..., :kd], qkv[..., kd:2 * kd], qkv[..., 2 * kd:]
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        attn = ((q * kd ** -0.5) @ k.transpose(-2, -1)
                + self.attention_biases[:, self.attention_bias_idxs][None])
        out = (attn.softmax(-1) @ v).transpose(1, 2).reshape(b, n, nh * self.d)
        return self.proj(out)


class Mlp(nn.Module):
    """LayerNorm (eps 1e-5) -> fc1 -> GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(self.norm(x))))


class TinyViTBlock(nn.Module):
    """Windowed attention (whole-input when the input is the window),
    residual, depthwise 3x3 ``local_conv``, then the MLP and its residual.
    Input (B, C, H, W)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.ws = window_size
        self.attn = TinyAttention(dim, dim // num_heads, num_heads,
                                  resolution=(window_size, window_size))
        self.local_conv = Conv2dBN(dim, dim, 3, 1, 1, groups=dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        b, c, h, w = x.shape
        t = x.permute(0, 2, 3, 1)
        if h == self.ws and w == self.ws:
            y = self.attn(t.reshape(b, h * w, c)).reshape(b, h, w, c)
        else:
            wins, pad_hw = window_partition(t, self.ws)
            nw = wins.shape[0]
            y = self.attn(wins.reshape(nw, self.ws * self.ws, c))
            y = window_unpartition(y.reshape(nw, self.ws, self.ws, c), self.ws, pad_hw, (h, w))
        x = self.local_conv((t + y).permute(0, 3, 1, 2))
        t = x.permute(0, 2, 3, 1)
        return (t + self.mlp(t)).permute(0, 3, 1, 2)


class ConvLayer(nn.Module):
    """Stage 0: MBConv ``blocks`` and the ``downsample`` merge."""

    def __init__(self, dim: int, out_dim: int, depth: int, merge_stride: int = 2):
        super().__init__()
        self.blocks = nn.ModuleList(MBConv(dim) for _ in range(depth))
        self.downsample = PatchMerging(dim, out_dim, merge_stride)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class BasicLayer(nn.Module):
    """Stages 1-3: TinyViT ``blocks`` and a ``downsample`` merge, none on
    the last stage (``out_dim`` 0)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int, out_dim: int = 0,
                 merge_stride: int = 2):
        super().__init__()
        self.blocks = nn.ModuleList(TinyViTBlock(dim, num_heads, window_size)
                                    for _ in range(depth))
        self.downsample = PatchMerging(dim, out_dim, merge_stride) if out_dim else None

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x if self.downsample is None else self.downsample(x)


class TinyViT(nn.Module):
    """(B, 3, S, S) normalized -> (B, out_chans, S/16, S/16)."""

    def __init__(self, img_size: int = 1024, embed_dims: Sequence[int] = TINYVIT_5M["embed_dims"],
                 depths: Sequence[int] = TINYVIT_5M["depths"],
                 num_heads: Sequence[int] = TINYVIT_5M["num_heads"],
                 window_sizes: Sequence[int] = TINYVIT_5M["window_sizes"], out_chans: int = 256):
        super().__init__()
        ed = embed_dims
        self.img_size = img_size
        self.patch_embed = PatchEmbed(3, ed[0])
        self.layers = nn.ModuleList([
            ConvLayer(ed[0], ed[1], depths[0]),
            BasicLayer(ed[1], depths[1], num_heads[1], window_sizes[1], out_dim=ed[2]),
            BasicLayer(ed[2], depths[2], num_heads[2], window_sizes[2], out_dim=ed[3],
                       merge_stride=1),
            BasicLayer(ed[3], depths[3], num_heads[3], window_sizes[3]),
        ])
        self.neck = sam_neck(ed[3], out_chans)

    def forward(self, x):
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x)
        return self.neck(x)
