"""The RT-DETR transformer pieces (counterpart of the JAX package's
``nn/modules/transformer.py``): ``inverse_sigmoid``, ``MLP``,
``bilinear_grid_sample``, flax's multi-head attention written out as
matmuls and a softmax, ``MSDeformAttn`` and
``DeformableTransformerDecoderLayer`` of the decoder, rtdetr-l's
encoder: ``TransformerEncoderLayer``, ``sincos_2d_position`` and ``AIFI``,
and the config module ``TransformerBlock`` with its ``TransformerLayer``.

Parameter names and layouts are flax's, so a JAX weight tree carries over
by ``utils/checkpoint.py`` with no rule of its own: ``nn.Linear`` for a
Dense (its kernel transposed), ``nn.LayerNorm`` at flax's eps 1e-6 (its
``scale`` is the weight), ``Embed.embedding`` as flax's ``nn.Embed``, and
the attention's DenseGeneral leaves kept in JAX's shapes: ``query``,
``key`` and ``value`` kernels (C, nh, hd) with biases (nh, hd), ``out``
kernel (nh, hd, C). The attention follows flax's
``dot_product_attention``: the query scaled by ``1 / sqrt(hd)`` before the
product, masked logits set to the dtype's most negative finite value, a
softmax over the keys. Sampling is ``F.grid_sample`` (bilinear, zero
padding, ``align_corners=False``), one call a level over batch x heads.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .conv import Conv

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``log(max(x, eps) / max(1 - x, eps))`` of ``x`` clipped to [0, 1]
    (the decoder's; ``models/utils/ops.py`` has the CDN one, which clips to
    [eps, 1 - eps] first)."""
    x = torch.minimum(torch.maximum(x, x.new_tensor(0.0)), x.new_tensor(1.0))
    e = x.new_tensor(eps)
    return torch.log(torch.maximum(x, e) / torch.maximum(1 - x, e))


class MLP(nn.Module):
    """``num_layers`` Dense layers ``layers{i}``, ReLU between them. The
    last one's kernel is zero-initialized where the JAX module's
    ``zero_last`` is set (``nn/tasks.py:init_weights`` does it)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layers{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layers{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class Embed(nn.Module):
    """flax ``nn.Embed``: a table ``embedding`` (num, features)."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, features))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.embedding[idx]


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` in JAX's shapes: ``kernel`` (*in, *out) and
    ``bias`` (*out), contracting the last ``n_in`` input axes."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...]):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = nn.Parameter(torch.zeros(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        k_in, k_out = math.prod(self.in_shape), math.prod(self.out_shape)
        y = x.reshape(-1, k_in) @ self.kernel.reshape(k_in, k_out)
        return y.reshape(*lead, *self.out_shape) + self.bias


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (no dropout): ``query``,
    ``key``, ``value`` (C -> nh x hd) and ``out`` (nh x hd -> C)."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        hd = d_model // n_heads
        self.n_heads, self.head_dim = n_heads, hd
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((d_model,), (n_heads, hd)))
        self.out = DenseGeneral((n_heads, hd), (d_model,))

    def forward(self, q_in, k_in, v_in, mask: Optional[torch.Tensor] = None):
        """(B, Q, C), (B, K, C), (B, K, C); ``mask`` broadcastable to (B,
        nh, Q, K), True where a query may attend -> (B, Q, C)."""
        q = self.query(q_in) / math.sqrt(self.head_dim)  # (B, Q, nh, hd)
        k = self.key(k_in)
        v = self.value(v_in)
        logits = q.transpose(1, 2) @ k.permute(0, 2, 3, 1)  # (B, nh, Q, K)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        out = (w @ v.transpose(1, 2)).transpose(1, 2)  # (B, Q, nh, hd)
        return self.out(out)


class TransformerEncoderLayer(nn.Module):
    """Post-norm self-attention and feed-forward (JAX's): ``ma`` on ``src +
    pos`` as query and key and ``src`` as value, ``norm1`` of the sum with
    ``src``; ``fc1`` (to cm), tanh-approximate GELU (flax's ``nn.gelu``),
    ``fc2``; ``norm2`` of the sum. LayerNorms at flax's eps."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.ma = MultiHeadAttention(c1, num_heads)
        self.norm1 = nn.LayerNorm(c1, eps=LN_EPS)
        self.fc1 = nn.Linear(c1, cm)
        self.fc2 = nn.Linear(cm, c1)
        self.norm2 = nn.LayerNorm(c1, eps=LN_EPS)

    def forward(self, src: torch.Tensor, pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """src (B, L, C), pos broadcastable to it -> (B, L, C)."""
        q = src if pos is None else src + pos
        src = self.norm1(src + self.ma(q, q, src))
        h = self.fc2(F.gelu(self.fc1(src), approximate="tanh"))
        return self.norm2(src + h)


def sincos_2d_position(w: int, h: int, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """The 2D sin-cos position table (1, w * h, dim), w-major (JAX's and the
    reference's), float32 on the CPU: ``omega = 1 / temperature^(i / (dim
    / 4))``, then [sin, cos] of x * omega and of y * omega."""
    if dim % 4:
        raise ValueError(f"dim {dim} is not a multiple of 4")
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (torch.arange(pos_dim, dtype=torch.float32) / pos_dim))
    gw, gh = torch.meshgrid(torch.arange(w, dtype=torch.float32),
                            torch.arange(h, dtype=torch.float32), indexing="ij")
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], 1)[None]


@functools.lru_cache(maxsize=32)
def aifi_position(h: int, w: int, c: int, device, dtype) -> torch.Tensor:
    """``sincos_2d_position`` transposed to row-major tokens (1, h * w, c),
    computed on the CPU and kept on ``device`` per map shape, so a card and
    the CPU take the same float32 table."""
    with torch.inference_mode(False):  # cached: a normal tensor, whatever the caller's mode
        pos = sincos_2d_position(w, h, c).reshape(1, w, h, c).transpose(1, 2)
        return pos.reshape(1, h * w, c).to(device, dtype)


class AIFI(TransformerEncoderLayer):
    """Intra-scale feature interaction on the last map: (B, C, H, W) as H *
    W row-major tokens through the encoder layer, with the w-major position
    table transposed to row-major (``aifi_position``), and back."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        pos = aifi_position(h, w, c, x.device, x.dtype)
        tokens = x.flatten(2).transpose(1, 2)
        out = super().forward(tokens, pos=pos)
        return out.transpose(1, 2).reshape(b, c, h, w)


class TransformerLayer(nn.Module):
    """Norm-free self-attention block: ``q``, ``k``, ``v`` (Dense, no bias)
    into the attention ``ma`` (flax's, with its own biased projections),
    plus the input; then ``fc2(fc1(.))`` (no bias, no activation), plus its
    input."""

    def __init__(self, c: int, num_heads: int = 8):
        super().__init__()
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = MultiHeadAttention(c, num_heads)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, L, C) -> (B, L, C)."""
        x = self.ma(self.q(x), self.k(x), self.v(x)) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """A Conv ``conv`` (1x1) where the width changes, the map as H * W
    row-major tokens plus the learned position term ``linear(tokens)``,
    ``num_layers`` TransformerLayers ``tr{i}``, and back to a map."""

    def __init__(self, c1: int, c2: int, num_heads: int = 8, num_layers: int = 1):
        super().__init__()
        self.conv = Conv(c1, c2) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"tr{i}", TransformerLayer(c2, num_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is not None:
            x = self.conv(x)
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)
        tokens = tokens + self.linear(tokens)
        for i in range(self.num_layers):
            tokens = getattr(self, f"tr{i}")(tokens)
        return tokens.transpose(1, 2).reshape(b, c, h, w)


def bilinear_grid_sample(value: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample(mode="bilinear", padding_mode="zeros",
    align_corners=False)``: value (N, C, H, W), grid (N, Q, P, 2) xy in
    [-1, 1] -> (N, C, Q, P). A corner outside the map contributes 0."""
    return F.grid_sample(value, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def offset_bias(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """``sampling_offsets``' initial bias: per head a unit direction (its
    larger coordinate 1) scaled by the point's index + 1, the same for each
    level; flattened (nh, L, P, 2) as the JAX initializer computes it in
    float32."""
    thetas = torch.arange(n_heads, dtype=torch.float32) * (2 * math.pi / n_heads)
    grid = torch.stack([torch.cos(thetas), torch.sin(thetas)], -1)
    grid = grid / grid.abs().amax(-1, keepdim=True)
    grid = grid[:, None, None, :].repeat(1, n_levels, n_points, 1)
    scale = torch.arange(1, n_points + 1, dtype=torch.float32)[None, None, :, None]
    return (grid * scale).reshape(-1)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention."""

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels, self.n_heads, self.n_points = (d_model, n_levels, n_heads,
                                                                    n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, refer_bbox, value, value_shapes: Sequence[Tuple[int, int]]):
        """query (B, Q, C); refer_bbox (B, Q, L or 1, 2 or 4) normalized;
        value (B, V, C), the levels' tokens concatenated, each flattened
        row-major over (h, w); value_shapes [(h, w), ...]."""
        B, Q = query.shape[:2]
        nh, L, P = self.n_heads, self.n_levels, self.n_points
        hd = self.d_model // nh
        v = self.value_proj(value).reshape(B, -1, nh, hd)
        off = self.sampling_offsets(query).reshape(B, Q, nh, L, P, 2)
        attw = torch.softmax(self.attention_weights(query).reshape(B, Q, nh, L * P), -1)
        attw = attw.reshape(B, Q, nh, L, P)
        rb = refer_bbox[:, :, None, :, None, :]  # (B, Q, 1, L, 1, 2 or 4)
        if refer_bbox.shape[-1] == 2:
            norm = torch.tensor([(w, h) for h, w in value_shapes], dtype=off.dtype,
                                device=off.device)
            loc = rb + off / norm[None, None, None, :, None, :]
        else:
            loc = rb[..., :2] + off / P * rb[..., 2:] * 0.5  # (B, Q, nh, L, P, 2)
        sampled = []
        start = 0
        for li, (h, w) in enumerate(value_shapes):
            vl = v[:, start:start + h * w].reshape(B, h, w, nh, hd)
            vl = vl.permute(0, 3, 4, 1, 2).reshape(B * nh, hd, h, w)
            grid = (2 * loc[:, :, :, li] - 1).transpose(1, 2).reshape(B * nh, Q, P, 2)
            sampled.append(bilinear_grid_sample(vl, grid))  # (B * nh, hd, Q, P)
            start += h * w
        stacked = torch.stack(sampled, dim=3)  # (B * nh, hd, Q, L, P)
        wts = attw.transpose(1, 2).reshape(B * nh, 1, Q, L, P)
        out = (stacked * wts).sum(dim=(3, 4))  # (B * nh, hd, Q)
        out = out.reshape(B, nh, hd, Q).permute(0, 3, 1, 2).reshape(B, Q, self.d_model)
        return self.output_proj(out)


class DeformableTransformerDecoderLayer(nn.Module):
    """Self-attention, deformable cross-attention and a ReLU FFN, each
    followed by a residual LayerNorm (post-norm)."""

    def __init__(self, d_model: int = 256, n_heads: int = 8, d_ffn: int = 1024,
                 n_levels: int = 3, n_points: int = 4):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, embed, refer_bbox, feats, shapes, attn_mask=None, query_pos=None):
        q = k = embed if query_pos is None else embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, k, embed, mask=attn_mask))
        rb = refer_bbox[:, :, None, :] if refer_bbox.dim() == 3 else refer_bbox
        tgt = self.cross_attn(embed if query_pos is None else embed + query_pos, rb, feats, shapes)
        embed = self.norm2(embed + tgt)
        h = self.linear2(F.relu(self.linear1(embed)))
        return self.norm3(embed + h)
