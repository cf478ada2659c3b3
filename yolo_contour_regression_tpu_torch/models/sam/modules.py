"""SAM's network in NCHW (counterpart of the JAX package's
``models/sam/modules.py``): the ViT image encoder (windowed and global
attention with decomposed relative positions, the conv/LayerNorm neck),
the prompt encoder (random-Fourier positions, point and box-corner
embeddings, the mask-downscaling CNN) and the two-way transformer mask
decoder.

Parameters carry the official segment-anything state-dict names
(``image_encoder.blocks.{i}.attn.qkv``, ``prompt_encoder.point_embeddings.
{i}.weight``, ``mask_decoder.output_upscaling.{0,1,3}``, ...), so an
official checkpoint loads with ``load_state_dict(strict=True)``
(``models/sam/convert.py`` maps the JAX package's variables onto them).

The numerics follow JAX's, not the official code's, where they part: GELU
exact; LayerNorm eps 1e-6 (flax's default) in the ViT blocks, the neck,
the decoder's upscaling and the mask CNN, 1e-5 in the two-way blocks; the
relative-position tables indexed, never interpolated (a global block's
table is ``2 * (img_size / 16) - 1`` long, a windowed one's ``2 * ws -
1``); the bias terms of the relative positions take the unscaled ``q``.
Tokens and images are NCHW / (B, N, C) here where JAX keeps NHWC.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x):
    """Exact (erf) GELU, as JAX's ``nn.gelu(approximate=False)``."""
    return F.gelu(x)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map (the official
    ``LayerNorm2d``; flax's LayerNorm on NHWC)."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], self.weight, self.bias,
                            self.eps).permute(0, 3, 1, 2)


class MLPBlock(nn.Module):
    """lin1 -> exact GELU -> lin2."""

    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)

    def forward(self, x):
        return self.lin2(gelu(self.lin1(x)))


class MLP(nn.Module):
    """``num_layers`` Linears ``layers.{i}``, ReLU between them (the
    official decoder MLP; JAX's ``nn/modules/transformer.py:MLP``, whose
    ``layers{i}`` are named ``layers.{i}`` here as in the official
    checkpoints)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def window_partition(x, ws: int):
    """(B, H, W, C) -> windows (B * nW, ws, ws, C), padding the bottom and
    right with zeros up to a multiple of ws; and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(wins, ws: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]):
    """The inverse of ``window_partition``, cropping the pad."""
    hp, wp = pad_hw
    h, w = hw
    b = wins.shape[0] // (hp // ws * wp // ws)
    x = wins.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)[:, :h, :w]


class Attention(nn.Module):
    """Multi-head self-attention on (B, H, W, C) with decomposed relative
    positions: ``rel_pos_h`` and ``rel_pos_w`` tables of ``2 * size - 1``
    rows for an input of ``input_size``, indexed by the offset."""

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool = True,
                 input_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            hd = dim // num_heads
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x):
        b, h, w, c = x.shape
        nh, hd = self.num_heads, c // self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, nh, HW, hd)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        if self.use_rel_pos:
            ih = torch.arange(h, device=x.device)
            iw = torch.arange(w, device=x.device)
            rh = self.rel_pos_h[ih[:, None] - ih[None, :] + (h - 1)]  # (H, H, hd)
            rw = self.rel_pos_w[iw[:, None] - iw[None, :] + (w - 1)]  # (W, W, hd)
            r_q = q.reshape(b, nh, h, w, hd)
            rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh)
            rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw)
            attn = (attn.reshape(b, nh, h, w, h, w) + rel_h[..., :, None]
                    + rel_w[..., None, :]).reshape(b, nh, h * w, h * w)
        out = (attn.softmax(-1) @ v).transpose(1, 2).reshape(b, h, w, c)
        return self.proj(out)


class Block(nn.Module):
    """A ViT block: LayerNorm (eps 1e-6), attention (in ``window_size``
    windows when it is > 0), residual, LayerNorm, MLP, residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, window_size: int = 0,
                 input_size: Tuple[int, int] = (64, 64)):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, True,
                              (window_size, window_size) if window_size else input_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))
        self.window_size = window_size

    def forward(self, x):
        h, w = x.shape[1:3]
        y = self.norm1(x)
        if self.window_size > 0:
            y, pad_hw = window_partition(y, self.window_size)
        y = self.attn(y)
        if self.window_size > 0:
            y = window_unpartition(y, self.window_size, pad_hw, (h, w))
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """A patch_size x patch_size conv, stride patch_size (``proj``)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x):
        return self.proj(x)


def sam_neck(embed_dim: int, out_chans: int) -> nn.Sequential:
    """1x1 conv -> LayerNorm2d -> 3x3 conv -> LayerNorm2d, bias-free convs
    (``neck.{0,1,2,3}``)."""
    return nn.Sequential(nn.Conv2d(embed_dim, out_chans, 1, bias=False), LayerNorm2d(out_chans),
                         nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
                         LayerNorm2d(out_chans))


class ImageEncoderViT(nn.Module):
    """(B, 3, S, S) normalized -> (B, out_chans, S/16, S/16): patch embed,
    ``pos_embed`` (1, S/16, S/16, C), ``depth`` blocks (global at
    ``global_attn_indexes``, windowed elsewhere), the neck."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, out_chans: int = 256,
                 window_size: int = 14, global_attn_indexes: Sequence[int] = (2, 5, 8, 11)):
        super().__init__()
        g = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, window_size=0 if i in global_attn_indexes else window_size,
                  input_size=(g, g)) for i in range(depth))
        self.neck = sam_neck(embed_dim, out_chans)

    def forward(self, x):
        x = self.patch_embed(x).permute(0, 2, 3, 1)
        x = x + self.pos_embed[:, : x.shape[1], : x.shape[2]]
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positions: normalized (x, y) in [0, 1] -> (sin, cos)
    of ``(2c - 1) @ G * 2 pi``, G (2, num_pos_feats) the buffer
    ``positional_encoding_gaussian_matrix``."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def forward(self, coords):
        c = (2 * coords - 1) @ self.positional_encoding_gaussian_matrix * (2 * math.pi)
        return torch.cat([torch.sin(c), torch.cos(c)], -1)

    def grid(self, h: int, w: int):
        """(h, w, C) at the cell centres."""
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return self(torch.stack([gx, gy], -1))


class PromptEncoder(nn.Module):
    """Points with labels (1 foreground, 0 background, 2 and 3 box corners,
    -1 padding) and an optional low-res mask -> sparse (B, P, C), dense
    (B, C, h, w) and the image's positions (1, C, h, w)."""

    def __init__(self, embed_dim: int = 256, image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024), mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, 2), LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, 2), LayerNorm2d(mask_in_chans),
            nn.GELU(), nn.Conv2d(mask_in_chans, embed_dim, 1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def forward(self, points, labels, masks=None):
        """points (B, P, 2) in input pixels, labels (B, P) int, masks
        (B, 1, 4h, 4w) logits or None."""
        h, w = self.image_embedding_size
        ih, iw = self.input_image_size
        coords = (points + 0.5) / torch.tensor([iw, ih], dtype=torch.float32,
                                               device=points.device)
        emb = self.pe_layer(coords)
        lab = labels[..., None]
        nap = self.not_a_point_embed.weight[0]
        emb = torch.where(lab == -1, nap, emb)
        for i in range(4):
            emb = torch.where(lab == i, emb + self.point_embeddings[i].weight[0], emb)
        if masks is not None:
            dense = self.mask_downscaling(masks)
        else:
            dense = self.no_mask_embed.weight[0][None, :, None, None].expand(
                points.shape[0], -1, h, w)
        image_pe = self.pe_layer.grid(h, w).permute(2, 0, 1)[None]
        return emb, dense, image_pe


class DownsampleAttention(nn.Module):
    """The decoder's attention with q/k/v/out projections of internal width
    ``C // downsample_rate`` (the official ``transformer.py:Attention``)."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        d = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, d)
        self.k_proj = nn.Linear(dim, d)
        self.v_proj = nn.Linear(dim, d)
        self.out_proj = nn.Linear(d, dim)

    def forward(self, q, k, v):
        b, nq, _ = q.shape
        nh = self.num_heads

        def heads(x):
            return x.reshape(x.shape[0], x.shape[1], nh, -1).transpose(1, 2)

        qh, kh, vh = heads(self.q_proj(q)), heads(self.k_proj(k)), heads(self.v_proj(v))
        hd = qh.shape[-1]
        attn = ((qh / math.sqrt(hd)) @ kh.transpose(-2, -1)).softmax(-1)
        return self.out_proj((attn @ vh).transpose(1, 2).reshape(b, nq, nh * hd))


class TwoWayAttentionBlock(nn.Module):
    """Self-attention of the tokens (no residual in the first block), tokens
    to image, MLP, image to tokens; LayerNorm eps 1e-5 after each."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2, skip_first_layer_pe: bool = False):
        super().__init__()
        ds = attention_downsample_rate
        self.self_attn = DownsampleAttention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn_token_to_image = DownsampleAttention(dim, num_heads, ds)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MLPBlock(dim, mlp_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.norm4 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn_image_to_token = DownsampleAttention(dim, num_heads, ds)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """``depth`` two-way blocks, then a final token-to-image attention and
    LayerNorm (eps 1e-5)."""

    def __init__(self, depth: int = 2, embedding_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim, attention_downsample_rate,
                                 skip_first_layer_pe=i == 0) for i in range(depth))
        self.final_attn_token_to_image = DownsampleAttention(embedding_dim, num_heads,
                                                             attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(embedding_dim, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding (B, C, h, w), image_pe (1 or B, C, h, w), tokens
        (B, T, C) -> (tokens, keys (B, h * w, C))."""
        b, c, h, w = image_embedding.shape
        keys = image_embedding.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2).expand(b, -1, -1)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    """An IoU token and 4 mask tokens with the prompt tokens through the
    two-way transformer; the image side upscaled 4x by two transposed convs
    (``output_upscaling.{0,1,3}``: a LayerNorm2d and exact GELUs); each
    mask token's hypernetwork MLP weights the upscaled channels; the IoU
    head scores each mask."""

    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 num_heads: int = 8, mlp_dim: int = 2048, iou_head_hidden_dim: int = 256,
                 iou_head_depth: int = 3):
        super().__init__()
        td = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(2, td, num_heads, mlp_dim)
        self.iou_token = nn.Embedding(1, td)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, td)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(td, td // 4, 2, 2), LayerNorm2d(td // 4), nn.GELU(),
            nn.ConvTranspose2d(td // 4, td // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(td, td, td // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(td, iou_head_hidden_dim, self.num_mask_tokens,
                                       iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                multimask_output: bool = True):
        """-> masks (B, 3 or 1, 4h, 4w) logits, iou_pred (B, 3 or 1). The
        embeddings may be a broadcast (``expand``) of one image's."""
        b = sparse_prompt.shape[0]
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], 0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse_prompt], 1)
        src = image_embeddings + dense_prompt
        _, c, h, w = src.shape
        hs, keys = self.transformer(src, image_pe, tokens)
        iou_tok = hs[:, 0]
        mask_toks = hs[:, 1: 1 + self.num_mask_tokens]
        up = self.output_upscaling(keys.transpose(1, 2).reshape(b, c, h, w))
        hyper = torch.stack([mlp(mask_toks[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], 1)
        masks = torch.einsum("btc,bchw->bthw", hyper, up)
        iou_pred = self.iou_prediction_head(iou_tok)
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, :1], iou_pred[:, :1]
