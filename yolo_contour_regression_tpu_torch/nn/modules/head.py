"""The polar-contour segment head, the stock YOLOv8 detect head, the
keypoint head, the proto-mask segment head, the classify head, their
decodes, and the RT-DETR decoder head (counterpart of the JAX package's
``nn/modules/head.py``).

``PolarSegment``, ``Detect`` and ``Pose`` return raw per-level maps in NCHW,
``SegmentProto`` those and its prototypes; the decode helpers take those
maps and produce the JAX package's layouts, anchors flattened row-major per
level as ``make_anchors`` orders them. ``Classify`` returns probabilities.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
from torch import nn

from ...ops import polar as polar_ops
from ...ops.boxes import dist2bbox
from .block import Proto
from .conv import Conv
from .transformer import LN_EPS, MLP, DeformableTransformerDecoderLayer, Embed, inverse_sigmoid


class PolarSegment(nn.Module):
    """Per level i: cv2[i] = Conv3x3 -> Conv3x3 -> 1x1 (36 rays),
    cv3[i] = Conv3x3 -> Conv3x3 -> 1x1 (nc logits). Output per level:
    (B, nm + nc, H, W), rays first."""

    def __init__(self, nc: int = 80, nm: int = polar_ops.NUM_RAYS, npr: int = 256,
                 ch: Sequence[int] = ()):
        super().__init__()
        self.nc, self.nm = nc, nm  # npr is kept for config parity; unused
        c2 = max(16, ch[0] // 4, 16 * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, nm, 1)) for x in ch
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), nn.Conv2d(c3, nc, 1)) for x in ch
        )

    def forward(self, feats: Sequence[torch.Tensor]):
        return [torch.cat([b2(x), b3(x)], dim=1) for x, b2, b3 in zip(feats, self.cv2, self.cv3)]


class Detect(nn.Module):
    """Stock YOLOv8 detect head with DFL box regression. Per level i:
    cv2[i] = Conv3x3 -> Conv3x3 -> 1x1 (4 * reg_max box bins), cv3[i] =
    Conv3x3 -> Conv3x3 -> 1x1 (nc logits), widths ``c2 = max(16, ch0 // 4,
    4 * reg_max)`` and ``c3 = max(ch0, min(nc, 100))``. Output per level:
    (B, 4 * reg_max + nc, H, W), box bins first."""

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max = nc, reg_max
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1))
            for x in ch
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), nn.Conv2d(c3, nc, 1)) for x in ch
        )

    def forward(self, feats: Sequence[torch.Tensor]):
        return [torch.cat([b2(x), b3(x)], dim=1) for x, b2, b3 in zip(feats, self.cv2, self.cv3)]


class Pose(nn.Module):
    """Keypoint head: a ``Detect`` (the child ``detect``, as the JAX head
    nests it) and per level i ``cv4[i]`` = Conv3x3 -> Conv3x3 -> 1x1 (nk =
    K * D keypoint outputs, bias), ``c4 = max(ch0 // 4, nk)``. Output per
    level: (B, 4 * reg_max + nc + nk, H, W), the detect maps first."""

    def __init__(self, nc: int = 1, kpt_shape: Sequence[int] = (17, 3), ch: Sequence[int] = (),
                 reg_max: int = 16):
        super().__init__()
        self.nc, self.kpt_shape = nc, tuple(int(v) for v in kpt_shape)
        self.nk = self.kpt_shape[0] * self.kpt_shape[1]
        self.detect = Detect(nc, ch, reg_max)
        c4 = max(ch[0] // 4, self.nk)
        self.cv4 = nn.ModuleList(
            nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), nn.Conv2d(c4, self.nk, 1)) for x in ch
        )

    def forward(self, feats: Sequence[torch.Tensor]):
        return [torch.cat([d, b4(x)], dim=1)
                for d, x, b4 in zip(self.detect(feats), feats, self.cv4)]


class SegmentProto(nn.Module):
    """The stock proto-mask segment head (the config's ``Segmentori``): a
    ``Detect`` (the child ``detect``, as the JAX head nests it), a
    ``Proto`` on the first level (the child ``proto``: ``npr`` channels,
    ``nm`` prototypes) and per level i ``cv4[i]`` = Conv3x3 -> Conv3x3 ->
    1x1 (nm mask coefficients, bias), ``c4 = max(ch0 // 4, nm)``. Returns
    (levels, proto): per level (B, 4 * reg_max + nc + nm, H, W), the detect
    maps first, and the prototypes (B, nm, 2 H0, 2 W0)."""

    def __init__(self, nc: int = 80, nm: int = 32, npr: int = 256, ch: Sequence[int] = (),
                 reg_max: int = 16):
        super().__init__()
        self.nc, self.nm = nc, nm
        self.detect = Detect(nc, ch, reg_max)
        self.proto = Proto(ch[0], npr, nm)
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(
            nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), nn.Conv2d(c4, nm, 1)) for x in ch
        )

    def forward(self, feats: Sequence[torch.Tensor]):
        levels = [torch.cat([d, b4(x)], dim=1)
                  for d, x, b4 in zip(self.detect(feats), feats, self.cv4)]
        return levels, self.proto(feats[0])


class Classify(nn.Module):
    """The classify head: Conv 1x1 to 1280 channels (not width-scaled, as in
    JAX), a global average pool, ``Dropout(0.0)`` (a no-op in both modes, as
    JAX's), ``linear`` to nc, and the fork's sigmoid on every output.
    (B, C, H, W) -> (B, nc) probabilities."""

    c_ = 1280

    def __init__(self, nc: int, ch: int):
        super().__init__()
        self.conv = Conv(ch, self.c_, 1, 1)
        self.drop = nn.Dropout(0.0)
        self.linear = nn.Linear(self.c_, nc)

    def forward(self, x):
        return torch.sigmoid(self.linear(self.drop(self.conv(x).mean((2, 3)))))


def flatten_levels(outs: Sequence[torch.Tensor]) -> torch.Tensor:
    """[(B, C, H, W)...] -> (B, A, C): permute each level to NHWC first, so
    anchors flatten row-major (y then x) as in ``make_anchors``."""
    return torch.cat([o.permute(0, 2, 3, 1).reshape(o.shape[0], -1, o.shape[1]) for o in outs], 1)


def decode_polar(outs: Sequence[torch.Tensor], strides: Sequence[int], nc: int,
                 nm: int = polar_ops.NUM_RAYS) -> torch.Tensor:
    """Eval-time polar decode in one tensor (the JAX ``decode_polar``; the
    exported predict's layout): (B, 4 + nc + 3 * nm, A) = [xyxy box | nc
    sigmoid scores | nm seg-x | nm seg-y | nm valid flags]."""
    boxes, scores, extras = decode_polar_parts(outs, strides, nc, nm)
    return torch.cat([boxes, scores, finalize_polar_extras(extras, nm)], -1).transpose(1, 2)


def decode_polar_parts(
    outs: Sequence[torch.Tensor],
    strides: Sequence[int],
    nc: int,
    nm: int = polar_ops.NUM_RAYS,
    sigmoid: bool = True,
):
    """Predict-path polar decode: (boxes (B, A, 4), scores (B, A, nc),
    extras (B, A, nm + 2) = [rays_px | anchor_px]). Contour points are
    rebuilt for the NMS survivors by ``finalize_polar_extras``.
    ``sigmoid=False`` returns raw class logits for
    ``non_max_suppression_parts(..., scores_are_logits=True)``."""
    feat_hw = [(o.shape[2], o.shape[3]) for o in outs]
    anchor_points, stride_t = polar_ops.make_anchors(
        feat_hw, strides, dtype=outs[0].dtype, device=outs[0].device
    )
    x = flatten_levels(outs)  # (B, A, nm + nc)
    rays, cls = x[..., :nm], x[..., nm:]
    rays_px = (rays * stride_t[None]).clamp_min(polar_ops.RAY_EPS)
    anchors_px = anchor_points * stride_t
    boxes = polar_ops.decode_ray_boxes(rays_px, anchors_px)
    scores = torch.sigmoid(cls) if sigmoid else cls
    anc = anchors_px[None].expand(x.shape[0], -1, -1).to(rays_px.dtype)
    return boxes, scores, torch.cat([rays_px, anc], dim=-1)


def finalize_polar_extras(ex: torch.Tensor, nm: int = polar_ops.NUM_RAYS):
    """Post-NMS half of the decode: extras (..., nm + 2) [rays_px |
    anchor_px] -> (..., 3 * nm) [36 x | 36 y | 36 valid]."""
    rays, anc = ex[..., :nm], ex[..., nm:]
    points, valid, _ = polar_ops.decode_rays(rays, anc)
    return torch.cat([points[..., 0], points[..., 1], valid.to(ex.dtype)], dim=-1)


def decode_detect(outs: Sequence[torch.Tensor], strides: Sequence[int], nc: int,
                  reg_max: int = 16) -> torch.Tensor:
    """Eval-time DFL decode: the softmax expectation over ``reg_max`` bins
    -> ltrb -> xywh boxes in pixels, and sigmoid scores: (B, 4 + nc, A)."""
    feat_hw = [(o.shape[2], o.shape[3]) for o in outs]
    anchor_points, stride_t = polar_ops.make_anchors(
        feat_hw, strides, dtype=outs[0].dtype, device=outs[0].device
    )
    x = flatten_levels(outs)  # (B, A, 4 * reg_max + nc)
    box_dist, cls = x[..., : 4 * reg_max], x[..., 4 * reg_max:]
    b, a, _ = box_dist.shape
    probs = box_dist.reshape(b, a, 4, reg_max).softmax(-1)
    proj = torch.arange(reg_max, dtype=probs.dtype, device=probs.device)
    ltrb = torch.einsum("bakr,r->bak", probs, proj)
    dbox = dist2bbox(ltrb, anchor_points[None], xywh=True) * stride_t[None]
    return torch.cat([dbox, torch.sigmoid(cls)], dim=-1).transpose(1, 2)


def decode_pose(kpt_raw: torch.Tensor, strides: Sequence[int], feat_hw, kpt_shape=(17, 3)
                ) -> torch.Tensor:
    """Raw keypoints (B, A, nk) -> (B, A, K, D) in pixels: ``xy = (raw * 2 +
    anchor - 0.5) * stride``, and with D = 3 the visibility ``sigmoid(raw)``."""
    anchor_points, stride_t = polar_ops.make_anchors(
        feat_hw, strides, dtype=kpt_raw.dtype, device=kpt_raw.device
    )
    b, a, _ = kpt_raw.shape
    k = kpt_raw.reshape(b, a, kpt_shape[0], kpt_shape[1])
    xy = (k[..., :2] * 2.0 + (anchor_points[None, :, None, :] - 0.5)) * stride_t[None, :, None, :]
    if kpt_shape[1] == 3:
        return torch.cat([xy, torch.sigmoid(k[..., 2:3])], dim=-1)
    return xy


def _grid_anchors(shapes) -> torch.Tensor:
    """The decoder's grid anchors (1, V, 4), normalized cxcywh in float32:
    centers ``((x + 0.5) / w, (y + 0.5) / h)`` row-major per level (JAX
    normalizes x by w and y by h, fixing the reference's swap), sizes
    ``0.05 * 2^level``."""
    out = []
    for i, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32), indexing="ij")
        xy = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1).reshape(-1, 2)
        out.append(torch.cat([xy, torch.full_like(xy, 0.05 * (2.0 ** i))], -1))
    return torch.cat(out, 0)[None]


@functools.lru_cache(maxsize=32)
def anchor_logits(shapes, device, dtype):
    """The decoder's anchor logits (1, V, 4) (``inverse_sigmoid`` of
    ``_grid_anchors``, in float32 as JAX computes them, inf outside
    (0.01, 0.99)) and their validity (1, V, 1), computed on the CPU and
    kept on ``device`` per map shape: a card and the CPU then take the same
    float32 values (the card's ``log`` may round the other way), which
    keeps a fresh model's sampling points on the same side of a pixel's
    edge on both."""
    with torch.inference_mode(False):  # cached: a normal tensor, whatever the caller's mode
        anchors = _grid_anchors(shapes)
        valid = ((anchors > 1e-2) & (anchors < 1 - 1e-2)).all(-1, keepdim=True)
        logit = torch.where(valid, inverse_sigmoid(anchors), torch.full_like(anchors, math.inf))
        return logit.to(device, dtype), valid.to(device)


def dn_attn_mask(G: int, per_group: int, nq: int, device) -> torch.Tensor:
    """The self-attention mask (1, 1, T, T), True where a row may attend,
    for ``G`` dn groups of ``per_group`` queries ahead of ``nq`` matching
    queries: matching rows see only matching queries; dn rows see their own
    group and the matching queries."""
    gid = torch.arange(G, device=device).repeat_interleave(per_group)
    row_g = torch.cat([gid, torch.full((nq,), -1, device=device, dtype=gid.dtype)])
    is_match = row_g < 0
    same_group = row_g[:, None] == row_g[None, :]
    allow = ((is_match[:, None] & is_match[None, :]) | (~is_match[:, None] & is_match[None, :])
             | (same_group & ~is_match[:, None]))
    return allow[None, None]


class RTDETRDecoder(nn.Module):
    """The RT-DETR decoder head: a 1x1 Conv + BN (no activation)
    ``input_proj{i}`` a level to ``hd`` channels, the levels' tokens
    concatenated (each flattened row-major over (h, w) from NHWC), an
    encoder head (``enc_output`` Dense + ``enc_output_ln``) scoring every
    token, the top ``min(nq, V)`` tokens by their best class score (a
    stable descending sort: ties to the lowest index, as ``lax.top_k``)
    as queries with their anchors' boxes refined by ``enc_bbox_head``, then
    ``ndl`` deformable decoder layers, each refining the boxes
    (``dec_bbox_head{i}``) and scoring them (``dec_score_head{i}``).

    Anchors outside (0.01, 0.99) get zero features and a ``+inf`` logit
    (``sigmoid`` 1, gradient 0). Eval (``self.training`` False) gives (B,
    nq, 4 + nc): the last layer's normalized cxcywh boxes and sigmoid
    scores. Train gives (dec_bboxes (ndl, B, T, 4), dec_scores (ndl, B, T,
    nc) logits, enc_bboxes (B, nq, 4), enc_scores (B, nq, nc) logits); with
    a ``dn`` dict (``models/utils/ops.py:get_cdn_group``) its G x 2 x N
    noised queries go ahead of the nq matching queries (T = G * 2 * N +
    nq) under ``dn_attn_mask``. In train mode the query features and their
    refer boxes are detached; layer i > 0's box comes from the undetached
    previous refinement, while the refer fed forward is detached (JAX's
    ``last_refined`` chain)."""

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), hd: int = 256, nq: int = 300,
                 ndp: int = 4, nh: int = 8, ndl: int = 6, d_ffn: int = 1024):
        super().__init__()
        self.nc, self.hd, self.nq, self.ndl = nc, hd, nq, ndl
        self.nl = len(ch)
        for i, c in enumerate(ch):
            self.add_module(f"input_proj{i}", Conv(c, hd, 1, 1, act=False))
        self.enc_output = nn.Linear(hd, hd)
        self.enc_output_ln = nn.LayerNorm(hd, eps=LN_EPS)
        self.enc_score_head = nn.Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.denoising_class_embed = Embed(nc, hd)
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        for i in range(ndl):
            self.add_module(f"dec_layer{i}", DeformableTransformerDecoderLayer(
                hd, nh, d_ffn, self.nl, ndp))
            self.add_module(f"dec_bbox_head{i}", MLP(hd, hd, 4, 3))
            self.add_module(f"dec_score_head{i}", nn.Linear(hd, nc))

    def forward(self, feats: Sequence[torch.Tensor], dn=None):
        train = self.training
        shapes = [(f.shape[2], f.shape[3]) for f in feats]
        B = feats[0].shape[0]
        tokens = [getattr(self, f"input_proj{i}")(f).permute(0, 2, 3, 1).reshape(B, -1, self.hd)
                  for i, f in enumerate(feats)]
        feats_flat = torch.cat(tokens, 1)  # (B, V, hd)
        dtype = feats_flat.dtype
        anchors_logit, valid = anchor_logits(tuple(map(tuple, shapes)), feats_flat.device, dtype)

        enc_feats = self.enc_output_ln(self.enc_output(feats_flat * valid))
        enc_scores_all = self.enc_score_head(enc_feats)
        nq = min(self.nq, enc_scores_all.shape[1])
        order = torch.sort(enc_scores_all.amax(-1), dim=-1, descending=True, stable=True)[1]
        topk = order[:, :nq]  # (B, nq)
        top_feats = enc_feats.gather(1, topk[..., None].expand(-1, -1, self.hd))
        top_anchors = anchors_logit.expand(B, -1, -1).gather(1, topk[..., None].expand(-1, -1, 4))
        refer_logit = self.enc_bbox_head(top_feats) + top_anchors
        enc_bboxes = torch.sigmoid(refer_logit)
        enc_scores = enc_scores_all.gather(1, topk[..., None].expand(-1, -1, self.nc))

        embed = top_feats.detach() if train else top_feats
        refer_l = refer_logit.detach() if train else refer_logit
        attn_mask = None
        if train and dn is not None:
            _, G, two, N = dn["labels"].shape
            dn_q = G * two * N
            labels = dn["labels"].clamp(0, self.nc - 1)
            dn_embed = self.denoising_class_embed(labels).reshape(B, dn_q, self.hd)
            dn_bbox = dn["boxes_logit"].reshape(B, dn_q, 4).to(dtype)
            embed = torch.cat([dn_embed, embed], 1)
            refer_l = torch.cat([dn_bbox, refer_l], 1)
            attn_mask = dn_attn_mask(G, two * N, nq, embed.device)
        refer = torch.sigmoid(refer_l)

        dec_bboxes, dec_scores = [], []
        last_refined = None
        for i in range(self.ndl):
            embed = getattr(self, f"dec_layer{i}")(embed, refer, feats_flat, shapes,
                                                   attn_mask=attn_mask,
                                                   query_pos=self.query_pos_head(refer))
            delta = getattr(self, f"dec_bbox_head{i}")(embed)
            refined = torch.sigmoid(delta + inverse_sigmoid(refer))
            if train:
                dec_scores.append(getattr(self, f"dec_score_head{i}")(embed))
                dec_bboxes.append(refined if i == 0 else
                                  torch.sigmoid(delta + inverse_sigmoid(last_refined)))
                last_refined = refined
                refer = refined.detach()
            else:
                refer = refined
        if train:
            return torch.stack(dec_bboxes), torch.stack(dec_scores), enc_bboxes, enc_scores
        scores = getattr(self, f"dec_score_head{self.ndl - 1}")(embed)
        return torch.cat([refer, torch.sigmoid(scores)], -1)  # (B, nq, 4 + nc)
