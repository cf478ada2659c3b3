"""SAM: the model, its prompt predictor and everything mode, and the
``SAM`` facade (counterpart of the JAX package's ``models/sam/model.py``)::

    sam = SAM("sam_b", device="cuda")                 # seeded weights (no download)
    masks, iou = sam.predict(img_bgr_u8, points=[[320, 240]], labels=[1])
    masks, scores = sam.predict(img_bgr_u8)           # no prompt: everything mode
    masks, scores, boxes = sam.generate(img_bgr_u8, crop_n_layers=1)
    SAM("sam_vit_b.pth")                              # an official checkpoint

``Predictor.set_image`` letterboxes to the square input without a pad
offset (cv2's uint8 INTER_LINEAR, ``data/augment.py:_resize_linear_u8``),
normalizes by SAM's pixel mean and std, then zero-pads, and caches the
embeddings; ``predict`` takes points, a box and a low-res ``mask_input``,
appends the official ``(0, 0)`` / -1 pad point when there is no box, and
brings the low-res logits back to the frame as JAX does (cv2's float
INTER_LINEAR to the square, the crop of the resized image, INTER_LINEAR
to the frame: ``resize_linear_f32``, on the device). ``generate`` prompts
a point grid in fixed batches (the tail padded) against the embeddings
broadcast with ``expand``, scores stability on the low-res logits on the
device, keeps what passes the confidence and stability filters there,
resizes the kept logits to the crop in one batched, antialiased resize
(``amg.resize_bilinear``), and runs the crop-edge filter, in-crop NMS,
uncrop, cross-crop dedupe (score 1 / crop area) and the optional
small-region cleanup on the host in numpy, as JAX does.

Where JAX's ``predict`` ignores ``multimask_output`` (it always returns
three masks), the port honours it; the default, True, is the same.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ...data.augment import _resize_linear_u8, resize_linear_f32
from ...nn.tasks import TRUNC_NORMAL_STD, _trunc_normal_
from . import amg
from .convert import load_official, num_weights
from .modules import ImageEncoderViT, MaskDecoder, PromptEncoder
from .tinyvit import TinyViT

SAM_VARIANTS = {
    # embed_dim, depth, num_heads, global_attn_indexes
    "sam_b": (768, 12, 12, (2, 5, 8, 11)),
    "sam_l": (1024, 24, 16, (5, 11, 17, 23)),
    "sam_h": (1280, 32, 16, (7, 15, 23, 31)),
}
# the TinyViT-encoder variants
MOBILE_VARIANTS = ("mobile_sam", "sam_t")


class Sam(nn.Module):
    """The image encoder (ViT or, for ``mobile_sam`` and ``sam_t``,
    TinyViT-5M), prompt encoder and mask decoder, with their official
    names. Weights are drawn from ``seed`` as the JAX ``Sam.init`` draws
    its (``init_sam_weights``), unless ``seed`` is None."""

    mask_threshold: float = 0.0
    pixel_mean = np.array([123.675, 116.28, 103.53], np.float32)
    pixel_std = np.array([58.395, 57.12, 57.375], np.float32)

    def __init__(self, variant: str = "sam_b", img_size: int = 1024, seed: Optional[int] = 0):
        super().__init__()
        self.variant, self.img_size = variant, img_size
        if variant in MOBILE_VARIANTS:
            self.image_encoder = TinyViT(img_size=img_size)
        else:
            ed, depth, nh, gai = SAM_VARIANTS[variant]
            self.image_encoder = ImageEncoderViT(img_size=img_size, embed_dim=ed, depth=depth,
                                                 num_heads=nh, global_attn_indexes=gai)
        emb = img_size // 16
        self.prompt_encoder = PromptEncoder(image_embedding_size=(emb, emb),
                                            input_image_size=(img_size, img_size))
        self.mask_decoder = MaskDecoder()
        if seed is not None:
            init_sam_weights(self, torch.Generator().manual_seed(seed))

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) normalized -> embeddings (B, 256, S/16, S/16)."""
        return self.image_encoder(image)

    def decode_prompts(self, embeddings, points, labels, masks=None, multimask: bool = True):
        """embeddings (B, 256, h, w), points (B, P, 2) input px, labels (B,
        P), masks (B, 1, 4h, 4w) low-res logits or None -> (masks (B, T, 4h,
        4w) logits, iou_pred (B, T))."""
        sparse, dense, image_pe = self.prompt_encoder(points, labels, masks)
        return self.mask_decoder(embeddings, image_pe, sparse, dense, multimask_output=multimask)

    def load_torch_weights(self, source, strict: bool = True) -> Dict:
        """Load an official checkpoint (a path, read by ``torch.load(
        weights_only=True)``, or a name -> array dict); see
        ``convert.load_official``."""
        return load_official(self, source, strict=strict)

    @property
    def num_params(self) -> int:
        """The JAX variables' entry count (``convert.num_weights``)."""
        return num_weights(self)


@torch.no_grad()
def init_sam_weights(model: Sam, generator: torch.Generator) -> Sam:
    """Fresh weights with JAX ``Sam.init``'s initializers, drawn from
    ``generator``: Linear and conv kernels flax's ``lecun_normal`` (``fan_in``
    the input width, times the kernel's area over groups, for a transposed
    conv too: flax's kernel is (kh, kw, in, out)), biases 0,
    LayerNorm and BatchNorm 1 and 0, ``pos_embed`` normal(0.02), the
    Fourier matrix and the prompt and decoder token embeddings normal(1),
    the relative-position tables and TinyViT attention biases 0."""
    for name, m in model.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w[0].numel()
            t = torch.empty(w.shape)
            _trunc_normal_(t, math.sqrt(1.0 / fan_in) / TRUNC_NORMAL_STD, generator)
            w.copy_(t)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
    enc = model.image_encoder
    if isinstance(enc, ImageEncoderViT):
        enc.pos_embed.copy_(torch.randn(enc.pos_embed.shape, generator=generator) * 0.02)
    for m in model.modules():
        if hasattr(m, "rel_pos_h"):
            m.rel_pos_h.zero_()
            m.rel_pos_w.zero_()
        if hasattr(m, "attention_biases"):
            m.attention_biases.zero_()
    g = model.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix
    g.copy_(torch.randn(g.shape, generator=generator))
    return model


def build_sam(variant: str = "sam_b", img_size: int = 1024, seed: Optional[int] = 0) -> Sam:
    """A ``Sam`` of ``variant`` (sam_b, sam_l, sam_h, mobile_sam, sam_t)."""
    if variant not in SAM_VARIANTS and variant not in MOBILE_VARIANTS:
        raise ValueError(f"variant '{variant}' not in {list(SAM_VARIANTS) + list(MOBILE_VARIANTS)}")
    return Sam(variant=variant, img_size=img_size, seed=seed)


class Predictor:
    """The promptable predictor on ``device`` (an ``nn.Module`` model, by
    default a seeded sam_b, is moved there; a model that is no module, such
    as a test's stub, keeps its own device): ``set_image`` then
    ``predict``, or ``generate``."""

    def __init__(self, model=None, img_size: int = 1024, device="cuda"):
        self.model = model if model is not None else build_sam(img_size=img_size)
        if isinstance(self.model, nn.Module):
            self.device = torch.device(device)
            self.model.to(self.device).eval()
        else:
            self.device = torch.device(getattr(self.model, "device", "cpu"))
        self._emb = None
        self._scale = 1.0
        self._orig_hw = None
        self.input_u8 = None

    def _normalize(self, rgb_u8: np.ndarray) -> torch.Tensor:
        """(h, w, 3) RGB uint8 -> (h, w, 3) float32 on the device, ``(x -
        mean) / std``."""
        x = torch.from_numpy(np.ascontiguousarray(rgb_u8)).to(self.device).float()
        mean = torch.from_numpy(self.model.pixel_mean).to(self.device)
        std = torch.from_numpy(self.model.pixel_std).to(self.device)
        return (x - mean) / std

    @torch.inference_mode()
    def set_image(self, image: np.ndarray):
        """BGR uint8 (H, W, 3) -> the embeddings of its square input, cached.
        ``input_u8`` keeps the resized RGB image before normalizing."""
        self._orig_hw = image.shape[:2]
        s = self.model.img_size
        r = min(s / image.shape[0], s / image.shape[1])
        nh, nw = round(image.shape[0] * r), round(image.shape[1] * r)
        resized = image if (nh, nw) == image.shape[:2] else _resize_linear_u8(image, nh, nw)
        self.input_u8 = np.ascontiguousarray(resized[..., ::-1])
        canvas = torch.zeros((s, s, 3), dtype=torch.float32, device=self.device)
        canvas[:nh, :nw] = self._normalize(self.input_u8)
        self._scale = r
        self._emb = self.model.encode_image(canvas.permute(2, 0, 1)[None])

    @torch.inference_mode()
    def predict(self, point_coords=None, point_labels=None, box=None, mask_input=None,
                multimask_output: bool = True, return_logits: bool = False):
        """Points (P, 2) px with labels (P,), a box (4,) xyxy px, a low-res
        mask prompt (4h, 4w) logits -> (masks (T, H, W) bool, iou_pred
        (T,)); with ``return_logits`` also the low-res logits (T, 4h, 4w)."""
        assert self._emb is not None, "call set_image first"
        pts, labs = [], []
        if point_coords is not None:
            pts.extend(np.asarray(point_coords, np.float32) * self._scale)
            labs.extend(np.asarray(point_labels, np.int32))
        if box is not None:
            b = np.asarray(box, np.float32) * self._scale
            pts.extend([b[:2], b[2:]])
            labs.extend([2, 3])
        else:  # the official pad point whenever no box is given
            pts.append([0.0, 0.0])
            labs.append(-1)
        p = torch.from_numpy(np.asarray(pts, np.float32))[None].to(self.device)
        lab = torch.from_numpy(np.asarray(labs, np.int64))[None].to(self.device)
        m = None
        if mask_input is not None:
            m = torch.from_numpy(np.array(mask_input, np.float32))[None, None].to(self.device)
        masks, iou = self.model.decode_prompts(self._emb, p, lab, m, multimask=multimask_output)
        low = masks[0].float()  # (T, s/4, s/4)
        h, w = self._orig_hw
        s = self.model.img_size
        full = resize_linear_f32(low, s, s)
        crop = full[:, : round(h * self._scale), : round(w * self._scale)].contiguous()
        out = (resize_linear_f32(crop, h, w) > self.model.mask_threshold).cpu().numpy()
        iou = iou[0].float().cpu().numpy()
        if return_logits:
            return out, iou, low.cpu().numpy()
        return out, iou

    def _amg_batch(self, emb, pts: torch.Tensor, thresh: torch.Tensor, offset: torch.Tensor):
        """One point batch: pts (P, 2) input px -> low-res logits (P, 3, hq,
        wq), iou (P, 3), stability (P, 3). Each point is a prompt with the
        official pad point; the embeddings are broadcast, not copied."""
        n = pts.shape[0]
        points = torch.stack([pts, torch.zeros_like(pts)], 1)
        labels = torch.tensor([1, -1], device=pts.device).expand(n, 2)
        embs = emb.expand(n, *emb.shape[1:])
        logits, iou = self.model.decode_prompts(embs, points, labels, multimask=True)
        return logits, iou, amg.stability_score(logits, thresh, offset)

    @torch.inference_mode()
    def generate(self, image, crop_n_layers: int = 0, crop_overlap_ratio: float = 512 / 1500,
                 crop_downscale_factor: int = 1, point_grids=None, points_stride: int = 32,
                 points_batch_size: int = 64, conf_thres: float = 0.88,
                 stability_score_thresh: float = 0.95, stability_score_offset: float = 0.95,
                 iou_thres: float = 0.7, crop_nms_thresh: float = 0.7,
                 min_mask_region_area: int = 0, crop_edge_atol: float = 20.0):
        """Segment everything -> (masks (N, H, W) bool, scores (N,), boxes
        (N, 4) xyxy px); see the module docstring. Each crop is resized to
        the square input and its grid points are placed in input pixels, as
        JAX's (its documented correction of the reference)."""
        image = np.asarray(image)
        h, w = image.shape[:2]
        crop_regions, layer_idxs = amg.generate_crop_boxes((h, w), crop_n_layers,
                                                           crop_overlap_ratio)
        if point_grids is None:
            point_grids = amg.build_all_layer_point_grids(points_stride, crop_n_layers,
                                                          crop_downscale_factor)
        s = self.model.img_size
        thr = torch.tensor(self.model.mask_threshold, dtype=torch.float32, device=self.device)
        off = torch.tensor(stability_score_offset, dtype=torch.float32, device=self.device)
        all_masks, all_boxes, all_scores, region_areas = [], [], [], []
        for region, layer in zip(crop_regions, layer_idxs):
            x0, y0, x1, y1 = region
            cw, ch = x1 - x0, y1 - y0
            crop = image[y0:y1, x0:x1]
            if crop.ndim == 2:
                crop = np.repeat(crop[..., None], 3, -1)
            resized = crop if crop.shape[:2] == (s, s) else _resize_linear_u8(crop, s, s)
            norm = self._normalize(resized[..., ::-1])
            emb = self.model.encode_image(norm.permute(2, 0, 1)[None])
            pts = torch.from_numpy((point_grids[layer] * s).astype(np.float32)).to(self.device)
            keep_logits, keep_scores = [], []
            for i in range(0, len(pts), points_batch_size):
                chunk = pts[i: i + points_batch_size]
                n = len(chunk)
                if n < points_batch_size:  # the tail padded: every batch one shape
                    chunk = torch.cat([chunk, chunk.new_zeros(points_batch_size - n, 2)])
                logits, iou, stab = self._amg_batch(emb, chunk, thr, off)
                logits = logits[:n].reshape(n * 3, *logits.shape[2:])
                iou, stab = iou[:n].reshape(-1), stab[:n].reshape(-1)
                sel = (iou > conf_thres) & (stab > stability_score_thresh)
                keep_logits.append(logits[sel])
                keep_scores.append(iou[sel])
            lo = torch.cat(keep_logits)
            if not len(lo):
                continue
            scores = torch.cat(keep_scores).float().cpu().numpy()
            up = amg.resize_bilinear(lo.float(), ch, cw)
            masks = (up > self.model.mask_threshold).cpu().numpy()
            boxes = amg.batched_mask_to_box(masks)
            keep = ~amg.is_box_near_crop_edge(boxes + [x0, y0, x0, y0], region, [0, 0, w, h],
                                              atol=crop_edge_atol)
            keep &= masks.any((-1, -2))
            masks, boxes, scores = masks[keep], boxes[keep], scores[keep]
            if not len(masks):
                continue
            keep = amg.nms_boxes(boxes, scores, iou_thres)
            full = np.zeros((len(keep), h, w), bool)
            full[:, y0:y1, x0:x1] = masks[keep]
            all_masks.append(full)
            all_boxes.append(boxes[keep] + [x0, y0, x0, y0])
            all_scores.append(scores[keep])
            region_areas.append(np.full(len(keep), cw * ch, np.float32))
        if not all_masks:
            return (np.zeros((0, h, w), bool), np.zeros(0, np.float32),
                    np.zeros((0, 4), np.float32))
        masks = np.concatenate(all_masks)
        boxes = np.concatenate(all_boxes)
        scores = np.concatenate(all_scores)
        areas = np.concatenate(region_areas)
        if len(crop_regions) > 1:  # cross-crop dedupe, smaller crops preferred
            keep = amg.nms_boxes(boxes, 1.0 / areas, crop_nms_thresh)
            masks, boxes, scores = masks[keep], boxes[keep], scores[keep]
        if min_mask_region_area > 0:
            masks, keep = self.remove_small_regions(masks, min_mask_region_area)
            boxes, scores = boxes[keep], scores[keep]
        return masks, scores, boxes

    @staticmethod
    def remove_small_regions(masks, min_area: float = 0, nms_thresh: float = 0.7):
        """Fill small holes and drop small islands of each mask, then box
        NMS preferring the masks left unchanged (score 1 against 0) ->
        (masks, kept indices)."""
        if len(masks) == 0:
            return masks, np.zeros(0, np.int64)
        cleaned, scores = [], []
        for m in masks:
            m2, ch_holes = amg.remove_small_regions(m, min_area, mode="holes")
            m2, ch_isl = amg.remove_small_regions(m2, min_area, mode="islands")
            cleaned.append(m2)
            scores.append(0.0 if (ch_holes or ch_isl) else 1.0)
        cleaned = np.stack(cleaned)
        keep = amg.nms_boxes(amg.batched_mask_to_box(cleaned), np.asarray(scores, np.float32),
                             nms_thresh)
        return cleaned[keep], keep


def _variant_of(path: str) -> str:
    stem = str(path).rsplit("/", 1)[-1]
    return next((v for v in ("sam_h", "sam_l", "sam_b", "mobile_sam", "sam_t")
                 if v in stem or v.replace("sam_", "vit_") in stem), "sam_b")


class SAM:
    """The user-facing handle on ``device``: a variant name (seeded
    weights, ``seed``) or an official ``.pt``/``.pth`` checkpoint, its
    variant read from the file name."""

    def __init__(self, model: str = "sam_b", img_size: int = 1024, device="cuda", seed: int = 0):
        if str(model).endswith((".pt", ".pth")):
            self.model = build_sam(_variant_of(model), img_size, seed=None)
            self.model.load_torch_weights(model)
        else:
            self.model = build_sam(model, img_size, seed=seed)
        self.device = torch.device(device)
        self.model.to(self.device).eval()
        self.predictor: Optional[Predictor] = None

    def _image(self, source) -> np.ndarray:
        if isinstance(source, (str, bytes)) or not hasattr(source, "shape"):
            raise TypeError("sources are decoded HWC uint8 BGR numpy images; decoding image "
                            "files is not ported")
        if self.predictor is None:
            self.predictor = Predictor(self.model, device=self.device)
        return np.asarray(source)

    def predict(self, source, points=None, labels=None, bboxes=None, masks=None, **kw):
        """With prompts: (masks, iou). With none: everything mode, (masks,
        scores) (``generate`` gives the boxes too)."""
        img = self._image(source)
        if points is None and bboxes is None and masks is None:
            m, s, _ = self.predictor.generate(img, **kw)
            return m, s
        self.predictor.set_image(img)
        return self.predictor.predict(points, labels, bboxes, mask_input=masks, **kw)

    def generate(self, source, **kw):
        """Everything mode: (masks (N, H, W) bool, scores (N,), boxes (N, 4))."""
        img = self._image(source)
        return self.predictor.generate(img, **kw)

    def info(self) -> Dict[str, int]:
        return {"parameters": self.model.num_params}
