"""Contrastive denoising (CDN) groups for the RT-DETR train step
(counterpart of the JAX package's ``models/utils/ops.py``).

The padded (B, N) GT tensors are copied into G = max(num_dn // N, 1)
groups of (positive, negative) pairs, so the dn query count 2 * N * G is
fixed; padded GT slots ride along and are masked out of the dn loss. Noise:
with probability ``cls_noise_ratio * 0.5`` a class is replaced by a uniform
random one; each box corner moves by ``sign * part * wh / 2 *
box_noise_scale`` with ``part`` uniform in [0, 1) for the positive copy and
in [1, 2) for the negative one (pushed outside the box), clipped to [0, 1].

The draws are split from the arithmetic: ``cdn_draws`` makes them from an
explicit ``torch.Generator`` (``cdn_generator(step)`` seeds it from
``(17, step)``, where the JAX step folds ``step`` into ``PRNGKey(17)``: the
port's draws are not JAX's), and ``cdn_group_from_draws`` computes the dn
dict from any draws, so a test can hand it JAX's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

CDN_SEED = 17


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``log(x / (1 - x))`` of ``x`` clipped to [eps, 1 - eps] (the CDN
    one; the decoder's ``nn/modules/transformer.py`` clips to [0, 1] and
    bounds each side by ``eps``)."""
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def cdn_generator(step: int) -> torch.Generator:
    """A CPU generator seeded from ``(CDN_SEED, step)``."""
    seed = int(np.random.SeedSequence([CDN_SEED, int(step)]).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


def num_groups(n: int, num_dn: int = 100) -> int:
    return max(num_dn // max(n, 1), 1)


def cdn_draws(B: int, G: int, N: int, nc: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The random draws of one CDN group set, on the CPU: ``flip`` (B, G, 2,
    N) uniform in [0, 1) (a class is replaced where it is below
    ``cls_noise_ratio * 0.5``), ``new_cls`` (B, G, 2, N) in [0, nc),
    ``sign`` (B, G, 2, N, 4) of +-1 and ``part`` (B, G, 2, N, 4) uniform
    in [0, 1)."""
    shape = (B, G, 2, N)
    return {"flip": torch.rand(shape, generator=generator),
            "new_cls": torch.randint(0, nc, shape, generator=generator),
            "sign": torch.randint(0, 2, shape + (4,), generator=generator).float() * 2.0 - 1.0,
            "part": torch.rand(shape + (4,), generator=generator)}


def cdn_group_from_draws(batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
                         cls_noise_ratio: float = 0.5, box_noise_scale: float = 1.0
                         ) -> Dict[str, torch.Tensor]:
    """batch {'cls' (B, N), 'bboxes' (B, N, 4) normalized cxcywh} and the
    draws (``cdn_draws``' keys and shapes, G from their shape) -> the dn
    dict {'labels' (B, G, 2, N) int64, 'boxes_logit' (B, G, 2, N, 4)
    float32}, on the batch's device."""
    gt_cls = batch["cls"].long()
    gt_boxes = batch["bboxes"].float()
    B, G, _, N = draws["flip"].shape
    dev = gt_boxes.device
    labels = gt_cls[:, None, None, :].expand(B, G, 2, N)
    boxes = gt_boxes[:, None, None].expand(B, G, 2, N, 4)
    if cls_noise_ratio > 0:
        flip = draws["flip"].to(dev) < (cls_noise_ratio * 0.5)
        labels = torch.where(flip, draws["new_cls"].to(dev), labels)
    if box_noise_scale > 0:
        xyxy = torch.cat([boxes[..., :2] - boxes[..., 2:] / 2,
                          boxes[..., :2] + boxes[..., 2:] / 2], -1)
        diff = torch.cat([boxes[..., 2:], boxes[..., 2:]], -1) * 0.5
        neg = torch.zeros((B, G, 2, N, 1), device=dev)
        neg[:, :, 1] = 1.0
        part = draws["part"].to(dev) + neg
        noised = (xyxy + draws["sign"].to(dev) * part * diff * box_noise_scale).clamp(0.0, 1.0)
        boxes = torch.cat([(noised[..., :2] + noised[..., 2:]) / 2,
                           noised[..., 2:] - noised[..., :2]], -1)
    return {"labels": labels.contiguous(), "boxes_logit": inverse_sigmoid(boxes)}


def get_cdn_group(batch: Dict[str, torch.Tensor], nc: int, generator: torch.Generator,
                  num_dn: int = 100, cls_noise_ratio: float = 0.5, box_noise_scale: float = 1.0,
                  shard: Tuple[int, int] = (0, 1)) -> Optional[Dict[str, torch.Tensor]]:
    """The dn dict of a batch with draws from ``generator``; None when
    ``num_dn <= 0``. ``shard`` (rank, world): the batch is that rank's rows
    of a global batch of ``world`` times as many; the draws are made for the
    global batch and the rank takes its rows, as JAX draws them on the
    global array."""
    if num_dn <= 0:
        return None
    B, N = batch["cls"].shape
    r, world = shard
    draws = cdn_draws(B * world, num_groups(N, num_dn), N, nc, generator)
    if world > 1:
        draws = {k: v[r * B:(r + 1) * B] for k, v in draws.items()}
    return cdn_group_from_draws(batch, draws, cls_noise_ratio, box_noise_scale)
