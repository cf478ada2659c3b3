"""The deploy form: structural reparameterization (counterpart of the JAX
package's ``nn/fuse.py``).

The JAX package folds its (params, batch_stats) trees into a deploy tree;
here the same algebra replaces modules in place. Each of the three conv
forms becomes one ``FusedConv``, a conv with bias and the activation:

  - Conv:     conv (no bias) + BN          -> conv (bias)
  - Conv2:    kxk + parallel 1x1 + BN      -> kxk (bias), the 1x1 at the centre
  - RepConv:  3x3 + BN, 1x1 + BN, id-BN    -> 3x3 (bias), the identity BN (when
                                              the block has one) as an identity
                                              kernel at the centre

The Convs inside other modules (Focus, GhostConv, GhostBottleneck, the
C-blocks, TransformerBlock) fuse the same way. A ``ConvTranspose`` with a
BatchNorm folds it into its transposed kernel (the reference's
``fuse_deconv_and_bn``; JAX's ``fuse_tree`` fuses only conv + BN pairs and
leaves such a module without its statistics, so the port departs from it
here); a raw one (no BN) passes as it is.

BatchNorm folds with its own eps (1e-3). Kernels are OIHW here (HWIO in
JAX), so a fused model's state dict carries over to and from a fused JAX
tree by ``utils/checkpoint.py``. A fused model keeps the graph's forward and
decodes; it has no BatchNorm and is inference-only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .modules.conv import Conv, Conv2, ConvTranspose, RepConv


class FusedConv(nn.Module):
    """The deploy form of Conv, Conv2 and RepConv: one conv with bias, then
    the block's activation. Its conv is ``conv`` (the JAX ``conv/kernel``
    and ``conv/bias``)."""

    def __init__(self, conv: nn.Conv2d, act: nn.Module):
        super().__init__()
        self.conv = conv
        self.act = act

    def forward(self, x):
        return self.act(self.conv(x))


def _bn_terms(bn: nn.BatchNorm2d):
    """BN as a per-channel scale and shift."""
    t = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return t, bn.bias - bn.running_mean * t


def _fold(kernel: torch.Tensor, bn: nn.BatchNorm2d):
    """(kernel OIHW, no bias) followed by BN -> (kernel, bias)."""
    t, shift = _bn_terms(bn)
    return kernel * t[:, None, None, None], shift


def _pad_to(k1: torch.Tensor, k: int) -> torch.Tensor:
    """(O, I, 1, 1) -> (O, I, k, k) with the 1x1 at the centre."""
    pad = (k - 1) // 2
    return F.pad(k1, [pad, k - 1 - pad, pad, k - 1 - pad])


def _identity_kernel(like: torch.Tensor) -> torch.Tensor:
    """The kernel of the identity, shaped as ``like`` (O, I, kh, kw), I being
    the channels of a group: centre[o, o % I] = 1."""
    co, ci, kh, kw = like.shape
    ident = torch.zeros_like(like)
    o = torch.arange(co, device=like.device)
    ident[o, o % ci, kh // 2, kw // 2] = 1.0
    return ident


def _conv_like(conv: nn.Conv2d, kernel: torch.Tensor, bias: torch.Tensor) -> nn.Conv2d:
    """A conv with ``conv``'s geometry, and the given kernel and bias."""
    out = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride,
                    conv.padding, conv.dilation, conv.groups, bias=True,
                    device=kernel.device, dtype=kernel.dtype)
    out.weight.copy_(kernel)
    out.bias.copy_(bias)
    return out


@torch.no_grad()
def fuse_conv(m: nn.Module) -> FusedConv:
    """The deploy form of one Conv, Conv2 or RepConv (see the module
    docstring), with its BatchNorm's running statistics."""
    if isinstance(m, RepConv):
        k3, b3 = _fold(m.conv1.conv.weight, m.conv1.bn)
        k1, b1 = _fold(m.conv2.conv.weight, m.conv2.bn)
        kernel, bias = k3 + _pad_to(k1, k3.shape[-1]), b3 + b1
        if m.bn is not None:
            kid, bid = _fold(_identity_kernel(k3), m.bn)
            kernel, bias = kernel + kid, bias + bid
        return FusedConv(_conv_like(m.conv1.conv, kernel, bias), m.act)
    if isinstance(m, Conv2):
        k = m.conv.weight.shape[-1]
        kernel, bias = _fold(m.conv.weight + _pad_to(m.cv2.weight, k), m.bn)
        return FusedConv(_conv_like(m.conv, kernel, bias), m.act)
    if isinstance(m, Conv):
        kernel, bias = _fold(m.conv.weight, m.bn)
        return FusedConv(_conv_like(m.conv, kernel, bias), m.act)
    raise TypeError(f"{type(m).__name__} has no deploy form")


@torch.no_grad()
def fuse_conv_transpose(m: ConvTranspose) -> ConvTranspose:
    """A BatchNorm'd ConvTranspose with the BN folded into a biased
    transposed kernel (in, out, kh, kw: the scale along ``out``), in
    place; a raw one as it is."""
    if m.bn is None:
        return m
    ct = m.conv_transpose
    t, shift = _bn_terms(m.bn)
    out = nn.ConvTranspose2d(ct.in_channels, ct.out_channels, ct.kernel_size, ct.stride,
                             ct.padding, ct.output_padding, ct.groups, bias=True,
                             dilation=ct.dilation, device=ct.weight.device,
                             dtype=ct.weight.dtype)
    out.weight.copy_(ct.weight * t[None, :, None, None])
    out.bias.copy_(shift)
    m.conv_transpose, m.bn = out, None
    return m


def _fuse_children(module: nn.Module):
    for name, child in module.named_children():
        if isinstance(child, (Conv, Conv2, RepConv)):
            setattr(module, name, fuse_conv(child))
        elif isinstance(child, ConvTranspose):
            fuse_conv_transpose(child)
        else:
            _fuse_children(child)


def fuse_model(model: nn.Module) -> nn.Module:
    """Fuse every Conv, Conv2, RepConv and BatchNorm'd ConvTranspose of
    ``model`` in place (the JAX ``fuse_variables``); sets ``model.fused``
    and puts it in eval mode. A model already fused is returned as it
    is."""
    if getattr(model, "fused", False):
        return model
    _fuse_children(model)
    model.fused = True
    return model.eval()


@torch.no_grad()
def fold_input_scale(model: nn.Module, scale: float = 1.0 / 255.0) -> nn.Module:
    """Fold an input scale into the stem conv of a fused model, in place:
    ``conv(s * x, W) + b == conv(x, s * W) + b``, so the model then takes
    raw 0..255 pixels in place of ``x / 255``. Raises unless the model is
    fused and its layer 0 is a conv on 1 or 3 channels."""
    stem = model.model[0] if getattr(model, "fused", False) else None
    if not isinstance(stem, FusedConv):
        raise ValueError("fold_input_scale needs a fused model (fuse_model) with a layer 0 "
                         "stem conv")
    if stem.conv.in_channels not in (1, 3):
        raise ValueError(f"layer 0 conv in-channels {stem.conv.in_channels} does not look like "
                         "an image stem; refusing to fold")
    stem.conv.weight.mul_(scale)
    return model
