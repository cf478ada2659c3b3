"""Native w8a8 int8 inference (counterpart of the JAX package's
``nn/quant.py`` and of the int8 branch of its ``deploy_conv``).

Post-training quantization of a FUSED deploy model (``nn/fuse.py``), in
place:

  1. **Calibrate** (``calibrate``): run batches through the fused model,
     recording each ``FusedConv``'s input absmax and its shape features
     (``h``, ``w``, ``cin``, ``cout``, ``groups``) under the JAX module path
     of the conv (``"layer2/m0/cv1"``), as JAX's ``quant_calibration``
     keys them.
  2. **Quantize** (``quantize_tree``, on the JAX-form weight tree that
     ``utils/checkpoint.py:to_jax_variables`` gives): per conv a symmetric
     per-out-channel weight scale ``w_scale = max(absmax(kernel over H, W,
     I) / 127, 1e-8)`` and a scalar input scale ``x_scale = max(absmax /
     127, 1e-8)``; the float kernel becomes int8 and the scales join it
     under the same ``conv`` scope. Depthwise convs (one in-channel a group)
     stay float, and with ``selective`` so do the convs ``int8_wins``
     rejects (``cin < 128``). numpy does this arithmetic, JAX's own.
  3. **Run** (``QuantConv2d``, swapped in for the quantized convs by
     ``as_quantized_model``): ``x_q = clip(round(x / x_scale), -127, 127)``
     as int8 (half to even, as ``jnp.round``), an s8 x s8 -> s32 conv with
     the conv's stride, padding, dilation and groups (``int8_conv2d``: a
     channels-last im2col, one strided copy, and ``torch._int_mm``; exact
     integer sums on either device),
     then ``acc * (x_scale * w_scale) + bias`` in float32 and the block's
     activation. A failure raises; nothing falls back to the float conv.

The state dict of a quantized conv is ``{weight (int8, OIHW), bias,
w_scale (C_out), x_scale ()}``, JAX's ``conv/{kernel (HWIO), bias, w_scale,
x_scale}`` through ``utils/checkpoint.py``, so an int8 checkpoint
(``deploy == "int8"``) goes both ways.
"""
from __future__ import annotations

import copy
import logging
from typing import Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.checkpoint import _jax_leaf, from_jax_variables, load_jax_variables, to_jax_variables
from .fuse import FusedConv

LOGGER = logging.getLogger(__name__)

QMAX = 127  # symmetric: codes in [-127, 127], -128 unused


def quantize_input(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / x_scale), -127, 127)`` as int8, rounding half to
    even (JAX's ``jnp.round``)."""
    return torch.clamp(torch.round(x.float() / x_scale), -QMAX, QMAX).to(torch.int8)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 by ``torch._int_mm``,
    zero-padded to the shapes its CUDA path takes (K and N multiples of 8,
    M above 16); the zeros add nothing to the exact integer sums."""
    m, k = a.shape
    n = b.shape[1]
    kp, npad, mp = -k % 8, -n % 8, max(17 - m, 0)
    if kp or mp:
        a = F.pad(a, (0, kp, 0, mp))
    # B column-major: the transposed view of a contiguous (N, K) matrix
    bt = F.pad(b.t(), (0, kp, 0, npad)) if kp or npad else b.t().contiguous()
    out = torch._int_mm(a.contiguous(), bt.t())
    return out[:m, :n] if mp or npad else out


def _im2col(x: torch.Tensor, kh: int, kw: int, stride, padding, dilation):
    """(N, H, W, C) -> (N * Ho * Wo, kh * kw * C) columns in the order of an
    OHWI kernel's (kh, kw, C): a strided view of the padded input, copied
    once; and (Ho, Wo)."""
    n, h, w, c = x.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if kh == kw == 1 and sh == sw == 1 and ph == pw == 0:
        return x.reshape(n * h * w, c), h, w
    xp = F.pad(x, (0, 0, pw, pw, ph, ph)).contiguous()
    s_n, s_h, s_w, s_c = xp.stride()
    cols = xp.as_strided((n, ho, wo, kh, kw, c),
                         (s_n, s_h * sh, s_w * sw, s_h * dh, s_w * dw, s_c))
    return cols.reshape(n * ho * wo, kh * kw * c), ho, wo


def int8_conv2d(x_q: torch.Tensor, w_q: torch.Tensor, stride=(1, 1), padding=(0, 0),
                dilation=(1, 1), groups: int = 1) -> torch.Tensor:
    """The s8 x s8 -> s32 conv (JAX's ``lax.conv_general_dilated(...,
    preferred_element_type=jnp.int32)``): ``x_q`` (N, C, H, W) int8,
    ``w_q`` (O, C / groups, kh, kw) int8 -> the int32 accumulations (N, Ho,
    Wo, O), channels last."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 tensors, got {x_q.dtype} and {w_q.dtype}")
    n = x_q.shape[0]
    o, ci, kh, kw = w_q.shape
    og = o // groups
    x_nhwc = x_q.permute(0, 2, 3, 1)
    w_ohwi = w_q.permute(0, 2, 3, 1).reshape(o, kh * kw * ci)
    accs = []
    for g in range(groups):
        xg = x_nhwc[..., g * ci:(g + 1) * ci] if groups > 1 else x_nhwc
        a, ho, wo = _im2col(xg, kh, kw, stride, padding, dilation)
        accs.append(_int_mm(a, w_ohwi[g * og:(g + 1) * og].t()))
    acc = accs[0] if groups == 1 else torch.cat(accs, 1)
    return acc.view(n, ho, wo, o)


class QuantConv2d(nn.Module):
    """The int8 form of a ``FusedConv``'s conv (its ``conv``): an int8
    kernel (OIHW), the float32 bias, ``w_scale`` (C_out) and the scalar
    ``x_scale``, each a frozen parameter (JAX keeps all four in ``params``);
    the geometry of the float conv it replaces. Inference only."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        dev = conv.weight.device
        self.stride, self.padding = tuple(conv.stride), tuple(conv.padding)
        self.dilation, self.groups = tuple(conv.dilation), conv.groups
        self.in_channels, self.out_channels = conv.in_channels, conv.out_channels
        frozen = lambda t: nn.Parameter(t, requires_grad=False)  # noqa: E731
        self.weight = frozen(torch.zeros(conv.weight.shape, dtype=torch.int8, device=dev))
        self.bias = frozen(torch.zeros(conv.out_channels, device=dev))
        self.w_scale = frozen(torch.ones(conv.out_channels, device=dev))
        self.x_scale = frozen(torch.ones((), device=dev))

    def accumulate(self, x: torch.Tensor) -> torch.Tensor:
        """The int32 accumulations of ``x`` quantized with ``x_scale``:
        (N, Ho, Wo, C_out)."""
        return int8_conv2d(quantize_input(x, self.x_scale), self.weight, self.stride,
                           self.padding, self.dilation, self.groups)

    def forward(self, x):
        acc = self.accumulate(x)
        # JAX's order: acc * (x_scale * w_scale) + bias, in float32
        y = acc.float() * (self.x_scale * self.w_scale) + self.bias
        return y.permute(0, 3, 1, 2).contiguous()

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, kernel_size="
                f"{tuple(self.weight.shape[2:])}, stride={self.stride}, padding={self.padding}, "
                f"groups={self.groups}, int8")


def conv_keys(model: nn.Module) -> Dict[str, str]:
    """The name of each ``FusedConv`` of ``model`` -> its JAX module path
    (JAX's calibration key: the scope whose ``conv`` holds the kernel)."""
    sd = model.state_dict()
    keys = {k: tuple(v.shape) for k, v in sd.items()}
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, FusedConv):
            kernel = f"{name}.conv.weight" if name else "conv.weight"
            if name.split(".")[0] == "model":
                out[name] = "/".join(_jax_leaf(kernel, keys[kernel], keys)[1][:-2])
            else:  # a bare module: its own dotted path
                out[name] = name.replace(".", "/")
    return out


def _as_nchw(x, device) -> torch.Tensor:
    """A (B, H, W, C) calibration batch (an array or a tensor) -> (B, C, H,
    W) float32 on ``device``."""
    t = torch.from_numpy(np.array(x, np.float32)) if not isinstance(x, torch.Tensor) else x
    return t.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2).contiguous()


@torch.inference_mode()
def calibrate(deploy_model: nn.Module, calib_batches: Iterable) -> Dict[str, dict]:
    """Run ``calib_batches`` ((B, H, W, 3) float arrays in [0, 1], JAX's
    layout) through the fused model on its device, recording each deploy
    conv's input absmax (the largest over the batches) and its shape
    features, keyed by JAX module path. Returns the capture dict."""
    keys = conv_keys(deploy_model)
    device = next(deploy_model.parameters()).device
    cal: Dict[str, dict] = {}

    def hook(key, c2, groups):
        def pre(_, args):
            x = args[0]
            prev = cal.get(key, {}).get("absmax", 0.0)
            cal[key] = {"absmax": max(prev, float(x.abs().max())),
                        "h": int(x.shape[2]), "w": int(x.shape[3]), "cin": int(x.shape[1]),
                        "cout": int(c2), "groups": int(groups)}
        return pre

    modules = dict(deploy_model.named_modules())
    handles = [modules[name].register_forward_pre_hook(
        hook(key, modules[name].conv.out_channels, modules[name].conv.groups))
        for name, key in keys.items()]
    try:
        for x in calib_batches:
            deploy_model(_as_nchw(x, device))
    finally:
        for h in handles:
            h.remove()
    if not cal:
        raise ValueError("calibration saw no deploy convs: pass a FUSED model (nn.fuse.fuse_model) "
                         "and at least one batch")
    return cal


def int8_wins(info: Dict) -> bool:
    """JAX's selective-quantization predicate: only deep layers (``cin >=
    128``) are converted with ``selective=True``."""
    return info.get("cin", 0) >= 128


def quantize_tree(params: Dict, cal: Dict, selective: bool = False) -> Tuple[Dict, int, int]:
    """A copy of the fused JAX-form ``params`` tree with int8 kernels and
    their scales for every calibrated conv -> (tree, n_quantized,
    n_skipped); JAX's ``quantize_tree``, the same numpy arithmetic."""
    out = copy.deepcopy(params)
    n_q = n_skip = 0
    for key, info in cal.items():
        if not isinstance(info, dict):  # a bare absmax
            info = {"absmax": float(info)}
        node = out
        for part in (p for p in key.split("/") if p):  # "" is the top-level module
            node = node[part]
        conv = node["conv"]
        kernel = np.asarray(conv["kernel"], np.float32)
        if (kernel.shape[2] == 1 and kernel.shape[3] > 1) or (selective and not int8_wins(info)):
            n_skip += 1  # depthwise (one in-channel a group), or selective's rejects
            continue
        w_scale = np.maximum(np.abs(kernel).max(axis=(0, 1, 2)) / 127.0, 1e-8).astype(np.float32)
        conv["kernel"] = np.clip(np.round(kernel / w_scale), -QMAX, QMAX).astype(np.int8)
        conv["w_scale"] = w_scale
        conv["x_scale"] = np.asarray(np.float32(max(info["absmax"] / 127.0, 1e-8)))
        n_q += 1
    return out, n_q, n_skip


def as_quantized_model(deploy_model: nn.Module, params: Dict) -> nn.Module:
    """Swap a ``QuantConv2d`` in for the conv of every ``FusedConv`` whose
    scope in ``params`` (a JAX-form tree, ``quantize_tree``'s or an int8
    checkpoint's) carries ``w_scale``, load ``params`` into the model, and
    mark it ``quantized``. Raises if no scope is quantized."""
    sd = from_jax_variables(params, {})
    n = 0
    for name, m in deploy_model.named_modules():
        if isinstance(m, FusedConv) and f"{name + '.' if name else ''}conv.w_scale" in sd:
            if not isinstance(m.conv, QuantConv2d):
                m.conv = QuantConv2d(m.conv)
            n += 1
    if n == 0:
        raise ValueError("no int8 conv in the weights: an int8 model needs kernels quantized by "
                         "nn/quant.py:quantize_tree (a deploy='int8' checkpoint carries them)")
    load_jax_variables(deploy_model, params, {})
    deploy_model.quantized = True
    return deploy_model.eval()


def quantize_variables(deploy_model: nn.Module, calib_batches: Iterable,
                       selective: bool = False) -> Tuple[nn.Module, int, int]:
    """Calibrate the fused ``deploy_model`` on its device, quantize its
    kernels with those scales, and swap the int8 convs in, in place ->
    (model, n_quantized, n_skipped) (JAX's ``quantize_variables``)."""
    if not getattr(deploy_model, "fused", False):
        raise ValueError("quantize a fused model (nn.fuse.fuse_model)")
    if getattr(deploy_model, "quantized", False):
        raise RuntimeError("the model is int8 already: re-calibrating from int8 codes would "
                           "corrupt its scales; quantize the fp32 weights")
    cal = calibrate(deploy_model, calib_batches)
    params, _ = to_jax_variables(deploy_model.state_dict())
    qparams, n_q, n_skip = quantize_tree(params, cal, selective=selective)
    as_quantized_model(deploy_model, qparams)
    LOGGER.info(f"quantized {n_q} convs to int8 ({n_skip} kept f32"
                f"{', selective mode' if selective else ', depthwise'})")
    return deploy_model, n_q, n_skip
