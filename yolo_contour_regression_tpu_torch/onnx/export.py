"""ONNX export of the port's fused models (the port's copy of the JAX
package's ``onnx/export.py``): the graph's layer specs (``nn/tasks.py:
parse_model``) walked in order, each emitted as opset-12 nodes from the
fused parameters.

The parameters are read in the JAX package's tree form
(``utils/checkpoint.py:to_jax_variables`` of the fused model's state dict:
HWIO kernels, ``layer{i}`` names), and every emitter is the JAX one, in the
same order; names come from ``GraphBuilder.fresh``'s counter, so the same
weights and metadata give the JAX exporter's file byte for byte. With BN,
RepConv and Conv2 folded (``nn/fuse.py``) each compute block is one Conv.

The decode is in the graph, equal to the model's predict up to float32
rounding:
  - segment:  output0 (B, 4+nc+108, A): xyxy, scores, 36 segx, 36 segy, valid
  - detect:   output0 (B, 4+nc, A): xywh (px), scores
  - pose:     output0 (B, 4+nc+3K, A)
  - segment_ori: output0 (B, 4+nc+nm, A) and output1 prototypes (B, nm, H/4, W/4)
  - classify: output0 (B, nc) sigmoid probabilities
  - rtdetr:   output0 (1, nq, 4+nc) (``onnx/rtdetr.py``)

The graph is NCHW: the input ``images`` is (1, 3, imgsz, imgsz) RGB in [0, 1].
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np

from ..utils.checkpoint import to_jax_variables
from .builder import GraphBuilder

NUM_RAYS = 36
RAY_EPS = 1e-6
VALID_THRESH = 1.0


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _w_oihw(kernel) -> np.ndarray:
    """flax HWIO -> ONNX OIHW."""
    return _np(kernel).transpose(3, 2, 0, 1).copy()


def _act(g: GraphBuilder, x: str, act) -> str:
    """Mirror conv.get_act: True/None -> relu (fork default), False ->
    identity, else by name."""
    if act is False or act == "identity":
        return x
    if act is True or act is None or act == "relu":
        return g.relu(x)
    if act == "sigmoid":
        return g.sigmoid(x)
    if act in ("silu", "swish"):
        return g.mul(x, g.sigmoid(x))
    if act == "leaky_relu":
        return g.node("LeakyRelu", [x], {"alpha": 0.01})
    raise NotImplementedError(f"activation {act!r} in ONNX export")


def _conv(g, p, x, s: int = 1, group: int = 1, act="relu", d: int = 1,
          pads=None) -> str:
    """Fused Conv emitter: p = {'conv': {'kernel','bias'}} (post-fuse) or a
    raw nn.Conv {'kernel','bias'}. k and padding inferred from the kernel
    unless explicit [t, l, b, r] ``pads`` are given (HGStem's asymmetric
    bottom/right pads)."""
    if "conv" in p:
        p = p["conv"]
    w = _w_oihw(p["kernel"])
    k = w.shape[2]
    if pads is None:
        pad = (d * (k - 1) + 1 - 1) // 2 if d > 1 else (k - 1) // 2
        pads = (pad, pad, pad, pad)
    b = _np(p["bias"]) if "bias" in p else None
    y = g.conv(x, w, b, strides=(s, s), pads=pads, group=group,
               dilations=(d, d))
    return _act(g, y, act)


def _split2(g, x, c: int):
    """Channel split into two halves of c (opset-12 Slice)."""
    return (g.slice(x, [0], [c], [1]), g.slice(x, [c], [2 * c], [1]))


# --- composite blocks ---------------------------------------------------------

def _bottleneck(g, p, x, shortcut: bool, add_ok: bool) -> str:
    y = _conv(g, p["cv1"], x)
    y = _conv(g, p["cv2"], y)
    if shortcut and add_ok:
        return g.add(x, y)
    return y


def _c2f(g, p, x, kw) -> str:
    n = kw.get("n", 1)
    shortcut = kw.get("shortcut", False)
    c = int(_np(p["cv1"]["conv"]["kernel"]).shape[-1]) // 2
    y = _conv(g, p["cv1"], x)
    a, b = _split2(g, y, c)
    ys = [a, b]
    for i in range(n):
        ys.append(_bottleneck(g, p[f"m{i}"], ys[-1], shortcut, add_ok=True))
    return _conv(g, p["cv2"], g.concat(ys, 1))


def _c2(g, p, x, kw) -> str:
    n = kw.get("n", 1)
    shortcut = kw.get("shortcut", True)
    c = int(_np(p["cv1"]["conv"]["kernel"]).shape[-1]) // 2
    y = _conv(g, p["cv1"], x)
    a, b = _split2(g, y, c)
    for i in range(n):
        a = _bottleneck(g, p[f"m{i}"], a, shortcut, add_ok=True)
    return _conv(g, p["cv2"], g.concat([a, b], 1))


def _c3(g, p, x, kw) -> str:
    n = kw.get("n", 1)
    shortcut = kw.get("shortcut", True)
    y1 = _conv(g, p["cv1"], x)
    for i in range(n):
        y1 = _bottleneck(g, p[f"m{i}"], y1, shortcut, add_ok=True)
    y2 = _conv(g, p["cv2"], x)
    return _conv(g, p["cv3"], g.concat([y1, y2], 1))


def _c1(g, p, x, kw) -> str:
    y = _conv(g, p["cv1"], x)
    z = y
    for i in range(kw.get("n", 1)):
        z = _conv(g, p[f"m{i}"], z)
    return g.add(z, y)


def _nascsp(g, p, x, kw) -> str:
    n = kw.get("n", 1)
    shortcut = kw.get("shortcut", True)
    y1 = _conv(g, p["cv1"], x)
    for i in range(n):
        m = p[f"m{i}"]
        y = _conv(g, m["cv1"], y1)
        y = _conv(g, m["cv2"], y)
        y1 = g.add(y1, y) if shortcut else y
    y2 = _conv(g, p["cv2"], x)
    return _conv(g, p["cv3"], g.concat([y1, y2], 1))


def _sppf(g, p, x, kw) -> str:
    k = kw.get("k", 5)
    pad = k // 2
    y = _conv(g, p["cv1"], x)
    y1 = g.maxpool(y, k, pads=(pad, pad, pad, pad))
    y2 = g.maxpool(y1, k, pads=(pad, pad, pad, pad))
    y3 = g.maxpool(y2, k, pads=(pad, pad, pad, pad))
    return _conv(g, p["cv2"], g.concat([y, y1, y2, y3], 1))


def _spp(g, p, x, kw) -> str:
    ks = kw.get("k", (5, 9, 13))
    y = _conv(g, p["cv1"], x)
    pooled = [y] + [g.maxpool(y, k, pads=(k // 2,) * 4) for k in ks]
    return _conv(g, p["cv2"], g.concat(pooled, 1))


def _focus(g, p, x, kw) -> str:
    big = 1 << 30
    parts = [
        g.slice(x, [0, 0], [big, big], [2, 3], [2, 2]),
        g.slice(x, [1, 0], [big, big], [2, 3], [2, 2]),
        g.slice(x, [0, 1], [big, big], [2, 3], [2, 2]),
        g.slice(x, [1, 1], [big, big], [2, 3], [2, 2]),
    ]
    return _conv(g, p["conv"], g.concat(parts, 1), s=kw.get("s", 1),
                 act=kw.get("act", True))


def _ghostconv(g, p, x, kw) -> str:
    y = _conv(g, p["cv1"], x, s=kw.get("s", 1), act=kw.get("act", True))
    c_ = int(_np(p["cv1"]["conv"]["kernel"]).shape[-1])
    y2 = _conv(g, p["cv2"], y, group=c_, act=kw.get("act", True))
    return g.concat([y, y2], 1)


def _dwconv(g, p, x, kw, c1: int) -> str:
    c2 = kw["c2"]
    return _conv(g, p["dw"], x, s=kw.get("s", 1), group=math.gcd(c1, c2),
                 act=kw.get("act", True), d=kw.get("d", 1))


# --- anchors / decode ---------------------------------------------------------

def _anchors(strides: Sequence[int], imgsz: int):
    """(A,) x/y anchor centers in grid units, per-anchor stride, level shapes."""
    xs, ys, ss, hw = [], [], [], []
    for s in strides:
        h = w = imgsz // s
        gx, gy = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
        xs.append(gx.reshape(-1))
        ys.append(gy.reshape(-1))
        ss.append(np.full(h * w, s, np.float32))
        hw.append((h, w))
    return (_np(np.concatenate(xs)), _np(np.concatenate(ys)),
            _np(np.concatenate(ss)), hw)


def _flatten_cat(g, levels: List[str], per_level_c: int, hw) -> str:
    flat = [
        g.reshape(lv, [0, per_level_c, h * w]) for lv, (h, w) in zip(levels, hw)
    ]
    return g.concat(flat, 2)


def _decode_polar(g, levels, nc: int, strides, imgsz: int) -> str:
    ax, ay, st, hw = _anchors(strides, imgsz)
    a = len(st)
    x = _flatten_cat(g, levels, NUM_RAYS + nc, hw)  # (B, 36+nc, A)
    rays = g.slice(x, [0], [NUM_RAYS], [1])
    cls = g.slice(x, [NUM_RAYS], [NUM_RAYS + nc], [1])

    # constants materialized at the full (1, 36, A) broadcast shape: OpenCV's
    # C++ ONNX importer (<= 4.6) only supports same-shape or per-channel
    # elementwise operands, not last-axis broadcast (~5 MB at 640px, free at
    # load time in every other runtime)
    def full(v, hint):
        return g.c(np.broadcast_to(v, (1, NUM_RAYS, a)).astype(np.float32).copy(),
                   hint=hint)

    stride_row = full(st.reshape(1, 1, a), "stride")
    rays_px = g.clip_min(g.mul(rays, stride_row), RAY_EPS)
    theta = np.arange(0, 360, 360 // NUM_RAYS, dtype=np.float64) * math.pi / 180.0
    cos = full(np.cos(theta).reshape(1, NUM_RAYS, 1), "cos")
    sin = full(np.sin(theta).reshape(1, NUM_RAYS, 1), "sin")
    cx = full((ax * st).reshape(1, 1, a), "cx")
    cy = full((ay * st).reshape(1, 1, a), "cy")
    segx = g.add(g.mul(rays_px, cos), cx)  # (B, 36, A)
    segy = g.add(g.mul(rays_px, sin), cy)
    valid = g.node(
        "Cast",
        [g.node("Greater", [rays_px, g.c(np.float32(VALID_THRESH), hint="vth")])],
        {"to": 1},
    )
    x1 = g.node("ReduceMin", [segx], {"axes": [1], "keepdims": 1})
    y1 = g.node("ReduceMin", [segy], {"axes": [1], "keepdims": 1})
    x2 = g.node("ReduceMax", [segx], {"axes": [1], "keepdims": 1})
    y2 = g.node("ReduceMax", [segy], {"axes": [1], "keepdims": 1})
    scores = g.sigmoid(cls)
    return g.concat([x1, y1, x2, y2, scores, segx, segy, valid], 1)


def _decode_detect_boxes(g, box_dist: str, strides, imgsz: int, reg_max: int = 16) -> str:
    """(B, 4*reg_max, A) raw DFL logits -> (B, 4, A) xywh boxes in pixels."""
    ax, ay, st, _ = _anchors(strides, imgsz)
    a = len(st)
    d4 = g.reshape(box_dist, [0, 4, reg_max, a])
    # stable softmax over the bin axis (2)
    m = g.node("ReduceMax", [d4], {"axes": [2], "keepdims": 1})
    e = g.node("Exp", [g.sub(d4, m)])
    ssum = g.node("ReduceSum", [e], {"axes": [2], "keepdims": 1})
    probs = g.div(e, ssum)
    proj = g.c(np.arange(reg_max, dtype=np.float32).reshape(1, 1, reg_max, 1), hint="proj")
    ltrb = g.node("ReduceSum", [g.mul(probs, proj)], {"axes": [2], "keepdims": 0})  # (B,4,A)
    anchor = g.c(np.stack([ax, ay]).reshape(1, 2, a).astype(np.float32), hint="anchor")
    lt = g.slice(ltrb, [0], [2], [1])
    rb = g.slice(ltrb, [2], [4], [1])
    x1y1 = g.sub(anchor, lt)
    x2y2 = g.add(anchor, rb)
    cxy = g.mul(g.add(x1y1, x2y2), g.c(np.float32(0.5), hint="half"))
    wh = g.sub(x2y2, x1y1)
    stride_row = g.c(st.reshape(1, 1, a), hint="stride")
    return g.mul(g.concat([cxy, wh], 1), stride_row)


def _decode_detect(g, levels, nc: int, strides, imgsz: int, reg_max: int = 16) -> str:
    _, _, st, hw = _anchors(strides, imgsz)
    x = _flatten_cat(g, levels, 4 * reg_max + nc, hw)
    box_dist = g.slice(x, [0], [4 * reg_max], [1])
    cls = g.slice(x, [4 * reg_max], [4 * reg_max + nc], [1])
    dbox = _decode_detect_boxes(g, box_dist, strides, imgsz, reg_max)
    return g.concat([dbox, g.sigmoid(cls)], 1)


def _decode_pose_kpts(g, kpt: str, strides, imgsz: int, kpt_shape) -> str:
    """(B, K*D, A) raw -> (B, K*D, A) decoded keypoints (head.py:789)."""
    K, D = kpt_shape
    ax, ay, st, _ = _anchors(strides, imgsz)
    a = len(st)
    k4 = g.reshape(kpt, [0, K, D, a])
    xy = g.slice(k4, [0], [2], [2])  # (B, K, 2, A)
    anchor = g.c(
        (np.stack([ax, ay]) - 0.5).reshape(1, 1, 2, a).astype(np.float32), hint="akpt"
    )
    stride4 = g.c(st.reshape(1, 1, 1, a), hint="skpt")
    xy = g.mul(
        g.add(g.mul(xy, g.c(np.float32(2.0), hint="two")), anchor), stride4
    )
    if D == 3:
        vis = g.sigmoid(g.slice(k4, [2], [3], [2]))
        dec = g.concat([xy, vis], 2)
    else:
        dec = xy
    return g.reshape(dec, [0, K * D, a])


# --- head emitters -------------------------------------------------------------

def _branch3(g, p, prefix: str, i: int, x: str) -> str:
    """head conv stack: Conv3x3 -> Conv3x3 -> raw 1x1."""
    y = _conv(g, p[f"{prefix}_{i}_0"], x)
    y = _conv(g, p[f"{prefix}_{i}_1"], y)
    return _conv(g, p[f"{prefix}_{i}_2"], y, act=False)


def _head_polar(g, p, feats, model, imgsz):
    levels = [
        g.concat([_branch3(g, p, "cv2", i, f), _branch3(g, p, "cv3", i, f)], 1)
        for i, f in enumerate(feats)
    ]
    out = _decode_polar(g, levels, model.nc, model.strides, imgsz)
    a = sum((imgsz // s) ** 2 for s in model.strides)
    return [(out, [1, 4 + model.nc + 3 * NUM_RAYS, a])]


def _head_detect(g, p, feats, model, imgsz):
    levels = [
        g.concat([_branch3(g, p, "cv2", i, f), _branch3(g, p, "cv3", i, f)], 1)
        for i, f in enumerate(feats)
    ]
    out = _decode_detect(g, levels, model.nc, model.strides, imgsz, model.reg_max)
    a = sum((imgsz // s) ** 2 for s in model.strides)
    return [(out, [1, 4 + model.nc, a])]


def _head_pose(g, p, feats, model, imgsz):
    det = _head_detect(g, p["detect"], feats, model, imgsz)[0][0]
    _, _, st, hw = _anchors(model.strides, imgsz)
    K, D = model.kpt_shape
    kls = [_branch3(g, p, "cv4", i, f) for i, f in enumerate(feats)]
    kpt = _flatten_cat(g, kls, K * D, hw)
    dec = _decode_pose_kpts(g, kpt, model.strides, imgsz, model.kpt_shape)
    out = g.concat([det, dec], 1)
    a = len(st)
    return [(out, [1, 4 + model.nc + K * D, a])]


def _proto(g, p, x) -> str:
    y = _conv(g, p["cv1"], x)
    y = g.resize2x_nearest(y)
    y = _conv(g, p["cv2"], y)
    return _conv(g, p["cv3"], y)


def _head_segproto(g, p, feats, model, imgsz):
    det = _head_detect(g, p["detect"], feats, model, imgsz)[0][0]
    nm = model.head_spec.kwargs.get("nm", 32)
    _, _, st, hw = _anchors(model.strides, imgsz)
    mls = [_branch3(g, p, "cv4", i, f) for i, f in enumerate(feats)]
    mc = _flatten_cat(g, mls, nm, hw)
    out = g.concat([det, mc], 1)
    proto = _proto(g, p["proto"], feats[0])
    a = len(st)
    s0 = model.strides[0]
    return [
        (out, [1, 4 + model.nc + nm, a]),
        (proto, [1, nm, 2 * imgsz // s0, 2 * imgsz // s0]),
    ]


def _head_classify(g, p, x, model, imgsz):
    y = _conv(g, p["conv"], x)
    y = g.node("GlobalAveragePool", [y])
    y = g.node("Flatten", [y], {"axis": 1})
    lin = p["linear"]
    wname = g.init(_np(lin["kernel"]), "lin_w")  # (in, out)
    bname = g.init(_np(lin["bias"]), "lin_b")
    y = g.node("Gemm", [y, wname, bname], {"alpha": 1.0, "beta": 1.0})
    return [(g.sigmoid(y), [1, model.nc])]


def _head_rtdetr(g, p, feats, model, imgsz):
    from .rtdetr import emit_rtdetr_head

    return emit_rtdetr_head(g, p, feats, model, imgsz)


_HEAD_EMITTERS = {
    "Segment": _head_polar,
    "Detect": _head_detect,
    "Pose": _head_pose,
    "Segmentori": _head_segproto,
    "Classify": _head_classify,
    "RTDETRDecoder": _head_rtdetr,
}


# --- the exporter ---------------------------------------------------------------

def export_onnx(model, path, imgsz: int = 640, metadata: Dict[str, Any] = None):
    """Write ``model`` (a fused ``TaskModel``: ``nn/fuse.py:fuse_model``) to
    ``path`` as an opset-12 ONNX file with the decode in the graph, and
    ``metadata`` (string values) after the graph's own keys. Returns
    (the ``GraphBuilder``, whose ``run`` executes the graph; the list of
    (output name, shape)). Input: ``images`` (1, 3, imgsz, imgsz) RGB float
    in [0, 1], as the model's predict takes it."""
    if model.head_spec.name not in _HEAD_EMITTERS:
        raise NotImplementedError(
            f"ONNX export for head '{model.head_spec.name}' is not "
            "implemented (use the pt2 format)"
        )
    if not getattr(model, "fused", False):
        raise ValueError("export_onnx needs a fused model (nn/fuse.py:fuse_model)")
    params, _ = to_jax_variables(model.state_dict())
    g = GraphBuilder(f"ycr_{model.task}")
    g.add_input("images", [1, 3, imgsz, imgsz])

    specs, save, head_spec = model.specs, model.save, model.head_spec
    y: Dict[int, str] = {}
    chs: Dict[int, int] = {}
    out, c_out = "images", 3

    for spec in specs:
        if spec.kind in ("head", "classify_head"):
            break
        if isinstance(spec.f, int):
            inp = out if spec.f == -1 else y[spec.f]
            c_in = c_out if spec.f == -1 else chs[spec.f]
        else:
            inp = [out if j == -1 else y[j] for j in spec.f]
            c_in = [c_out if j == -1 else chs[j] for j in spec.f]
        kw = spec.kwargs
        reps = spec.repeats
        for r in range(reps):
            pname = f"layer{spec.i}" + (f"_{r}" if reps > 1 else "")
            x = inp if r == 0 else out
            if spec.kind == "upsample":
                out = g.resize2x_nearest(x)
            elif spec.kind == "concat":
                out = g.concat(x, 1)
            elif spec.name in ("Conv", "Conv2", "RepConv"):
                out = _conv(g, params[pname], x, s=kw.get("s", 1),
                            group=kw.get("g", 1), act=kw.get("act", True),
                            d=kw.get("d", 1))
            elif spec.name == "DWConv":
                out = _dwconv(g, params[pname], x, kw, c_in)
            elif spec.name in ("ConvTranspose", "nn.ConvTranspose2d"):
                if "bn" in params[pname]:
                    raise NotImplementedError(
                        "ONNX emitter covers bias-only ConvTranspose "
                        "(the v6 neck); BN-variant folding not implemented"
                    )
                ct = params[pname]["conv_transpose"]
                w = _np(ct["kernel"]).transpose(2, 3, 0, 1).copy()  # HWIO->IOHW
                pp = kw.get("p", 0)
                yt = g.node(
                    "ConvTranspose",
                    [x, g.init(w, "WT")]
                    + ([g.init(_np(ct["bias"]), "BT")] if "bias" in ct else []),
                    {"kernel_shape": [w.shape[2], w.shape[3]],
                     "strides": [kw.get("s", 2)] * 2, "pads": [pp] * 4},
                )
                act = kw.get("act", False if spec.name.startswith("nn.") else True)
                out = _act(g, yt, act)
            elif spec.name == "RepBlock":
                out = _conv(g, params[pname]["cv1"], x)
            elif spec.name == "Bottleneck":
                out = _bottleneck(g, params[pname], x, kw.get("shortcut", True),
                                  add_ok=c_in == kw["c2"])
            elif spec.name == "C2f":
                out = _c2f(g, params[pname], x, kw)
            elif spec.name == "C2":
                out = _c2(g, params[pname], x, kw)
            elif spec.name in ("C3", "C3x"):
                out = _c3(g, params[pname], x, kw)
            elif spec.name == "C1":
                out = _c1(g, params[pname], x, kw)
            elif spec.name == "NASCSP":
                out = _nascsp(g, params[pname], x, kw)
            elif spec.name == "HGStem":
                from .rtdetr import emit_hgstem

                out = emit_hgstem(g, params[pname], x, _conv)
            elif spec.name == "HGBlock":
                from .rtdetr import emit_hgblock

                out = emit_hgblock(g, params[pname], x, _conv, kw, c_in)
            elif spec.name == "RepC3":
                from .rtdetr import emit_repc3

                out = emit_repc3(g, params[pname], x, _conv, kw)
            elif spec.kind == "aifi":
                from .rtdetr import emit_aifi

                hw = imgsz // 32  # AIFI sits on the P5 map
                out = emit_aifi(g, params[pname], x, _conv, hw, hw, c_in)
            elif spec.name == "SPPF":
                out = _sppf(g, params[pname], x, kw)
            elif spec.name == "SPP":
                out = _spp(g, params[pname], x, kw)
            elif spec.name == "Focus":
                out = _focus(g, params[pname], x, kw)
            elif spec.name == "GhostConv":
                out = _ghostconv(g, params[pname], x, kw)
            else:
                raise NotImplementedError(
                    f"ONNX emitter for module '{spec.name}' "
                    f"(layer {spec.i}) is not implemented"
                )
        c_out = spec.c2
        if spec.i in save:
            y[spec.i] = out
            chs[spec.i] = c_out

    # head
    hp = params[f"layer{head_spec.i}"]
    if isinstance(head_spec.f, list):
        feats = [out if j == -1 else y[j] for j in head_spec.f]
    else:
        feats = out if head_spec.f == -1 else y[head_spec.f]
    outs = _HEAD_EMITTERS[head_spec.name](g, hp, feats, model, imgsz)
    for i, (name, shape) in enumerate(outs):
        g.add_output(name, shape)

    meta = {
        "task": model.task, "imgsz": imgsz, "nc": model.nc,
        "names": str(dict(model.names)),
        "stride": max(model.strides) if model.strides else 32,
        "decode": "in-graph",
    }
    meta.update(metadata or {})
    g.save(path, opset=12, metadata=meta)
    return g, outs
