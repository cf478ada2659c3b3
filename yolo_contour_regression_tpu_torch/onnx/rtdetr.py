"""ONNX emitters of the RT-DETR graph (the port's copy of the JAX package's
``onnx/rtdetr.py``): the HGNetV2 backbone blocks, the AIFI encoder layer and
the deformable-attention decoder head, at batch 1 with static shapes.

They emit JAX's graph op for op, from the parameters in JAX's tree form
(``utils/checkpoint.py:to_jax_variables`` of the fused model):
  - attention, LayerNorm and GELU (tanh) as opset-12 primitives;
  - the grid anchors and sin-cos position tables as initializers;
  - the top-nq query selection as TopK and Gather;
  - the deformable sampling as four GatherElements and a lerp, zero outside
    the map as ``grid_sample`` with zero padding.

Output: (1, nq, 4 + nc), normalized cxcywh and sigmoid scores. Consumers:
onnxruntime, or this package's numpy executor (OpenCV-DNN has no TopK or
GatherElements).
"""
from __future__ import annotations

import math

import numpy as np

from .builder import GraphBuilder

HD = 256  # hidden dim
NH = 8  # attention heads
NDP = 4  # deformable sampling points
NDL = 6  # decoder layers


def _np(x):
    return np.asarray(x, np.float32)


def _dense(g, p, x):
    """flax nn.Dense: MatMul (in,out) + bias."""
    y = g.node("MatMul", [x, g.init(_np(p["kernel"]), "W")])
    if "bias" in p:
        y = g.add(y, g.init(_np(p["bias"]), "B"))
    return y


def _layernorm(g, p, x, eps: float = 1e-6):
    mu = g.node("ReduceMean", [x], {"axes": [-1], "keepdims": 1})
    xc = g.sub(x, mu)
    var = g.node("ReduceMean", [g.mul(xc, xc)], {"axes": [-1], "keepdims": 1})
    std = g.node("Sqrt", [g.add(var, g.c(np.float32(eps), hint="eps"))])
    y = g.div(xc, std)
    y = g.mul(y, g.init(_np(p["scale"]), "ln_s"))
    return g.add(y, g.init(_np(p["bias"]), "ln_b"))


def _gelu_tanh(g, x):
    """flax nn.gelu default (approximate=True): tanh approximation."""
    x3 = g.mul(g.mul(x, x), x)
    inner = g.mul(
        g.add(x, g.mul(x3, g.c(np.float32(0.044715), hint="g1"))),
        g.c(np.float32(math.sqrt(2.0 / math.pi)), hint="g2"),
    )
    t = g.node("Tanh", [inner])
    return g.mul(
        g.mul(x, g.c(np.float32(0.5), hint="half")),
        g.add(t, g.c(np.float32(1.0), hint="one")),
    )


def _mhsa(g, p, q_in, k_in, v_in, T: int, C: int = HD, nh: int = NH):
    """flax MultiHeadDotProductAttention at batch=1: params {query,key,value,
    out} with (C, nh, hd) kernels; q scaled by 1/sqrt(hd)."""
    hd = C // nh

    def proj(name, x):
        w = _np(p[name]["kernel"]).reshape(C, C)
        b = _np(p[name]["bias"]).reshape(C)
        y = g.add(g.node("MatMul", [x, g.init(w, f"{name}_w")]),
                  g.init(b, f"{name}_b"))
        y = g.reshape(y, [1, T, nh, hd])
        return g.transpose(y, [0, 2, 1, 3])  # (1, nh, T, hd)

    q = proj("query", q_in)
    k = proj("key", k_in)
    v = proj("value", v_in)
    q = g.mul(q, g.c(np.float32(1.0 / math.sqrt(hd)), hint="scale"))
    attn = g.node("MatMul", [q, g.transpose(k, [0, 1, 3, 2])])  # (1, nh, T, T)
    attn = g.softmax_lastaxis_4d(attn)
    out = g.node("MatMul", [attn, v])  # (1, nh, T, hd)
    out = g.reshape(g.transpose(out, [0, 2, 1, 3]), [1, T, C])
    wo = _np(p["out"]["kernel"]).reshape(C, C)
    bo = _np(p["out"]["bias"]).reshape(C)
    return g.add(g.node("MatMul", [out, g.init(wo, "out_w")]), g.init(bo, "out_b"))


def _mlp(g, p, x, num_layers: int = 3):
    """transformer.MLP: relu between layers, none after the last."""
    for i in range(num_layers):
        x = _dense(g, p[f"layers{i}"], x)
        if i < num_layers - 1:
            x = g.relu(x)
    return x


def _inverse_sigmoid(g, x, eps: float = 1e-5):
    """clip(x,0,1) then log(max(x,eps)/max(1-x,eps)) (transformer.py:23)."""
    one = g.c(np.float32(1.0), hint="one")
    x = g.relu(x)                      # max(x, 0)
    x = g.sub(one, g.relu(g.sub(one, x)))  # min(x, 1)
    num = g.clip_min(x, eps)
    den = g.clip_min(g.sub(one, x), eps)
    return g.sub(g.node("Log", [num]), g.node("Log", [den]))


# --- backbone blocks ----------------------------------------------------------

def _sincos_pos(w: int, h: int, dim: int, temperature: float = 10000.0):
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float64) / pos_dim))
    gw, gh = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    pos = np.concatenate(
        [np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1
    ).astype(np.float32)  # (w*h, dim), w-major
    # transpose grid to h-major to match AIFI's row-major tokens
    return pos.reshape(w, h, dim).transpose(1, 0, 2).reshape(1, h * w, dim)


def emit_aifi(g, p, x, conv_fn, h: int, w: int, c: int):
    """AIFI (transformer.py:104): tokens + sincos pos -> post-norm encoder
    layer -> map. x is NCHW (1, c, h, w)."""
    tokens = g.transpose(g.reshape(x, [1, c, h * w]), [0, 2, 1])  # (1, hw, c)
    pos = g.init(_sincos_pos(w, h, c), "aifi_pos")
    qk = g.add(tokens, pos)
    attn = _mhsa(g, p["ma"], qk, qk, tokens, T=h * w, C=c)
    src = _layernorm(g, p["norm1"], g.add(tokens, attn))
    ff = _dense(g, p["fc1"], src)
    ff = _dense(g, p["fc2"], _gelu_tanh(g, ff))
    out = _layernorm(g, p["norm2"], g.add(src, ff))
    return g.reshape(g.transpose(out, [0, 2, 1]), [1, c, h, w])


def emit_hgstem(g, p, x, conv_fn):
    """HGStem (block.py:294): stem1 s2 -> [maxpool ‖ stem2a+stem2b with
    bottom/right pad] -> concat -> stem3 s2 -> stem4 1x1."""
    x = conv_fn(g, p["stem1"], x, s=2)
    # asymmetric (0,1) bottom/right pads -> ONNX pads [t,l,b,r]
    x2 = conv_fn(g, p["stem2a"], x, pads=(0, 0, 1, 1))
    x2 = conv_fn(g, p["stem2b"], x2, pads=(0, 0, 1, 1))
    x1 = g.maxpool(x, 2, strides=(1, 1), pads=(0, 0, 1, 1))
    x = g.concat([x1, x2], 1)
    x = conv_fn(g, p["stem3"], x, s=2)
    return conv_fn(g, p["stem4"], x)


def emit_hgblock(g, p, x, conv_fn, kw, c1: int):
    """HGBlock (block.py:316): n chained (Light)Convs, concat-all, sc/ec."""
    n = kw.get("n", 6)
    lightconv = kw.get("lightconv", False)
    shortcut = kw.get("shortcut", False)
    ys = [x]
    for i in range(n):
        m = p[f"m{i}"]
        if lightconv:  # conv1 1x1 (no act) + depthwise k (act)
            c2 = int(_np(m["conv1"]["conv"]["kernel"]).shape[-1])
            y = conv_fn(g, m["conv1"], ys[-1], act=False)
            y = conv_fn(g, m["conv2"], y, group=c2)
        else:
            y = conv_fn(g, m, ys[-1])
        ys.append(y)
    y = conv_fn(g, p["sc"], g.concat(ys, 1))
    y = conv_fn(g, p["ec"], y)
    if shortcut and c1 == kw["c2"]:
        y = g.add(x, y)
    return y


def emit_repc3(g, p, x, conv_fn, kw):
    """RepC3 (block.py:144): cv1 -> n fused RepConvs; + cv2; optional cv3."""
    y1 = conv_fn(g, p["cv1"], x)
    for i in range(kw.get("n", 3)):
        y1 = conv_fn(g, p[f"m{i}"], y1)
    y2 = conv_fn(g, p["cv2"], x)
    y = g.add(y1, y2)
    if "cv3" in p:
        y = conv_fn(g, p["cv3"], y, act=False)
    return y


# --- deformable decoder head --------------------------------------------------

def _min_const(g, x, cval: float):
    """min(x, c) = c - Relu(c - x)."""
    c = g.c(np.float32(cval), hint="mc")
    return g.sub(c, g.relu(g.sub(c, x)))


def _deform_attn(g, p, query, refer, value_levels, shapes, nq: int):
    """MSDeformAttn (transformer.py:202) at batch=1.

    query (1,nq,256); refer (1,nq,4) normalized cxcywh; value_levels: list of
    already-projected per-level value tensors (NH, h*w, hd)."""
    hd = HD // NH
    L = len(shapes)
    off = _dense(g, p["sampling_offsets"], query)  # (1, nq, NH*L*NDP*2)
    off = g.reshape(off, [1, nq, NH, L, NDP, 2])
    attw = g.reshape(_dense(g, p["attention_weights"], query), [1, nq, NH, L * NDP])
    attw = g.softmax_lastaxis_4d(attw)
    attw = g.reshape(attw, [1, nq, NH, L, NDP])

    xy = g.reshape(g.slice(refer, [0], [2], [2]), [1, nq, 1, 1, 1, 2])
    wh = g.reshape(g.slice(refer, [2], [4], [2]), [1, nq, 1, 1, 1, 2])
    # loc = xy + off / NDP * wh * 0.5  (4-coord branch, transformer.py:256)
    loc = g.add(xy, g.mul(off, g.mul(wh, g.c(np.float32(0.5 / NDP), hint="ls"))))

    level_outs = []
    for li, (h, w) in enumerate(shapes):
        # (1, nq, NH, 1, NDP, 2) -> x,y pixel coords (NH, nq*NDP)
        gl = g.reshape(
            g.slice(loc, [li], [li + 1], [3]), [1, nq, NH, NDP, 2]
        )
        gl = g.reshape(g.transpose(gl, [0, 2, 1, 3, 4]), [NH, nq * NDP, 2])
        # x = loc_x * W - 0.5 (== grid_sample align_corners=False)
        px = g.sub(
            g.mul(g.slice(gl, [0], [1], [2]), g.c(np.float32(w), hint="W")),
            g.c(np.float32(0.5), hint="hf"),
        )  # (NH, nq*NDP, 1)
        py = g.sub(
            g.mul(g.slice(gl, [1], [2], [2]), g.c(np.float32(h), hint="H")),
            g.c(np.float32(0.5), hint="hf"),
        )
        x0 = g.node("Floor", [px])
        y0 = g.node("Floor", [py])
        wx = g.sub(px, x0)
        wy = g.sub(py, y0)
        one = g.c(np.float32(1.0), hint="one")

        def corner(xi, yi):
            # in-bounds mask (floats): (xi>=0)*(xi<W)*(yi>=0)*(yi<H)
            def ge0(t):
                return g.node(
                    "Cast",
                    [g.node("Not", [g.node("Less", [t, g.c(np.float32(0.0), hint="z")])])],
                    {"to": 1},
                )

            def lt(t, c):
                return g.node(
                    "Cast", [g.node("Less", [t, g.c(np.float32(c), hint="c")])],
                    {"to": 1},
                )

            inb = g.mul(g.mul(ge0(xi), lt(xi, w)), g.mul(ge0(yi), lt(yi, h)))
            xc = _min_const(g, g.relu(xi), w - 1)
            yc = _min_const(g, g.relu(yi), h - 1)
            idx = g.add(g.mul(yc, g.c(np.float32(w), hint="W")), xc)
            idx = g.node("Cast", [idx], {"to": 7})  # (NH, nq*NDP, 1) int64
            idx = g.node(
                "Expand",
                [idx, g.c(np.asarray([NH, nq * NDP, hd], np.int64), np.int64, "eshape")],
            )
            v = g.node(
                "GatherElements", [value_levels[li], idx], {"axis": 1}
            )  # (NH, nq*NDP, hd)
            return g.mul(v, inb)

        v00 = corner(x0, y0)
        v01 = corner(g.add(x0, one), y0)
        v10 = corner(x0, g.add(y0, one))
        v11 = corner(g.add(x0, one), g.add(y0, one))
        iwx = g.sub(one, wx)
        iwy = g.sub(one, wy)
        samp = g.add(
            g.add(g.mul(v00, g.mul(iwx, iwy)), g.mul(v01, g.mul(wx, iwy))),
            g.add(g.mul(v10, g.mul(iwx, wy)), g.mul(v11, g.mul(wx, wy))),
        )
        level_outs.append(g.reshape(samp, [NH, nq, 1, NDP, hd]))

    stacked = g.concat(level_outs, 2)  # (NH, nq, L, NDP, hd)
    wts = g.reshape(g.transpose(attw, [0, 2, 1, 3, 4]), [NH, nq, L, NDP, 1])
    out = g.node(
        "ReduceSum", [g.mul(stacked, wts)], {"axes": [2, 3], "keepdims": 0}
    )  # (NH, nq, hd)
    out = g.reshape(g.transpose(out, [1, 0, 2]), [1, nq, HD])
    return _dense(g, p["output_proj"], out)


def emit_rtdetr_head(g, p, feats, model, imgsz: int):
    """RTDETRDecoder eval path (head.py:234): fused input_proj, anchors,
    top-nq selection, 6 deformable decoder layers with box refinement."""
    strides = [8, 16, 32]
    shapes = [(imgsz // s, imgsz // s) for s in strides]
    nc = model.nc
    V = sum(h * w for h, w in shapes)
    nq = min(300, V)

    # per-level projection (conv+BN folded by nn/fuse.py) -> flat tokens
    tokens = []
    for i, f in enumerate(feats):
        h, w = shapes[i]
        k = _np(p[f"input_proj{i}"]["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()
        y = g.conv(f, k, _np(p[f"input_proj{i}"]["conv"]["bias"]))
        tokens.append(g.transpose(g.reshape(y, [1, HD, h * w]), [0, 2, 1]))
    feats_flat = g.concat(tokens, 1)  # (1, V, HD)

    # anchors (head.py:279) as initializers, inf where invalid
    anchors = []
    for i, (h, w) in enumerate(shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float64),
                             np.arange(w, dtype=np.float64), indexing="ij")
        xy = np.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1).reshape(-1, 2)
        wh = np.full_like(xy, 0.05 * (2.0 ** i))
        anchors.append(np.concatenate([xy, wh], -1))
    anchors = np.concatenate(anchors, 0)[None].astype(np.float32)  # (1, V, 4)
    valid = ((anchors > 1e-2) & (anchors < 1 - 1e-2)).all(-1, keepdims=True)
    anchors_logit = np.where(
        valid, np.log(anchors / np.clip(1 - anchors, 1e-12, None)), np.inf
    ).astype(np.float32)
    valid_f = valid.astype(np.float32)

    enc_in = g.mul(feats_flat, g.init(valid_f, "valid"))
    enc_feats = _layernorm(g, p["enc_output_ln"], _dense(g, p["enc_output"], enc_in))
    enc_scores = _dense(g, p["enc_score_head"], enc_feats)  # (1, V, nc)

    cls_max = g.node("ReduceMax", [enc_scores], {"axes": [2], "keepdims": 0})  # (1, V)
    _, idx = g.node(
        "TopK", [cls_max, g.c(np.asarray([nq], np.int64), np.int64, "K")],
        {"axis": 1, "largest": 1, "sorted": 1}, n_out=2,
    )
    idx_flat = g.reshape(idx, [nq])
    top_feats = g.node("Gather", [enc_feats, idx_flat], {"axis": 1})  # (1, nq, HD)
    top_anchor = g.node(
        "Gather", [g.init(anchors_logit, "anchors"), idx_flat], {"axis": 1}
    )
    refer_logit = g.add(_mlp(g, p["enc_bbox_head"], top_feats, 3), top_anchor)
    refer = g.sigmoid(refer_logit)

    # pre-project value levels once per decoder layer? value_proj is
    # per-layer (inside each MSDeformAttn) -> compute inside the loop.
    embed = top_feats
    hd = HD // NH
    for i in range(NDL):
        lp = p[f"dec_layer{i}"]
        qpos = _mlp(g, p["query_pos_head"], refer, 2)
        qk = g.add(embed, qpos)
        tgt = _mhsa(g, lp["self_attn"], qk, qk, embed, T=nq)
        embed = _layernorm(g, lp["norm1"], g.add(embed, tgt))

        vproj = _dense(g, lp["cross_attn"]["value_proj"], feats_flat)  # (1, V, HD)
        value_levels = []
        start = 0
        for (h, w) in shapes:
            vl = g.slice(vproj, [start], [start + h * w], [1])  # (1, hw, HD)
            vl = g.reshape(vl, [1, h * w, NH, hd])
            vl = g.reshape(g.transpose(vl, [0, 2, 1, 3]), [NH, h * w, hd])
            value_levels.append(vl)
            start += h * w
        tgt = _deform_attn(
            g, lp["cross_attn"], g.add(embed, qpos), refer, value_levels, shapes, nq
        )
        embed = _layernorm(g, lp["norm2"], g.add(embed, tgt))
        ff = _dense(g, lp["linear2"], g.relu(_dense(g, lp["linear1"], embed)))
        embed = _layernorm(g, lp["norm3"], g.add(embed, ff))

        delta = _mlp(g, p[f"dec_bbox_head{i}"], embed, 3)
        refer = g.sigmoid(g.add(delta, _inverse_sigmoid(g, refer)))

    scores = _dense(g, p[f"dec_score_head{NDL - 1}"], embed)
    out = g.concat([refer, g.sigmoid(scores)], 2)  # (1, nq, 4+nc)
    return [(out, [1, nq, 4 + nc])]
