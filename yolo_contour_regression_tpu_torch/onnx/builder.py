"""ONNX graph builder and numpy executor (the port's copy of the JAX
package's ``onnx/builder.py``).

``GraphBuilder`` keeps nodes and initializers as plain Python structures;
``serialize`` writes the ModelProto bytes through ``proto.py``; ``run``
executes the graph with numpy versions of each op used, at ONNX opset-12
semantics. The executor is how an exported file is checked without the
``onnx`` package or a runtime: its outputs are held to the model's predict
(``tests/test_torch_port_onnx.py``). Initializer and node names come from
one counter (``fresh``), so emitting in the same order gives the same bytes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import proto


class Node:
    __slots__ = ("op", "inputs", "outputs", "attrs", "name")

    def __init__(self, op, inputs, outputs, attrs, name):
        self.op, self.inputs, self.outputs = op, list(inputs), list(outputs)
        self.attrs, self.name = dict(attrs or {}), name


class GraphBuilder:
    def __init__(self, name: str = "graph"):
        self.name = name
        self.nodes: List[Node] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.inputs: List = []  # (name, elem_type, shape)
        self.outputs: List = []
        self._n = 0

    # -- construction -------------------------------------------------------
    def fresh(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init(self, array: np.ndarray, hint: str = "const") -> str:
        name = self.fresh(hint)
        self.initializers[name] = np.ascontiguousarray(array)
        return name

    def add_input(self, name: str, shape: Sequence, elem_type: int = proto.FLOAT):
        self.inputs.append((name, elem_type, list(shape)))

    def add_output(self, name: str, shape: Sequence, elem_type: int = proto.FLOAT):
        self.outputs.append((name, elem_type, list(shape)))

    def node(
        self,
        op: str,
        inputs: Sequence[str],
        attrs: Optional[Dict] = None,
        n_out: int = 1,
        hint: Optional[str] = None,
    ):
        outs = [self.fresh(hint or op.lower()) for _ in range(n_out)]
        self.nodes.append(Node(op, inputs, outs, attrs, f"n{len(self.nodes)}_{op}"))
        return outs[0] if n_out == 1 else outs

    # common-op sugar
    def c(self, value, dtype=np.float32, hint="c") -> str:
        return self.init(np.asarray(value, dtype), hint)

    def conv(self, x, w, b=None, strides=(1, 1), pads=(0, 0, 0, 0), group=1, dilations=(1, 1)):
        wname = self.init(w, "W")
        ins = [x, wname] + ([self.init(b, "B")] if b is not None else [])
        return self.node(
            "Conv", ins,
            {"kernel_shape": [int(w.shape[2]), int(w.shape[3])],
             "strides": list(strides), "pads": list(pads), "group": group,
             "dilations": list(dilations)},
        )

    def binop(self, op, a, b):
        return self.node(op, [a, b])

    def add(self, a, b):
        return self.binop("Add", a, b)

    def mul(self, a, b):
        return self.binop("Mul", a, b)

    def sub(self, a, b):
        return self.binop("Sub", a, b)

    def div(self, a, b):
        return self.binop("Div", a, b)

    def relu(self, x):
        return self.node("Relu", [x])

    def sigmoid(self, x):
        return self.node("Sigmoid", [x])

    def concat(self, xs, axis):
        return self.node("Concat", list(xs), {"axis": axis})

    def reshape(self, x, shape):
        return self.node("Reshape", [x, self.c(shape, np.int64, "shape")])

    def transpose(self, x, perm):
        return self.node("Transpose", [x], {"perm": list(perm)})

    def slice(self, x, starts, ends, axes, steps=None):
        ins = [x, self.c(starts, np.int64, "st"), self.c(ends, np.int64, "en"),
               self.c(axes, np.int64, "ax")]
        if steps is not None:
            ins.append(self.c(steps, np.int64, "sp"))
        return self.node("Slice", ins)

    def maxpool(self, x, k, strides=(1, 1), pads=(0, 0, 0, 0)):
        return self.node(
            "MaxPool", [x],
            {"kernel_shape": [k, k], "strides": list(strides), "pads": list(pads)},
        )

    def resize2x_nearest(self, x):
        roi = self.c(np.zeros((0,), np.float32), hint="roi")
        scales = self.c(np.array([1.0, 1.0, 2.0, 2.0], np.float32), hint="scales")
        return self.node(
            "Resize", [x, roi, scales],
            {"mode": "nearest", "coordinate_transformation_mode": "asymmetric",
             "nearest_mode": "floor"},
        )

    def softmax_lastaxis_4d(self, x):
        """Explicit numerically-stable softmax over the LAST axis, built from
        primitive ops (opset-12 Softmax flattens to 2D at `axis`, which is
        wrong for interior axes and poorly supported by lightweight runtimes)."""
        m = self.node("ReduceMax", [x], {"axes": [-1], "keepdims": 1})
        e = self.node("Exp", [self.sub(x, m)])
        s = self.node("ReduceSum", [e], {"axes": [-1], "keepdims": 1})
        return self.div(e, s)

    def clip_min(self, x, lo: float):
        """max(x, lo) as Relu(x - lo) + lo. Equivalent to opset-11 Clip with
        only `min`, but works in consumers (OpenCV <= 4.6 C++) that only
        accept the pre-opset-11 attribute form of Clip."""
        lo_c = self.c(np.float32(lo), hint="lo")
        return self.add(self.relu(self.sub(x, lo_c)), lo_c)

    # -- serialization -------------------------------------------------------
    def serialize(self, opset: int = 12, metadata: Optional[Dict] = None) -> bytes:
        nodes = [
            proto.node_proto(n.op, n.inputs, n.outputs, n.name, n.attrs)
            for n in self.nodes
        ]
        inits = [proto.tensor_proto(k, v) for k, v in self.initializers.items()]
        inputs = [proto.value_info_proto(n, t, s) for n, t, s in self.inputs]
        outputs = [proto.value_info_proto(n, t, s) for n, t, s in self.outputs]
        g = proto.graph_proto(nodes, self.name, inits, inputs, outputs)
        return proto.model_proto(g, opset=opset, metadata=metadata)

    def save(self, path, opset: int = 12, metadata: Optional[Dict] = None):
        data = self.serialize(opset=opset, metadata=metadata)
        with open(path, "wb") as fh:
            fh.write(data)
        return path

    # -- numpy reference executor -------------------------------------------
    def run(self, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        env: Dict[str, np.ndarray] = dict(self.initializers)
        env.update({k: np.asarray(v) for k, v in feeds.items()})
        for n in self.nodes:
            _OPS[n.op](n, env)
        return {name: env[name] for name, _, _ in self.outputs}


# --- numpy implementations (ONNX opset-12 semantics) -------------------------

def _conv(n, env):
    """Pure-numpy im2col convolution (NCHW / OIHW), with groups+dilation."""
    x = env[n.inputs[0]]
    w = env[n.inputs[1]]
    b = env[n.inputs[2]] if len(n.inputs) > 2 else None
    sh, sw = n.attrs.get("strides", [1, 1])
    p = n.attrs.get("pads", [0, 0, 0, 0])
    dh, dw = n.attrs.get("dilations", [1, 1])
    g = n.attrs.get("group", 1)
    O, Ig, kh, kw = w.shape
    xp = np.pad(x, ((0, 0), (0, 0), (p[0], p[2]), (p[1], p[3])))
    B, C, H, W = xp.shape
    oh = (H - (dh * (kh - 1) + 1)) // sh + 1
    ow = (W - (dw * (kw - 1) + 1)) // sw + 1
    # im2col: (B, C, kh, kw, oh, ow)
    cols = np.empty((B, C, kh, kw, oh, ow), x.dtype)
    for i in range(kh):
        for j in range(kw):
            cols[:, :, i, j] = xp[
                :, :, i * dh : i * dh + oh * sh : sh, j * dw : j * dw + ow * sw : sw
            ]
    Og = O // g
    y = np.empty((B, O, oh, ow), np.float32)
    for gi in range(g):
        cg = cols[:, gi * Ig : (gi + 1) * Ig]  # (B, Ig, kh, kw, oh, ow)
        wg = w[gi * Og : (gi + 1) * Og].reshape(Og, -1)  # (Og, Ig*kh*kw)
        cgm = cg.reshape(B, Ig * kh * kw, oh * ow)
        y[:, gi * Og : (gi + 1) * Og] = (wg @ cgm).reshape(B, Og, oh, ow)
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    env[n.outputs[0]] = y.astype(np.float32)


def _maxpool(n, env):
    x = env[n.inputs[0]]
    kh, kw = n.attrs["kernel_shape"]
    sh, sw = n.attrs.get("strides", [1, 1])
    p = n.attrs.get("pads", [0, 0, 0, 0])
    xp = np.pad(
        x, ((0, 0), (0, 0), (p[0], p[2]), (p[1], p[3])),
        constant_values=-np.inf,
    )
    B, C, H, W = xp.shape
    oh = (H - kh) // sh + 1
    ow = (W - kw) // sw + 1
    out = np.full((B, C, oh, ow), -np.inf, x.dtype)
    for i in range(kh):
        for j in range(kw):
            out = np.maximum(out, xp[:, :, i : i + oh * sh : sh, j : j + ow * sw : sw])
    env[n.outputs[0]] = out


def _resize(n, env):
    x = env[n.inputs[0]]
    scales = env[n.inputs[2]]
    assert n.attrs.get("mode") == "nearest"
    rh, rw = int(scales[2]), int(scales[3])
    env[n.outputs[0]] = x.repeat(rh, axis=2).repeat(rw, axis=3)


def _slice(n, env):
    x = env[n.inputs[0]]
    starts = env[n.inputs[1]].tolist()
    ends = env[n.inputs[2]].tolist()
    axes = env[n.inputs[3]].tolist() if len(n.inputs) > 3 else list(range(len(starts)))
    steps = env[n.inputs[4]].tolist() if len(n.inputs) > 4 else [1] * len(starts)
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        sl[ax] = slice(st, en, sp)
    env[n.outputs[0]] = x[tuple(sl)]


def _reduce(fn):
    def impl(n, env):
        x = env[n.inputs[0]]
        axes = tuple(n.attrs["axes"])
        keep = bool(n.attrs.get("keepdims", 1))
        env[n.outputs[0]] = fn(x, axis=axes, keepdims=keep)

    return impl


def _gemm(n, env):
    a, b = env[n.inputs[0]], env[n.inputs[1]]
    if n.attrs.get("transB"):
        b = b.T
    y = a @ b
    if len(n.inputs) > 2:
        y = y + env[n.inputs[2]]
    env[n.outputs[0]] = y


def _clip(n, env):
    x = env[n.inputs[0]]
    lo = env[n.inputs[1]] if len(n.inputs) > 1 and n.inputs[1] else None
    hi = env[n.inputs[2]] if len(n.inputs) > 2 and n.inputs[2] else None
    env[n.outputs[0]] = np.clip(x, lo, hi)


def _conv_transpose(n, env):
    """ONNX ConvTranspose, weight (C_in, C_out/g, kH, kW), zero pads."""
    x, w = env[n.inputs[0]], env[n.inputs[1]]
    b = env[n.inputs[2]] if len(n.inputs) > 2 else None
    sh, sw = n.attrs.get("strides", [1, 1])
    p = n.attrs.get("pads", [0, 0, 0, 0])
    B, C, H, W = x.shape
    _, O, kh, kw = w.shape
    oh = (H - 1) * sh + kh - p[0] - p[2]
    ow = (W - 1) * sw + kw - p[1] - p[3]
    full = np.zeros((B, O, (H - 1) * sh + kh, (W - 1) * sw + kw), np.float32)
    for di in range(kh):
        for dj in range(kw):
            # (B, O, H, W) contribution of kernel tap (di, dj)
            contrib = np.einsum("bchw,co->bohw", x, w[:, :, di, dj])
            full[:, :, di : di + H * sh : sh, dj : dj + W * sw : sw] += contrib
    y = full[:, :, p[0] : p[0] + oh, p[1] : p[1] + ow]
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    env[n.outputs[0]] = y


def _topk(n, env):
    x = env[n.inputs[0]]
    k = int(env[n.inputs[1]].reshape(-1)[0])
    axis = n.attrs.get("axis", -1)
    # stable descending sort -> ties broken by lower index, matching lax.top_k
    order = np.argsort(-np.moveaxis(x, axis, -1), axis=-1, kind="stable")[..., :k]
    vals = np.take_along_axis(np.moveaxis(x, axis, -1), order, axis=-1)
    env[n.outputs[0]] = np.moveaxis(vals, -1, axis)
    env[n.outputs[1]] = np.moveaxis(order.astype(np.int64), -1, axis)


def _gather(n, env):
    x, idx = env[n.inputs[0]], env[n.inputs[1]].astype(np.int64)
    env[n.outputs[0]] = np.take(x, idx, axis=n.attrs.get("axis", 0))


def _gather_elements(n, env):
    x, idx = env[n.inputs[0]], env[n.inputs[1]].astype(np.int64)
    env[n.outputs[0]] = np.take_along_axis(x, idx, axis=n.attrs.get("axis", 0))


# the error function in double precision (the standard library's), a value at a time
_ERF = np.vectorize(math.erf, otypes=[np.float64])


def _erf(n, env):
    env[n.outputs[0]] = _ERF(env[n.inputs[0]]).astype(np.float32)


_OPS = {
    "Conv": _conv,
    "ConvTranspose": _conv_transpose,
    "TopK": _topk,
    "Gather": _gather,
    "GatherElements": _gather_elements,
    "Expand": lambda n, e: e.__setitem__(
        n.outputs[0],
        np.broadcast_to(
            e[n.inputs[0]],
            np.broadcast_shapes(tuple(e[n.inputs[0]].shape),
                                tuple(e[n.inputs[1]].astype(int).tolist())),
        ).copy(),
    ),
    "Floor": lambda n, e: e.__setitem__(n.outputs[0], np.floor(e[n.inputs[0]])),
    "Sqrt": lambda n, e: e.__setitem__(n.outputs[0], np.sqrt(e[n.inputs[0]])),
    "Log": lambda n, e: e.__setitem__(n.outputs[0], np.log(e[n.inputs[0]])),
    "Tanh": lambda n, e: e.__setitem__(n.outputs[0], np.tanh(e[n.inputs[0]])),
    "Erf": _erf,
    "Less": lambda n, e: e.__setitem__(n.outputs[0], e[n.inputs[0]] < e[n.inputs[1]]),
    "Not": lambda n, e: e.__setitem__(n.outputs[0], ~e[n.inputs[0]]),
    "And": lambda n, e: e.__setitem__(n.outputs[0], e[n.inputs[0]] & e[n.inputs[1]]),
    "MaxPool": _maxpool,
    "Resize": _resize,
    "Slice": _slice,
    "Relu": lambda n, e: e.__setitem__(n.outputs[0], np.maximum(e[n.inputs[0]], 0)),
    "Sigmoid": lambda n, e: e.__setitem__(
        n.outputs[0], 1.0 / (1.0 + np.exp(-e[n.inputs[0]]))
    ),
    "Exp": lambda n, e: e.__setitem__(n.outputs[0], np.exp(e[n.inputs[0]])),
    "Add": lambda n, e: e.__setitem__(n.outputs[0], e[n.inputs[0]] + e[n.inputs[1]]),
    "Sub": lambda n, e: e.__setitem__(n.outputs[0], e[n.inputs[0]] - e[n.inputs[1]]),
    "Mul": lambda n, e: e.__setitem__(n.outputs[0], e[n.inputs[0]] * e[n.inputs[1]]),
    "Div": lambda n, e: e.__setitem__(n.outputs[0], e[n.inputs[0]] / e[n.inputs[1]]),
    "Concat": lambda n, e: e.__setitem__(
        n.outputs[0], np.concatenate([e[i] for i in n.inputs], axis=n.attrs["axis"])
    ),
    "Reshape": lambda n, e: e.__setitem__(
        n.outputs[0],
        e[n.inputs[0]].reshape([
            e[n.inputs[0]].shape[i] if d == 0 else d
            for i, d in enumerate(e[n.inputs[1]].astype(int).tolist())
        ]),
    ),
    "Transpose": lambda n, e: e.__setitem__(
        n.outputs[0], e[n.inputs[0]].transpose(n.attrs["perm"])
    ),
    "ReduceMax": _reduce(np.max),
    "ReduceMin": _reduce(np.min),
    "ReduceSum": _reduce(np.sum),
    "ReduceMean": _reduce(np.mean),
    "Gemm": _gemm,
    "MatMul": lambda n, e: e.__setitem__(n.outputs[0], e[n.inputs[0]] @ e[n.inputs[1]]),
    "Clip": _clip,
    "GlobalAveragePool": lambda n, e: e.__setitem__(
        n.outputs[0], e[n.inputs[0]].mean(axis=(2, 3), keepdims=True)
    ),
    "Flatten": lambda n, e: e.__setitem__(
        n.outputs[0], e[n.inputs[0]].reshape(e[n.inputs[0]].shape[0], -1)
    ),
    "Greater": lambda n, e: e.__setitem__(
        n.outputs[0], e[n.inputs[0]] > e[n.inputs[1]]
    ),
    "Cast": lambda n, e: e.__setitem__(
        n.outputs[0],
        e[n.inputs[0]].astype({1: np.float32, 6: np.int32, 7: np.int64}[n.attrs["to"]]),
    ),
    "Ceil": lambda n, e: e.__setitem__(n.outputs[0], np.ceil(e[n.inputs[0]])),
}
