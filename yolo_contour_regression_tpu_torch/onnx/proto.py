"""The ONNX protobuf writer (the port's copy of the JAX package's
``onnx/proto.py``, numpy and the standard library only).

ONNX files are proto3 messages (onnx/onnx.proto); the wire format is tagged
varint and length-delimited fields, so the file is written directly with no
``onnx`` package. Only the messages an inference graph needs are written:
ModelProto, GraphProto, NodeProto, TensorProto, AttributeProto and
ValueInfoProto. Field for field and byte for byte the JAX writer's output:
its ``producer_name`` ("yolo-contour-regression-tpu") included.

Wire format (proto3): each field is ``key = (field_number << 3) | type`` and
then the payload; wire type 0 is a varint, 2 a length-delimited payload
(strings, bytes, sub-messages, packed repeated scalars), 5 four bytes.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

# ONNX TensorProto.DataType values (onnx.proto)
FLOAT = 1
UINT8 = 2
INT8 = 3
INT32 = 6
INT64 = 7
STRING = 8
BOOL = 9
FLOAT16 = 10
DOUBLE = 11

NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.float64): DOUBLE,
}

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int64 per proto spec
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wtype: int) -> bytes:
    return _varint((field << 3) | wtype)


def _tag_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _tag_bytes(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _tag_string(field: int, s: str) -> bytes:
    return _tag_bytes(field, s.encode("utf-8"))


def _packed_varints(field: int, values: Sequence[int]) -> bytes:
    payload = b"".join(_varint(v) for v in values)
    return _tag_bytes(field, payload)


def tensor_proto(name: str, array: np.ndarray) -> bytes:
    """TensorProto: dims(1) data_type(2) name(8) raw_data(9)."""
    array = np.ascontiguousarray(array)
    onnx_dtype = NP_TO_ONNX[array.dtype]
    out = b""
    out += _packed_varints(1, [int(d) for d in array.shape])
    out += _tag_varint(2, onnx_dtype)
    out += _tag_string(8, name)
    out += _tag_bytes(9, array.tobytes())
    return out


def attribute_proto(name: str, value) -> bytes:
    """AttributeProto: name(1) f(2) i(3) s(4) t(5) floats(7) ints(8)
    strings(9) type(20)."""
    out = _tag_string(1, name)
    if isinstance(value, bool):
        out += _key(3, 0) + _varint(int(value)) + _tag_varint(20, ATTR_INT)
    elif isinstance(value, int):
        out += _key(3, 0) + _varint(value) + _tag_varint(20, ATTR_INT)
    elif isinstance(value, float):
        out += _key(2, 5) + struct.pack("<f", value) + _tag_varint(20, ATTR_FLOAT)
    elif isinstance(value, str):
        out += _tag_bytes(4, value.encode()) + _tag_varint(20, ATTR_STRING)
    elif isinstance(value, bytes):
        out += _tag_bytes(4, value) + _tag_varint(20, ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += _tag_bytes(5, tensor_proto(name + "_t", value)) + _tag_varint(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            for v in value:
                out += _key(8, 0) + _varint(int(v))
            out += _tag_varint(20, ATTR_INTS)
        elif all(isinstance(v, (float, np.floating)) for v in value):
            for v in value:
                out += _key(7, 5) + struct.pack("<f", float(v))
            out += _tag_varint(20, ATTR_FLOATS)
        elif all(isinstance(v, str) for v in value):
            for v in value:
                out += _tag_bytes(9, v.encode())
            out += _tag_varint(20, ATTR_STRINGS)
        else:
            raise TypeError(f"mixed attribute list for {name}: {value!r}")
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


def node_proto(
    op_type: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    name: str = "",
    attrs: Optional[Dict] = None,
) -> bytes:
    """NodeProto: input(1) output(2) name(3) op_type(4) attribute(5)."""
    out = b""
    for i in inputs:
        out += _tag_string(1, i)
    for o in outputs:
        out += _tag_string(2, o)
    if name:
        out += _tag_string(3, name)
    out += _tag_string(4, op_type)
    for k, v in (attrs or {}).items():
        out += _tag_bytes(5, attribute_proto(k, v))
    return out


def _tensor_type(elem_type: int, shape: Sequence[Union[int, str]]) -> bytes:
    """TypeProto{tensor_type(1){elem_type(1) shape(2){dim(1){dim_value(1)|
    dim_param(3)}}}}"""
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dim = _tag_string(3, d)
        else:
            dim = _key(1, 0) + _varint(int(d))
        dims += _tag_bytes(1, dim)
    shape_proto = dims
    tensor = _tag_varint(1, elem_type) + _tag_bytes(2, shape_proto)
    return _tag_bytes(1, tensor)


def value_info_proto(name: str, elem_type: int, shape: Sequence) -> bytes:
    """ValueInfoProto: name(1) type(2)."""
    return _tag_string(1, name) + _tag_bytes(2, _tensor_type(elem_type, shape))


def graph_proto(
    nodes: List[bytes],
    name: str,
    initializers: List[bytes],
    inputs: List[bytes],
    outputs: List[bytes],
) -> bytes:
    """GraphProto: node(1) name(2) initializer(5) input(11) output(12).
    (Joined once: adding each field to a growing ``bytes`` copies the graph
    again for every one.)"""
    return b"".join([*(_tag_bytes(1, n) for n in nodes), _tag_string(2, name),
                     *(_tag_bytes(5, t) for t in initializers),
                     *(_tag_bytes(11, i) for i in inputs), *(_tag_bytes(12, o) for o in outputs)])


def model_proto(
    graph: bytes,
    opset: int = 12,
    ir_version: int = 7,
    producer: str = "yolo-contour-regression-tpu",
    metadata: Optional[Dict[str, str]] = None,
) -> bytes:
    """ModelProto: ir_version(1) producer_name(2) opset_import(8) graph(7)
    metadata_props(14: StringStringEntryProto{key(1) value(2)})."""
    out = _tag_varint(1, ir_version)
    out += _tag_string(2, producer)
    out += _tag_bytes(7, graph)
    opset_entry = _tag_string(1, "") + _tag_varint(2, opset)
    out += _tag_bytes(8, opset_entry)
    for k, v in (metadata or {}).items():
        entry = _tag_string(1, k) + _tag_string(2, str(v))
        out += _tag_bytes(14, entry)
    return out
