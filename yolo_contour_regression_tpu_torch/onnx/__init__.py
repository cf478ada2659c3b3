"""ONNX export without the ``onnx`` package: a protobuf writer
(``proto.py``), a graph builder with a numpy executor (``builder.py``) and
the per-module emitters (``export.py``, ``rtdetr.py``), copies of the JAX
package's ``onnx/`` that read the port's fused weights."""
from .builder import GraphBuilder  # noqa: F401
from .export import export_onnx  # noqa: F401
