"""Serving: the dynamic-batching ``InferenceServer`` (``server.py``) and its
standard-library HTTP front end (``http_api.py``), counterparts of the JAX
package's ``serve/``."""
from .server import InferenceServer, ServerStats

__all__ = ["InferenceServer", "ServerStats"]
