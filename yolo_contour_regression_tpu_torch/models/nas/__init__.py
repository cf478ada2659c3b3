"""YOLO-NAS (counterpart of the JAX package's ``models/nas/``)."""
from .model import NAS

__all__ = ["NAS"]
