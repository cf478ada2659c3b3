"""The YOLO-NAS facade (counterpart of the JAX package's
``models/nas/model.py``)."""
from __future__ import annotations

from pathlib import Path

from ...engine.model import YOLO


class NAS(YOLO):
    """``YOLO`` bound to the detect task on the YOLO-NAS graph
    (``nn/tasks.py:YOLO_NAS``: RepConv stem and stages, NASCSP, SPP, a PAN
    neck, the DFL Detect head): ``yolo_nas_{s,m,l}``, the base
    ``yolo_nas.yaml``, or a checkpoint of one. A ``.pt`` (a super-gradients
    pickle) raises, as JAX's does."""

    def __init__(self, model: str = "yolo_nas_s", device="cuda"):
        p = Path(str(model))
        if p.suffix in ("", ".yaml", ".yml") and p.stem.startswith("yolo_nas"):
            model = str(p.with_suffix(".yaml"))
        elif p.suffix == ".pt":
            raise NotImplementedError(
                "super-gradients .pt checkpoints are torch pickles; convert them offline with "
                "the JAX package's examples/scripts/convert_torch_ckpt.py and load the .ckpt")
        super().__init__(model, device=device, task="detect")
