"""yolo_contour_regression_tpu_torch — the PyTorch/CUDA port of the polar
contour-regression framework.

The JAX package ``yolo_contour_regression_tpu`` beside it is the reference;
this package keeps its module layout and names so each counterpart is easy to
find, and imports neither JAX nor anything of that package. It needs only
``torch``, ``numpy`` and the standard library. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``::

    from yolo_contour_regression_tpu_torch import YOLO
    results = YOLO("runs/floor_seg160/best.ckpt").predict(images)
    results[0].boxes.xyxy, results[0].contours.points, results[0].masks.data
    masks, iou = SAM("sam_b").predict(img, points=[[320, 240]], labels=[1])
    FastSAMPrompt(img, FastSAM("runs/floor_seg160/best.ckpt").predict(img)).box_prompt(box)
    NAS("yolo_nas_s").train(data=...)

Hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc`` at
first use (``utils/cuda_build.py``); every kernel has a plain PyTorch version
beside it, which is taken for CPU tensors only.
"""

__version__ = "0.1.0"

from .engine.model import YOLO  # noqa: E402
from .models.fastsam import FastSAM, FastSAMPrompt  # noqa: E402
from .models.nas import NAS  # noqa: E402
from .models.sam import SAM  # noqa: E402

__all__ = ["YOLO", "SAM", "FastSAM", "FastSAMPrompt", "NAS"]
