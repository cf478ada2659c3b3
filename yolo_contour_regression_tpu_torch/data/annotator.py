"""Automatic labelling (counterpart of the JAX package's
``data/annotator.py``): a detector's predictions over a folder written as
YOLO polygon label files. Two modes:

- default: each detection's polar contour (its valid points) is the
  polygon, straight from the polar segment model;
- ``sam_model=``: each detector box is a box prompt to the port's SAM
  ``Predictor``; the mask with the best predicted IoU gives its largest
  outer contour (``ops/contours.py``, cv2's ``findContours`` rule), as JAX
  does with cv2. Images without a decoded frame are read with
  ``data/imcodec.py`` (cv2's ``imread``).

Lines are ``cls x1 y1 x2 y2 ...`` normalized to 5 decimals; a polygon of
fewer than 3 points is skipped, as in JAX.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.contours import largest_contour


def _sam_contour(predictor, box):
    """Box prompt -> the best mask's largest outer contour (n, 2) px, or
    None for an empty mask."""
    masks, iou = predictor.predict(box=np.asarray(box, np.float32), multimask_output=True)
    pts = largest_contour(masks[int(np.argmax(iou))].astype(np.uint8))
    return pts if len(pts) else None


def auto_annotate(data, det_model="yolov8n-seg.yaml", sam_model=None, output_dir=None,
                  conf=0.25, imgsz=640, device="cuda"):
    """Label the images of ``data`` (a folder, file or glob) with
    ``det_model``'s detections and write one ``.txt`` file an image into
    ``output_dir`` (default ``<data>_auto_annotate_labels`` beside it);
    returns that folder. ``sam_model`` is a SAM variant name (seeded
    weights, ``models/sam``), an official checkpoint path, or a built
    ``Sam``; with it the boxes are refined into SAM masks. Both models run
    on ``device``."""
    from ..engine.model import YOLO
    from .imcodec import imread

    model = YOLO(det_model, device=device)
    predictor = None
    if sam_model is not None:
        from ..models.sam import Predictor
        from ..models.sam.model import SAM

        sam = sam_model if hasattr(sam_model, "decode_prompts") else SAM(
            sam_model, device=device).model
        predictor = Predictor(sam, device=device)
    out = Path(output_dir or (Path(data).parent / f"{Path(data).stem}_auto_annotate_labels"))
    out.mkdir(parents=True, exist_ok=True)
    for res in model.predict(str(data), stream=True, conf=conf, imgsz=imgsz):
        h, w = res.orig_shape
        polygons = []
        if predictor is not None and res.boxes is not None and len(res.boxes.cls):
            img = res.orig_img
            if img is None and res.path:
                img = imread(str(res.path))
            predictor.set_image(img)
            for box, cls in zip(res.boxes.xyxy, res.boxes.cls):
                polygons.append((cls, _sam_contour(predictor, box)))
        elif res.contours is not None and res.boxes is not None:
            polygons = list(zip(res.contours.xy, res.boxes.cls))
            polygons = [(cls, pts) for pts, cls in polygons]
        lines = [f"{int(cls)} " + " ".join(f"{x / w:.5f} {y / h:.5f}" for x, y in pts)
                 for cls, pts in polygons if pts is not None and pts.shape[0] >= 3]
        (out / (Path(str(res.path)).stem + ".txt")).write_text("\n".join(lines))
    return str(out)
