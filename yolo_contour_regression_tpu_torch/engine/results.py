"""Inference result containers (counterpart of the JAX package's
``engine/results.py``), numpy-backed. A detect result carries boxes only
(``contours`` and ``masks`` are None), a pose result boxes and
``keypoints`` (n, K, D) in the image's pixels, a segment result no
keypoints (None).

A segment_ori result carries its masks as computed (``masks``), a classify
result its probabilities (``probs``, a ``Probs``) and nothing else.

For the polar segment task ``Results.masks`` is lazy where the predictor
says so (``lazy_masks``, JAX's ``retina_masks or boxes``, true at the
defaults): the first read rasterizes the polar contours at
the original image size through ``ops.raster.fill_polygons_cv2`` on the
predictor's device (the CUDA kernel on a card, the plain version on the
CPU). Its rule is the JAX facade's, ``cv2.fillPoly`` of the valid vertices
at 3-bit subpixel precision (JAX ``contours_to_masks_host``), reproduced
without cv2: the masks are the JAX facade's, pixel for pixel. Without the flag (``predict(boxes=
False)``) a result holds contours and no masks (``masks`` is None), as
JAX's; ``FastSAMPrompt`` then fills the contours by the even-odd rule.

The data methods are JAX's: ``Boxes.xywh``, ``.xyxyn``, ``.xywhn``,
``Contours.xy``, and ``Results.new``, ``keys``, ``__getitem__``,
``update``, ``verbose``, ``tojson`` and ``save_txt``; ``cpu``, ``numpy``
and ``to`` return the result itself (its arrays are host numpy already).
``Masks.xy`` / ``.xyn`` are each mask's largest outer contour
(``ops/contours.py``, cv2's ``findContours`` and ``contourArea`` without
cv2). A tracked result (``YOLO.track``) carries ``track_ids``, aligned with
its boxes (-1 where no track matched). ``plot``, ``save`` and ``save_crop``
(drawing and an image encoder) are not ported and raise
``NotImplementedError``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.contours import largest_contour
from ..ops.raster import fill_polygons_cv2


class Boxes:
    """data rows: [x1, y1, x2, y2, conf, cls]."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data, np.float32).reshape(-1, 6)
        self.orig_shape = orig_shape

    def __len__(self):
        return self.data.shape[0]

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, 4]

    @property
    def cls(self):
        return self.data[:, 5]

    @property
    def xywh(self):
        b = self.data[:, :4]
        return np.concatenate([(b[:, :2] + b[:, 2:]) / 2, b[:, 2:] - b[:, :2]], -1)

    @property
    def xyxyn(self):
        h, w = self.orig_shape
        return self.xyxy / np.array([w, h, w, h], np.float32)

    @property
    def xywhn(self):
        h, w = self.orig_shape
        return self.xywh / np.array([w, h, w, h], np.float32)


NOT_YET = "is not ported (drawing: ROADMAP Queue 1 item 3.3)"


class Masks:
    """Binary masks (n, H, W) and their outer contours."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data)
        self.orig_shape = orig_shape

    def __len__(self):
        return self.data.shape[0]

    @property
    def xy(self):
        """Each mask's largest outer contour, (k, 2) float32 pixels ((0, 2)
        for an empty mask), as the JAX ``Masks.xy``."""
        return [largest_contour(m) for m in self.data.astype(np.uint8)]

    @property
    def xyn(self):
        h, w = self.orig_shape
        return [c / np.array([w, h], np.float32) for c in self.xy]


class Contours:
    """Polar contours (n, 36, 2) px + per-ray validity (n, 36)."""

    def __init__(self, points: np.ndarray, valid: np.ndarray, orig_shape):
        self.points = np.asarray(points, np.float32)
        self.valid = np.asarray(valid, bool)
        self.orig_shape = orig_shape

    def __len__(self):
        return self.points.shape[0]

    @property
    def xy(self):
        """Each contour's valid points (k, 2) in pixels."""
        return [p[v] for p, v in zip(self.points, self.valid)]


class Probs:
    """Class probabilities (nc,): ``top1``, ``top5`` (ranked by
    ``np.argsort(-data)``) and ``top1conf``, as the JAX ``Probs``."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, np.float32)

    @property
    def top1(self) -> int:
        return int(self.data.argmax())

    @property
    def top5(self):
        return np.argsort(-self.data)[:5].tolist()

    @property
    def top1conf(self) -> float:
        return float(self.data.max())


def contours_to_masks(points: np.ndarray, valid: np.ndarray, height: int, width: int,
                      device="cuda") -> np.ndarray:
    """(n, V, 2) px contours + validity -> (n, H, W) bool masks, filled on
    ``device`` as the JAX facade fills them (``cv2.fillPoly`` at
    ``shift=3``; fewer than 3 valid vertices give an empty mask)."""
    pts = torch.as_tensor(points, dtype=torch.float32).to(device).contiguous()
    ok = torch.as_tensor(valid, dtype=torch.bool).to(device).contiguous()
    return fill_polygons_cv2(pts, ok, height, width).cpu().numpy()


class Results:
    """One image's results: boxes, contours and lazy masks (or masks as
    given), keypoints, or probabilities. ``lazy_masks`` lets ``masks`` fill
    the contours on first read; without it ``masks`` is what was given."""

    def __init__(
        self,
        orig_img: np.ndarray,
        path: str,
        names: Dict[int, str],
        boxes: Optional[np.ndarray] = None,
        contours=None,
        keypoints: Optional[np.ndarray] = None,
        speed: Optional[Dict[str, float]] = None,
        device="cuda",
        masks: Optional[np.ndarray] = None,
        probs: Optional[np.ndarray] = None,
        lazy_masks: bool = False,
    ):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.contours = (
            Contours(contours[0], contours[1], self.orig_shape) if contours is not None else None
        )
        self.keypoints = keypoints
        self.device = device
        self.speed = speed or {}
        self._masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.probs = Probs(probs) if probs is not None else None
        self._lazy_masks = bool(lazy_masks)

    @property
    def masks(self) -> Optional[Masks]:
        if self._masks is None and self._lazy_masks and self.contours is not None:
            self._masks = Masks(
                contours_to_masks(
                    self.contours.points, self.contours.valid, *self.orig_shape,
                    device=self.device,
                ),
                self.orig_shape,
            )
        return self._masks

    @masks.setter
    def masks(self, value):
        if value is not None and not isinstance(value, Masks):
            value = Masks(value, self.orig_shape)
        self._masks = value

    def __len__(self):
        for v in (self.boxes, self._masks, self.contours):
            if v is not None:
                return len(v)
        return 0

    # the arrays are host numpy already: device moves are the identity, as JAX's
    def cpu(self):
        return self

    def numpy(self):
        return self

    def to(self, *args, **kwargs):
        return self

    def new(self) -> "Results":
        """An empty result carrying the image, path and names."""
        return Results(self.orig_img, self.path, self.names, device=self.device)

    @property
    def keys(self):
        """The fields present; masks count where they can be filled lazily,
        without filling them."""
        have_masks = self._masks is not None or (self._lazy_masks and self.contours is not None)
        return [k for k in ("boxes", "masks", "contours", "probs", "keypoints")
                if (have_masks if k == "masks" else getattr(self, k) is not None)]

    def __getitem__(self, idx) -> "Results":
        """The detections at ``idx``. An integer keeps the leading instance
        axis (``r[0].masks.data`` is (1, H, W)); the lazy-masks flag is
        kept, so indexing does not fill the masks."""
        r = self.new()
        is_int = isinstance(idx, (int, np.integer))

        def keepdim(a):
            a = np.asarray(a)[idx]
            return a[None] if is_int else a

        if self.boxes is not None:
            r.boxes = Boxes(self.boxes.data[idx].reshape(-1, self.boxes.data.shape[-1]),
                            self.orig_shape)
        r._lazy_masks = self._lazy_masks
        if self._masks is not None:
            r.masks = Masks(keepdim(self._masks.data), self.orig_shape)
        if self.contours is not None:
            r.contours = Contours(keepdim(self.contours.points), keepdim(self.contours.valid),
                                  self.orig_shape)
        if self.keypoints is not None:
            r.keypoints = keepdim(self.keypoints)
        return r

    def update(self, boxes=None, masks=None, probs=None):
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)
        if masks is not None:
            self.masks = Masks(masks, self.orig_shape)
        if probs is not None:
            self.probs = Probs(probs)

    def verbose(self) -> str:
        """A summary such as '4 circles, 1 rect, '."""
        if self.probs is not None:
            return f"{self.names.get(self.probs.top1, self.probs.top1)} " \
                   f"{self.probs.top1conf:.2f}, "
        if self.boxes is None or len(self.boxes) == 0:
            return "(no detections), "
        cls = self.boxes.cls.astype(int)
        parts = []
        for c in sorted(set(cls.tolist())):
            n = int((cls == c).sum())
            parts.append(f"{n} {self.names.get(c, str(c))}{'s' * (n > 1)}")
        return ", ".join(parts) + ", "

    def tojson(self, normalize: bool = False) -> str:
        """JSON rows of name, class, confidence and box, with segments and
        keypoints where the result has them (JAX's layout and rounding)."""
        h, w = self.orig_shape
        sx, sy = (w, h) if normalize else (1, 1)
        rows = []
        if self.probs is not None:
            rows.append({"name": self.names.get(self.probs.top1, str(self.probs.top1)),
                         "class": int(self.probs.top1),
                         "confidence": round(self.probs.top1conf, 5)})
        elif self.boxes is not None:
            for i, row in enumerate(self.boxes.data):
                x1, y1, x2, y2 = (float(v) for v in row[:4])
                item = {
                    "name": self.names.get(int(row[5]), str(int(row[5]))),
                    "class": int(row[5]),
                    "confidence": round(float(row[4]), 5),
                    "box": {"x1": round(x1 / sx, 5), "y1": round(y1 / sy, 5),
                            "x2": round(x2 / sx, 5), "y2": round(y2 / sy, 5)},
                }
                if self.contours is not None and i < len(self.contours):
                    pts = self.contours.xy[i]
                    item["segments"] = {"x": [round(float(x) / sx, 5) for x in pts[:, 0]],
                                        "y": [round(float(y) / sy, 5) for y in pts[:, 1]]}
                if self.keypoints is not None:
                    k = np.asarray(self.keypoints[i], np.float64)
                    item["keypoints"] = {"x": [round(float(x) / sx, 5) for x in k[:, 0]],
                                         "y": [round(float(y) / sy, 5) for y in k[:, 1]]}
                rows.append(item)
        return json.dumps(rows, indent=2)

    def save_txt(self, txt_file: str, save_conf: bool = False) -> str:
        """YOLO-format label lines: ``cls`` and the normalized polygon of a
        contour (skipped below 3 valid points), else ``cls xywhn``; with
        ``save_conf`` the confidence last; a classify result ``top1conf
        top1``."""
        lines = []
        if self.probs is not None:
            lines.append(f"{self.probs.top1conf:.2f} {self.probs.top1}")
        elif self.boxes is not None:
            for i, row in enumerate(self.boxes.data):
                cls = int(row[5])
                if self.contours is not None and i < len(self.contours):
                    pts = self.contours.xy[i]
                    if pts.shape[0] < 3:
                        continue
                    h, w = self.orig_shape
                    line = f"{cls} " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in pts)
                else:
                    line = f"{cls} " + " ".join(f"{v:.6f}" for v in self.boxes.xywhn[i])
                if save_conf:
                    line += f" {row[4]:.6f}"
                lines.append(line)
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        Path(txt_file).write_text("\n".join(lines) + ("\n" if lines else ""))
        return txt_file

    def plot(self, *args, **kwargs):
        raise NotImplementedError(f"Results.plot (drawing) {NOT_YET}")

    def save(self, *args, **kwargs):
        raise NotImplementedError(f"Results.save (drawing and an image encoder) {NOT_YET}")

    def save_crop(self, *args, **kwargs):
        raise NotImplementedError(f"Results.save_crop (an image encoder) {NOT_YET}")
