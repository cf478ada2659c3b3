"""YOLO-format labels and the datasets (counterparts of ``img2label_path``,
``parse_label_file``, ``YOLODataset`` (its val mode, and its train mode
with the augmentation on the device or on the host) and
``ClassificationDataset`` in the JAX package's ``data/dataset.py``), in pure
Python and numpy.

``ValDataset`` and ``TrainDataset`` take decoded HWC uint8 BGR arrays, each
with a YOLO label file or its parsed arrays, or a split on disk as JAX's
``YOLODataset`` takes it (an image directory, a ``.txt`` list, a file, or a
list of those: ``data/utils.py:scan_images``) with the label files beside
them (``img2label_path``). ``ClassificationDataset`` takes decoded arrays
and class indices, or a root of class folders. Files are decoded by
``data/imcodec.py`` (JPEG and PNG, byte-equal to ``cv2.imread``; other
formats raise) when a sample is first read. There is no label cache (JAX
keeps one in an ``.npz`` beside the images): the label files are parsed
when the dataset is made.
"""
from __future__ import annotations

import copy
import functools
import os
import random
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np

from ..ops.polar import NUM_CONTOUR_POINTS
from .imcodec import imread
from .augment import (Sample, _resize_linear_u8, classify_transform_eval,
                      classify_transform_train, format_sample, format_sample_raw, letterbox_sample,
                      train_transform)
from .imgproc import resize_area
from .instance import Instances, resample_segment, segments2boxes
from .utils import IMG_FORMATS, scan_images

Labels = Tuple[np.ndarray, np.ndarray, np.ndarray]  # cls, xywh boxes, segments


def img2label_path(img_path: str) -> str:
    """``.../images/x.jpg`` -> ``.../labels/x.txt`` (the last ``images``
    directory of the path)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return sb.join(img_path.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"


def parse_label_lines(lines: Iterable[str], nc: Optional[int] = None, kpt_shape=None):
    """YOLO label lines -> (cls (n,) int32, bboxes (n, 4) normalized xywh,
    segments (n, 360, 2) normalized [, keypoints (n, K, 3)]). Lines of fewer
    than 5 numbers, and with ``nc`` given classes ``c >= nc``, are skipped.

    Line formats:
      - 5 numbers: class and an xywh box (the contour stays zero);
      - 5 + K * 2 or 5 + K * 3 with ``kpt_shape`` (K, 2 or 3): a box and
        keypoints (2 columns get a visibility of 1);
      - more than 5 otherwise: class and a polygon, resampled to 360 points,
        its box taken from the resampled contour.
    """
    cls, boxes, segs, kpts = [], [], [], []
    nk = kpt_shape[0] if kpt_shape else 0
    nd = kpt_shape[1] if kpt_shape else 0
    for line in lines:
        parts = line.split()
        if len(parts) < 5:
            continue
        c = int(float(parts[0]))
        if nc is not None and c >= nc:
            continue
        vals = np.asarray([float(v) for v in parts[1:]], np.float32)
        if kpt_shape and len(vals) == 4 + nk * nd:
            cls.append(c)
            boxes.append(vals[:4])
            segs.append(np.zeros((NUM_CONTOUR_POINTS, 2), np.float32))
            k = vals[4:].reshape(nk, nd)
            if nd == 2:
                k = np.concatenate([k, np.ones((nk, 1), np.float32)], -1)
            kpts.append(k)
        elif len(vals) == 4:
            cls.append(c)
            boxes.append(vals)
            segs.append(np.zeros((NUM_CONTOUR_POINTS, 2), np.float32))
            kpts.append(np.zeros((max(nk, 1), 3), np.float32))
        else:
            seg = resample_segment(vals.reshape(-1, 2))
            cls.append(c)
            boxes.append(segments2boxes(seg[None])[0])
            segs.append(seg)
            kpts.append(np.zeros((max(nk, 1), 3), np.float32))
    if not cls:
        out = (
            np.zeros((0,), np.int32),
            np.zeros((0, 4), np.float32),
            np.zeros((0, NUM_CONTOUR_POINTS, 2), np.float32),
        )
        return out + ((np.zeros((0, max(nk, 1), 3), np.float32),) if kpt_shape else ())
    out = (np.asarray(cls, np.int32), np.stack(boxes), np.stack(segs))
    return out + ((np.stack(kpts),) if kpt_shape else ())


def _is_path_source(x) -> bool:
    """A split on disk (a path, or a non-empty list of paths), not a list
    of decoded arrays."""
    if isinstance(x, (str, Path)):
        return True
    return (isinstance(x, (list, tuple)) and len(x) > 0
            and all(isinstance(e, (str, Path)) for e in x))


def parse_label_file(path: str, nc: Optional[int] = None, kpt_shape=None):
    """``parse_label_lines`` of a YOLO txt file; a missing file has no
    labels."""
    if not os.path.isfile(path):
        return parse_label_lines((), nc, kpt_shape)
    with open(path) as fh:
        return parse_label_lines(fh, nc, kpt_shape)


class ValDataset:
    """Val samples over decoded images or image files.

    ``images``: HWC uint8 BGR arrays, or a split on disk (see the module
    docstring; then ``labels`` defaults to the label files beside the
    images, and each image is decoded when first read; with ``cache`` its
    resized copy is kept, as JAX's ``cache='ram'``). ``labels``: one per
    image, a path to a YOLO label file or the ``(cls, bboxes, segments)`` arrays
    ``parse_label_file`` gives (normalized to the image); with ``kpt_shape``
    (K, D) a pose set, whose labels add keypoints (``(cls, bboxes, segments,
    keypoints (n, K, 3))``, as ``parse_label_file(..., kpt_shape=...)``
    gives them) and whose samples carry ``keypoints``. Each image is first
    resized so its long side is ``imgsz``, as the JAX dataset caches it, and
    ``ori_shape`` is that resized image's shape: the metrics are in its
    frame. Then it is letterboxed without upscaling and formatted with its
    labels padded to ``max_instances``. With ``single_cls`` every label's
    class is 0, as JAX's dataset reads it.
    """

    augment = False  # the JAX dataset's train mode (``TrainDataset``)

    def __init__(self, images, labels: Optional[Sequence[Union[str, Path, Labels]]] = None,
                 imgsz: int = 640, max_instances: int = 48, kpt_shape=None,
                 single_cls: bool = False, cache: bool = True):
        self.files: Optional[list] = None
        if _is_path_source(images):
            self.files = scan_images(images)
            if labels is None:
                labels = [img2label_path(f) for f in self.files]
            images = [None] * len(self.files)
        elif labels is None:
            raise ValueError("decoded images need their labels")
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self.single_cls = bool(single_cls)
        if self.files is None:
            for i, img in enumerate(images):
                if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.ndim == 3):
                    raise TypeError(f"image {i}: expected an HWC uint8 numpy array")
        self.images = list(images)
        self.cache = bool(cache)
        self._hw = [None] * len(self.images)  # the files' decoded sizes
        self.kpt_shape = tuple(int(v) for v in kpt_shape) if kpt_shape else None
        self.labels = [self._labels(lab) for lab in labels]
        self.imgsz = int(imgsz)
        self.max_instances = int(max_instances)

    def _keep_first(self, n: int):
        """Keep the first ``n`` samples."""
        self.images, self.labels, self._hw = self.images[:n], self.labels[:n], self._hw[:n]
        if self.files is not None:
            self.files = self.files[:n]

    def _labels(self, lab) -> Dict[str, np.ndarray]:
        if isinstance(lab, (str, Path)):
            lab = parse_label_file(str(lab), kpt_shape=self.kpt_shape)
        c, b, s = lab[:3]
        c = np.asarray(c, np.int32).reshape(-1)
        out = {"cls": np.zeros_like(c) if self.single_cls else c,
               "bboxes": np.asarray(b, np.float32).reshape(-1, 4),
               "segments": np.asarray(s, np.float32).reshape(-1, NUM_CONTOUR_POINTS, 2)}
        if self.kpt_shape:
            if len(lab) < 4:
                raise ValueError(f"a pose set (kpt_shape {self.kpt_shape}) needs keypoints with "
                                 "each label: (cls, bboxes, segments, keypoints)")
            out["keypoints"] = np.asarray(lab[3], np.float32).reshape(len(out["cls"]), -1, 3)
        return out

    def __len__(self):
        return len(self.images)

    def resized(self, i: int) -> np.ndarray:
        """The image with its long side at ``imgsz``, as the JAX dataset
        caches it, exactly: by cv2's INTER_LINEAR
        (``data/augment.py:_resize_linear_u8``) when enlarging and in train
        mode, by cv2's INTER_AREA (``data/imgproc.py:resize_area``) when
        shrinking for validation. A file is decoded here (its resized copy
        kept with ``cache``)."""
        img = self.images[i]
        if img is not None and self.files is not None:
            return img  # the cached resized copy
        if img is None:
            img = imread(self.files[i])
            self._hw[i] = img.shape[:2]
        nh, nw = self.resized_hw(i)
        if (nh, nw) == img.shape[:2]:
            out = img
        elif nh < img.shape[0] and not self.augment:
            out = resize_area(img, nh, nw)
        else:
            out = _resize_linear_u8(img, nh, nw)
        if self.files is not None and self.cache:
            self.images[i] = out
        return out

    def resized_hw(self, i: int) -> Tuple[int, int]:
        """The size of ``resized(i)``."""
        if self.files is None:
            h, w = self.images[i].shape[:2]
        else:
            if self._hw[i] is None:
                self.resized(i)
            h, w = self._hw[i]
        r = self.imgsz / max(h, w)
        if r == 1.0:
            return h, w
        return min(int(round(h * r)), self.imgsz), min(int(round(w * r)), self.imgsz)

    def load_raw(self, i: int, pixels: bool = True) -> Sample:
        """Sample i at its ``resized`` size, its labels in pixels; without
        ``pixels``, its size alone (``Sample.hw``)."""
        img = self.resized(i) if pixels else None
        h, w = self.resized_hw(i)
        lab = self.labels[i]
        xywh = lab["bboxes"] * np.array([w, h, w, h], np.float32)
        xyxy = np.concatenate([xywh[:, :2] - xywh[:, 2:] / 2, xywh[:, :2] + xywh[:, 2:] / 2], -1)
        segs = lab["segments"] * np.array([w, h], np.float32)
        kpts = None
        if "keypoints" in lab:
            kpts = lab["keypoints"].copy()
            kpts[..., 0] *= w
            kpts[..., 1] *= h
        return Sample(img, Instances(lab["cls"].astype(np.float32), xyxy, segs, kpts), hw=(h, w))

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        s = letterbox_sample(self.load_raw(i), self.imgsz, scaleup=False)
        return format_sample(s, self.max_instances)


class TrainDataset(ValDataset):
    """Train samples over decoded images (the JAX ``YOLODataset`` with
    ``augment``), each image first resized so its long side is ``imgsz``
    (cv2's INTER_LINEAR both ways, as the JAX train mode takes it).

    With ``device_augment`` (the default) for the augmentation on the
    device: letterboxed to ``imgsz`` with upscaling and formatted by
    ``format_sample_raw`` (uint8 BGR, the labels padded to
    ``max_instances``, the letterbox geometry); mosaic, the affine warp,
    MixUp, HSV and the flips run on the device in the train step.

    Without it, the host chain (``data/augment.py:train_transform``) with
    the settings of ``hyp``, its draws from ``self.rng``,
    ``random.Random(seed)``, in the order samples are read (read them in
    batch order, ``TrainLoader(..., in_order=True)``, to repeat a run), its
    MixUp beta from ``noise`` (default ``numpy.random.default_rng(seed)``;
    JAX draws it from numpy's global state, ``np.random``, which may be
    passed to reproduce its draws), keypoints flipped by ``flip_idx``;
    then ``format_sample`` (uint8 RGB). ``close_mosaic()`` turns mosaic and
    MixUp off for the samples read after it. ``plan(i)`` makes the draws of
    ``self[i]`` and ``render`` its pixels: ``self[i]`` is
    ``render(plan(i))``, and plans made in read order may be rendered in
    any order, at once, in other processes.

    ``fraction`` below 1 keeps the first ``max(1, round(n * fraction))``
    samples, as JAX's train set keeps its first image files. ``images`` and
    ``cache`` as ``ValDataset`` takes them."""

    augment = True

    def __init__(self, images, labels: Optional[Sequence[Union[str, Path, Labels]]] = None,
                 imgsz: int = 640, max_instances: int = 48, kpt_shape=None, hyp=None,
                 device_augment: bool = True, seed: int = 0, flip_idx=None, noise=None,
                 single_cls: bool = False, fraction: float = 1.0, cache: bool = True):
        super().__init__(images, labels, imgsz=imgsz, max_instances=max_instances,
                         kpt_shape=kpt_shape, single_cls=single_cls, cache=cache)
        if fraction < 1.0:
            self._keep_first(max(1, round(len(self.images) * fraction)))
        self.device_augment = bool(device_augment)
        if not self.device_augment and hyp is None:
            raise ValueError("the host train chain (device_augment=False) needs hyp")
        self.hyp = hyp
        self.rng = random.Random(seed)
        self.noise = np.random.default_rng(seed) if noise is None else noise
        self.flip_idx = tuple(int(v) for v in flip_idx) if flip_idx else None
        self.mosaic_enabled = True

    def close_mosaic(self):
        """Mosaic and MixUp off from here on (the host chain's last
        ``close_mosaic`` epochs)."""
        self.mosaic_enabled = False

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return self.render(self.plan(i))

    def plan(self, i: int) -> Tuple:
        """The host chain run on sample i without pixels (``data/augment.py``):
        every draw it makes, its MixUp betas recorded. Returns the job that
        ``render`` takes (plain data: it may cross to another process):
        the index, the settings, the generator's state before the draws and
        the betas."""
        if self.device_augment:
            return (i, None, None, ())
        hyp = self.hyp
        if not self.mosaic_enabled:
            hyp = copy.copy(hyp)
            hyp.mosaic, hyp.mixup = 0.0, 0.0
        state = self.rng.getstate()
        betas = _Betas(self.noise)
        train_transform(functools.partial(self.load_raw, pixels=False), i, len(self), self.imgsz,
                        hyp, self.rng, betas, flip_idx=self.flip_idx)
        return (i, hyp, state, tuple(betas.drawn))

    def render(self, job: Tuple) -> Dict[str, np.ndarray]:
        """A ``plan``'s sample: the chain rerun with pixels from a copy of
        the generator's state, the betas replayed (on the device path, the
        letterboxed raw sample)."""
        i, hyp, state, betas = job
        if hyp is None:
            s = letterbox_sample(self.load_raw(i), self.imgsz, scaleup=True)
            return format_sample_raw(s, self.max_instances)
        rng = random.Random()
        rng.setstate(state)
        s = train_transform(self.load_raw, i, len(self), self.imgsz, hyp, rng,
                            _Betas(values=betas), flip_idx=self.flip_idx)
        return format_sample(s, self.max_instances)


class _Betas:
    """MixUp's beta draws: from ``noise``, kept in ``drawn``, or handed out
    again from ``values`` in order."""

    def __init__(self, noise=None, values=()):
        self.noise, self.drawn, self.values = noise, [], list(values)

    def beta(self, a: float, b: float) -> float:
        if self.noise is None:
            return self.values.pop(0)
        v = float(self.noise.beta(a, b))
        self.drawn.append(v)
        return v


class ClassificationDataset:
    """Classify samples over decoded images or a folder (the JAX
    ``ClassificationDataset``): ``images`` HWC uint8 BGR with ``labels``
    their class indices, or a root of class folders (``labels`` None: the
    sorted folders numbered, as JAX; every image file below each, sorted,
    decoded each time it is read, as JAX reads it). A sample is ``{"img": (imgsz, imgsz, 3) float32,
    "cls": int32}`` by the fork's grayscale transforms
    (``data/augment.py``): ``classify_transform_train`` with ``augment``,
    its brightness draws from ``random.Random(seed)`` in the order samples
    are read, its noise from ``self.noise``, ``numpy.random.default_rng(
    seed)`` (JAX draws it from numpy's global state), else
    ``classify_transform_eval``."""

    def __init__(self, images, labels: Optional[Sequence[int]] = None, imgsz: int = 224,
                 augment: bool = False, seed: int = 0):
        self.classes: Optional[list] = None
        if isinstance(images, (str, Path)):
            root = Path(images)
            self.classes = sorted(d.name for d in root.iterdir() if d.is_dir())
            samples = [(str(f), ci) for ci, c in enumerate(self.classes)
                       for f in sorted((root / c).rglob("*")) if f.suffix.lower() in IMG_FORMATS]
            if not samples:
                raise FileNotFoundError(f"no classification images under {root}")
            images, labels = [f for f, _ in samples], [c for _, c in samples]
        elif labels is None:
            raise ValueError("decoded images need their class indices")
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        if self.classes is None:
            for i, img in enumerate(images):
                if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.ndim == 3):
                    raise TypeError(f"image {i}: expected an HWC uint8 numpy array")
        self.images = list(images)
        self.labels = np.asarray(labels, np.int32).reshape(-1)
        self.imgsz = int(imgsz)
        self.augment = bool(augment)
        self.rng = random.Random(seed)
        self.noise = np.random.default_rng(seed)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        img = self.images[i]
        if self.classes is not None:
            img = imread(img)
        if self.augment:
            x = classify_transform_train(img, self.imgsz, self.rng, self.noise)
        else:
            x = classify_transform_eval(img, self.imgsz)
        return {"img": x, "cls": np.int32(self.labels[i])}
