"""Predictors of the segment, detect, pose, segment_ori and classify tasks
(counterparts of the JAX package's ``engine/predictor.py``).

Per batch: host letterbox (uint8, BGR -> RGB) -> device uint8 -> [0, 1]
float -> the task's device evaluation -> host postprocess (unpad/ungain and
clip). Segment: ``predict_parts(sigmoid=False)`` ->
``non_max_suppression_parts(scores_are_logits=True)`` ->
``finalize_polar_extras``; boxes, contours and masks (lazy, unless
``boxes=False`` and ``retina_masks=False``, where JAX's results hold none). Detect, as the JAX
detect branch: ``decode_detect`` (sigmoid scores) -> ``xywh2xyxy`` -> NMS
in float32 with scores as probabilities; boxes only. Pose, as detect with
the decoded keypoints riding through NMS as its extras; boxes and keypoints
(unpadded and ungained, not clipped, the visibility kept). Segment_ori, as
detect with the 32 mask coefficients riding through NMS, then on the host
as the JAX postprocess: ``sigmoid(mc @ proto)`` in numpy float32, zeroed
outside each box on the proto grid (the half-open test), the letterbox pad
stripped (``int(round(pad * r))`` proto pixels a side), upsampled to the
image by cv2's float INTER_LINEAR (``resize_linear_f32``, in torch on the
predictor's device) and thresholded at ``> 0.5``. Classify: the fork's
grayscale eval transform on the host (no uint8 path), the probabilities.
Every task's NMS takes ``agnostic`` (``agnostic_nms``).

Sources (``iter_source``, JAX's): HWC uint8 BGR arrays, image files, a
directory (recursive, sorted), a glob, or a list mixing paths and arrays;
files are decoded by ``data/imcodec.py`` (JPEG and PNG, byte-equal to
``cv2.imread``). Video files, webcam indices, URLs and ``screen`` raise
``NotImplementedError`` (no video decoder or ``mss`` is ported). A
``LoadStreams``, a ``*.streams`` file or a list of two or more live specs
runs ``_stream_batched``: one batch-N forward a step over the N streams'
freshest frames, the results yielded per stream. ``stream=True`` returns a
generator; ``save_txt`` writes JAX's label files for image files.
"""
from __future__ import annotations

import glob
import itertools
import os
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..data.augment import bgr_to_rgb, classify_transform_eval, letterbox, resize_linear_f32
from ..data.imcodec import imread
from ..data.streams import LoadStreams
from ..nn.modules.head import finalize_polar_extras
from ..ops.boxes import xywh2xyxy
from ..ops.nms import non_max_suppression, non_max_suppression_parts
from .results import Results

VID_FORMATS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v", ".wmv")
IMG_FORMATS = (".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp")
LIVE_PREFIXES = ("rtsp://", "rtmp://", "http://", "https://")


def iter_source(source) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (name, BGR image) from an array, an image file, a directory
    (recursive, sorted, image and video suffixes), a glob or a list of
    these; the names are JAX's."""
    if isinstance(source, np.ndarray):
        yield "array", source
        return
    if isinstance(source, (list, tuple)):
        for i, s in enumerate(source):
            if isinstance(s, np.ndarray):
                yield f"array{i}", s
            else:
                yield from iter_source(s)
        return
    if not isinstance(source, (str, Path)):
        raise TypeError(f"a source is an image array, a path or a list of them, not "
                        f"{type(source).__name__}")
    p = str(source)
    if p.startswith("screen"):
        raise NotImplementedError("screenshot sources need the 'mss' package, which the port "
                                  "does not use")
    if os.path.isdir(p):
        files = sorted(f for f in glob.glob(os.path.join(p, "**", "*"), recursive=True)
                       if Path(f).suffix.lower() in IMG_FORMATS + VID_FORMATS)
        for f in files:
            yield from iter_source(f)
        return
    if Path(p).suffix.lower() in VID_FORMATS or p.isdigit() or p.startswith(LIVE_PREFIXES):
        raise NotImplementedError(f"{p}: no video, camera or URL decoder is ported (JAX reads "
                                  f"these with cv2's VideoCapture)")
    if any(c in p for c in "*?[") and not os.path.exists(p):
        files = sorted(glob.glob(p, recursive=True))
        if not files:
            raise FileNotFoundError(f"no files match {p}")
        for f in files:
            yield from iter_source(f)
        return
    yield p, imread(p)


def _is_live_spec(s) -> bool:
    """A webcam index or a stream URL: a candidate for ``LoadStreams``."""
    p = str(s)
    return p.isdigit() or p.startswith(LIVE_PREFIXES)


def stream_loader(source, vid_stride: int = 1) -> Optional[LoadStreams]:
    """The ``LoadStreams`` a source asks for (itself, a ``*.streams`` file,
    or a list of two or more live specs), else None."""
    if isinstance(source, LoadStreams):
        return source
    if isinstance(source, (str, Path)) and str(source).endswith(".streams"):
        return LoadStreams(source, vid_stride=vid_stride)
    if (isinstance(source, (list, tuple)) and len(source) > 1
            and all(not isinstance(s, np.ndarray) and _is_live_spec(s) for s in source)):
        return LoadStreams(source, vid_stride=vid_stride)
    return None


def _as_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> [0, 1] float32 on the device (1 byte/px crosses the host
    link)."""
    if images.dtype != torch.uint8:
        raise TypeError(f"images must be uint8, got {images.dtype}")
    return images.float() / 255.0


class BasePredictor:
    """The batching, letterbox and timing the tasks share; a task gives
    ``eval_batch`` and ``postprocess``."""

    task = ""

    def __init__(self, imgsz: int = 640, conf: float = 0.25, iou: float = 0.7,
                 max_det: int = 300, pre_nms: int = 1024, batch: int = 1,
                 agnostic_nms: bool = False, boxes: bool = True, retina_masks: bool = False,
                 vid_stride: int = 1, save_txt: bool = False, save_conf: bool = False,
                 project: Optional[str] = None):
        self.imgsz, self.batch = int(imgsz), max(int(batch), 1)
        self.vid_stride = vid_stride
        self.save_txt, self.save_conf, self.project = save_txt, save_conf, project
        # the polar results' masks fill lazily where JAX's do (its
        # ``lazy_masks=bool(args.retina_masks or args.boxes)``)
        self.lazy_masks = bool(retina_masks or boxes)
        self.nms_kw = dict(conf_thres=conf, iou_thres=iou, pre_nms=pre_nms, max_det=max_det,
                           agnostic=bool(agnostic_nms))

    def preprocess_u8(self, img: np.ndarray, imgsz: int):
        """Letterbox to imgsz and flip BGR -> RGB, staying uint8."""
        lb, gain, pad = letterbox(img, (imgsz, imgsz))
        return bgr_to_rgb(lb), gain, pad

    def __call__(self, model, source, names=None, stream: bool = False):
        """Results for every image of ``source``, ``batch`` images a forward
        (a list, or with ``stream`` a generator)."""
        gen = self._stream(model, source, names or getattr(model, "names", {}))
        return gen if stream else list(gen)

    def _stream(self, model, source, names) -> Iterator[Results]:
        loader = stream_loader(source, self.vid_stride)
        if loader is not None:
            yield from self._stream_batched(model, loader, names)
            return
        items = iter_source(source)
        while True:
            chunk = list(itertools.islice(items, self.batch))
            if not chunk:
                return
            for res in self._run_batch(model, chunk, names):
                self._save_labels(res)
                yield res

    def _stream_batched(self, model, loader: LoadStreams, names) -> Iterator[Results]:
        """N live streams -> one batch-N forward a step; the results of each
        step yielded per stream, tagged with the stream's frame id."""
        try:
            for paths, frames in loader:
                yield from self._run_batch(model, list(zip(paths, frames)), names)
        finally:
            loader.close()

    def _run_batch(self, model, chunk, names) -> List[Results]:
        """[(path, BGR image)] -> their Results from one forward."""
        device = next(model.parameters()).device
        t0 = time.perf_counter()
        pre = [self.preprocess_u8(img, self.imgsz) for _, img in chunk]
        x = torch.from_numpy(np.stack([p[0] for p in pre])).to(device)
        t1 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in self.eval_batch(model, x).items()}
        t2 = time.perf_counter()
        n = len(chunk)
        results = []
        for bi, ((path, orig), (_, gain, pad)) in enumerate(zip(chunk, pre)):
            t3 = time.perf_counter()
            res = self.postprocess(out, bi, orig, path, gain, pad, names, device)
            res.speed = {
                "preprocess": (t1 - t0) * 1e3 / n,
                "inference": (t2 - t1) * 1e3 / n,
                "postprocess": (time.perf_counter() - t3) * 1e3,
            }
            results.append(res)
        return results

    def _save_labels(self, res: Results):
        """JAX's ``save_txt`` files: ``<project>/predict/labels/<stem>.txt``
        for results of image files."""
        path = res.path
        if self.save_txt and isinstance(path, str) and Path(path).suffix.lower() in IMG_FORMATS:
            labels = Path(self.project or "runs") / "predict" / "labels"
            res.save_txt(str(labels / (Path(path).stem + ".txt")), save_conf=self.save_conf)


def detect_xyxy(pred: torch.Tensor) -> torch.Tensor:
    """``decode_detect``'s (B, 4 + nc, A) with its xywh boxes made xyxy, the
    layout ``non_max_suppression`` takes."""
    return torch.cat([xywh2xyxy(pred[:, :4].transpose(1, 2)).transpose(1, 2), pred[:, 4:]], 1)


def _image_boxes(out: Dict[str, np.ndarray], bi: int, orig, gain, pad) -> np.ndarray:
    """Image ``bi``'s kept detections as [x1, y1, x2, y2, conf, cls] rows,
    boxes unpadded, ungained and clipped to the image."""
    keep = out["valid"][bi]
    h, w = orig.shape[:2]
    boxes = (out["boxes"][bi][keep] - np.array([pad[0], pad[1], pad[0], pad[1]])) / gain
    boxes = np.clip(boxes, 0, [w, h, w, h])
    return np.concatenate(
        [boxes, out["scores"][bi][keep][:, None], out["classes"][bi][keep][:, None]], -1)


class SegmentationPredictor(BasePredictor):
    task = "segment"

    @torch.inference_mode()
    def eval_batch(self, model, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) uint8 on the model's device -> NMS
        outputs with ``extras`` as [36 x | 36 y | 36 valid]."""
        x = _as_float(images).permute(0, 3, 1, 2).contiguous()
        boxes, logits, extras = model.predict_parts(x, sigmoid=False)
        out = non_max_suppression_parts(boxes, logits, extras, scores_are_logits=True,
                                        **self.nms_kw)
        out["extras"] = finalize_polar_extras(out["extras"])
        return out

    def postprocess(self, out: Dict[str, np.ndarray], bi: int, orig, path, gain, pad, names,
                    device) -> Results:
        ex = out["extras"][bi][out["valid"][bi]]  # (n, 108)
        h, w = orig.shape[:2]
        pts = np.stack([ex[:, :36], ex[:, 36:72]], -1)
        pts = (pts - np.array(pad)) / gain
        pts[..., 0] = pts[..., 0].clip(0, w)
        pts[..., 1] = pts[..., 1].clip(0, h)
        valid_rays = ex[:, 72:108] > 0.5
        return Results(orig, path, names, boxes=_image_boxes(out, bi, orig, gain, pad),
                       contours=(pts, valid_rays), device=device, lazy_masks=self.lazy_masks)


class DetectionPredictor(BasePredictor):
    task = "detect"

    @torch.inference_mode()
    def eval_batch(self, model, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) uint8 on the model's device -> NMS outputs
        (boxes in letterbox pixels, xyxy)."""
        pred = detect_xyxy(model.predict(_as_float(images).permute(0, 3, 1, 2).contiguous()))
        return non_max_suppression(pred.float(), nc=model.nc, **self.nms_kw)

    def postprocess(self, out: Dict[str, np.ndarray], bi: int, orig, path, gain, pad, names,
                    device) -> Results:
        return Results(orig, path, names, boxes=_image_boxes(out, bi, orig, gain, pad),
                       device=device)


class PosePredictor(DetectionPredictor):
    task = "pose"

    def postprocess(self, out: Dict[str, np.ndarray], bi: int, orig, path, gain, pad, names,
                    device) -> Results:
        """The detect result, and each detection's keypoints (n, K, D) in the
        image's pixels: ``(k[..., :2] - pad) / gain``, the visibility kept. As in
        the JAX ``PosePredictor``, keypoints are reported where nk is a
        multiple of 3; an image without detections gets (0, K, 3) (JAX's
        reshape of the empty array raises there)."""
        res = super().postprocess(out, bi, orig, path, gain, pad, names, device)
        ex = out["extras"][bi][out["valid"][bi]]  # (n, nk) decoded keypoints
        if ex.shape[1] % 3 == 0:
            k = ex.reshape(ex.shape[0], ex.shape[1] // 3, 3).copy()
            k[..., :2] = (k[..., :2] - np.array(pad)) / gain
            res.keypoints = k
        return res


class SegmentationOriPredictor(DetectionPredictor):
    task = "segment_ori"

    @torch.inference_mode()
    def eval_batch(self, model, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) uint8 on the model's device -> NMS outputs
        (boxes in letterbox pixels, xyxy; ``extras`` the mask coefficients)
        and ``proto`` (B, nm, hp, wp)."""
        pred, proto = model.predict(_as_float(images).permute(0, 3, 1, 2).contiguous())
        out = non_max_suppression(detect_xyxy(pred).float(), nc=model.nc, **self.nms_kw)
        return {**out, "proto": proto.float()}

    def postprocess(self, out: Dict[str, np.ndarray], bi: int, orig, path, gain, pad, names,
                    device) -> Results:
        """The detect result, and each detection's mask (n, h, w) bool as
        the JAX ``SegmentationOriPredictor`` makes it (see the module
        docstring); None without detections, as JAX."""
        keep = out["valid"][bi]
        coeffs = out["extras"][bi][keep]  # (n, nm)
        masks = None
        if coeffs.shape[0]:
            nm, hp, wp = out["proto"][bi].shape
            proto = np.ascontiguousarray(out["proto"][bi].transpose(1, 2, 0))  # JAX's (hp, wp, nm)
            pm = 1.0 / (1.0 + np.exp(-(coeffs @ proto.reshape(-1, nm).T)))
            pm = pm.reshape(-1, hp, wp)
            r = hp / self.imgsz
            bx = out["boxes"][bi][keep] * r
            py = np.arange(hp)[None, :, None]
            px = np.arange(wp)[None, None, :]
            inbox = ((px >= bx[:, 0, None, None]) & (px < bx[:, 2, None, None])
                     & (py >= bx[:, 1, None, None]) & (py < bx[:, 3, None, None]))
            pm = np.where(inbox, pm, 0.0)
            x0, y0 = int(round(pad[0] * r)), int(round(pad[1] * r))
            x1 = wp - x0 if x0 else wp
            y1 = hp - y0 if y0 else hp
            crop = torch.from_numpy(np.ascontiguousarray(pm[:, y0:y1, x0:x1])).to(device)
            h, w = orig.shape[:2]
            masks = (resize_linear_f32(crop, h, w) > 0.5).cpu().numpy()
        return Results(orig, path, names, boxes=_image_boxes(out, bi, orig, gain, pad),
                       masks=masks, device=device)


class ClassificationPredictor(BasePredictor):
    """Class probabilities of each image (``Results.probs``); the NMS
    settings are not used."""

    task = "classify"

    def _save_labels(self, res: Results):
        """None: JAX's classify stream writes no label files."""

    def preprocess_u8(self, img: np.ndarray, imgsz: int):
        """The classify eval transform (float32, normalized on the host: no
        uint8 path, as in JAX)."""
        return classify_transform_eval(img, imgsz), 1.0, (0.0, 0.0)

    @torch.inference_mode()
    def eval_batch(self, model, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"probs": model.predict(images.permute(0, 3, 1, 2).contiguous()).float()}

    def postprocess(self, out: Dict[str, np.ndarray], bi: int, orig, path, gain, pad, names,
                    device) -> Results:
        return Results(orig, path, names, probs=out["probs"][bi], device=device)
