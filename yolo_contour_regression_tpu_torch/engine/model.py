"""The ``YOLO`` facade of the segment, detect, pose, segment_ori, classify
and rtdetr tasks (counterpart of the JAX package's ``engine/model.py``)::

    model = YOLO("yolov8n-seg.yaml", device="cuda")     # a fresh polar model
    metrics = model.train(data={"train": (images, labels), "val": (images, labels),
                                "names": {0: "circle", 1: "rect"}}, epochs=100, imgsz=640)
    model = YOLO("runs/floor_seg160/best.ckpt", device="cuda")
    results = model.predict([img_bgr_u8, ...], imgsz=160)
    metrics = model.val([img_bgr_u8, ...], ["a.txt", ...], imgsz=160, batch=4)
    metrics = model.val(data="coco8-seg.yaml")          # a dataset yaml's val split
    YOLO("yolov8n-seg.yaml").train(data="data.yaml", device=["cuda:0", "cuda:1"])  # 2 ranks
    model = YOLO("runs/floor_detect/best.ckpt").fuse()  # detect, deploy form
    results = YOLO("runs/floor_pose/best.ckpt").predict(images)  # results[0].keypoints
    YOLO("yolov8n-segori.yaml").train(data=...)          # proto masks: results[0].masks
    model = YOLO("runs/floor_classify/best.ckpt")        # classify: results[0].probs
    metrics = model.val([img_bgr_u8, ...], [0, 1, ...], imgsz=64)  # labels: class indices
    model = YOLO("runs/floor_rtdetr/best.ckpt")          # RT-DETR: no NMS; predict, val, fuse
    YOLO("yolov8n-rtdetr.yaml").train(data=..., imgsz=192)  # RT-DETR on the host train chain
    model.predict(images, boxes=False)                    # polar: contours, masks None
    model("images/", stream=True, save_txt=True, project="out")  # files, a generator, labels
    httpd = model.serve(port=8570, imgsz=640, background=True)  # POST /predict, GET /stats
    YOLO("runs/segment_train/weights/last.ckpt").train(resume=True)  # go on with a cut run
    YOLO("runs/floor_seg160/best.ckpt").fuse().save("fused.ckpt")  # deploy form, JAX's format
    model.info(detailed=True); model.add_callback("on_fit_epoch_end", fn); model.tune(data)

SAM, FastSAM and NAS (``models/``) are facades of their own; FastSAM and
NAS are this facade bound to the segment and detect tasks.

A name ending in ``.yaml`` names a fresh model (``nn/tasks.py``:
``yaml_model_load``; ``yolov8n-seg.yaml`` is the polar segment task,
``yolov8n.yaml`` detect, ``yolov8n-pose.yaml`` pose, ``yolov8n-segori.yaml``
segment_ori, ``yolov8n-cls.yaml`` classify, ``yolov8n-rtdetr.yaml`` rtdetr)
that has no weights until ``train`` builds and initializes it from ``seed``
and adopts its ``best.ckpt`` (RT-DETR trains on the host train chain, as
JAX's); anything else is a checkpoint of one of those tasks of the JAX
package, in its
training form or fused (``deploy == "fused"``, as the JAX ``YOLO.save``
writes it after ``fuse()``), or one the port's trainer wrote. The task
comes from the checkpoint's ``train_args`` or, failing that, the config's
head; ``predict``, ``val`` and ``train`` take the task's classes.

``save`` writes the facade's weights in the JAX package's format, fused ones
too (``deploy == "fused"``); ``load`` reads a checkpoint into the facade;
``info`` gives JAX's dict (layers, parameters and, ``detailed``, a row a
layer); ``reset_weights`` draws fresh weights from seed 0; ``to`` moves the
model (JAX's is the identity); ``add_callback``, ``clear_callback`` and
``reset_callbacks`` keep callbacks for the next trainer; ``tune`` runs the
evolutionary ``Tuner`` (``utils/tuner.py``; Ray Tune is not ported).
"""
from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import torch

from ..data.utils import check_cls_dataset, check_det_dataset
from ..models.rtdetr.predict import RTDETRPredictor
from ..models.rtdetr.val import RTDETRValidator
from ..nn.fuse import fuse_model
from ..nn.tasks import (TASK_MODELS, TaskModel, build_model, guess_model_task, init_weights,
                        yaml_model_load)
from ..utils.checkpoint import (checkpoint_variables, load_checkpoint, load_jax_variables,
                                save_checkpoint, to_jax_variables)
from .predictor import (ClassificationPredictor, DetectionPredictor, PosePredictor,
                        SegmentationOriPredictor, SegmentationPredictor)
from .trainer import (ClassificationTrainer, DetectionTrainer, PoseTrainer, RTDETRTrainer,
                      SegmentationOriTrainer, SegmentationTrainer)
from .validator import (ClassificationValidator, DetectionValidator, PoseValidator,
                        SegmentationOriValidator, SegmentationValidator)



LOGGER = logging.getLogger(__name__)

# each task's predictor, validator and trainer (the JAX ``TASK_MAP``, for the ported tasks)
TASK_MAP = {
    "segment": {"predictor": SegmentationPredictor, "validator": SegmentationValidator,
                "trainer": SegmentationTrainer},
    "detect": {"predictor": DetectionPredictor, "validator": DetectionValidator,
               "trainer": DetectionTrainer},
    "pose": {"predictor": PosePredictor, "validator": PoseValidator, "trainer": PoseTrainer},
    "segment_ori": {"predictor": SegmentationOriPredictor, "validator": SegmentationOriValidator,
                    "trainer": SegmentationOriTrainer},
    "classify": {"predictor": ClassificationPredictor, "validator": ClassificationValidator,
                 "trainer": ClassificationTrainer},
    "rtdetr": {"predictor": RTDETRPredictor, "validator": RTDETRValidator,
               "trainer": RTDETRTrainer},
}


def _jax_kwargs(spec) -> Dict:
    """A layer's arguments as the JAX package's spec names them: NHWC
    Concat on ``axis`` -1, Upsample's ``scale``, lists for tuples."""
    if spec.kind == "concat":
        return {"axis": -1}
    kwargs = {k: list(v) if isinstance(v, tuple) else v for k, v in spec.kwargs.items()
              if not k.startswith("_")}
    if spec.kind == "upsample":
        kwargs = {"scale": kwargs.pop("scale_factor"), **kwargs}
    return kwargs


def _check_task(task: str) -> str:
    if task not in TASK_MAP:
        raise NotImplementedError(f"task={task!r} is not ported; only {sorted(TASK_MAP)}")
    return task


class YOLO:
    """User-facing model handle: a model's weights on ``device``. ``task``,
    if given, must be the model's (``RTDETR`` passes "rtdetr")."""

    def __init__(self, model: Union[str, Path], device="cuda", task: Optional[str] = None):
        self._device_arg = device  # the trainer's: "cuda" is every visible card
        self.device = torch.device(device[0] if isinstance(device, (list, tuple)) else device)
        self.ckpt_path: Optional[Path] = None
        self._callbacks: Dict[str, list] = {}
        if str(model).endswith((".yaml", ".yml")):
            self._new(str(model))
        else:
            self._load(model)
        if task is not None and task != self.task:
            raise ValueError(f"{model} is a {self.task!r} model, not {task!r}")

    def _new(self, name: str):
        self.task = _check_task(guess_model_task(yaml_model_load(name)))
        self.model: Optional[TaskModel] = None  # the trainer builds it
        self.imgsz = 640
        self.overrides = {"model": name, "task": self.task}

    def _load(self, path):
        ckpt = load_checkpoint(path)
        deploy = ckpt.get("deploy")
        if deploy not in (None, "fused"):
            raise NotImplementedError(f"deploy={deploy!r} checkpoints are not ported")
        train_args = ckpt.get("train_args") or {}
        cfg = ckpt["model_yaml"]
        self.task = _check_task(train_args.get("task") or guess_model_task(cfg))
        self.model = build_model(cfg)
        if not isinstance(self.model, TASK_MODELS[self.task]):
            raise NotImplementedError(f"task={self.task!r} on a {type(self.model).__name__}")
        self.model.names = dict(ckpt.get("names") or self.model.names)
        if deploy == "fused":  # a fused params tree, no batch_stats
            fuse_model(self.model)
        load_jax_variables(self.model, *checkpoint_variables(ckpt))
        self.model.to(self.device).eval()
        # the JAX facade takes the training imgsz as the predict default, and
        # keeps the training single_cls (for val) and data
        self.imgsz = int(train_args.get("imgsz", 640))
        self.overrides = {k: v for k, v in train_args.items()
                          if k in ("imgsz", "task", "single_cls", "data")}
        self.ckpt_path = Path(path)

    @property
    def names(self):
        return self._weights().names

    def _weights(self) -> TaskModel:
        if self.model is None:
            raise RuntimeError(f"{self.overrides['model']} has no weights yet: train it, or "
                               f"load a checkpoint")
        return self.model

    def train(self, data=None, mark: Optional[Callable[[str], None]] = None, device=None,
              **overrides) -> Dict[str, float]:
        """Train a fresh model of this facade's config on ``data`` (a dataset
        yaml's path, or the splits: see ``engine/trainer.py``) on ``device``
        (default: the facade's; a list of devices, or ``"cuda"`` for every
        visible card, trains data-parallel), with the
        ``cfg/__init__.py:DEFAULT_CFG`` settings and ``overrides``; then
        adopt ``best.ckpt`` (or ``last.ckpt``) on the facade's device.
        Returns the final validation of ``best.ckpt``. The trainer stays at
        ``self.trainer``; ``mark`` is its stage hook, and the callbacks of
        ``add_callback`` are added to it.

        ``resume=True`` (or a checkpoint's path) goes on with a cut run (see
        ``engine/trainer.py``); on a facade loaded from a checkpoint,
        ``resume=True`` resumes from that checkpoint, and ``data`` defaults
        to the dataset yaml it was trained on. Training a checkpoint's
        weights without ``resume`` is not ported (nor does the JAX facade
        do it)."""
        resume = overrides.get("resume")
        if self.ckpt_path is not None:
            if not resume:
                raise NotImplementedError("training starts from a model config (YOLO('yolov8n-"
                                          "seg.yaml')) or resumes a run (resume=True); from a "
                                          "checkpoint's weights it is not ported")
            if resume is True:
                overrides["resume"] = str(self.ckpt_path)
        trainer = TASK_MAP[self.task]["trainer"]
        self.trainer = trainer(overrides={**self.overrides, **overrides, "mode": "train"},
                               device=self._device_arg if device is None else device, mark=mark)
        for event, fns in self._callbacks.items():
            for fn in fns:
                self.trainer.add_callback(event, fn)
        metrics = self.trainer.train(data)
        best, last = self.trainer.wdir / "best.ckpt", self.trainer.wdir / "last.ckpt"
        src = best if best.exists() else last
        if src.exists():
            self._load(src)
        return metrics

    def predict(self, source, imgsz=None, conf: float = 0.25, iou: float = 0.7,
                max_det: int = 300, pre_nms: int = 1024, batch: int = 1,
                agnostic_nms: bool = False, boxes: bool = True, retina_masks: bool = False,
                stream: bool = False, save_txt: bool = False, save_conf: bool = False,
                project: Optional[str] = None, vid_stride: int = 1):
        """Results of ``source`` (see ``engine/predictor.py:iter_source``: HWC
        uint8 BGR arrays, image files, directories, globs, lists of them; a
        ``LoadStreams`` or two or more live specs batched a step), ``batch``
        images per forward; a list, or with ``stream`` a generator.
        ``agnostic_nms`` suppresses across classes. The polar segment task's
        results fill their masks lazily unless ``boxes`` and
        ``retina_masks`` are both false (then ``masks`` is None, as JAX's).
        ``save_txt`` (``save_conf``) writes label files of image sources
        under ``<project or runs>/predict/labels``. Nothing is drawn or
        saved as an image (JAX's ``save``, ``save_crop``): drawing is not
        ported."""
        predictor = TASK_MAP[self.task]["predictor"](
            imgsz=imgsz or self.imgsz, conf=conf, iou=iou, max_det=max_det,
            pre_nms=pre_nms, batch=batch, agnostic_nms=agnostic_nms, boxes=boxes,
            retina_masks=retina_masks, vid_stride=vid_stride, save_txt=save_txt,
            save_conf=save_conf, project=project,
        )
        return predictor(self._weights(), source, names=self.names, stream=stream)

    def __call__(self, source=None, **kwargs):
        return self.predict(source, **kwargs)

    def serve(self, host: str = "127.0.0.1", port: int = 8570, imgsz: int = 640,
              max_batch: int = 32, max_delay_ms: float = 5.0, background: bool = False, **kw):
        """The dynamic-batching HTTP server over this model
        (``serve/http_api.py:serve_http``; ``kw`` goes to the
        ``InferenceServer`` and ``warmup_buckets``). Blocks in
        ``serve_forever`` unless ``background``; then returns the httpd,
        whose ``engine`` is the ``InferenceServer`` (stop it with
        ``httpd.shutdown(); httpd.engine.close()``)."""
        from ..serve.http_api import serve_http

        httpd = serve_http(self, host=host, port=port, imgsz=imgsz, max_batch=max_batch,
                           max_delay_ms=max_delay_ms, **kw)
        if background:
            threading.Thread(target=httpd.serve_forever, daemon=True,
                             name="serve-http").start()
            return httpd
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.shutdown()
            httpd.server_close()
            httpd.engine.close()
        return None

    def val(self, images=None, labels=None, imgsz=None, batch: int = 16, conf: float = 0.001,
            iou: float = 0.7, max_det: int = 300, pre_nms: int = 1024, mask_ratio: int = 1,
            single_cls: Optional[bool] = None, data=None):
        """Box (and for the segment tasks mask, for pose keypoint) mAP on
        decoded images (HWC uint8 BGR numpy) with their labels (YOLO
        label-file paths, or the arrays ``data/dataset.py:parse_label_file``
        gives: ``(cls, bboxes, segments)``, for pose with the model's
        ``kpt_shape`` also ``keypoints``; for classify the class indices,
        and top-1 and top-5 accuracy), on the model's device -> the JAX
        ``results_dict`` keys. Or, without ``images``, on the ``val`` split
        of ``data`` (a dataset yaml, ``data/utils.py:check_det_dataset``;
        for classify a root of class folders), default the checkpoint's
        training ``data``; ``images`` may also be a split on disk (a
        directory, a ``.txt`` list), its label files beside it.
        ``single_cls`` (default: the checkpoint's train setting, as JAX's
        facade keeps it) reads every label as class 0. The validator, with
        its ``speed``, stays at ``self.validator``."""
        if images is None:
            data = data or self.overrides.get("data")
            if not data:
                raise ValueError("val needs images and labels, or data (a dataset yaml)")
            check = check_cls_dataset if self.task == "classify" else check_det_dataset
            images, labels = check(data)["val"], None
        kw = dict(imgsz=imgsz or self.imgsz, batch=batch)
        if self.task != "classify":
            if single_cls is None:
                single_cls = bool(self.overrides.get("single_cls", False))
            kw.update(conf=conf, iou=iou, max_det=max_det, pre_nms=pre_nms, single_cls=single_cls)
        if self.task == "segment":
            kw["mask_ratio"] = mask_ratio
        self.validator = TASK_MAP[self.task]["validator"](**kw)
        return self.validator(self._weights(), images, labels, names=self.names)

    def fuse(self) -> "YOLO":
        """The deploy form, in place (``nn/fuse.py:fuse_model``): every Conv,
        Conv2 and RepConv folded with its BatchNorm into one conv (a Linear
        stays as it is). A no-op on a fused model; the model no longer
        trains."""
        fuse_model(self._weights())
        return self

    def save(self, path="model.ckpt") -> Path:
        """The facade's current weights (fused ones too: ``deploy ==
        "fused"``) as a checkpoint of the JAX package's format, which
        ``YOLO(path)`` here or in the JAX package loads (JAX's ``save``:
        no EMA, no optimizer state, step 0, epoch -1; ``train_args`` the
        task and the facade's overrides)."""
        model = self._weights()
        params, batch_stats = to_jax_variables(model.state_dict())
        return save_checkpoint(path, params, batch_stats, None, step=0, epoch=-1,
                               best_fitness=0.0, train_args={"task": self.task, **self.overrides},
                               model_yaml=model.yaml, names=dict(self.names or {}),
                               deploy="fused" if model.fused else None)

    def load(self, weights) -> "YOLO":
        """Load a checkpoint into this facade, on its device (JAX's
        ``load``)."""
        self._load(weights)
        return self

    def reset_weights(self) -> "YOLO":
        """Fresh weights for the model, drawn as the trainer draws them
        from seed 0 (``nn/tasks.py:init_weights``)."""
        model = self._weights()
        init_weights(model.to("cpu"), torch.Generator().manual_seed(0))
        model.to(self.device)
        return self

    def to(self, device) -> "YOLO":
        """Move the model to ``device`` (which predict, val and the trainer
        then use)."""
        self._device_arg = device
        self.device = torch.device(device[0] if isinstance(device, (list, tuple)) else device)
        if self.model is not None:
            self.model.to(self.device)
        return self

    def info(self, detailed: bool = False, imgsz: int = 640) -> Dict:
        """JAX's ``info``: the layer count and the parameter count, and with
        ``detailed`` a row a layer (index, from, module, parameters, output
        channels, arguments); ``imgsz`` is JAX's, unused here. A fresh
        config's facade counts a model built for the purpose."""
        model = self.model
        if model is None:
            model = build_model(yaml_model_load(self.overrides["model"]))
        out = {"layers": len(model.specs), "parameters": model.num_params}
        LOGGER.info(f"{type(model).__name__}: task={self.task}, {out['layers']} layers, "
                    f"{out['parameters']:,} params, strides={model.strides}")
        if detailed:
            rows = []
            for spec, layer in zip(model.specs, model.model):
                kwargs = _jax_kwargs(spec)
                n_p = sum(p.numel() for p in layer.parameters())
                rows.append({"i": spec.i, "from": spec.f, "module": spec.name, "params": n_p,
                             "c2": spec.c2, "kwargs": kwargs})
                LOGGER.info(f"{spec.i:>4} {str(spec.f):>10} {n_p:>12,}  {spec.name}({kwargs})")
            out["layers_detail"] = rows
        return out

    def add_callback(self, event: str, func: Callable):
        """A callback for the next trainer this facade builds."""
        self._callbacks.setdefault(event, []).append(func)

    def clear_callback(self, event: str):
        self._callbacks.pop(event, None)

    def reset_callbacks(self):
        self._callbacks = {}

    def tune(self, data, iterations: int = 10, epochs: int = 10, **kwargs):
        """The evolutionary hyperparameter search (``utils/tuner.py:Tuner``)
        over this facade's model config: ``iterations`` trainings of
        ``epochs`` epochs each on ``data`` -> (the best hyperparameters,
        their fitness)."""
        from ..utils.tuner import Tuner

        model = self.overrides.get("model") or self.ckpt_path or "yolov8n-seg.yaml"
        return Tuner(model, device=self._device_arg)(data, iterations=iterations, epochs=epochs,
                                                     **kwargs)
