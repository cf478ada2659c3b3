"""The trainers of the segment, detect, pose, segment_ori, classify and
rtdetr tasks (counterparts of ``SegmentationTrainer``, ``DetectionTrainer``,
``PoseTrainer``, ``SegmentationOriTrainer``, ``ClassificationTrainer`` and
``RTDETRTrainer`` in the JAX package's ``engine/trainer.py`` and
``engine/model.py``: its single-device path, one optimizer step per
dispatch).

``SegmentationTrainer(overrides=..., device="cuda").train(data)`` trains a
fresh polar segmentation model, ``DetectionTrainer`` a fresh detect model,
``PoseTrainer`` a fresh keypoint model, ``SegmentationOriTrainer`` a fresh
proto-mask segmentation model, ``ClassificationTrainer`` a fresh classify
model, ``RTDETRTrainer`` a fresh RT-DETR (the task is the ``task``
override's, else the model config's head's, and must be the trainer's):
the model built from ``args.model`` at ``nc = len(data["names"])`` and
initialized from ``args.seed`` (``nn/tasks.py:init_weights``); gradient
accumulation toward ``nbs``; AdamW or SGD with the JAX schedules and the EMA
(``utils/optim.py``). Each epoch ends with a validation (the task's
validator) of the EMA weights with the live BatchNorm statistics, on a copy
of the model in eval mode (the training model is left as it is), a
``results.csv`` row in the JAX columns, ``last.ckpt`` and ``best.ckpt`` on
the JAX cadence (written at once, not in a thread), and early stopping. At
the end ``best.ckpt`` and ``last.ckpt`` are stripped (EMA -> params) and the
stripped ``best.ckpt`` is validated again; its metrics are returned.

The train data takes one of two paths, by JAX's rule
(``data/build.py:use_device_augment``):

- the device path (``device_augment`` on, a detect-family task, no
  ``mosaic9`` and no ``copy_paste``): the train set letterboxed on the host
  (``data/dataset.py:TrainDataset``) and batched by worker threads
  (``data/build.py:TrainLoader``); mosaic, the affine warp, MixUp, HSV and
  the flips on the device inside the step (``data/device_augment.py``),
  with ``mosaic`` and ``mixup`` turned off for the last ``close_mosaic``
  epochs;
- the host path (everything else, RT-DETR always): JAX's host chain
  (``data/augment.py:train_transform``) in ``TrainDataset`` with
  ``device_augment=False``, its draws from ``random.Random(seed)``, read in
  batch order by ``TrainLoader(..., in_order=True)``; uint8 images, one
  copy to the device a batch, ``/ 255`` there; ``train_set.close_mosaic()``
  for the last ``close_mosaic`` epochs (the loader's batches already made
  keep their mosaics, as in JAX). Classify's is its own: the fork's
  grayscale transforms in ``ClassificationDataset`` (brightness from
  ``random.Random(seed)``, noise from ``numpy.random.default_rng(seed)``),
  float images.

``data`` is a dataset yaml's path (``data/utils.py:check_det_dataset``;
for classify a root of ``train/`` and ``val/`` class folders,
``check_cls_dataset``): the splits are read from disk, the images decoded
by ``data/imcodec.py``, their resized copies kept with ``cache``. Or it
holds the splits: ``{"train": (images, labels), "val": (images, labels),
"names": {0: "...", ...}}``, images HWC uint8 BGR, labels as
``data/dataset.py:ValDataset`` takes them (for classify the labels are
class indices); a split may also be a path on disk (``"train":
"images/train"``). A pose set adds ``"kpt_shape": [K, D]``, which overrides
the model config's (as the JAX trainer takes the data yaml's), and
optionally ``"flip_idx"``, the keypoint permutation of a horizontal flip,
which goes to the augmentation as ``args.flip_idx``.

Devices and data parallelism (JAX's trainer trains on every visible chip):
``device`` is one device, a list of devices, or ``"cuda"`` for every visible
card; the trainer uses the largest count of them that divides ``batch``
(``parallel/mesh.py:build_train_mesh``). On one device nothing below
changes and no process group is made. On W > 1 devices ``train`` spawns W
ranks (``parallel.launch``: NCCL on distinct cards, gloo on the CPU), each a
trainer of this class on its device; under ``torchrun`` (a group in the
environment, ``initialize_distributed``) this process is one rank. Each rank
renders its rows of every global batch (``TrainLoader(rank, world)``), the
padded instance axis widened to the global batch's, and steps on them
(``engine/step.py``: the BatchNorm statistics, loss normalizers, gradient
and loss items are the global batch's). Rank 0 alone validates the EMA,
writes ``results.csv`` and the checkpoints; the fitness goes from it to
every rank, so early stopping stops all at one epoch, and the others wait
at a barrier while it saves. The caller gets rank 0's metrics and epoch
times; ``mark`` and ``dn_fn`` stay in the calling process (they do not
cross to spawned ranks). ``tp > 1`` raises: tensor parallelism is not
ported.

Detect batches carry the label files' segments as the JAX dataset does (its
``use_segments`` is stored and never read): a polygon label's instance is
warped by its contour, a box label's (zero segments) by its box corners.

Not ported (raising ``NotImplementedError`` where asked for): ``resume``, the
other families. Without effect: ``plots`` (the JAX plots need cv2), the
multi-step dispatch and ``cache`` options, the integration callbacks.

Timing: ``mark`` goes to the step (its stages, "augment" first on the device
path) and is called with "copy" as a batch is copied to the device;
``epoch_times`` holds each epoch's host-clock seconds: the train steps, the
wait for the loader within them, the validation and the save. ``dn_fn``
goes to the RT-DETR step (``engine/step.py``).
"""
from __future__ import annotations

import copy
import csv
import logging
import math
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..cfg import get_cfg
from ..data.augment import INSTANCE_KEYS
from ..data.build import TrainLoader, use_device_augment
from ..data.dataset import ClassificationDataset, TrainDataset
from ..data.device_augment import make_augment_fn
from ..data.utils import check_cls_dataset, check_det_dataset
from ..models.rtdetr.val import RTDETRValidator
from ..nn.tasks import TaskModel, build_model, guess_model_task, init_weights, yaml_model_load
from ..parallel.mesh import (TP_NOT_PORTED, all_max, barrier, broadcast_float, build_train_mesh,
                             initialize_distributed, launch, rank, resolve_devices, world_size)
from ..utils.checkpoint import (checkpoint_variables, load_checkpoint, load_jax_variables, plain,
                                save_checkpoint, strip_optimizer, to_jax_variables)
from ..utils.optim import build_optimizer
from .step import init_train_state, make_train_step
from .validator import (ClassificationValidator, DetectionValidator, PoseValidator,
                        SegmentationOriValidator, SegmentationValidator)

LOGGER = logging.getLogger(__name__)


class EarlyStopping:
    """Stop once ``patience`` epochs passed without a fitness at least as
    good as the best (reference ``torch_utils.py:EarlyStopping``)."""

    def __init__(self, patience: int = 50):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        return (epoch - self.best_epoch) >= self.patience


def schedule(n_images: int, batch: int, nbs: int, epochs: int):
    """(accumulate, steps_per_epoch, iterations) as the JAX trainer counts
    them: micro-batches toward the nominal batch ``nbs``, at most one
    epoch's loader batches (drop_last), and optimizer steps."""
    micro = max(n_images // batch, 1)
    accumulate = min(max(round(nbs / batch), 1), micro)
    steps_per_epoch = max(micro // accumulate, 1)
    return accumulate, steps_per_epoch, steps_per_epoch * epochs


def pad_instances(batch: Dict[str, np.ndarray], n: int, axis: int = 1) -> Dict[str, np.ndarray]:
    """The padded instance axis (``axis``) of a batch's instance keys
    widened to ``n`` with zeros (invalid instances)."""
    for k in (k for k in INSTANCE_KEYS if k in batch):
        pad = n - batch[k].shape[axis]
        if pad > 0:
            widths = [(0, 0)] * batch[k].ndim
            widths[axis] = (0, pad)
            batch[k] = np.pad(batch[k], widths)
    return batch


def stack_raw_batches(data_iter, n: int):
    """``n`` loader batches stacked into (n, B, ...) arrays, for gradient
    accumulation; the instance axis of each padded to the group's largest
    (the collate buckets differ between batches; classify batches have
    none)."""
    micro = [next(data_iter) for _ in range(n)]
    if "mask_gt" in micro[0]:
        n_max = max(m["mask_gt"].shape[1] for m in micro)
        micro = [pad_instances(m, n_max) for m in micro]
    images = np.stack([m.pop("img") for m in micro])
    return images, {k: np.stack([m[k] for m in micro]) for k in micro[0]}


def _split(data: Dict, name: str) -> tuple:
    """A split of ``data`` as the datasets take it: ``(images, labels)``,
    or a path on disk with its label files beside it."""
    v = data[name]
    return (v, None) if isinstance(v, (str, Path)) else tuple(v)


def _train_rank(r: int, device, cls, overrides: Dict, data) -> Dict:
    """One rank of a data-parallel run (``parallel.launch``'s target): a
    trainer of ``cls`` on ``device``, inside the group."""
    trainer = cls(overrides=overrides, device=device)
    metrics = trainer.train(data)
    return {"metrics": metrics, "epoch_times": trainer.epoch_times,
            "best_fitness": trainer.best_fitness}


def _no_mark(stage: str):
    pass


class BaseTrainer:
    """The trainer: see the module docstring. A task's trainer gives
    ``task``, its default model config and its validator's class."""

    task = ""
    default_model = ""
    validator_cls = DetectionValidator

    def __init__(self, overrides: Optional[Dict] = None, device="cuda",
                 mark: Optional[Callable[[str], None]] = None,
                 dn_fn: Optional[Callable] = None):
        overrides = dict(overrides or {})
        model = overrides.get("model") or self.default_model
        cfg = yaml_model_load(model) if isinstance(model, (str, Path)) else model
        task = overrides.pop("task", None) or guess_model_task(cfg)
        if task != self.task:
            raise NotImplementedError(f"task {task!r} is not this trainer's ({self.task!r})")
        self._overrides = overrides  # a spawned rank's trainer takes them
        self.args = get_cfg(None, overrides)
        self.args.task = self.task
        if int(self.args.tp or 1) > 1:
            raise NotImplementedError(f"tp={self.args.tp}: {TP_NOT_PORTED}")
        if self.args.resume:
            raise NotImplementedError("resume is not ported: the port's optimizer state has no "
                                      "form in the checkpoint")
        # the device augmentation, else the host chain
        self.device_augment = use_device_augment(self.args)
        self._device_arg = device
        self.device = torch.device(device[0] if isinstance(device, (list, tuple)) else device)
        self.mark = mark or _no_mark
        self.dn_fn = dn_fn
        name = self.args.name or f"{self.task}_train"
        project = Path(self.args.project or "runs")
        self.save_dir = project / name
        i = 1
        while self.save_dir.exists() and not self.args.exist_ok:
            self.save_dir = project / f"{name}{i}"
            i += 1
        self.wdir = self.save_dir / "weights"
        self.csv = self.save_dir / "results.csv"
        self.metrics: Dict[str, float] = {}
        self.best_fitness = 0.0
        self.epoch_times = []
        self._last_saved_epoch = -1

    def build_model(self, nc: int, names, data: Optional[Dict] = None) -> TaskModel:
        cfg = self.args.model or self.default_model
        cfg = yaml_model_load(cfg) if isinstance(cfg, (str, Path)) else copy.deepcopy(dict(cfg))
        if self.task == "pose" and (data or {}).get("kpt_shape"):
            cfg["kpt_shape"] = [int(v) for v in data["kpt_shape"]]
        model = build_model(cfg, nc=nc)
        model.names = dict(names)
        return init_weights(model, torch.Generator().manual_seed(int(self.args.seed)))

    def get_data(self, data) -> Dict:
        """``data`` resolved: a yaml path by ``check_det_dataset``, a dict
        as it is."""
        return check_det_dataset(data) if isinstance(data, (str, Path)) else data

    def train(self, data) -> Dict[str, float]:
        """Train on ``data`` (see the module docstring) on this trainer's
        devices; returns the final validation of ``best.ckpt`` (rank 0's)."""
        if isinstance(data, (str, Path)):
            self.args.data = str(data)
        if initialize_distributed():  # one rank of a group (launched, or torchrun)
            return self._train(data)
        devices = resolve_devices(self._device_arg)
        mesh = build_train_mesh(devices, self.args.batch, self.args.tp)
        if mesh.size < len(devices):
            LOGGER.warning(f"batch {self.args.batch} uses {mesh.size} of {len(devices)} devices")
        if mesh.size == 1:  # self.device: the first of the devices
            return self._train(data)
        # the ranks write to this trainer's save_dir
        overrides = {**self._overrides, "project": str(self.save_dir.parent),
                     "name": self.save_dir.name, "exist_ok": True}
        out = launch(_train_rank, mesh.devices, args=(type(self), overrides, data))[0]
        self.metrics, self.epoch_times = out["metrics"], out["epoch_times"]
        self.best_fitness = out["best_fitness"]
        return self.metrics

    def _train(self, data) -> Dict[str, float]:
        args = self.args
        data = self.get_data(data)
        r, world = rank(), world_size()
        if args.batch % world:
            raise ValueError(f"batch {args.batch} does not split over {world} ranks")
        names = dict(data["names"])
        args.nc = len(names)
        self.model = model = self.build_model(args.nc, names, data)
        max_inst = int(args.max_instances)
        if self.task == "pose" and data.get("flip_idx"):
            args.flip_idx = tuple(int(v) for v in data["flip_idx"])
        train_set = self.get_dataset(data)
        loader = TrainLoader(train_set, args.batch, args.workers, seed=args.seed,
                             in_order=not self.device_augment, rank=r, world=world)
        accumulate, steps_per_epoch, iterations = schedule(
            len(train_set), args.batch, args.nbs, args.epochs)
        args.accumulate = accumulate
        optimizer = build_optimizer(model, args, steps_per_epoch, iterations)
        state = init_train_state(model, optimizer, device=self.device)

        def build_step(hyp):
            aug = make_augment_fn(hyp, args.imgsz, max_inst) if self.device_augment else None
            return make_train_step(model, optimizer, args, cand=args.cand_per_gt,
                                   accumulate=accumulate, mark=self.mark, augment_fn=aug,
                                   aug_seed=args.seed, amp=bool(args.amp), dn_fn=self.dn_fn)

        step_fn = build_step(args)
        # rank 0 validates
        self.validator = validator = self.get_validator() if args.val and r == 0 else None
        # the EMA is validated on this copy, in eval mode
        self.eval_model = copy.deepcopy(model).eval() if validator is not None else None
        stopper = EarlyStopping(args.patience)
        LOGGER.info(f"train: {len(train_set)} imgs, {steps_per_epoch} steps/epoch, "
                    f"accumulate {accumulate}, batch {args.batch}, imgsz {args.imgsz}, "
                    f"{self.device}")

        close_mosaic_at = args.epochs - args.close_mosaic
        data_iter = iter(loader)
        t_train = time.perf_counter()
        try:
            for epoch in range(args.epochs):
                if epoch == close_mosaic_at:
                    LOGGER.info("closing mosaic augmentation")
                    if hasattr(train_set, "close_mosaic"):
                        train_set.close_mosaic()
                    if self.device_augment:
                        hyp = copy.copy(args)
                        hyp.mosaic, hyp.mixup = 0.0, 0.0
                        step_fn = build_step(hyp)
                epoch_metrics: Dict[str, float] = {}
                t0 = time.perf_counter()
                wait = 0.0
                for i in range(steps_per_epoch):
                    t = time.perf_counter()
                    if accumulate > 1:
                        images, batch = stack_raw_batches(data_iter, accumulate)
                    else:
                        batch = next(data_iter)
                        images = batch.pop("img")
                    if world > 1 and "mask_gt" in batch:  # the global batch's instance pad
                        axis = batch["mask_gt"].ndim - 1
                        pad_instances(batch, all_max(batch["mask_gt"].shape[axis], self.device),
                                      axis)
                    wait += time.perf_counter() - t
                    self.mark("copy")
                    images = torch.from_numpy(images).to(self.device)
                    if not self.device_augment and images.dtype == torch.uint8:
                        images = images.float() / 255.0  # the host chain's RGB
                    batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
                    metrics = step_fn(state, images, batch)
                    if i == steps_per_epoch - 1 or i % 50 == 0:
                        epoch_metrics = {k: float(v) for k, v in metrics.items()}
                        if not math.isfinite(epoch_metrics["loss"]):
                            raise FloatingPointError(
                                f"non-finite loss at epoch {epoch} step {i}: {epoch_metrics}")
                times = {"epoch": epoch, "train_s": time.perf_counter() - t0,
                         "loader_wait_s": wait}
                log = {f"train/{k}": epoch_metrics[k] for k in sorted(epoch_metrics)}
                LOGGER.info(f"epoch {epoch + 1}/{args.epochs}  "
                            + "  ".join(f"{k[6:]} {v:.3f}" for k, v in log.items()))
                fitness = self._epoch_tail(state, epoch, log, data, times)
                self.epoch_times.append(times)
                if stopper(epoch, fitness):
                    LOGGER.info(f"early stopping at epoch {epoch + 1} (patience {args.patience})")
                    if args.save and self._last_saved_epoch != epoch and r == 0:
                        self._save(state, epoch, fitness)
                    break
        finally:
            data_iter.close()  # stops the loader's worker threads

        LOGGER.info(f"training done in {time.perf_counter() - t_train:.1f} s")
        best, last = self.wdir / "best.ckpt", self.wdir / "last.ckpt"
        if args.save and best.exists() and r == 0:
            strip_optimizer(best)
            strip_optimizer(last)
            if validator is not None:
                # the returned metrics describe the stripped best.ckpt
                load_jax_variables(self.eval_model, *checkpoint_variables(load_checkpoint(best)))
                self.metrics = validator(self.eval_model, *_split(data, "val"), names=names)
        self.state = state
        return self.metrics

    def get_dataset(self, data: Dict):
        """The train set: ``TrainDataset``, letterboxed raw samples for the
        device augmentation, or the host chain's samples, its draws seeded
        by ``args.seed``; ``args.single_cls`` and ``args.fraction`` taken as
        JAX's ``build_yolo_dataset`` takes them."""
        args = self.args
        return TrainDataset(*_split(data, "train"), imgsz=args.imgsz,
                            max_instances=int(args.max_instances), cache=bool(args.cache),
                            kpt_shape=getattr(self.model, "kpt_shape", None), hyp=args,
                            device_augment=self.device_augment, seed=int(args.seed),
                            flip_idx=getattr(args, "flip_idx", None),
                            single_cls=bool(args.single_cls), fraction=float(args.fraction))

    def get_validator(self):
        args = self.args
        kw = dict(imgsz=args.imgsz, batch=args.batch,
                  conf=0.001 if args.conf is None else args.conf, iou=args.iou,
                  max_det=args.max_det, pre_nms=args.pre_nms,
                  max_instances=int(args.max_instances), single_cls=bool(args.single_cls))
        if self.task == "segment":
            kw["mask_ratio"] = args.val_mask_ratio
        return self.validator_cls(**kw)

    def _epoch_tail(self, state, epoch: int, log: Dict[str, float], data, times) -> float:
        """EMA validation -> fitness -> csv row -> checkpoint; returns this
        epoch's fitness (rank 0's, on every rank)."""
        args = self.args
        fitness = 0.0
        t = time.perf_counter()
        if self.validator is not None:
            with torch.no_grad():
                for n, p in self.eval_model.named_parameters():
                    p.copy_(state.ema[n])
                for (_, b), (_, src) in zip(self.eval_model.named_buffers(),
                                            state.model.named_buffers()):
                    b.copy_(src)
            vm = self.validator(self.eval_model, *_split(data, "val"), names=self.model.names)
            log.update(vm)
            fitness = vm.get("fitness", 0.0)
            self.metrics = vm
        times["val_s"] = time.perf_counter() - t
        fitness = broadcast_float(fitness, 0, self.device)
        if fitness >= self.best_fitness:
            self.best_fitness = fitness
        main = rank() == 0
        if main:
            self._write_csv(epoch, log)
        t = time.perf_counter()
        if args.save and main:
            every = max(1, int(args.save_last_every or 1))
            improved = fitness >= self.best_fitness and fitness > 0
            periodic = args.save_period > 0 and (epoch + 1) % args.save_period == 0
            if improved or periodic or (epoch + 1) % every == 0 or epoch + 1 == args.epochs:
                self._save(state, epoch, fitness)
        barrier()  # the other ranks wait while rank 0 saves
        times["save_s"] = time.perf_counter() - t
        return fitness

    def _save(self, state, epoch: int, fitness: float):
        params, batch_stats = to_jax_variables(state.model.state_dict())
        ema, _ = to_jax_variables(state.ema)
        paths = [self.wdir / "last.ckpt"]
        if fitness >= self.best_fitness:
            paths.append(self.wdir / "best.ckpt")
        if self.args.save_period > 0 and (epoch + 1) % self.args.save_period == 0:
            paths.append(self.wdir / f"epoch{epoch + 1}.ckpt")
        train_args = {k: plain(v) for k, v in vars(self.args).items() if not callable(v)}
        for p in paths:
            save_checkpoint(p, params, batch_stats, ema, step=state.step, epoch=epoch,
                            best_fitness=self.best_fitness, train_args=train_args,
                            model_yaml=self.model.yaml, names=self.model.names)
        self._last_saved_epoch = epoch

    def _write_csv(self, epoch: int, metrics: Dict[str, float]):
        self.csv.parent.mkdir(parents=True, exist_ok=True)
        exists = self.csv.exists()
        with open(self.csv, "a", newline="") as fh:
            w = csv.writer(fh)
            if not exists:
                w.writerow(["epoch"] + list(metrics.keys()))
            w.writerow([epoch] + [f"{v:.5f}" for v in metrics.values()])


class SegmentationTrainer(BaseTrainer):
    task = "segment"
    default_model = "yolov8n-seg.yaml"
    validator_cls = SegmentationValidator


class DetectionTrainer(BaseTrainer):
    task = "detect"
    default_model = "yolov8n.yaml"


class PoseTrainer(BaseTrainer):
    task = "pose"
    default_model = "yolov8n-pose.yaml"
    validator_cls = PoseValidator


class SegmentationOriTrainer(BaseTrainer):
    task = "segment_ori"
    default_model = "yolov8n-segori.yaml"
    validator_cls = SegmentationOriValidator


class RTDETRTrainer(BaseTrainer):
    """RT-DETR: always the host path (its task is not a device-augment one),
    the RT-DETR step and validator."""

    task = "rtdetr"
    default_model = "yolov8n-rtdetr.yaml"
    validator_cls = RTDETRValidator


class ClassificationTrainer(BaseTrainer):
    task = "classify"
    default_model = "yolov8n-cls.yaml"

    def get_data(self, data) -> Dict:
        """``data`` resolved: a root of class folders by
        ``check_cls_dataset``, a dict as it is."""
        return check_cls_dataset(data) if isinstance(data, (str, Path)) else data

    def get_dataset(self, data: Dict):
        """The train set: ``ClassificationDataset`` with the train
        transforms, its draws seeded by ``args.seed``."""
        return ClassificationDataset(*_split(data, "train"), imgsz=self.args.imgsz, augment=True,
                                     seed=int(self.args.seed))

    def get_validator(self):
        return ClassificationValidator(imgsz=self.args.imgsz, batch=self.args.batch)
