#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one timestamped line each (elapsed seconds):
  1. device: fail without CUDA (there is no CPU path); print the card's name
     and power limit; turn TF32 off for convolutions and matmuls, so the
     card computes in full float32 like the CPU it is compared with.
  2. build: nvcc every kernel of the port from ``csrc/``, one process per
     source, all started together (timed).
  3. kernels: each kernel's wrapper against its plain PyTorch version on the
     card, at the main paths' shapes, with its time, the plain version's
     time and the card's least time for the same work (its bound): both
     polygon fills (even-odd, and the facade's cv2 rule) at the predict
     path's masks, the even-odd one also on the validator's 640x640 grid,
     with the edge cases of ``raster_inputs``, and at the segment_ori GT
     masks' shapes (N=128 and N=768 360-point contours on the 160x160 proto
     grid, ``segori_fill_inputs``), each with the
     device kernels one call launches (``torch.profiler``); the GT rays,
     rows form, at the train path's shapes (imgsz 640, batch 16, N_pad 8
     -> K 128 and N_pad 48 -> K 48; the trainer's augmented batches, N_pad
     32 -> K 48), and per pair at P 16,384, each with
     its device kernels, then both entries on ``ray_scenes``' hard cases
     and the GT-ray kernel's own per-phase clock (``gt_rays_phases``);
     atan2f's instruction count from ``cuobjdump -sass`` (a probe built with
     the kernels' flags) and the share of the GT-ray bound it leaves.
  4. predict: ``YOLO(runs/floor_seg160/best.ckpt).predict`` on synthetic
     circle/rectangle images at imgsz 160 (batch 1) and 640 (batch 8),
     reading every result's masks; launch counts are zeroed just before and
     read just after. Then the masks of the 640 phase are split into their
     steps (copies, kernels, numpy), each timed apart, and the card's head
     outputs, detections and scores are held against the port on the CPU
     at imgsz 160 (``card_vs_cpu_predict``).
  5. validate: (a) ``YOLO(runs/floor_seg160/best.ckpt).val`` on the seg160
     floor set (16 decoded val images, ``tests/data/``) at imgsz 160, batch
     4: its mask and box mAP50-95 must meet ``floor.json``; the first
     batch's eval outputs on the card against the port on the CPU
     (``compare_eval``), and ``polygon_mask_iou`` (the even-odd fill kernel
     and a product) against its plain version: 0 differing IoUs. (b) The
     validator at full width, imgsz 640, batch 16, on 32 480x640 frames:
     launches, peak device memory and ms per image split into host
     preprocess, forward + NMS, scale + box IoU, mask IoU and host matching.
     Launch counts are zeroed just before each run and read just after.
  6. train: (a) the seg160 model at imgsz 160, batch 4: one loss, the
     assignment and every gradient on the card against the CPU; (b) the
     same model at full width, imgsz 640, batch 16: 3 warm-up steps of
     ``make_train_step`` with AdamW, then 20 timed steps on one repeated
     batch (launch counts zeroed just before and read just after; the loss
     must stay finite and fall), each split by CUDA events at the step's
     own stage marks into forward, assigner (and the GT-ray kernel in it),
     loss, backward and clip + optimizer + EMA; (c) ``save_checkpoint`` of
     the trained state and ``YOLO(path).predict`` from it.
  7. the trainer: (a) ``train_floor``: ``YOLO("yolov8n-seg.yaml").train``
     from scratch on the seg160 floor set (64 train, 16 val images,
     ``tests/data/``) at the ``floor.json`` config, 120 epochs at imgsz 160
     batch 16 with the augmentation on the card; the stripped
     ``best.ckpt`` must meet the floor, and predict from it must find
     detections; (b) ``train_640``: the default config at imgsz 640 batch
     16 for 5 epochs on 256 480x640 frames. Each prints its metrics, wall
     time, the epoch split on the host clock (train steps, loader wait,
     validation, save) and the step split by CUDA events at the step's
     marks (copy, augment, forward, assigner, GT rays, loss, backward,
     clip + optimizer + EMA); launch counts zeroed just before each, read
     just after.
  8. fuse: ``YOLO(floor checkpoint).fuse()`` on the card for seg160,
     floor_detect and floor_pose, each against the unfused model on the card (head maps
     1e-3, the same detections) and validated on its floor set (each
     metric within 0.01 of the unfused model's, and the floor); launch
     counts zeroed just before the fused validation and read just after
     (the seg160 one launches the even-odd fill).
  9. detect predict: ``YOLO(runs/floor_detect/best.ckpt).predict`` at imgsz
     96 batch 1 on the detect floor images and at 640 batch 8 on 480x640
     frames (ms per image), and the card against the port on the CPU at 96
     (head 1e-3, the same detections, boxes 0.05 px, scores 1e-4).
  10. detect validate: (a) the detect floor set at 96 batch 4: box
     mAP50-95 at least ``floor.json``'s and each metric within 0.01 of the
     JAX validator's (stored with the set); (b) the validator at 640 batch
     16 on 32 frames, split as in 5 (b) without the mask IoU.
  11. detect train step: as 6 (a) at imgsz 96 and 6 (b) at 640 batch 16,
     for yolov8n from the floor_detect checkpoint.
  12. detect trainer: ``YOLO("yolov8n.yaml").train`` from scratch on the
     detect floor set at its ``floor.json`` config (100 epochs at 96, batch
     16), as 7 (a): the stripped ``best.ckpt`` must meet the detect floor.
  13. pose predict: ``YOLO(runs/floor_pose/best.ckpt).predict`` at imgsz
     96 batch 1 on the pose floor images, and yolov8n-pose at full width
     (nc 1, 17 keypoints, a fresh init from a seed) at 640 batch 8 on
     480x640 frames: keypoints (n, K, 3) and finite, ms per image; the
     floor model on the card against the port on the CPU at 96 (heads 1e-3,
     the same detections, boxes and keypoints 0.05 px, scores and
     visibilities 1e-4).
  14. pose validate: (a) the pose floor set at 96 batch 4: pose and box
     mAP50-95 at least ``floor.json``'s and each of the eight metrics and
     fitness within 0.01 of the JAX validator's (stored with the set); (b)
     the full-width model at 640 batch 16 on 32 480x640 frames with 17
     keypoints an instance along each contour, split as in 10 (b).
  15. pose train step: as 6 (a) at imgsz 96 on the floor_pose checkpoint,
     and 6 (b) at 640 batch 16 for the full-width model (K 17), batches
     with keypoints along each contour.
  16. pose trainer: ``YOLO("yolov8n-pose.yaml").train`` from scratch on the
     pose floor set (``kpt_shape`` [5, 3] and ``flip_idx`` from its data)
     at its ``floor.json`` config (150 epochs at 96, batch 16), as 7 (a):
     the stripped ``best.ckpt`` must meet the pose floor (pose and box
     mAP50-95) and predict keypoints. The pose phases launch no kernel: their
     counts are printed, all 0.
  17. segment_ori predict: the fresh full-width yolov8n-segori (nc 2, a
     seeded init) on 480x640 frames at 640, batch 1 and 8, conf 0.001,
     every result's masks (n, 480, 640); ms per image.
  18. segment_ori validate: that model at 640 batch 16 on 32 480x640
     frames, split as in 10 (b) with the mask IoU (the GT masks filled by
     the even-odd kernel, one launch a batch).
  19. segment_ori train step: as 6 (a) at 320 batch 2 N_pad 8, the
     networks in float64 (a fresh init's float32 gradients are
     ill-conditioned; card against CPU: loss 1e-4 relative, the same
     assignment, gradients 1e-3)
     and 6 (b) for that model: one fill launch a step.
  20. segment_ori trainer: ``YOLO("yolov8n-segori.yaml").train`` from
     scratch on the seg160 floor set at its config (120 epochs at 160), as
     7 (a) with its metrics recorded, not held (no segment_ori floor is
     committed); its best.ckpt on the card against the port on the CPU at
     160 (heads and prototypes, detections, boxes, scores; the masks'
     differing pixels printed), then fused on the card as in 8.
  21. classify: ``YOLO(runs/floor_classify/best.ckpt).val`` on the 32
     committed val images at 64: the JAX validator's metrics exactly, and
     the probabilities card against CPU within 1e-4; predict at 224, batch
     1 and 8 on 480x640 frames (ms per image); the fused model's
     probabilities within 1e-3 and its metrics the same;
     ``YOLO("yolov8n-cls.yaml").train`` from scratch at the floor.json
     config (60 epochs at 64 on the 96 committed train images) must meet
     the floor (top-1) and predict. Classify launches no kernel.
  22. rtdetr predict: ``YOLO(runs/floor_rtdetr/best.ckpt).predict`` at
     imgsz 192 batch 1 on the RT-DETR floor images, and yolov8n-rtdetr at
     full width (nc 2, a fresh init from a seed) at 640, batch 1 and 8, on
     480x640 frames (ms per image); the floor model on the card against the
     port on the CPU at 192: decoder outputs 1e-3 (the two sides' queries
     matched by encoder token, ``query_perm``), the same kept queries,
     boxes 0.05 px, scores 1e-4.
  23. rtdetr validate: (a) the RT-DETR floor set at 192 batch 4: box
     mAP50-95 at least ``floor.json``'s and each metric within 0.01 of the
     JAX validator's (stored with the set); (b) the full-width model at 640
     batch 16 on 32 frames, split as in 10 (b) (forward is the graph and the
     decoder; no NMS), and its peak memory.
  24. rtdetr train step: (a) floor_rtdetr at 192 batch 4 with one set of dn
     groups drawn on the CPU and used on both sides, card against CPU, the
     networks in float64 (in float32 the card's sums leave a neck
     BatchNorm bias 1.5e-3 apart): loss 1e-4 relative,
     every layer's assignment (as encoder tokens), gradients 1e-3 of each
     tensor's largest; (b) at 640 batch 16 with AdamW, as 6 (b),
     split into forward (the CDN draw in it), matching (the cost and the
     auction), loss, backward and clip + optimizer + EMA, with the auction's
     rounds and host syncs a step, then one step's device kernels by name
     (``torch.profiler``).
  25. rtdetr fuse: the fused floor model against the unfused on the card
     (decoder outputs 1e-3, the same kept queries) and validated on the
     floor set (each metric within 0.01, and the floor). RT-DETR launches
     no kernel: each phase's counts are printed and must be 0.
  26. host pipeline: the host train chain (``data/augment.py``) timed on
     the host, ms a sample for each transform at imgsz 160 (the seg160 set)
     and 640 (480x640 frames); then ``YOLO("yolov8n-seg.yaml").train`` from
     scratch on the seg160 set with ``device_augment=false``, ``mosaic9``
     0.5 and ``copy_paste`` 0.5 for 5 epochs at the floor config (launch
     counts zeroed just before, read just after): finite losses falling
     from epoch 1 to 5, a ``results.csv`` row an epoch, and the GT-ray and
     fill kernels launched.
  27. rtdetr trainer: ``YOLO("yolov8n-rtdetr.yaml").train`` from scratch on
     the RT-DETR floor set (64 train, 16 val images at 192,
     ``tests/data/``) at JAX's floor recipe (300 epochs, batch 16, AdamW
     lr0 2e-4, warmup 2, no mosaic or MixUp, on the host chain): the
     stripped ``best.ckpt`` must meet ``runs/floor_rtdetr/floor.json``;
     metrics, wall and the train / val / save split printed.
  28. rtdetr-l: the fresh rtdetr-l (nc 80, a seeded init) on the card:
     predict at 640, batch 1 and 8, against the port on the CPU (queries
     matched by encoder token), one train step at 256 batch 2 in float64
     against the CPU, fused against unfused; its parameters, ms an image,
     peak memory and launches (0).
  29. sam: sam_b at 1024 on seeded weights (``sam_model``: relative
     positions drawn) on a 480x640 frame: ``set_image`` and ``predict``
     with a point, a box, and a point with the previous low-res logits as
     the mask prompt, card against CPU (embeddings 1e-4 of their largest,
     low-res logits and IoU 1e-3, masks equal but at pixels within 1e-4 of
     the threshold, counted); JAX's parameter count; the encoder's ms at
     batch 1 and the decoder's for 1 and 64 prompts by CUDA events, the
     CPU's set_image seconds, the peak (``sam_phase``).
  30. mobile_sam: the same for the TinyViT encoder.
  31. sam_generate: everything mode with sam_b at 1024 on a frame of
     planted shapes, 1,024 prompts in batches of 64 (``SAM_GEN``: its
     thresholds keep masks of seeded weights, NMS off), crop_n_layers 0
     and 1 timed on the card, crop layer 0 held against the CPU on fewer
     prompts (points_stride 8): every kept mask paired at IoU >= 0.99,
     boxes within 1 px, scores 1e-4.
  32. fastsam: ``FastSAM(seg160 checkpoint)`` agnostic on the floor images,
     card against CPU, its box, point and everything prompts selecting the
     same masks, at ``boxes=True`` (the cv2-rule fill) and ``boxes=False``
     (the even-odd fill); both fills' launches > 0; a fresh yolov8s-seg
     (FastSAM's width) timed at 640, batch 1 and 8.
  33. nas: a fresh yolo_nas_s (nc 2, BatchNorm statistics calibrated):
     JAX's parameter count; card against CPU in float64 (heads, the same
     detections, boxes, scores; the fused copy), the facade's float32
     predict at 640 batch 1 and 8 (the same detections, boxes within 0.05
     px, ms an image), the fused float32 model's detections, classes and
     boxes, a float64 train step against the CPU at 320 batch 2, the train
     step at 640 batch 16 timed.
  34. nas_trainer: ``NAS("yolo_nas_s").train`` from scratch on the detect
     floor set at the detect floor recipe, cut to 10 epochs: losses fall,
     the metrics recorded (no NAS floor is committed). SAM and NAS launch
     no kernel: their counts are printed, all 0.
  35. configs: yolov3, yolov5n, yolov6n, yolov8n-det-rep, yolov8n-p2,
     yolov8n-p6 and yolov8n-pose-p6, each fresh from seed 0 at full width
     with JAX's parameter count: card against CPU at 640 (batch 1 for
     yolov3, else 2; heads 1e-3, the same detections at a confidence in a
     gap of the CPU's scores, boxes and keypoints 0.05 px, scores 1e-4), the
     fused model against the unfused one, ms an image at 640 batch 1 and 8
     and the peak memory; one train step of p2, p6 and pose-p6 (four
     levels) at 320 batch 2, card against CPU in float64. No kernel: the
     phase's counts must be 0.
  36. compare: the fork's headline, printed and not gated: ms an image on
     the card at 640, batch 1 and 8, of yolov8n-seg polar (contours, no
     masks) and yolov8n detect, fused and unfused, and seg / detect.
  37. serve: ``InferenceServer`` (``serve/``) on the card. The fused
     seg160 checkpoint at 160 on the 16 floor val frames (bucket 8, every
     bucket warmed) against the direct predictor at batch 8: the same
     counts and classes, boxes and contours within 1e-4 px, scores 1e-4,
     the masks read on both sides equal pixel for pixel (the cv2 fill's
     launches of the served path alone, zeroed before ``infer`` and read
     once its masks are read); the floor detect,
     pose, classify and rtdetr checkpoints and the committed narrow
     segment_ori one at bucket 2 against predict at batch 2, held the same
     way; a closed-loop load on yolov8n-seg at 640 on 480x640 frames
     (``max_batch`` 32, ``max_delay_ms`` 5) at concurrency 1, 8 and 32 for
     2 s each: p50/p95/p99 ms, rps, mean batch, padded rows, the warm-up ms
     of each bucket, the completion thread's overlap with the dispatcher
     (recorded, not limited); ``serve_http`` on port 0: the committed JPEG
     and PNG files (``tests/data/torch_port_serve_*``) posted, their
     decodes byte-equal to the committed cv2 decodes, each reply's rows
     held to ``tojson`` of a direct predict, ``/stats``, ``/healthz``, a
     404 and the 400s; two synthetic captures through ``LoadStreams`` (one
     batch-2 forward a step) held to a predict of each frame (its launches
     counted alone); the host decode ms of a 480x640 JPEG (quality 95) and
     PNG and of the posted files; a closed loop of 8 clients posting the
     480x640 JPEG to ``serve_http`` at 640 for 4 s: rps, client p50/p95/p99
     and the cap that the Python decode puts on one process (recorded).
  38. ddp: (a) ``YOLO("yolov8n-seg.yaml").train`` on the seg160 floor set
     for 2 epochs at its config (``save_period=1``), with no process group
     and inside a one-rank NCCL group (an all-reduce through it first):
     metrics, results.csv and the stripped best.ckpt equal bit for bit
     (cuDNN deterministic for both); then the run without a group resumed
     from its ``epoch1.ckpt`` into a fresh trainer in its directory
     (``YOLO(epoch1.ckpt).train(resume=True)``): the restored weights,
     BatchNorm statistics, EMA, optimizer moments, step, best fitness and
     start epoch equal what was saved, bit for bit, the resumed first step
     fed the batch the uninterrupted run took there gives that run's
     weights, EMA and moments bit for bit, and results.csv carries on after
     the first run's rows; (b) two gloo ranks sharing ``cuda:0``
     (``parallel.launch``), each with 4 rows of a batch of 8 at 160, three
     float64 steps of the seg160 model against one process on all 8: loss
     1e-10 relative, gradients 1e-9 of each tensor's largest, BatchNorm
     statistics 1e-12, the ranks' states bit-identical after 3 steps; the
     GT-ray launches counted in each rank.
  39. serve_mesh: ``InferenceServer(mesh=create_mesh(["cuda:0", "cuda:0"]))``,
     two replicas of the fused seg160 weights, the 16 floor val frames in
     one bucket-16 batch (two shards of 8) against predict at batch 8: 0 px,
     0 score, masks equal.
  40. datasets: the seg160 and classify floor val sets written as PNG files
     (the smoke's own ``zlib`` writer) with label files, a yaml and class
     folders; ``val(data=yaml)`` and ``val(data=folder)`` give the in-memory
     metrics exactly.
  41. lifecycle: (c) Adam, NAdam, RAdam, Adamax and RMSProp, each 5
     updates of the seg160 model at 160 batch 4 in float64 on the card (the
     first step's loss and gradients against the CPU's, the train-step
     limits), every update against the same optimizer on the CPU fed the
     card's gradients; (d) ``YOLO(seg160).fuse().save(p)`` then ``YOLO(p)``
     predicts the 16 floor frames bit-identically to the fused model,
     ``entrypoint(["segment", "val", ...])`` on the datasets phase's yaml
     gives ``YOLO.val``'s metrics exactly, and one ``python -m
     yolo_contour_regression_tpu_torch version`` exits 0; (e)
     ``YOLO("yolov8n-seg.yaml").tune(iterations=2, epochs=1)`` at the
     seg160 config. Throughout the run, (b): every checkpoint a trainer's
     asynchronous saver writes (``SaveCheck``) equals, leaf for leaf, the
     checkpoint a synchronous save builds from the state as it was at the
     save (kept on the card), each trainer's save seconds printed.
  42. report: a JSON line of the kernels (launches summed over the predict,
     validate, train-step, trainer and fused validate runs of every task,
     FastSAM's, the serve phase's and phases 38-41's), the card's line, and
     last ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero.
"""
from __future__ import annotations

import ast
import contextlib
import copy
import csv
import ctypes
import filecmp
import io
import json
import os
import pickle
import queue
import math
import random
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from yolo_contour_regression_tpu_torch import NAS, SAM, YOLO, FastSAM, FastSAMPrompt
from yolo_contour_regression_tpu_torch import parallel
from yolo_contour_regression_tpu_torch.cfg import entrypoint, get_cfg
from yolo_contour_regression_tpu_torch.data import augment, imgproc
from yolo_contour_regression_tpu_torch.data.dataset import TrainDataset, parse_label_lines
from yolo_contour_regression_tpu_torch.data.imcodec import imdecode, imread
from yolo_contour_regression_tpu_torch.data.streams import LoadStreams
from yolo_contour_regression_tpu_torch.nn.fuse import fuse_model
from yolo_contour_regression_tpu_torch.nn.modules import head as head_mod
from yolo_contour_regression_tpu_torch.engine.predictor import (
    ClassificationPredictor, DetectionPredictor, PosePredictor, SegmentationOriPredictor,
    SegmentationPredictor, detect_xyxy)
from yolo_contour_regression_tpu_torch.engine.results import Masks, contours_to_masks
from yolo_contour_regression_tpu_torch.engine.step import init_train_state, make_train_step
from yolo_contour_regression_tpu_torch.models.rtdetr.predict import RTDETRPredictor
from yolo_contour_regression_tpu_torch.models.sam import Predictor as SamPredictor
from yolo_contour_regression_tpu_torch.models.rtdetr.val import RTDETRValidator
from yolo_contour_regression_tpu_torch.models.utils import loss as loss_mod
from yolo_contour_regression_tpu_torch.models.utils.loss import (hungarian_assign, rtdetr_assign,
                                                                 rtdetr_loss)
from yolo_contour_regression_tpu_torch.models.utils.ops import cdn_generator, get_cdn_group
from yolo_contour_regression_tpu_torch.engine.validator import (
    EVAL_KEYS, DetectionValidator, PoseValidator, SegmentationOriValidator, SegmentationValidator,
    grid_scale)
from yolo_contour_regression_tpu_torch.nn.tasks import (build_model, guess_model_task, init_weights,
                                                        yaml_model_load)
from yolo_contour_regression_tpu_torch.ops import gt_rays, polar, raster
from yolo_contour_regression_tpu_torch.ops.boxes import box_iou, scale_coords
from yolo_contour_regression_tpu_torch.ops.nms import non_max_suppression
from yolo_contour_regression_tpu_torch.serve import InferenceServer
from yolo_contour_regression_tpu_torch.serve.http_api import serve_http
from yolo_contour_regression_tpu_torch.engine import trainer as trainer_mod
from yolo_contour_regression_tpu_torch.utils import checkpoint as ckpt_mod
from yolo_contour_regression_tpu_torch.utils import cuda_build, optim, tuner
from yolo_contour_regression_tpu_torch.utils.checkpoint import (
    checkpoint_variables, load_checkpoint, load_jax_variables, save_checkpoint, to_jax_variables)
from yolo_contour_regression_tpu_torch.utils.loss import (detect_loss, detect_targets, polar_loss,
                                                          polar_targets, pose_loss,
                                                          segmentation_ori_loss)

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "runs" / "floor_seg160" / "best.ckpt"
T0 = time.perf_counter()

# H100 SXM published peaks (dense): HBM bytes/s, and fp32 (non-tensor)
# instructions/s: the data sheet's 67 TFLOP/s counts an FMA as two operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_INSTR_PER_S = 67e12 / 2

# mask shape of the predict path's 640 phase (a 480x640 camera frame), of
# the validator's 640 grid, and the most polygons one image can give (max_det)
RASTER_N, RASTER_V, RASTER_HW = 300, 36, (480, 640)
VAL_GRID_HW = (640, 640)
# the card against the port on the CPU, both in float32
HEAD_ATOL = 1e-3  # raw head outputs: cuDNN and CPU conv sum orders differ
BOX_ATOL = 0.05  # px
# train step, card against CPU: loss (relative) and each gradient (of its
# tensor's largest entry); f32 convs and BatchNorm summed in other orders
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3

# validate: (a) the 16 val images of the seg160 floor set, decoded, with
# their label lines (tests/test_torch_port_val.py regenerates them), held to
# the committed floor; (b) full width at imgsz 640, batch 16, on 32 camera
# frames (480x640: the long side is imgsz, so no pre-resize)
FLOOR_VAL = ROOT / "tests" / "data" / "torch_port_floor_seg160_val16.npz"
FLOOR_TRAIN = ROOT / "tests" / "data" / "torch_port_floor_seg160_train64.npz"
FLOOR_JSON = ROOT / "runs" / "floor_seg160" / "floor.json"
# the detect floor set (16 val and 64 train images at 96 px, decoded, with
# their label lines and the JAX validator's metrics of the floor_detect
# checkpoint; tests/test_torch_port_detect_val.py regenerates them)
DETECT_CKPT = ROOT / "runs" / "floor_detect" / "best.ckpt"
DETECT_FLOOR_JSON = ROOT / "runs" / "floor_detect" / "floor.json"
FLOOR_DETECT_VAL = ROOT / "tests" / "data" / "torch_port_floor_detect_val16.npz"
FLOOR_DETECT_TRAIN = ROOT / "tests" / "data" / "torch_port_floor_detect_train64.npz"
# the pose floor set (16 val and 64 train images at 96 px, decoded, with
# their label lines, the data's kpt_shape and flip_idx, and the JAX
# validator's metrics of the floor_pose checkpoint;
# tests/test_torch_port_pose_val.py regenerates them)
POSE_CKPT = ROOT / "runs" / "floor_pose" / "best.ckpt"
POSE_FLOOR_JSON = ROOT / "runs" / "floor_pose" / "floor.json"
FLOOR_POSE_VAL = ROOT / "tests" / "data" / "torch_port_floor_pose_val16.npz"
FLOOR_POSE_TRAIN = ROOT / "tests" / "data" / "torch_port_floor_pose_train64.npz"
VAL_IMGSZ, VAL_B = 160, 4
VAL640_N, VAL640_HW, VAL640_B = 32, (480, 640), 16
VAL_CONF, VAL_IOU = 0.001, 0.7
METRIC_KEYS = tuple(f"metrics/{m}({t})" for t in "BM"
                    for m in ("precision", "recall", "mAP50", "mAP50-95"))
# the card's eval outputs against the CPU port's on the first floor batch: a
# detection may be on one side only where its score is this close to the
# gate, or its suppressing IoU this close to ``iou``
VAL_GATE_TOL, VAL_IOU_TOL = 1e-4, 1e-3
VAL_SCORE_ATOL, VAL_BOX_IOU_ATOL, VAL_MASK_IOU_ATOL = 1e-4, 1e-3, 0.02

# the detect slice: the floor_detect checkpoint's imgsz; fused against
# unfused on the card (head maps, and each validation metric); the card's
# validation against the JAX validator's stored metrics; predict scores,
# card against CPU; the batches of the seg/detect comparison
DETECT_IMGSZ = 96
FUSE_HEAD_ATOL = 1e-3
FUSE_METRIC_ATOL = DETECT_METRIC_ATOL = 0.01
SCORE_ATOL = 1e-4
COMPARE_BATCHES = (1, 8)

KERNEL_SOURCES = ("raster", "gt_rays")
# the trainer at imgsz 640, batch 16, cand_per_gt 128 with cand_balance:
# GT rows padded to N_pad 8 give K = 128 candidates a row, to N_pad 48 K = 48
TRAIN_IMGSZ, TRAIN_B, TRAIN_NPAD, TRAIN_K = 640, 16, 8, 128
RAY_SHAPES = ((8, 128), (48, 48), (32, 48))
# the trainer's batches after the augmentation: N_pad 32 (4 tiles of the 8
# bucket), so K = 48 with cand_balance, R = 16 x 32
TRAINER_NPAD = 32
RAY_PAIRS = 16384  # the per-pair entry, as many pairs as the rows form at K 128
TRAIN_STEPS = 20
# train_floor: the floor.json config, from the seg160 checkpoint's train_args
# (the rest are the defaults; optimizer 'auto' picks AdamW and its lr)
FLOOR_TRAIN_KEYS = ("epochs", "imgsz", "batch", "nbs", "seed", "amp", "close_mosaic", "patience",
                    "workers", "mixup")
# and for pose its loss gains and the flip its flip_idx serves
POSE_TRAIN_KEYS = ("pose", "kobj", "fliplr")
# the pose slice: the floor_pose checkpoint's imgsz; yolov8n-pose at full
# width (the published config: nc 1, COCO's 17 keypoints) from a fresh
# init drawn from this seed
POSE_IMGSZ, POSE_SEED = 96, 0
# train_640: the default config at the size users train
TRAIN640_N, TRAIN640_VAL, TRAIN640_EPOCHS = 256, 16, 5  # 4 optimizer steps an epoch
# the segment_ori slice: yolov8n-segori at full width (the published config
# at nc 2) from a fresh init drawn from this seed; its loss and validator
# fill the GT masks at proto size (imgsz / 4) from 360-point contours: at
# imgsz 640 batch 16, N = 16 x 8 (the train step's N_pad 8) and 16 x 48
# (max_instances)
SEGORI_SEED, SEGORI_PROTO_HW = 0, (160, 160)
SEGORI_FILL_N = (TRAIN_B * TRAIN_NPAD, TRAIN_B * 48)
SHAPE_NAMES = {0: "circle", 1: "rect"}
# the classify slice: the floor_classify checkpoint and its floor set (96
# train and 32 val images at 64 px, decoded by cv2, with their class indices
# and the JAX validator's metrics of the checkpoint;
# tests/test_torch_port_classify.py regenerates them); the predict size of
# the published config; probabilities card against CPU, and fused against
# unfused; the floor.json config the trainer takes from the checkpoint
CLS_CKPT = ROOT / "runs" / "floor_classify" / "best.ckpt"
CLS_FLOOR_JSON = ROOT / "runs" / "floor_classify" / "floor.json"
FLOOR_CLS_TRAIN = ROOT / "tests" / "data" / "torch_port_floor_classify_train96.npz"
FLOOR_CLS_VAL = ROOT / "tests" / "data" / "torch_port_floor_classify_val32.npz"
CLS_PREDICT_IMGSZ, PROB_ATOL, FUSE_PROB_ATOL = 224, 1e-4, 1e-3
CLS_TRAIN_KEYS = ("epochs", "imgsz", "batch", "nbs", "seed", "amp", "patience", "workers")
# the RT-DETR slice: the floor_rtdetr checkpoint (yolov8n-rtdetr, nc 2) and
# its floor set (16 val images at 192 px, decoded by cv2, with their label
# lines and the JAX validator's metrics of the checkpoint at batch 4;
# tests/test_torch_port_rtdetr_val.py regenerates them); yolov8n-rtdetr at
# full width (nc 2) from a fresh init drawn from this seed
RTDETR_CKPT = ROOT / "runs" / "floor_rtdetr" / "best.ckpt"
RTDETR_FLOOR_JSON = ROOT / "runs" / "floor_rtdetr" / "floor.json"
FLOOR_RTDETR_VAL = ROOT / "tests" / "data" / "torch_port_floor_rtdetr_val16.npz"
FLOOR_RTDETR_TRAIN = ROOT / "tests" / "data" / "torch_port_floor_rtdetr_train64.npz"
# the RT-DETR floor run: JAX's recipe (examples/scripts/train_floor.py), the
# keys the floor checkpoint's train_args give; the loader's thread count,
# which leaves the draws as they are, raised for the host chain
RTDETR_TRAIN_KEYS = FLOOR_TRAIN_KEYS + ("optimizer", "lr0", "warmup_epochs", "mosaic",
                                        "save_last_every")
HOST_WORKERS = 8
# SAM, MobileSAM and everything mode at the published 1024 on seeded weights;
# the parameter counts are JAX's (tests/test_torch_port_sam.py holds them)
SAM_IMG, SAM_SEED, SAM_REL_STD = 1024, 0, 0.02
SAM_PARAMS = {"sam_b": 93_735_728, "mobile_sam": 9_818_564}
SAM_EMB_RTOL = 1e-4  # embeddings, of their largest entry
SAM_LOGIT_ATOL = 1e-3  # low-res logits and IoU
SAM_THRESH_BAND = 1e-4  # a mask pixel whose logit is this close to 0 may flip
SAM_DECODE_BATCH = 64
# everything mode: 1,024 prompts in batches of 64; seeded weights give IoU
# predictions within -0.74-0.25 and logits within +-2, so the default
# thresholds (0.88, stability 0.95 at offset 0.95) keep nothing: these keep
# 205 of the 3,072 candidates on the frame before the edge filter and NMS
# (measured on the CPU); the NMS thresholds at 1 keep every one (seeded
# masks are frame-wide blobs whose boxes overlap: at 0.7 one survives), so
# the timed runs and the crop_n_layers 0 comparison have NMS off
SAM_GEN = dict(points_stride=32, points_batch_size=64, conf_thres=0.1,
               stability_score_thresh=0.5, stability_score_offset=0.1, iou_thres=1.0,
               crop_nms_thresh=1.0)
# the card against the CPU on fewer prompts: crop_n_layers 0 at
# points_stride 8 (64 prompts: the CPU's 1,024 took 46 s of the smoke's
# 1,200, its 256 at points_stride 16 17.5 s, cut to make room for the ddp
# phases); crop_n_layers 1 is timed on the card only (its CPU reference,
# five crops of ~6 s of CPU encoder each, was cut to make room for the
# serve phase; its in-crop NMS and cross-crop dedupe run in host numpy,
# held against JAX by tests/test_torch_port_sam_predict.py)
SAM_GEN_CPU = {0: dict(points_stride=8)}
SAM_GEN_IOU = 0.99  # a pair of kept masks, card and CPU
SAM_BOX_PX = 1.0  # a threshold pixel on a mask's edge moves its box by one
# the serve phase's HTTP posts: files written by cv2 (tests/test_torch_port_imcodec.py
# regenerates them) and their cv2 decodes, keyed by file name
SERVE_FIXTURES = ("torch_port_serve_q95_420.jpg", "torch_port_serve_q75_444_rst.jpg",
                  "torch_port_serve_q90_422_exif6.jpg", "torch_port_serve_bgr8.png",
                  "torch_port_serve_bgra16.png")
SERVE_DECODES = "torch_port_serve_decodes.npz"
# the host decode timed at 480x640 (textured; cv2 decodes them in the CPU tests)
SERVE_TIMED = ("torch_port_serve_time_q95_480x640.jpg", "torch_port_serve_time_480x640.png")
# yolo_nas_s at nc 2 (JAX's count, tests/test_torch_port_fastsam_nas.py)
NAS_PARAMS = 22_309_542
# the float64 card-against-CPU step (the CPU takes ~4 s an image) and
# predict, each cut from 4 to make room for the configs phase
NAS_F64_B = 2
# the float64 steps of NAS and segment_ori card against CPU at this imgsz
# (640 until the ddp phases needed room: ~8 s of CPU each)
F64_STEP_IMGSZ = 320
NAS_F64_FRAMES = 2
# predict's default: the calibrated fresh net scores 11,449 anchors of 4
# frames above 0.001 (pre_nms cuts near-ties) and 253 above 0.3
NAS_CONF = 0.25
NAS_TRAIN_EPOCHS = 10
# the configs phase: each config the port builds beside the ones above, at
# full width (nc as its yaml has it), with JAX's parameter count
# (``jax.eval_shape`` of the JAX package's build of the same yaml;
# tests/test_torch_port_configs.py holds the port's counts to JAX's)
CONFIG_PARAMS = {"yolov3.yaml": 103_754_128, "yolov5n.yaml": 2_654_800,
                 "yolov6n.yaml": 4_500_064, "yolov8n-det-rep.yaml": 658_363,
                 "yolov8n-p2.yaml": 3_354_128, "yolov8n-p6.yaml": 4_984_336,
                 "yolov8n-pose-p6.yaml": 5_182_136}
# the four-level configs' train step, card against CPU in float64 (a fresh
# init's float32 gradients are ill-conditioned)
CONFIG_STEPS, CONFIG_STEP_IMGSZ, CONFIG_STEP_B = (
    ("yolov8n-p2.yaml", "yolov8n-p6.yaml", "yolov8n-pose-p6.yaml"), 320, 2)
# the confidence of the card-against-CPU predict sits in the widest gap
# between neighbours among the CONFIG_GAP ranks of the CPU's scores, so
# that card and CPU keep the same anchors: a fresh net's scores crowd at
# its class prior, where a fixed 0.001 or 0.25 keeps nothing or cuts
# through a run of near-equal scores
CONFIG_GAP = (10, 300)
# segment_ori's fresh float64 step, card against CPU (the CPU's float64 step
# at batch 16 took 29 s of the smoke's 1,200, 10.6 at 4)
SEGORI_F64_B = 2
# last.ckpt every 25 epochs in the smoke's floor-recipe trainer runs, as
# the RT-DETR floor recipe saves (best.ckpt still on every improvement and
# the last epoch always): the cadence changes no weight, and saving every
# epoch took 10-33% of a run's wall
SAVE_LAST_EVERY = 25
# the host pipeline phase: the seg160 floor config, 5 epochs, the host chain
HOST_TRAIN = dict(epochs=5, device_augment=False, mosaic9=0.5, copy_paste=0.5)
# rtdetr-l: the published config (nc 80; JAX's build of it has this many
# parameters) from a fresh init drawn from this seed; its float64 train step
# card against CPU at 256 batch 2 (320 until the ddp phases needed room)
RTDETR_L_PARAMS, RTDETR_L_SEED = 32_986_636, 0
RTDETR_L_TRAIN = (256, 2)
RTDETR_IMGSZ, RTDETR_SEED = 192, 0
# a gradient that is 0 in exact arithmetic (the attention's key biases), of
# the largest gradient of any tensor
ZERO_GRAD_TOL = 1e-6


def log(phase: str, msg: str):
    print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {msg}", flush=True)


def shape_images(n: int, h: int, w: int, seed: int):
    """n HWC uint8 BGR images of filled circles and rectangles on a flat
    background, as the seg160 checkpoint was trained on (numpy only)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    out = []
    for _ in range(n):
        img = np.full((h, w, 3), 40, np.uint8)
        for _ in range(rng.integers(1, 4)):
            cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
            r = rng.uniform(0.08, 0.2) * min(h, w)
            color = rng.integers(100, 256, 3).astype(np.uint8)
            if rng.integers(2) == 0:
                img[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = color
            else:
                img[int(cy - r) : int(cy + r), int(cx - r) : int(cx + r)] = color
        out.append(img)
    return out


def rect_contour(x0: float, y0: float, x1: float, y1: float, n: int = 360):
    """n points evenly along a rectangle's perimeter, clockwise in the
    y-down frame from (x0, y0), n / 4 per side."""
    corners = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]], np.float64)
    u = np.arange(n) * 4.0 / n
    side = np.floor(u).astype(int)
    f = (u - side)[:, None]
    return corners[side] + f * (corners[side + 1] - corners[side])


def circle_contour(cx: float, cy: float, r: float, n: int = 360):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], -1)


def draw_shape(img, rng, yy, xx):
    """Draw one filled circle (class 0) or rectangle (class 1) of seeded
    place, size and color into ``img`` (H, W, 3) uint8, as ``shape_images``
    draws them; returns (class, its exact 360-point contour in pixels)."""
    h, w = img.shape[:2]
    cx, cy = rng.uniform(0.3, 0.7, 2) * np.array([w, h])
    r = rng.uniform(0.08, 0.2) * min(h, w)
    color = rng.integers(100, 256, 3).astype(np.uint8)
    if rng.integers(2) == 0:
        img[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = color
        return 0, circle_contour(cx, cy, r)
    x0, y0, x1, y1 = int(cx - r), int(cy - r), int(cx + r), int(cy + r)
    img[y0:y1, x0:x1] = color
    return 1, rect_contour(x0, y0, x1, y1)


def shape_batch(n: int, imgsz: int, n_pad: int, seed: int):
    """A train batch of n square images of filled circles (class 0) and
    rectangles (class 1), drawn by ``draw_shape``, with exact 360-point
    contours, in the train step's layout (numpy): images (n, imgsz, imgsz,
    3) f32 in [0, 1]; cls (n, n_pad) int32, bboxes (n, n_pad, 4) normalized
    xywh, segments (n, n_pad, 360, 2) normalized, mask_gt (n, n_pad) bool.
    Each image holds 1 to min(3, n_pad) shapes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:imgsz, :imgsz]
    imgs = np.full((n, imgsz, imgsz, 3), 40, np.uint8)
    batch = {"cls": np.zeros((n, n_pad), np.int32),
             "bboxes": np.zeros((n, n_pad, 4), np.float32),
             "segments": np.zeros((n, n_pad, 360, 2), np.float32),
             "mask_gt": np.zeros((n, n_pad), bool)}
    for i in range(n):
        for j in range(rng.integers(1, min(3, n_pad) + 1)):
            batch["cls"][i, j], contour = draw_shape(imgs[i], rng, yy, xx)
            lo, hi = contour.min(0), contour.max(0)
            batch["bboxes"][i, j] = np.concatenate([(lo + hi) / 2, hi - lo]) / imgsz
            batch["segments"][i, j] = contour / imgsz
            batch["mask_gt"][i, j] = True
    return imgs.astype(np.float32) / 255.0, batch


def shape_val_set(n: int, h: int, w: int, seed: int):
    """n HWC uint8 BGR images (h, w) of 1 to 3 shapes each, drawn by
    ``draw_shape``, and their exact labels as ``parse_label_file`` gives
    them: (cls (k,) int32, bboxes (k, 4) normalized xywh, segments (k, 360,
    2) normalized)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    images, labels = [], []
    for _ in range(n):
        img = np.full((h, w, 3), 40, np.uint8)
        drawn = [draw_shape(img, rng, yy, xx) for _ in range(rng.integers(1, 4))]
        segs = np.stack([c for _, c in drawn]) / np.array([w, h])
        lo, hi = segs.min(1), segs.max(1)
        boxes = np.concatenate([(lo + hi) / 2, hi - lo], -1)
        images.append(img)
        labels.append((np.array([k for k, _ in drawn], np.int32), boxes.astype(np.float32),
                       segs.astype(np.float32)))
    return images, labels


def contour_keypoints(segments: np.ndarray, valid: np.ndarray, k: int) -> np.ndarray:
    """``k`` keypoints an instance, evenly spaced along its 360-point contour
    (..., 360, 2), normalized as the contour, visibility 2 where ``valid``
    (...,) and 0 elsewhere -> (..., k, 3) float32: a pose label of any
    keypoint count for the shape sets."""
    xy = segments[..., (np.arange(k) * segments.shape[-2]) // k, :]
    vis = np.broadcast_to(np.where(valid, 2.0, 0.0)[..., None, None], xy.shape[:-1] + (1,))
    return np.concatenate([xy, vis], -1).astype(np.float32)


def with_keypoints(labels, k: int):
    """``shape_val_set``'s labels as a one-class pose set's: every shape
    class 0, with ``contour_keypoints`` added: (cls, bboxes, segments,
    keypoints (n, k, 3))."""
    return [(np.zeros_like(c), b, s, contour_keypoints(s, np.ones(len(c), bool), k))
            for c, b, s in labels]


def pose_batch(batch: dict, k: int) -> dict:
    """``shape_batch``'s labels as a one-class pose batch's, in place: every
    shape class 0, with ``contour_keypoints``."""
    batch["cls"][:] = 0
    batch["keypoints"] = contour_keypoints(batch["segments"], batch["mask_gt"], k)
    return batch


def ray_contours(n: int, seed: int, size: float = 640.0):
    """n seeded 360-point contours in pixels: circles, ellipses, 5-point
    stars and rectangles, of radius 2% to 20% of ``size``, with the center
    and radius of each (numpy f32 (n, 360, 2), (n, 2), (n,))."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, 360, endpoint=False)
    c = rng.uniform(0.2, 0.8, (n, 2)) * size
    r = rng.uniform(0.02, 0.2, n) * size
    out = np.empty((n, 360, 2))
    for i in range(n):
        kind = i % 4
        if kind == 0:
            out[i] = circle_contour(c[i, 0], c[i, 1], r[i])
        elif kind == 1:
            a = rng.uniform(0.4, 1.0)
            out[i] = c[i] + np.stack([r[i] * np.cos(t), a * r[i] * np.sin(t)], -1)
        elif kind == 2:
            rad = r[i] * (1 + 0.5 * np.cos(5 * t + rng.uniform(0, 2 * np.pi)))
            out[i] = c[i] + np.stack([rad * np.cos(t), rad * np.sin(t)], -1)
        else:
            a = rng.uniform(0.4, 1.0)
            out[i] = rect_contour(c[i, 0] - r[i], c[i, 1] - a * r[i],
                                  c[i, 0] + r[i], c[i, 1] + a * r[i])
    return out.astype(np.float32), c.astype(np.float32), r.astype(np.float32)


def ray_inputs(rows: int, k: int, seed: int):
    """The assigner's GT-ray inputs at R = rows, K = k: seeded contours, K
    centers per row within 1.5 radii of the shape's center (inside and
    outside it), and a valid prefix per row of 0 to K pairs (numpy)."""
    rng = np.random.default_rng(seed)
    contours, c, r = ray_contours(rows, seed)
    centers = c[:, None] + rng.uniform(-1.5, 1.5, (rows, k, 2)) * r[:, None, None]
    n_valid = rng.integers(0, k + 1, rows)
    n_valid[0], n_valid[-1] = k, 0
    valid = np.arange(k)[None] < n_valid[:, None]
    return contours, centers.astype(np.float32), valid


RAY_SCENES = ("circle_ties", "rect_repeated_corners", "one_point", "center_on_point",
              "far_outside", "gate_exact", "wrap_and_sector_edges", "concave_star")


def _polar_points(center, deg, rad):
    """Points at angles ``deg`` (degrees, y-down frame) and radii ``rad``
    about ``center``, in float64."""
    t = np.radians(np.asarray(deg, np.float64))
    return np.asarray(center, np.float64) + np.stack([rad * np.cos(t), rad * np.sin(t)], -1)


def ray_scenes():
    """The GT-ray search's hard cases, one 360-point contour and 8 centers
    each (numpy f32 (S, 360, 2), (S, 8, 2)), in ``RAY_SCENES``'
    order: a circle about its own center, whose 4th and 5th nearest points
    tie on every ray; a rectangle whose corners repeat; 360 copies of one
    point; centers on contour points (atan2(0, 0) and a distance of 0); a
    shape 3,000 px away; points at exactly 3 degrees (and 3 +- 1e-4) from
    the rays; angles within 1e-4 degrees of 0/360 and of the sector edges
    at ray +- 5; a concave star whose 10-degree sectors hold 0 or 30+
    points. Each scene's first center is the one the case is built about."""
    rng = np.random.default_rng(7)
    idx = np.arange(360)
    contours, centers = [], []
    # circle about its own center, distinct radii so a pick shows
    rad = 10.0 + idx * 0.01
    contours.append(_polar_points((50, 50), idx, rad))
    centers.append([[50, 50], [50.5, 50], [50, 49.5], [53, 53], [46, 52], [58, 49], [41, 41],
                    [80, 50]])
    # rectangle: 80 points along each side, its first corner repeated 10 times
    corners = np.array([[100, 80], [300, 80], [300, 200], [100, 200], [100, 80]], np.float64)
    along = np.arange(80)[:, None] / 80
    sides = [np.concatenate([np.repeat(corners[s:s + 1], 10, 0),
                             corners[s] + along * (corners[s + 1] - corners[s])]) for s in range(4)]
    contours.append(np.concatenate(sides))
    centers.append([[200, 140], [100, 80], [300, 200], [200, 80], [105, 85], [400, 140],
                    [200, 300], [299.5, 80.5]])
    # 360 copies of one point
    contours.append(np.repeat([[200.0, 150.0]], 360, 0))
    centers.append([[200, 150], [210, 150], [190, 140], [200, 100], [200, 160], [150, 150],
                    [200.0001, 150], [230, 120]])
    # centers on contour points of a 5-lobed shape
    t = np.radians(idx)
    r5 = 60 * (1 + 0.4 * np.cos(5 * t))
    lobes = np.stack([320 + r5 * np.cos(t), 240 + r5 * np.sin(t)], -1)
    contours.append(lobes)
    centers.append(lobes.astype(np.float32)[::45])
    # a circle of radius 20 seen from 3,000 px away in 8 directions
    contours.append(_polar_points((320, 320), idx, 20.0))
    centers.append(_polar_points((320, 320), np.arange(8) * 45.0 + 1.5, 3000.0))
    # points at 3 degrees exactly (ray r % 3 == 0), 3 + 1e-4 (1) and 3 - 1e-4
    # (2) on both sides of each ray, then 3.5, 4.9999, 5.0001 and 5 (sector edges)
    base = np.array([3.0, 3.0001, 2.9999])[np.arange(36) % 3]
    offs = np.stack([base, -base, base + 0.5, -base - 0.5, np.full(36, 4.9999),
                     np.full(36, -4.9999), np.full(36, 5.0001), np.full(36, -5.0001),
                     np.full(36, 5.0), np.full(36, -5.0)], -1)
    deg = (np.arange(36)[:, None] * 10.0 + offs).reshape(-1)
    contours.append(_polar_points((300, 300), deg, 100.0 + (idx % 17) * 3.0))
    centers.append([[300, 300], [300.001, 300], [300, 300.001], [299.999, 299.999],
                    [300.0005, 299.9995], [300.01, 300], [300, 299.99], [299.99, 300.01]])
    # angles within 1e-4 degrees of 0/360, of each ray and of each sector edge
    wrap = np.array([-1e-4, -5e-5, -1e-5, 0.0, 1e-5, 5e-5, 1e-4])
    edges = (np.arange(36)[:, None] * 10.0 + 5.0 + np.array([-1e-4, 0.0, 1e-4])).reshape(-1)
    rays = (np.arange(36)[:, None] * 10.0 + np.array([-1e-4, 1e-4])).reshape(-1)
    deg = np.concatenate([np.tile(wrap, 4), edges, rays])
    deg = np.concatenate([deg, rng.uniform(0, 360, 360 - len(deg))])
    contours.append(_polar_points((250, 250), deg, 80.0 + (idx % 23) * 2.0))
    centers.append([[250, 250], [250.0001, 250], [250, 249.9999], [250.001, 250.001],
                    [249.999, 250], [250, 250.0003], [260, 250], [250, 240]])
    # concave star: 4 long thin spikes, 360 points evenly along its outline
    vert = _polar_points((320, 320), np.arange(8) * 45.0,
                         np.where(np.arange(8) % 2 == 0, 200.0, 5.0))
    vert = np.concatenate([vert, vert[:1]])
    seg = np.linalg.norm(np.diff(vert, axis=0), axis=-1)
    s = np.arange(360) * seg.sum() / 360
    e = np.searchsorted(np.cumsum(seg), s, side="right")
    f = (s - np.concatenate([[0], np.cumsum(seg)])[e]) / seg[e]
    contours.append(vert[e] + f[:, None] * (vert[e + 1] - vert[e]))
    centers.append([[320, 320], [321, 320], [319, 322], [318, 318], [400, 320], [320, 250],
                    [600, 600], [323, 317]])
    contours = np.stack(contours).astype(np.float32)
    centers = np.stack([np.asarray(c, np.float64) for c in centers]).astype(np.float32)
    return np.ascontiguousarray(contours), np.ascontiguousarray(centers)


def ray_mismatches(got, want, contours, rows, centers, rtol: float = 0.0):
    """The rays where ``got`` and ``want`` (P, 36) differ by more than
    ``rtol`` relative, each with its 3-degree gate and 4th/5th-nearest gap
    recomputed in float64: pair p has contour ``contours[rows[p]]`` (R, 360,
    2) and center ``centers[p]`` (P, 2). A difference is explained when the
    nearest point lies within 1e-3 degrees of the gate, or the 4th and 5th
    nearest within 1e-3 degrees of each other: there one rounding of atan2
    may pick another point. Returns [(pair, ray, got, want, explained)]."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.argwhere(np.abs(got - want) > rtol * np.abs(want))
    out = []
    for p, r in bad:
        v = np.asarray(contours[rows[p]], np.float64) - np.asarray(centers[p], np.float64)
        ang = np.degrees(np.arctan2(v[:, 1], v[:, 0])) % 360.0
        diff = np.abs(ang - 10.0 * r)
        d = np.sort(np.where(diff > 180.0, 360.0 - diff, diff))
        explained = abs(d[0] - 3.0) < 1e-3 or abs(d[3] - d[4]) < 1e-3
        out.append((int(p), int(r), float(got[p, r]), float(want[p, r]), explained))
    return out


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median over ``reps`` single calls, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def event_ms(fn) -> float:
    """One call of ``fn`` between two CUDA events, after the card is idle."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def host_ms(fn) -> float:
    """One call of ``fn`` on the host clock, from an idle card to an idle card."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def mask_breakdown(results, reps: int = 5) -> dict:
    """ms per image of each step of ``Results.masks`` on the card, each step
    run apart from an idle card: the contours to the card (host clock), the
    kernels alone (the cv2 entry's fill and outline launches, called
    straight through its C entry; CUDA events), the wrapper
    ``fill_polygons_cv2`` as a whole (checks, allocation and kernels; CUDA
    events), the masks to the host (CUDA events, which span the host's side
    of the synchronous copy too, and the host clock with the host
    allocation), numpy's view and ``Masks`` (host clock), and
    ``contours_to_masks`` whole (host clock), once per image with its masks
    dropped and once over all images with every mask kept, as ``Results``
    keeps them. Median of ``reps`` passes over ``results``. It launches the
    kernels, so it runs after the main path's launch count is read."""
    lib = raster._raster_lib()
    passes = []
    for _ in range(reps):
        acc = dict.fromkeys(("to_card", "kernels", "fill_polygons_cv2", "to_host_events",
                             "to_host", "numpy", "contours_to_masks",
                             "contours_to_masks_kept"), 0.0)
        for r in results:
            pts_np, ok_np, (h, w) = r.contours.points, r.contours.valid, r.orig_shape
            box = {}

            def to_card():
                box["pts"] = torch.as_tensor(pts_np, dtype=torch.float32).cuda().contiguous()
                box["ok"] = torch.as_tensor(ok_np, dtype=torch.bool).cuda().contiguous()

            acc["to_card"] += host_ms(to_card)
            pts, ok = box["pts"], box["ok"]
            n, v = ok.shape
            out = torch.empty((n, h, w), dtype=torch.bool, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            if n:
                acc["kernels"] += event_ms(lambda: box.__setitem__(
                    "err", lib.raster_fill_polygons_cv2(pts.data_ptr(), ok.data_ptr(),
                                                        out.data_ptr(), n, v, h, w, stream)))
                if box["err"] != 0:
                    raise RuntimeError(f"raster kernel launch failed: CUDA error {box['err']}")
            acc["fill_polygons_cv2"] += event_ms(lambda: raster.fill_polygons_cv2(pts, ok, h, w))
            acc["to_host_events"] += event_ms(lambda: out.cpu())
            acc["to_host"] += host_ms(lambda: box.__setitem__("host", out.cpu()))
            acc["numpy"] += host_ms(lambda: Masks(box["host"].numpy(), (h, w)))
            acc["contours_to_masks"] += host_ms(lambda: contours_to_masks(pts_np, ok_np, h, w))
        kept = []
        acc["contours_to_masks_kept"] = host_ms(lambda: kept.extend(
            contours_to_masks(r.contours.points, r.contours.valid, *r.orig_shape)
            for r in results))
        del kept
        passes.append({k: x / len(results) for k, x in acc.items()})
    return {k: statistics.median(p[k] for p in passes) for k in passes[0]}


def raster_inputs(seed: int = 0, device="cuda", hw=RASTER_HW):
    """Seeded star-shaped polygons at the path's shapes (masks ``hw``), plus
    edge cases: an all-invalid polygon, invalid runs at the start and the
    end, horizontal edges, vertices on integer pixel rows, a polygon that
    leaves the image and a degenerate one."""
    n, v, (h, w) = RASTER_N, RASTER_V, hw
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 2 * np.pi, (n, v)), axis=1)
    r = rng.uniform(3, 0.4 * min(h, w), (n, v))
    c = rng.uniform(0.1, 0.9, (n, 1, 2)) * np.array([w, h])
    pts = (np.stack([np.cos(t), np.sin(t)], -1) * r[..., None] + c).astype(np.float32)
    valid = rng.uniform(size=(n, v)) > 0.15
    valid[0] = False
    valid[1, :6] = False
    valid[2, -6:] = False
    pts[3, 4:10, 1] = pts[3, 4, 1]
    pts[4, :, 1] = np.round(pts[4, :, 1])
    pts[5] = pts[5] * 3 - np.array([w, h], np.float32)
    pts[6] = pts[6, :1]
    return torch.from_numpy(pts).to(device), torch.from_numpy(valid).to(device)


def raster_bound_ms(pts, valid, h: int, w: int, rule: str = "even_odd"):
    """Least time for a polygon fill on this card, from this run's data, and
    what sets it: max(bytes / HBM rate, ops / fp32 issue rate).

    Bytes, the same for both rules: points and valid read once, masks
    written once. Ops: the work the function needs, not what the kernel
    does. Even-odd: whether an edge spans a row (two compares and an
    inequality) is one value per (row, edge) of a polygon with a valid
    vertex: 3 ops. Its crossing ``xi`` is one value per spanning (row,
    edge): 3 subtractions, a division, a multiply and an add, 6 ops. Each
    (pixel, spanning edge) then takes a compare and a parity flip: 2 ops.
    The cv2 rule, over its fixed-point edges: whether a live edge spans a
    row, 2 compares per (row, edge); its x, a multiply and an add per
    spanning (row, edge); a compare and an or per (pixel, spanning edge);
    the outlines' pixels are bytes already counted. None of these is an
    FMA, so the rate is the data sheet's fp32 rate halved (it counts an FMA
    as two operations); the integer operations are counted at that rate
    too, which no integer rate of the card exceeds, so the bound stays a
    lower bound."""
    n, v = valid.shape
    rows = torch.arange(h, device=pts.device)
    if rule == "even_odd":
        ok = valid.any(-1)
        col = raster.collapse_invalid_vertices(pts, valid)
        y0 = col[..., 1]
        y1 = torch.roll(y0, -1, dims=-1)
        rows = rows.to(pts.dtype)
        spans = ((y0[..., None] > rows) != (y1[..., None] > rows)) & ok[:, None, None]
        n_spans = int(spans.sum())
        ops = 3 * int(ok.sum()) * v * h + 6 * n_spans + 2 * n_spans * w
    else:
        live, _, (y0, y1, _, _) = raster._cv2_edges(pts, valid, h, w)
        live = live & (y0 != y1)
        spans = live[..., None] & (y0[..., None] <= rows) & (rows < y1[..., None])
        n_spans = int(spans.sum())
        ops = 2 * int(live.sum()) * h + 2 * n_spans + 2 * n_spans * w
    nbytes = pts.numel() * 4 + valid.numel() + n * h * w
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_INSTR_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gt_rays_bound_ms(n_rows: int, n_pairs: int, n_valid: int, with_valid: bool = True):
    """Least time for GT rays on this card, from this run's data, and what
    sets it: max(bytes / HBM rate, ops / fp32 issue rate).

    Bytes: the contours once per row, the centers, the valid flags (rows
    form) and the rays out. Ops: the work the function needs for the valid
    pairs (an invalid pair needs none), not what the kernel does; the
    kernel scans all 360 points for each ray, the function does not have to.
    Per valid pair: per point the angle and distance, 10 (2 subtractions,
    atan2, a multiply, the wrap's compare and add; 2 multiplies, an add and
    a square root; atan2 and the square root counted as one each); one sort
    of the 360 angles, log2(360!) comparisons (the least any comparison
    sort needs), a compare and a select each; one walk of the sorted angles
    beside the 36 rays in order, a compare per angle and per ray; per ray,
    the 4 nearest of the 8 sorted neighbours around it, 2 ops each for 8
    differences (a subtraction, the fold) and a compare for each of the 4
    picks, then 6 (3 maxima of the 4 distances, the gate's compare and
    select, the clamp). None is an FMA, so the rate is the data sheet's
    fp32 rate halved. Every op counted is a lower bound, so the bound is."""
    pts, rays = polar.NUM_CONTOUR_POINTS, polar.NUM_RAYS
    sort_cmps = math.lgamma(pts + 1) / math.log(2)
    per_pair = 10 * pts + 2 * sort_cmps + (pts + rays) + rays * (2 * 8 + 4 + 6)
    ops = n_valid * per_pair
    nbytes = n_rows * pts * 2 * 4 + n_pairs * 2 * 4 + n_pairs * with_valid + n_pairs * rays * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_INSTR_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# atan2f alone, and a kernel of the same shape with one subtraction in its
# place, built as the kernels are, for atan2f's instruction count
ATAN2F_PROBE = r"""
extern "C" __global__ void probe_atan2f(const float* y, const float* x, float* o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  o[i] = atan2f(y[i], x[i]);
}
extern "C" __global__ void probe_sub(const float* y, const float* x, float* o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  o[i] = __fsub_rn(y[i], x[i]);
}
"""
SASS_LINE = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def sass(lib: Path) -> dict:
    """{kernel: [(predicated, opcode)]} from ``cuobjdump -sass`` of a built
    library, NOPs left out."""
    tool = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=120, check=True)
    out, name = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and (m := SASS_LINE.match(line)) and m.group(2) != "NOP":
            out[name].append((bool(m.group(1)), m.group(2)))
    return out


def to_exit(ops) -> int:
    """Instructions up to the first unpredicated EXIT: the kernel's own path,
    without the subroutines placed after it (a division's slow path)."""
    return next((i + 1 for i, (pred, op) in enumerate(ops) if op == "EXIT" and not pred),
                len(ops))


def gt_rays_sass(lib: Path, card: str):
    """atan2f's SASS instructions (the probe less the subtraction probe,
    plus the subtraction), built with the kernels' flags, and each GT-ray
    kernel's; None (not measured) where the toolkit has no cuobjdump."""
    try:
        with tempfile.TemporaryDirectory() as d:
            src, so = Path(d) / "atan2f_probe.cu", Path(d) / "atan2f_probe.so"
            src.write_text(ATAN2F_PROBE)
            subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                            str(src)], capture_output=True, text=True, timeout=300, check=True)
            probe = sass(so)
        kernels = sass(lib)
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        log("kernels", f"SASS: not measured ({type(e).__name__}: {e}) | {card}")
        return None
    a, b = probe["probe_atan2f"], probe["probe_sub"]
    path, total = to_exit(a) - to_exit(b) + 1, len(a) - len(b) + 1
    sizes = {("rows" if "ILb1E" in name else "pairs"): (to_exit(ops), len(ops))
             for name, ops in kernels.items() if "gt_rays_kernel" in name}
    log("kernels", f"SASS (cuobjdump -sass, nvcc {' '.join(cuda_build.NVCC_FLAGS)}): atan2f "
        f"{path} instructions on its path to EXIT, {total} with its subroutines; GT-ray kernels "
        f"(to EXIT, all): {sizes} | {card}")
    return path


def atan2f_floor(check: dict, kind: str, atan2f_instr, card: str):
    """The bound with atan2f at its SASS count instead of one operation, and
    the share of the bound that leaves the kernel at most."""
    if atan2f_instr is None:
        return
    extra = check["n_valid"] * polar.NUM_CONTOUR_POINTS * (atan2f_instr - 1)
    ops_ms = gt_rays_bound_ms(0, 0, check["n_valid"])[0] + extra / PEAK_FP32_INSTR_PER_S * 1e3
    floor_ms = max(check["bound_ms"], ops_ms)
    log("kernels", f"gt_rays_{kind}: with atan2f at {atan2f_instr} instructions the bound "
        f"{check['bound_ms']:.4f} ms becomes {floor_ms:.4f} ms, so the kernel can reach at most "
        f"{check['bound_ms'] / floor_ms:.1%} of the bound; it is at "
        f"{check['bound_ms'] / check['ms']:.1%} of the bound, {floor_ms / check['ms']:.1%} of "
        f"that floor | {card}")


def gt_rays_phases(inputs: dict, card: str):
    """The GT-ray kernel's own clock (``csrc/gt_rays.cu`` built with
    ``-DGT_RAYS_PROFILE`` into a scratch library): per live block, its
    clock64 cycles in phases 1-2 (angles, counting sort), in phase 3's order
    and in its search; per SM the blocks resident on average (their summed
    time over the SM's span) against the most it can hold. ``inputs`` maps a
    label to (entry, contours, centers, valid). Not measured where it does
    not build."""
    with tempfile.TemporaryDirectory() as d:
        so = Path(d) / "gt_rays_profile.so"
        try:
            subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-DGT_RAYS_PROFILE",
                            "-o", str(so), str(cuda_build.CSRC_DIR / "gt_rays.cu")],
                           capture_output=True, text=True, timeout=300, check=True)
            lib = ctypes.CDLL(str(so))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            log("kernels", f"gt_rays phases: not measured ({type(e).__name__}: {e}) | {card}")
            return
        for fn, args in ((lib.gt_rays_rows, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                          + [ctypes.c_void_p]),
                         (lib.gt_rays_pairs, [ctypes.c_void_p] * 3
                          + [ctypes.c_int, ctypes.c_void_p]),
                         (lib.gt_rays_set_profile, [ctypes.c_void_p]),
                         (lib.gt_rays_blocks_per_sm, [ctypes.c_int])):
            fn.argtypes, fn.restype = args, ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        for label, (kind, c, x, v) in inputs.items():
            out = torch.empty(x.shape[:-1] + (polar.NUM_RAYS,), device="cuda")
            blocks = x.shape[0] * -(-x.shape[1] // 8) if kind == "rows" else -(-len(x) // 8)
            rec = torch.zeros((blocks, 5), dtype=torch.int64, device="cuda")
            if lib.gt_rays_set_profile(rec.data_ptr()):
                raise RuntimeError("gt_rays_set_profile failed")
            for _ in range(2):  # the second launch is read
                rec.zero_()
                err = (lib.gt_rays_rows(c.data_ptr(), x.data_ptr(), v.data_ptr(), out.data_ptr(),
                                        *x.shape[:2], stream) if kind == "rows" else
                       lib.gt_rays_pairs(c.data_ptr(), x.data_ptr(), out.data_ptr(), len(x),
                                         stream))
                if err:
                    raise RuntimeError(f"profile launch failed: CUDA error {err}")
                torch.cuda.synchronize()
            r = rec.cpu().numpy()
            r = r[r[:, 0] > 0]
            sm, t0, t1, t2, t3 = r[:, 0] - 1, r[:, 1], r[:, 2], r[:, 3], r[:, 4]
            resident = [float((t3[on] - t0[on]).sum() / (t3[on].max() - t0[on].min()))
                        for on in (sm == k for k in np.unique(sm))]
            parts = {"phases 1-2": t1 - t0, "order": t2 - t1, "search": t3 - t2}
            cyc = ", ".join(f"{k} {np.median(a):.0f} (p90 {np.percentile(a, 90):.0f})"
                            for k, a in parts.items())
            log("kernels", f"gt_rays_{kind} {label} phases (the kernel's clock64, "
                f"-DGT_RAYS_PROFILE): {len(r)} live blocks on {len(np.unique(sm))} SMs; cycles "
                f"per block, median: {cyc}; the search's share of a block's cycles "
                f"{(t3 - t2).sum() / (t3 - t0).sum():.1%}; blocks resident per SM "
                f"{statistics.fmean(resident):.2f} of "
                f"{lib.gt_rays_blocks_per_sm(int(kind == 'rows'))} | {card}")


def ray_entry(kind: str, c, x, v, out):
    """A call of the C entry of ``csrc/gt_rays.cu`` straight, with no
    wrapper, on the wrapper's inputs; it returns the CUDA error."""
    lib, stream = gt_rays._lib(), torch.cuda.current_stream().cuda_stream
    if kind == "rows":
        fn, args = lib.gt_rays_rows, (c.data_ptr(), x.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      *x.shape[:2], stream)
    else:
        fn, args = lib.gt_rays_pairs, (c.data_ptr(), x.data_ptr(), out.data_ptr(), len(x), stream)
    return lambda: fn(*args)


def check_gt_rays(kind: str, contours, centers, valid, card: str, seed_note: str,
                  timed: bool = True) -> dict:
    """One GT-ray entry against its plain version on the card: differing
    rays (each named, and required to sit at a gate or tie) and the device
    kernels of one call (one, where the profiler records them); if
    ``timed``, the kernel's time per launch (``back_to_back_ms`` of the C
    entry), the wrapper's per call (``time_ms``, the host's side of the
    call included), the plain version's, and the bound."""
    c = torch.from_numpy(contours).cuda()
    x = torch.from_numpy(centers).cuda()
    if kind == "rows":
        v = torch.from_numpy(valid).cuda()
        fast, plain = (lambda: gt_rays.gt_rays_rows_fast(c, x, v),
                       lambda: gt_rays.gt_rays_rows_plain(c, x, v))
        rows = np.nonzero(valid)[0]
        pair_centers = centers[valid]
        n_rows, n_pairs, n_valid = valid.shape[0], valid.size, int(valid.sum())
    else:
        v = None
        fast, plain = (lambda: gt_rays.gt_rays_fast(c, x), lambda: gt_rays.gt_rays_pairs_plain(c, x))
        rows, pair_centers = np.arange(len(centers)), centers
        n_rows = n_pairs = n_valid = len(centers)
    got, want = fast(), plain()
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    if kind == "rows":
        if not bool((got[~v] == np.float32(polar.RAY_EPS)).all()):
            raise AssertionError("GT-ray rows kernel: an invalid pair is not RAY_EPS")
        got_v, want_v = got[v], want[v]
    else:
        got_v, want_v = got, want
    named = ray_mismatches(got_v.cpu().numpy(), want_v.cpu().numpy(), contours, rows,
                           pair_centers) if n_diff else []
    for p_, r_, g_, w_, ok in named:
        log("kernels", f"  gt_rays_{kind}: pair {p_} ray {r_}: kernel {g_:.6f} plain {w_:.6f}, "
            f"at a 3-degree gate or 4th/5th tie: {ok}")
    if not all(item[4] for item in named):
        raise AssertionError(f"GT-ray {kind} kernel: {n_diff} rays differ from the plain "
                             f"version, some away from any gate or tie")
    kernels = kernels_of_one_call(f"gt_rays_{kind}", fast, 1)
    res = {"max_abs_err": float((got - want).abs().max()), "n_diff": n_diff, "kernels": kernels}
    note = (f"gt_rays_{kind} {seed_note}: {n_valid} valid of {n_pairs} pairs, {n_rows} contours; "
            f"{n_diff} of {got.numel()} rays differ from the plain version; device kernels of "
            f"one call: {kernels if kernels else 'not measured'}")
    if not timed:
        log("kernels", f"{note} | {card}")
        return res
    ms = back_to_back_ms(ray_entry(kind, c, x, v, torch.empty_like(got)))
    call_ms, plain_ms = time_ms(fast), time_ms(plain)
    bound_ms, bound_by = gt_rays_bound_ms(n_rows, n_pairs, n_valid, kind == "rows")
    log("kernels", f"{note}; kernel {ms:.4f} ms a launch ({bound_ms / ms:.1%} of the bound), "
        f"wrapper {call_ms:.4f} ms a call, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), library ms: none (no PyTorch call computes GT rays) | {card}")
    return {**res, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "n_valid": n_valid}


def check_ray_scenes(card: str):
    """Both GT-ray entries on ``ray_scenes``' hard cases: the rows entry with
    each scene's contour as a row of 8 candidates, the per-pair entry on the
    same 64 pairs."""
    contours, centers = ray_scenes()
    s, k = centers.shape[:2]
    note = f"scenes ({', '.join(RAY_SCENES)})"
    check_gt_rays("rows", contours, centers, np.ones((s, k), bool), card, note, timed=False)
    check_gt_rays("pairs", np.ascontiguousarray(np.repeat(contours, k, 0)),
                  np.ascontiguousarray(centers.reshape(-1, 2)), None, card, note, timed=False)


def back_to_back_ms(call, launches: int = 20) -> float:
    """ms per launch of ``call`` (a C entry called straight, returning its
    CUDA error): ``launches`` back-to-back calls between two CUDA events, so
    the host's side of each call overlaps the card's work; median of
    ``time_ms``'s repetitions."""
    def run():
        for _ in range(launches):
            err = call()
            if err:
                raise RuntimeError(f"kernel launch failed: CUDA error {err}")

    return time_ms(run) / launches


def launch_ms(entry: str, pts, valid, h: int, w: int) -> float:
    """ms per launch of a C entry of ``csrc/raster.cu`` called straight, with
    no wrapper (``back_to_back_ms``)."""
    fn = getattr(raster._raster_lib(), entry)
    n, v = valid.shape
    out = torch.empty((n, h, w), dtype=torch.bool, device="cuda")
    args = (pts.data_ptr(), valid.data_ptr(), out.data_ptr(), n, v, h, w,
            torch.cuda.current_stream().cuda_stream)
    return back_to_back_ms(lambda: fn(*args))


def device_kernels(fn):
    """The device kernels one call of ``fn`` launches, as ``torch.profiler``
    records them: [(name, device µs)] in launch order; None where it
    records no device activity (then they are not measured)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    return [(e.name.split("::")[-1].split("(")[0], round(e.time_range.elapsed_us(), 1))
            for e in events] or None


def kernels_of_one_call(name: str, fn, n_kernels: int, tries: int = 3):
    """``device_kernels(fn)``, which must be ``n_kernels`` where the profiler
    records them. The profiler may drop a kernel's record (a run saw the cv2
    entry's outline without its fill) but adds none, so up to ``tries``
    profiles are read and the first that records ``n_kernels`` proves the
    count; more kernels, or fewer in every profile that recorded any, fail.
    No device activity in any profile, or the profiler's own failure, is a
    gap in the report ("not measured"), not in the kernel."""
    seen = []
    for _ in range(tries):
        try:
            kernels = device_kernels(fn)
        except Exception as e:
            return f"not measured ({type(e).__name__}: {e})"
        if kernels is None:
            continue
        if len(kernels) > n_kernels:
            raise AssertionError(f"{name}: one call launched {kernels}, not {n_kernels} kernels")
        if len(kernels) == n_kernels:
            return kernels
        seen.append(kernels)
    if seen:
        raise AssertionError(f"{name}: one call launched {seen}, not {n_kernels} kernels")
    return None


def check_fill(name: str, entry: str, fast, plain, rule: str, n_kernels: int, card: str,
               hw=RASTER_HW, inputs=None) -> dict:
    """One polygon-fill entry against its plain version on the card, at
    masks of shape ``hw`` (the predict path's by default) and the edge cases
    of ``raster_inputs`` (or ``inputs``, points and valid on the card): 0
    differing pixels; the kernel's time per launch (``launch_ms``), the
    wrapper's per call, the plain version's and the bound; the device
    kernels of one call, which must be ``n_kernels`` where the profiler
    records them."""
    pts, valid = raster_inputs(hw=hw) if inputs is None else inputs
    h, w = hw
    got, want = fast(pts, valid, h, w), plain(pts, valid, h, w)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    cases = (not want[1:].any() or want[0].any()) if inputs is None else not want.any()
    if n_diff or cases:
        raise AssertionError(f"{name}: {n_diff} pixels differ from the plain version")
    ms = launch_ms(entry, pts, valid, h, w)
    call_ms = time_ms(lambda: fast(pts, valid, h, w))
    plain_ms = time_ms(lambda: plain(pts, valid, h, w), reps=10)
    bound_ms, bound_by = raster_bound_ms(pts, valid, h, w, rule)
    kernels = kernels_of_one_call(name, lambda: fast(pts, valid, h, w), n_kernels)
    n, v = valid.shape
    log("kernels", f"{name} N={n} V={v} {h}x{w}: {n_diff} of {got.numel()} pixels "
        f"differ from the plain version; kernel {ms:.4f} ms a launch ({bound_ms / ms:.1%} of the "
        f"bound), wrapper {call_ms:.4f} ms a call, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by}); device kernels of one call: {kernels if kernels else 'not measured'}; "
        f"library ms: none (no PyTorch call fills polygons) | {card}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": float((got.int() - want.int()).abs().max())}


def segori_fill_inputs(n: int):
    """GT contours at proto size (``SEGORI_PROTO_HW``) as the segment_ori
    loss fills them, on the card: N = 128, the train step's batch
    (``shape_batch(16, 640, 8, seed=4)``, as ``train_full_width`` draws it:
    1 to 3 shapes an image, the padded rows all invalid); N = 768, every row
    a valid 360-point contour (``ray_contours`` on the proto grid), the
    most the loss fills at ``max_instances``."""
    hp, wp = SEGORI_PROTO_HW
    if n == TRAIN_B * TRAIN_NPAD:
        _, batch = shape_batch(TRAIN_B, TRAIN_IMGSZ, TRAIN_NPAD, seed=4)
        pts = batch["segments"].reshape(n, -1, 2) * np.array([wp, hp], np.float32)
        valid = np.repeat(batch["mask_gt"].reshape(n, 1), pts.shape[1], 1)
    else:
        pts = ray_contours(n, seed=n, size=float(hp))[0]
        valid = np.ones(pts.shape[:2], bool)
    return (torch.from_numpy(np.ascontiguousarray(pts, np.float32)).cuda(),
            torch.from_numpy(np.ascontiguousarray(valid)).cuda())


def report_row(check: dict) -> dict:
    return {k: check[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}


KERNEL_WRAPPERS = {"fill_polygons": raster.fill_polygons,
                   "fill_polygons_cv2": raster.fill_polygons_cv2,
                   "gt_rays_rows": gt_rays.gt_rays_rows_fast,
                   "gt_rays_pairs": gt_rays.gt_rays_fast}


def zero_launch_counts():
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def train_hyp(ckpt, **over):
    """The checkpoint's train_args as the optimizer's and loss's hyp."""
    hyp = SimpleNamespace(**ckpt["train_args"])
    for k, v in over.items():
        setattr(hyp, k, v)
    return hyp


def ckpt_model(ckpt, device):
    """The checkpoint's model (its task's) with its weights, in train mode."""
    model = build_model(ckpt["model_yaml"])
    model.names = dict(ckpt["names"])
    load_jax_variables(model, *checkpoint_variables(ckpt))
    return model.to(device).train()


def loss_and_assign(model, feats, batch, hyp):
    """The model's task loss on its head maps, and the assignment."""
    if model.task == "segment_ori":
        levels, _ = feats
        tg = detect_targets([f[:, :-model.nm] for f in levels], batch, model.strides, model.nc,
                            model.reg_max)
        return segmentation_ori_loss(feats, batch, model.strides, model.nc, hyp, nm=model.nm,
                                     reg_max=model.reg_max).total, tg.assign
    if model.task == "pose":
        nk = model.kpt_shape[0] * model.kpt_shape[1]
        tg = detect_targets([f[:, :-nk] for f in feats], batch, model.strides, model.nc,
                            model.reg_max)
        return pose_loss(feats, batch, model.strides, model.nc, hyp, model.kpt_shape,
                         model.reg_max).total, tg.assign
    if model.task == "detect":
        tg = detect_targets(feats, batch, model.strides, model.nc, model.reg_max)
        return detect_loss(tg, hyp).total, tg.assign
    tg = polar_targets(feats, batch, model.strides, model.nc, hyp, cand=hyp.cand_per_gt)
    return polar_loss(tg, hyp).total, tg.assign


def to_device(images, batch, device):
    return (torch.from_numpy(images).to(device),
            {k: torch.from_numpy(v).to(device) for k, v in batch.items()})


def train_card_vs_cpu(ckpt, card: str, imgsz: int = 160, phase: str = "train", b: int = 4,
                      model=None, dtype=torch.float32):
    """One loss, the assignment and every gradient of the checkpoint's
    model (or of a copy of ``model``, with the checkpoint's train_args) at
    ``imgsz``, batch ``b``, N_pad 8, on the card and on the CPU (the
    network in ``dtype``, the loss math f32; TF32 off). A fresh init's
    float32 gradients are ill-conditioned (a neck bottleneck's are 10% of
    its largest entry off their float64 values on the CPU alone), so a
    fresh model is held in float64, as the CPU tests hold JAX's."""
    images, batch = shape_batch(b, imgsz, 8, seed=3)
    if guess_model_task(ckpt["model_yaml"]) == "pose":
        pose_batch(batch, ckpt["model_yaml"]["kpt_shape"][0])
    hyp = train_hyp(ckpt)
    res = {}
    for dev in ("cpu", "cuda"):
        model_d = (ckpt_model(ckpt, dev) if model is None
                   else copy.deepcopy(model).to(dev).train()).to(dtype)
        x, bt = to_device(images, batch, dev)
        total, assign = loss_and_assign(model_d, model_d(x.to(dtype).permute(0, 3, 1, 2)
                                                         .contiguous()), bt, hyp)
        total.backward()
        res[dev] = (total.item(), assign.fg_mask.cpu(), assign.target_gt_idx.cpu(),
                    {n: p.grad.cpu() for n, p in model_d.named_parameters()})
        del model_d
    (lc, fc, ic, gc), (lg, fg, ig, gg) = res["cpu"], res["cuda"]
    loss_rel = abs(lg - lc) / abs(lc)
    grad_rel, worst = max((float((gg[n] - gc[n]).abs().max()
                                 / gc[n].abs().max().clamp_min(1e-30)), n) for n in gc)
    same = torch.equal(fc, fg) and torch.equal(ic[fc], ig[fg]) and bool(fc.any())
    if not same or loss_rel > TRAIN_LOSS_RTOL or grad_rel > TRAIN_GRAD_TOL:
        raise AssertionError(f"{phase} card vs CPU: same assignment {same}, loss rel "
                             f"{loss_rel:.2e} (limit {TRAIN_LOSS_RTOL}), grad {grad_rel:.2e} of the "
                             f"tensor max at {worst} (limit {TRAIN_GRAD_TOL})")
    head = (model.yaml if model is not None else ckpt["model_yaml"])["head"][-1][2]
    whose = "a fresh" if model is not None else "the checkpoint's"
    log(phase, f"card vs CPU, {whose} {head} model ({str(dtype)[6:]}) at "
        f"imgsz {imgsz} batch {b}: loss {lg:.6f} vs {lc:.6f} (rel "
        f"{loss_rel:.2e}, limit {TRAIN_LOSS_RTOL}); same assignment ({int(fc.sum())} fg anchors); "
        f"worst gradient {grad_rel:.2e} of its tensor's max, {worst} (limit {TRAIN_GRAD_TOL}) | "
        f"{card}")


class StageTimer:
    """A ``mark`` hook (of ``make_train_step`` or ``SegmentationValidator``):
    a CUDA event as each stage starts. ``totals()`` reads the marks since the
    last read, ms per stage, summed where a stage recurs; the span after an
    "end" mark (outside the timed code) is left out. ``split()`` reads one
    train step: forward, assigner (the GT-ray kernel's wrapper included),
    gt_rays_kernel (that wrapper alone), loss, backward, clip_optimizer_ema,
    total."""

    def __init__(self):
        self.marks = []

    def __call__(self, stage: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((stage, ev))

    def totals(self) -> dict:
        marks, self.marks = self.marks, []
        marks[-1][1].synchronize()
        out = {}
        for (stage, a), (_, b) in zip(marks, marks[1:]):
            if stage != "end":
                out[stage] = out.get(stage, 0.0) + a.elapsed_time(b)
        return out

    def split(self) -> dict:
        first, last = self.marks[0][1], self.marks[-1][1]
        out = dict.fromkeys(("forward", "assigner", "gt_rays", "loss", "backward",
                             "clip_optimizer_ema"), 0.0)
        out.update(self.totals())
        out["gt_rays_kernel"] = out.pop("gt_rays")
        out["assigner"] += out["gt_rays_kernel"]
        out["total"] = first.elapsed_time(last)
        return out


def train_full_width(ckpt, card: str, phase: str = "train", model=None, label: str = None):
    """The checkpoint's model (yolov8n-seg or yolov8n), or ``model`` (the
    fresh yolov8n-pose or yolov8n-segori) with the checkpoint's train_args,
    at full width,
    imgsz 640, batch 16, N_pad 8, AdamW from the checkpoint's train_args
    with no warmup: 3 warm-up steps, then TRAIN_STEPS steps of
    ``make_train_step`` on one repeated batch (counts zeroed just before,
    read just after), each timed on the host clock and split into its
    stages by the step's own marks (``StageTimer``), and its peak device
    memory (from the warm-up steps on). Pose batches are ``pose_batch``'s.
    ``label`` names the model in the log (by default its task's yolov8n)."""
    hyp = train_hyp(ckpt, optimizer="AdamW", warmup_epochs=0.0, batch=TRAIN_B)
    model = ckpt_model(ckpt, "cuda") if model is None else model.to("cuda").train()
    opt = optim.build_optimizer(model, hyp, steps_per_epoch=1000, iterations=1000)
    state = init_train_state(model, opt, device="cuda")
    timer = StageTimer()
    step = make_train_step(model, opt, hyp, cand=hyp.cand_per_gt, mark=timer)
    images, batch = shape_batch(TRAIN_B, TRAIN_IMGSZ, TRAIN_NPAD, seed=4)
    if model.task == "pose":
        pose_batch(batch, model.kpt_shape[0])
    x, b = to_device(images, batch, "cuda")
    torch.cuda.reset_peak_memory_stats()
    losses = [step(state, x, b)["loss"].item() for _ in range(3)]
    timer.marks = []
    zero_launch_counts()
    for k in ("rounds", "syncs", "solves"):
        setattr(hungarian_assign, k, 0)
    times, splits = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step(state, x, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        splits.append(timer.split())
        losses.append(metrics["loss"].item())
    counts = launch_counts()
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase} at 640: losses {losses}")
    if model.task == "segment" and counts["gt_rays_rows"] == 0:
        raise AssertionError("the train path never launched the GT-ray kernel")
    if model.task == "segment_ori" and counts["fill_polygons"] != TRAIN_STEPS:
        raise AssertionError(f"the segment_ori step fills its GT masks once a step: {counts}")
    name = label or (f"yolov8n-pose (K {model.kpt_shape[0]})" if model.task == "pose"
                     else {"segment": "yolov8n-seg", "detect": "yolov8n",
                           "segment_ori": "yolov8n-segori", "rtdetr": "yolov8n-rtdetr"}[model.task])
    if model.task == "rtdetr":
        log(phase, f"the auction over the {TRAIN_STEPS} timed steps (7 layers x {TRAIN_B} "
            f"images solved as one batch a step, the host asked every "
            f"{loss_mod.CHECK_EVERY} rounds): {hungarian_assign.rounds / TRAIN_STEPS:.1f} "
            f"rounds and {hungarian_assign.syncs / TRAIN_STEPS:.1f} host syncs a step, "
            f"{hungarian_assign.solves} solves | {card}")
    log(phase, f"{name} full width, imgsz {TRAIN_IMGSZ} batch {TRAIN_B} N_pad "
        f"{TRAIN_NPAD}, AdamW lr0 {hyp.lr0}: loss {losses[0]:.4f} at step 0, {losses[-1]:.4f} "
        f"at step {len(losses) - 1}, all finite; {int(batch['mask_gt'].sum())} GT instances; "
        f"launches {counts}; ms per step (host clock, median of {TRAIN_STEPS}) "
        f"{statistics.median(times):.3f} (min {min(times):.3f}, max {max(times):.3f}); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
    med = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    parts = ", ".join(f"{k} {v:.3f}" for k, v in med.items())
    log(phase, f"imgsz {TRAIN_IMGSZ} batch {TRAIN_B}, ms per step split by CUDA events at the "
        f"step's own stage marks (median of the same {TRAIN_STEPS} steps): {parts} | {card}")
    return state, counts, med, statistics.median(times)


def save_and_predict(ckpt, state, images, card: str):
    """``save_checkpoint`` the trained state in the JAX format, then
    ``YOLO(path).predict`` on the card."""
    params, bstats = to_jax_variables(state.model.state_dict())
    ema, _ = to_jax_variables(state.ema)
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(Path(d) / "last.ckpt", params, bstats, ema, step=state.step,
                               epoch=0, best_fitness=0.0, train_args=ckpt["train_args"],
                               model_yaml=state.model.yaml, names=ckpt["names"])
        size = path.stat().st_size
        loaded = YOLO(path, device="cuda")
        res = loaded.predict(images, imgsz=160)
    # the facade loads the EMA weights, and the trained BatchNorm statistics
    sd = loaded.model.state_dict()
    same = (all(torch.equal(sd[n], t) for n, t in state.ema.items())
            and all(torch.equal(sd[n], t) for n, t in state.model.state_dict().items()
                    if "running" in n))
    if len(res) != len(images) or not same:
        raise AssertionError(f"predict from the saved checkpoint: {len(res)} results, "
                             f"weights as saved: {same}")
    log("train", f"saved the trained state ({size} bytes, step {state.step}); YOLO(path, "
        f"device='cuda') holds the saved EMA weights and BatchNorm statistics exactly; "
        f".predict on {len(images)} images: {sum(len(r) for r in res)} detections | {card}")


class TrainTotals(StageTimer):
    """A ``StageTimer`` for a whole training run: every ``every`` steps (at
    a step's "end" mark, one wait for the card) its marks are folded into
    per-stage sums, so it holds a bounded number of events; the first
    ``skip`` optimizer steps (the first epoch: kernels load, cuDNN picks its
    algorithms) are dropped. ``per_step()`` gives device ms per optimizer
    step by stage over ``steps``."""

    def __init__(self, skip: int, every: int = 50):
        super().__init__()
        self.sums, self.seen, self.skip, self.every = {}, 0, skip, every

    @property
    def steps(self) -> int:
        return max(self.seen - self.skip, 0)

    def __call__(self, stage: str):
        super().__call__(stage)
        if stage == "end":
            self.seen += 1
            if self.seen <= self.skip:
                self.totals()  # dropped
            elif self.steps % self.every == 0:
                self.fold()

    def fold(self):
        if self.marks:
            for k, v in self.totals().items():
                self.sums[k] = self.sums.get(k, 0.0) + v

    def per_step(self) -> dict:
        self.fold()
        out = {k: v / max(self.steps, 1) for k, v in self.sums.items()}
        out["assigner"] = out.get("assigner", 0.0) + out.get("gt_rays", 0.0)
        out["gt_rays_kernel"] = out.pop("gt_rays", 0.0)
        out["total"] = sum(v for k, v in out.items() if k != "gt_rays_kernel")
        return out


def epoch_split(trainer) -> dict:
    """Host-clock seconds of the trainer's epochs (``epoch_times``): the
    median per epoch of the train steps, the loader wait in them, the
    validation and the save, and their sums."""
    keys = ("train_s", "loader_wait_s", "val_s", "save_s")
    times = trainer.epoch_times
    return {"median": {k: statistics.median(t[k] for t in times) for k in keys},
            "sum": {k: sum(t[k] for t in times) for k in keys}}


def save_split(trainer) -> str:
    """The trainer's saves: how many, the training thread's save_s, the
    saver worker's seconds, and the host-clock train seconds of the epochs
    that follow a save against the others (the worker's pickle and writes
    share the process with the next epoch's steps)."""
    saved = set(trainer.saved_epochs)
    after = [t["train_s"] for t in trainer.epoch_times if t["epoch"] - 1 in saved]
    other = [t["train_s"] for t in trainer.epoch_times[1:] if t["epoch"] - 1 not in saved]
    write = trainer.saver.write_s if trainer.saver is not None else []
    med = lambda v: f"{statistics.median(v):.4f}" if v else "-"  # noqa: E731
    return (f"saves: {len(saved)} ({'async' if trainer.args.async_save else 'sync'}), save_s "
            f"summed {sum(t['save_s'] for t in trainer.epoch_times):.3f}, the worker's "
            f"{sum(write):.3f} s ({med(write)} s a save, median); train_s an epoch (median) after "
            f"a save {med(after)} over {len(after)}, after none {med(other)} over {len(other)}")


def train_floor(card: str, task: str = "segment", keep: Path = None):
    """``YOLO(yaml, device="cuda").train`` from scratch on the task's floor
    set (64 train and 16 val images, decoded) at its ``floor.json`` config
    with the floor checkpoint's train_args, last.ckpt saved every
    ``SAVE_LAST_EVERY`` epochs (launch counts zeroed just
    before, read just after): the final validation of the stripped
    ``best.ckpt`` must meet the floor. Segment: yolov8n-seg on the seg160
    set, 120 epochs at 160; detect: yolov8n on the detect set, 100 epochs at
    96; pose: yolov8n-pose on the pose set with its ``kpt_shape`` [5, 3] and
    ``flip_idx``, 150 epochs at 96, with the checkpoint's pose and kobj
    gains and fliplr; segment_ori: yolov8n-segori on the seg160 set at the
    seg160 config, its metrics recorded, not held (no segment_ori floor is
    committed). Prints the metrics, every 10th epoch's train loss
    beside the JAX run's ``results.csv`` (not for segment_ori, whose loss
    is not the polar run's), the wall time, the epoch and step
    splits and the peak memory; then ``YOLO(best.ckpt).predict`` on the val
    images must find detections (for pose, each with its keypoints). With
    ``keep``, the stripped best.ckpt is copied there."""
    ckpt_path, floor_json, yaml, train_set, val_set, _ = FLOOR_RUNS[task]
    phase = {"segment": "train_floor", "detect": "detect_trainer", "pose": "pose_trainer",
             "segment_ori": "segori_trainer"}[task]
    gated = task != "segment_ori"
    record = json.loads(floor_json.read_text())
    ckpt = load_checkpoint(ckpt_path)
    keys = FLOOR_TRAIN_KEYS + (POSE_TRAIN_KEYS if task == "pose" else ())
    over = {**{k: ckpt["train_args"][k] for k in keys}, "save_last_every": SAVE_LAST_EVERY}
    train, val = train_set(), val_set()
    data = {"train": train, "val": val, "names": ckpt["names"],
            **(floor_pose_data() if task == "pose" else {})}
    timer = TrainTotals(skip=len(train[0]) // over["batch"])
    with tempfile.TemporaryDirectory() as d:
        model = YOLO(yaml, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        t = time.perf_counter()
        res = model.train(data=data, mark=timer, project=d, name="floor", **over)
        wall = time.perf_counter() - t
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        trainer = model.trainer
        with open(trainer.csv) as fh:
            rows = list(csv.DictReader(fh))
        best = YOLO(trainer.wdir / "best.ckpt", device="cuda")
        pred = best.predict(val[0], imgsz=over["imgsz"], conf=0.25 if gated else VAL_CONF)
        if keep is not None:
            shutil.copyfile(trainer.wdir / "best.ckpt", keep)
    metrics = ", ".join(f"{k.split('/')[1]} {x:.4f}" for k, x in res.items() if k != "fitness")
    n_ep = len(trainer.epoch_times)
    split = epoch_split(trainer)
    steps = timer.seen
    floors = (", ".join(f"{n} {v}" for n, v in record["floor"].items()) if gated
              else "none (recorded, not held)")
    set_name = "seg160" if task == "segment_ori" else task
    log(phase, f"{yaml} from scratch on the {set_name} floor set ({len(train[0])} train, "
        f"{len(val[0])} val images), {over}: {n_ep} epochs, {steps} steps in {wall:.2f}s wall "
        f"({wall / n_ep:.3f}s an epoch); final eval of the stripped best.ckpt: {metrics}; floor "
        f"{floors}; launches {counts}; peak memory {peak / 2**30:.3f} GiB | {card}")
    if gated:
        with open(ckpt_path.parent / "results.csv") as fh:
            jax_rows = list(csv.DictReader(fh))
        pairs = [f"{e}: {float(rows[e]['train/loss']):.3f} vs "
                 f"{float(jax_rows[e]['train/loss']):.3f}"
                 for e in range(9, min(len(rows), len(jax_rows)), 10)]
        log(phase, f"train loss every 10th epoch, this run vs the JAX run's results.csv "
            f"(host augmentation, bf16 on a TPU; a yardstick, not a gate): {'; '.join(pairs)} | "
            f"{card}")
    else:
        pairs = [f"{e}: {float(rows[e]['train/loss']):.3f}" for e in range(9, len(rows), 10)]
        log(phase, f"train loss every 10th epoch: {'; '.join(pairs)} | {card}")
    med, tot = split["median"], split["sum"]
    per_step = timer.per_step()
    log(phase, "host clock, s an epoch (median of the epochs): "
        + ", ".join(f"{k} {v:.4f}" for k, v in med.items()) + "; summed over the run: "
        + ", ".join(f"{k} {v:.2f}" for k, v in tot.items())
        + f"; ms per step by the host clock {1e3 * tot['train_s'] / max(steps, 1):.3f} | {card}")
    log(phase, save_split(trainer) + f" | {card}")
    log(phase, f"device ms per step by CUDA events at the marks (mean of the "
        f"{timer.steps} steps after the first epoch; copy includes waiting for the card to "
        f"take it): "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_step.items()) + f" | {card}")
    below = {k: (res[k], record["floor"][n]) for k, n in record["floor_keys"].items()
             if gated and not res[k] >= record["floor"][n]}
    if below:
        raise AssertionError(f"{phase}: the port-trained best.ckpt is below the {task} floor: "
                             f"{below}")
    if task == "segment" and (counts["gt_rays_rows"] == 0 or counts["fill_polygons"] == 0):
        raise AssertionError(f"train_floor: a kernel of the path never launched: {counts}")
    if task == "segment_ori" and counts["fill_polygons"] < steps:
        raise AssertionError(f"{phase}: the GT-mask fill launched {counts['fill_polygons']} "
                             f"times in {steps} steps")
    n_det = sum(len(r) for r in pred)
    kpts = ""
    if task == "pose":
        k = data["kpt_shape"]
        if not all(r.keypoints.shape == (len(r), *k) and np.isfinite(r.keypoints).all()
                   for r in pred):
            raise AssertionError(f"{phase}: predict from best.ckpt gave keypoints of shapes "
                                 f"{[r.keypoints.shape for r in pred]}, not (n, {k[0]}, {k[1]})")
        kpts = f", each with its {k[0]} keypoints"
    log(phase, f"YOLO(best.ckpt).predict on the {len(pred)} val images: {n_det} "
        f"detections{kpts} | {card}")
    if n_det == 0:
        raise AssertionError(f"{phase}: predict from the trained best.ckpt found nothing")
    return counts


def train_640(card: str):
    """The trainer at the size users train: ``YOLO("yolov8n-seg.yaml")``
    with the default config (nbs 64, so 4 micro-batches an optimizer step,
    and MixUp on) at imgsz 640 batch 16 for ``TRAIN640_EPOCHS`` epochs on
    ``TRAIN640_N`` 480x640 frames with exact labels, validating on
    ``TRAIN640_VAL`` (launch counts zeroed just before, read just after):
    images per second, over all epochs and over those after the first (16
    optimizer steps), and the same splits as ``train_floor``."""
    train = shape_val_set(TRAIN640_N, *VAL640_HW, seed=7)
    val = shape_val_set(TRAIN640_VAL, *VAL640_HW, seed=8)
    data = {"train": train, "val": val, "names": {0: "circle", 1: "rect"}}
    timer = TrainTotals(skip=TRAIN640_N // 64)  # the first epoch: 64 images (nbs) a step
    with tempfile.TemporaryDirectory() as d:
        model = YOLO("yolov8n-seg.yaml", device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        t = time.perf_counter()
        res = model.train(data=data, mark=timer, project=d, name="train640", epochs=TRAIN640_EPOCHS,
                          imgsz=640, batch=16)
        wall = time.perf_counter() - t
        counts = launch_counts()
    trainer = model.trainer
    split = epoch_split(trainer)
    tot = split["sum"]
    n_img = TRAIN640_N * len(trainer.epoch_times)
    later_s = sum(t["train_s"] for t in trainer.epoch_times[1:])
    n_later = TRAIN640_N * (len(trainer.epoch_times) - 1)
    per_step = timer.per_step()
    metrics = ", ".join(f"{k.split('/')[1]} {res[k]:.4f}" for k in METRIC_KEYS)
    log("train_640", f"yolov8n-seg from scratch, default config, imgsz 640 batch 16, accumulate "
        f"{trainer.args.accumulate}, {len(trainer.epoch_times)} epochs of {TRAIN640_N} 480x640 "
        f"frames: {n_img / tot['train_s']:.1f} images/s in the train steps "
        f"({n_later / later_s:.1f} after the first epoch, {timer.steps} optimizer steps), "
        f"{n_img / wall:.1f} images/s over the {wall:.2f}s wall; {metrics} (printed, not held); "
        f"launches {counts}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"| {card}")
    log("train_640", "host clock, s summed over the epochs: "
        + ", ".join(f"{k} {v:.3f}" for k, v in tot.items())
        + f"; epochs (host clock, s) {[round(t['train_s'], 3) for t in trainer.epoch_times]}"
        + f"; device ms per optimizer step by CUDA events after the first epoch ({timer.steps} "
        f"steps of {trainer.args.accumulate} micro-batches): "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_step.items()) + f" | {card}")
    if counts["gt_rays_rows"] == 0 or counts["fill_polygons"] == 0:
        raise AssertionError(f"train_640: a kernel of the path never launched: {counts}")
    return counts


def _decoded_set(path):
    with np.load(path) as z:
        kpt_shape = tuple(int(v) for v in z["kpt_shape"]) if "kpt_shape" in z else None
        return list(z["images"]), [parse_label_lines(str(t).splitlines(), kpt_shape=kpt_shape)
                                   for t in z["labels"]]


def floor_val_set():
    """The 16 val images of the seg160 floor set (``make_shape_dataset(n_train=64,
    n_val=16, imgsz=160, seed=0)``, decoded by cv2) and their labels, parsed
    from the committed label lines."""
    return _decoded_set(FLOOR_VAL)


def floor_train_set():
    """The 64 train images of the same floor set, decoded the same way."""
    return _decoded_set(FLOOR_TRAIN)


def floor_detect_val_set():
    """The 16 val images of the detect floor set (``make_shape_dataset(
    n_train=64, n_val=16, imgsz=96, seed=0)``, decoded by cv2) and their
    labels, parsed from the committed label lines."""
    return _decoded_set(FLOOR_DETECT_VAL)


def floor_detect_train_set():
    """The 64 train images of the detect floor set, decoded the same way."""
    return _decoded_set(FLOOR_DETECT_TRAIN)


def _jax_metrics(path) -> dict:
    with np.load(path) as z:
        return {str(k): float(v) for k, v in zip(z["jax_metric_names"], z["jax_metrics"])}


def floor_detect_jax_metrics() -> dict:
    """The JAX validator's metrics of ``runs/floor_detect/best.ckpt`` on the
    detect floor set at imgsz 96, batch 4, stored with the set."""
    return _jax_metrics(FLOOR_DETECT_VAL)


def floor_pose_val_set():
    """The 16 val images of the pose floor set (``make_pose_dataset(
    n_train=64, n_val=16, imgsz=96, seed=0)``, decoded by cv2) and their
    labels with keypoints, parsed from the committed label lines."""
    return _decoded_set(FLOOR_POSE_VAL)


def floor_pose_train_set():
    """The 64 train images of the pose floor set, decoded the same way."""
    return _decoded_set(FLOOR_POSE_TRAIN)


def floor_pose_data() -> dict:
    """The pose floor set's ``kpt_shape`` and ``flip_idx``, from its data
    yaml, stored with the set."""
    with np.load(FLOOR_POSE_TRAIN) as z:
        return {"kpt_shape": [int(v) for v in z["kpt_shape"]],
                "flip_idx": [int(v) for v in z["flip_idx"]]}


def floor_pose_jax_metrics() -> dict:
    """The JAX validator's metrics of ``runs/floor_pose/best.ckpt`` on the
    pose floor set at imgsz 96, batch 4, stored with the set."""
    return _jax_metrics(FLOOR_POSE_VAL)


def floor_rtdetr_val_set():
    """The 16 val images of the RT-DETR floor set (``make_shape_dataset(
    n_train=64, n_val=16, imgsz=192, seed=0)``, decoded by cv2) and their
    labels, parsed from the committed label lines."""
    return _decoded_set(FLOOR_RTDETR_VAL)


def floor_rtdetr_jax_metrics() -> dict:
    """The JAX validator's metrics of ``runs/floor_rtdetr/best.ckpt`` on the
    RT-DETR floor set at imgsz 192, batch 4, stored with the set."""
    return _jax_metrics(FLOOR_RTDETR_VAL)


# per task: the floor checkpoint, its floor.json, the model a trainer starts
# from, the floor set's train and val images, and the JAX validator's
# metrics stored with the val set (the seg160 set's are checked by
# ``validate_floor`` against the CPU port instead); segment_ori borrows the
# seg160 set, checkpoint (its train_args) and floor.json (its config), and
# holds no floor
FLOOR_RUNS = {
    "segment": (CKPT, FLOOR_JSON, "yolov8n-seg.yaml", floor_train_set, floor_val_set, None),
    "detect": (DETECT_CKPT, DETECT_FLOOR_JSON, "yolov8n.yaml", floor_detect_train_set,
               floor_detect_val_set, floor_detect_jax_metrics),
    "pose": (POSE_CKPT, POSE_FLOOR_JSON, "yolov8n-pose.yaml", floor_pose_train_set,
             floor_pose_val_set, floor_pose_jax_metrics),
    # no segment_ori floor: the seg160 set and config, the metrics recorded
    "segment_ori": (CKPT, FLOOR_JSON, "yolov8n-segori.yaml", floor_train_set, floor_val_set,
                    None),
    # no RT-DETR trainer (JAX trains it through the host cv2 pipeline)
    "rtdetr": (RTDETR_CKPT, RTDETR_FLOOR_JSON, "yolov8n-rtdetr.yaml", None, floor_rtdetr_val_set,
               floor_rtdetr_jax_metrics),
}


def eval_np(validator, model, batch: dict, device) -> dict:
    """``validator.eval_batch`` of one collated batch on ``device``, as numpy."""
    dev = {k: torch.from_numpy(batch[k]).to(device) for k in EVAL_KEYS}
    return {k: v.cpu().numpy() for k, v in validator.eval_batch(model, dev).items()}


def compare_eval(got: dict, want: dict, conf: float = VAL_CONF, iou: float = VAL_IOU) -> dict:
    """Two eval outputs of one batch (numpy dicts of ``eval_batch``), held
    detection by detection. Detections pair up by class and box (each box
    within ``BOX_ATOL`` px, each detection once). A detection found on one
    side only is named, with its cause, and must have one: "gate", its
    score within ``VAL_GATE_TOL`` of ``conf``; "iou", on the other side a
    kept detection of its class ranked above it overlaps it by an IoU
    within ``VAL_IOU_TOL`` of ``iou``; "rank", on the other side a
    detection of its class within ``VAL_SCORE_ATOL`` of its score overlaps
    it by more than ``iou - VAL_IOU_TOL`` (the two swapped ranks, so the
    other suppressed it there); "knock-on", its suppressor on the other
    side (ranked above it, the same overlap) is itself a detection found
    on one side only, with a cause; "max_det", the other side is full and
    its score is within ``VAL_SCORE_ATOL`` of that side's last. Overlaps are
    of the boxes NMS compared: each detection's 36 contour points' extent,
    unclipped. Pairs: scores within ``VAL_SCORE_ATOL``, box IoUs with every
    GT within ``VAL_BOX_IOU_ATOL``, mask IoUs within ``VAL_MASK_IOU_ATOL``.
    Returns the worst differences, the named detections and ``ok``."""
    sides = (got, want)
    res = {"pairs": 0, "box": 0.0, "score": 0.0, "ious_box": 0.0, "ious_mask": 0.0,
           "gt_boxes": float(np.abs(got["gt_boxes"] - want["gt_boxes"]).max()), "named": []}
    for bi in range(got["valid"].shape[0]):
        dets = [np.nonzero(o["valid"][bi])[0] for o in sides]
        pairs, used = [], set()
        for i in dets[0]:
            d = np.abs(want["boxes"][bi, dets[1]] - got["boxes"][bi, i]).max(-1, initial=0.0)
            ok = [(d[n], j) for n, j in enumerate(dets[1]) if j not in used and d[n] <= BOX_ATOL
                  and want["classes"][bi, j] == got["classes"][bi, i]]
            if ok:
                j = min(ok)[1]
                used.add(j)
                pairs.append((i, j))
        for i, j in pairs:
            res["box"] = max(res["box"], float(np.abs(got["boxes"][bi, i] - want["boxes"][bi, j]).max()))
            res["score"] = max(res["score"], abs(float(got["scores"][bi, i] - want["scores"][bi, j])))
            for key in ("ious_box", "ious_mask"):
                diff = np.abs(got[key][bi][:, i] - want[key][bi][:, j]).max(initial=0.0)
                res[key] = max(res[key], float(diff))
        res["pairs"] += len(pairs)
        paired = ({i for i, _ in pairs}, {j for _, j in pairs})
        alone = [(s, k) for s in (0, 1) for k in dets[s] if k not in paired[s]]
        box = [torch.from_numpy(np.concatenate([o["pred_pts"][bi].min(-2),
                                                o["pred_pts"][bi].max(-2)], -1)) for o in sides]
        cause = {}
        for s, k in alone:
            o, q = sides[s], 1 - s
            cls, score = o["classes"][bi, k], float(o["scores"][bi, k])
            other = [j for j in dets[q] if sides[q]["classes"][bi, j] == cls]
            ov = box_iou(box[s][k][None], box[q][other])[0].numpy()
            sc = sides[q]["scores"][bi, other]
            if abs(score - conf) <= VAL_GATE_TOL:
                cause[(s, k)] = "gate"
            elif np.any((sc >= score - VAL_SCORE_ATOL) & (np.abs(ov - iou) <= VAL_IOU_TOL)):
                cause[(s, k)] = "iou"
            elif np.any((np.abs(sc - score) <= VAL_SCORE_ATOL) & (ov > iou - VAL_IOU_TOL)):
                cause[(s, k)] = "rank"
            elif (len(dets[q]) == got["valid"].shape[1]
                  and score <= float(sides[q]["scores"][bi, dets[q]].min()) + VAL_SCORE_ATOL):
                cause[(s, k)] = "max_det"
        grew = True
        while grew:  # knock-on, to a fixpoint
            grew = False
            for s, k in alone:
                if (s, k) in cause:
                    continue
                o, q = sides[s], 1 - s
                score = float(o["scores"][bi, k])
                for j in dets[q]:
                    if ((q, j) in cause and sides[q]["classes"][bi, j] == o["classes"][bi, k]
                            and sides[q]["scores"][bi, j] >= score - VAL_SCORE_ATOL
                            and float(box_iou(box[s][k][None], box[q][j][None])) > iou - VAL_IOU_TOL):
                        cause[(s, k)] = f"knock-on of {('card', 'cpu')[q]} slot {j}"
                        grew = True
                        break
        for s, k in alone:
            o = sides[s]
            res["named"].append((("card", "cpu")[s], int(bi), int(k), int(o["classes"][bi, k]),
                                 float(o["scores"][bi, k]), cause.get((s, k))))
    res["ok"] = (all(n[-1] for n in res["named"]) and res["box"] <= BOX_ATOL
                 and res["score"] <= VAL_SCORE_ATOL and res["ious_box"] <= VAL_BOX_IOU_ATOL
                 and res["ious_mask"] <= VAL_MASK_IOU_ATOL and res["gt_boxes"] <= BOX_ATOL)
    return res


def grid_polygons(out: dict, batch: dict, grid: int):
    """The polygons ``eval_batch`` compares on its grid, from its outputs
    and batch (numpy): per image (GT points, GT valid, predicted points,
    predicted valid), all scaled onto the ``grid`` x ``grid`` mask grid."""
    h, w = batch["img"].shape[1:3]
    ratio_pad = torch.from_numpy(batch["ratio_pad"])
    gpts = scale_coords(torch.from_numpy(batch["segments"]) * torch.tensor([w, h], dtype=torch.float32),
                        ratio_pad)
    s = grid_scale(torch.from_numpy(batch["ori_shape"]), grid)[:, None, None, None]
    gpts, ppts = gpts * s, torch.from_numpy(out["pred_pts"]) * s
    gvalid = torch.from_numpy(batch["mask_gt"])[..., None].expand(gpts.shape[:-1])
    pvalid = torch.from_numpy(out["pred_pts_valid"])
    return [(gpts[b], gvalid[b], ppts[b], pvalid[b]) for b in range(len(gpts))]


def validate_floor(model, cpu, card: str):
    """(a) ``YOLO.val`` on the card over the seg160 floor set at imgsz 160,
    batch 4 (launch counts zeroed just before, read just after): the floor
    of ``runs/floor_seg160/floor.json`` must hold. Then the first batch's
    eval outputs, card against the port on the CPU (``compare_eval``), and
    ``polygon_mask_iou`` on the card (the fill kernel and the product)
    against its plain version on the card and on the CPU, on the CPU run's
    polygons: 0 differing IoUs."""
    images, labels = floor_val_set()
    record = json.loads(FLOOR_JSON.read_text())
    zero_launch_counts()
    res = model.val(images, labels, imgsz=VAL_IMGSZ, batch=VAL_B, conf=VAL_CONF, iou=VAL_IOU)
    counts = launch_counts()
    speed = model.validator.speed
    metrics = ", ".join(f"{k.split('/')[1]} {res[k]:.4f}" for k in METRIC_KEYS)
    log("validate", f"floor set, {len(images)} images at imgsz {VAL_IMGSZ} batch {VAL_B} on the "
        f"card: {metrics}; ms per image (host clock) "
        f"{', '.join(f'{k} {v:.3f}' for k, v in speed.items())}; launches {counts} | {card}")
    below = {k: (res[k], record["floor"][n]) for k, n in record["floor_keys"].items()
             if not res[k] >= record["floor"][n]}
    if below:
        raise AssertionError(f"validate on the card below the seg160 floor: {below}")
    if counts["fill_polygons"] == 0:
        raise AssertionError("the validate path never launched the even-odd fill kernel")

    v = SegmentationValidator(imgsz=VAL_IMGSZ, batch=VAL_B, conf=VAL_CONF, iou=VAL_IOU)
    batch = next(iter(v.loader(images, labels)))
    got, want = eval_np(v, model.model, batch, "cuda"), eval_np(v, cpu.model, batch, "cpu")
    cmp = compare_eval(got, want)
    for side, bi, k, c, score, why in cmp["named"]:
        log("validate", f"  on the {side} only: image {bi} slot {k} class {c} score {score:.6f}: "
            f"{why or 'NOT EXPLAINED'}")
    log("validate", f"card vs CPU, first batch of {VAL_B}: {int(got['valid'].sum())} and "
        f"{int(want['valid'].sum())} detections, {cmp['pairs']} paired, {len(cmp['named'])} on one "
        f"side only; worst: boxes {cmp['box']:.2e} px (limit {BOX_ATOL}), scores "
        f"{cmp['score']:.2e} (limit {VAL_SCORE_ATOL}), ious_box {cmp['ious_box']:.2e} (limit "
        f"{VAL_BOX_IOU_ATOL}), ious_mask {cmp['ious_mask']:.2e} (limit {VAL_MASK_IOU_ATOL}), GT "
        f"boxes {cmp['gt_boxes']:.2e} px | {card}")
    if not cmp["ok"]:
        raise AssertionError("validate: the card's eval outputs differ from the CPU port's")

    n_diff = n_all = 0
    for g, gv, p, pv in grid_polygons(want, batch, v.grid):
        kernel = raster.polygon_mask_iou(g.cuda(), gv.cuda(), p.cuda(), pv.cuda(), v.grid, v.grid)
        plain = raster.polygon_mask_iou_plain(g.cuda(), gv.cuda(), p.cuda(), pv.cuda(), v.grid,
                                              v.grid)
        host = raster.polygon_mask_iou_plain(g, gv, p, pv, v.grid, v.grid)
        n_diff += int((kernel != plain).sum()) + int((kernel.cpu() != host).sum())
        n_all += kernel.numel()
    log("validate", f"polygon_mask_iou on the card (fill kernel + product) vs its plain version "
        f"on the card and on the CPU, the CPU run's polygons on {v.grid}x{v.grid}: {n_diff} of "
        f"{2 * n_all} IoUs differ | {card}")
    if n_diff:
        raise AssertionError(f"polygon_mask_iou: {n_diff} IoUs differ from the plain version")
    return res, counts


def validate_full_width(model, card: str, passes: int = 3, phase: str = "validate"):
    """(b) The task's validator at imgsz 640, batch 16, over ``VAL640_N``
    480x640 frames with exact labels (``shape_val_set``; for pose with the
    model's keypoint count along each contour, ``with_keypoints``): one pass with the
    launch counts zeroed just before and read just after and the peak
    device memory, then ``passes`` timed passes, ms per image (median): host
    preprocess, then by CUDA events at the validator's marks forward + NMS,
    scale + box IoU, and for the segment task ``polygon_mask_iou`` (fills
    and product), then host matching + metrics; and the device eval on the
    host clock."""
    images, labels = shape_val_set(VAL640_N, *VAL640_HW, seed=6)
    if model.task == "pose":
        labels = with_keypoints(labels, model.model.kpt_shape[0])
    timer = StageTimer()
    seg = model.task == "segment"
    v = {"segment": SegmentationValidator, "detect": DetectionValidator,
         "pose": PoseValidator, "segment_ori": SegmentationOriValidator,
         "rtdetr": RTDETRValidator}[model.task](
        imgsz=640, batch=VAL640_B, conf=VAL_CONF, iou=VAL_IOU, mark=timer)
    v(model.model, images, labels)  # warm-up
    timer.marks = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    res = v(model.model, images, labels)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    timer.marks = []
    splits = []
    for _ in range(passes):
        v(model.model, images, labels)
        dev = {k: x / len(images) for k, x in timer.totals().items()}
        splits.append({"preprocess": v.speed["preprocess"], **dev,
                       "matching": v.speed["matching"], "eval (host clock)": v.speed["eval"]})
    med = {k: statistics.median(sp[k] for sp in splits) for k in splits[0]}
    if model.task in ("segment", "segment_ori") and counts["fill_polygons"] == 0:
        raise AssertionError("the validate path at 640 never launched the even-odd fill kernel")
    metrics = ", ".join(f"{k.split('/')[1]} {x:.4f}" for k, x in res.items() if k != "fitness")
    log(phase, f"full width, {VAL640_N} images {VAL640_HW[0]}x{VAL640_HW[1]} at imgsz 640 "
        f"batch {VAL640_B} (printed, not held: "
        f"{f'the model was trained at {model.imgsz}' if model.ckpt_path else 'random weights'}): "
        f"{metrics}; "
        f"launches of one pass {counts}; peak device memory {peak / 2**30:.3f} GiB | {card}")
    log(phase, f"imgsz 640 batch {VAL640_B}, ms per image (median of {passes} passes): "
        f"{', '.join(f'{k} {x:.3f}' for k, x in med.items())} | {card}")
    if not seg:
        return res, counts, med, peak
    batch = next(iter(v.loader(images, labels)))
    g, gv, p, pv = (t.cuda() for t in grid_polygons(eval_np(v, model.model, batch, "cuda"), batch,
                                                    v.grid)[0])
    call = lambda: raster.polygon_mask_iou(g, gv, p, pv, v.grid, v.grid)  # noqa: E731
    call()
    ms = time_ms(call, reps=10)
    try:
        kernels = device_kernels(call) or device_kernels(call)
    except Exception as e:
        kernels = f"not measured ({type(e).__name__}: {e})"
    by_name = {}
    for name, us in kernels if isinstance(kernels, list) else ():
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, round(t + us, 1))
    log("validate", f"polygon_mask_iou of one image ({len(g)} GT slots of 360 points, {len(p)} "
        f"detection slots of 36, {v.grid}x{v.grid}): {ms:.4f} ms a call (CUDA events, median of "
        f"10); device kernels by name (launches, µs summed, torch.profiler): "
        f"{by_name if by_name else kernels} | {card}")
    return res, counts, med, peak


def predict_ms(model, images, imgsz: int, batch: int, masks: bool, conf: float = 0.25) -> dict:
    """One predict call at ``conf`` (and, with ``masks``, every result's
    masks); ms per image of each stage on the host clock."""
    t = time.perf_counter()
    res = model.predict(images, imgsz=imgsz, batch=batch, conf=conf)
    t_masks = time.perf_counter()
    if masks:
        for r in res:
            r.masks  # noqa: B018 (rasterize)
    torch.cuda.synchronize()
    end = time.perf_counter()
    n = len(images)
    stages = {k: statistics.fmean(r.speed[k] for r in res)
              for k in ("preprocess", "inference", "postprocess")}
    out = {"total": (end - t) * 1e3 / n, **stages}
    if masks:
        out["masks"] = (end - t_masks) * 1e3 / n
    return out


def predictor_of(model):
    return {"segment": SegmentationPredictor, "detect": DetectionPredictor,
            "pose": PosePredictor, "segment_ori": SegmentationOriPredictor,
            "classify": ClassificationPredictor, "rtdetr": RTDETRPredictor}[model.task]


def head_maps(out):
    """A model's raw outputs as a flat list of tensors (segment_ori's
    levels and prototypes, classify's probabilities)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, tuple):
        return head_maps(out[0]) + head_maps(out[1])
    return list(out)


def card_vs_cpu_predict(model, cpu, images, imgsz: int, phase: str, card: str,
                        conf: float = 0.25):
    """The card's head maps and predict outputs against the port on the CPU,
    from the same letterboxed inputs, NMS at ``conf``: head maps within ``HEAD_ATOL``, the
    same detections, boxes within ``BOX_ATOL`` px, scores within
    ``SCORE_ATOL``; for pose the kept detections' keypoints within
    ``BOX_ATOL`` px and their visibilities within ``SCORE_ATOL``."""
    pred = predictor_of(model)(imgsz=imgsz, conf=conf)
    worst = dict.fromkeys(("head", "box", "score", "keypoint", "visibility"), 0.0)
    n_det = 0
    for img in images:
        x, _, _ = pred.preprocess_u8(img, imgsz)
        xt = torch.from_numpy(x[None])
        with torch.inference_mode():
            xf = xt.float().div(255.0).permute(0, 3, 1, 2).contiguous()
            for g, c in zip(head_maps(model.model(xf.cuda())), head_maps(cpu.model(xf))):
                worst["head"] = max(worst["head"], float((g.cpu() - c).abs().max()))
        out_gpu = {k: v.cpu() for k, v in pred.eval_batch(model.model, xt.cuda()).items()}
        out_cpu = pred.eval_batch(cpu.model, xt)
        if not (torch.equal(out_gpu["valid"], out_cpu["valid"])
                and torch.equal(out_gpu["classes"], out_cpu["classes"])):
            raise AssertionError(f"{phase}: card and CPU keep different detections")
        worst["box"] = max(worst["box"], float((out_gpu["boxes"] - out_cpu["boxes"]).abs().max()))
        worst["score"] = max(worst["score"],
                             float((out_gpu["scores"] - out_cpu["scores"]).abs().max()))
        if model.task == "pose":
            keep = out_cpu["valid"]
            d = (out_gpu["extras"][keep] - out_cpu["extras"][keep]).abs()
            d = d.reshape(d.shape[0], -1, model.model.kpt_shape[1])
            if d.numel():
                worst["keypoint"] = max(worst["keypoint"], float(d[..., :2].max()))
                worst["visibility"] = max(worst["visibility"], float(d[..., 2:].max()))
        n_det += int(out_cpu["valid"].sum())
    limits = {"head": HEAD_ATOL, "box": BOX_ATOL, "score": SCORE_ATOL, "keypoint": BOX_ATOL,
              "visibility": SCORE_ATOL}
    if any(worst[k] > limits[k] for k in limits) or n_det == 0:
        raise AssertionError(f"{phase} card vs CPU: {worst} (limits {limits}), {n_det} detections")
    log(phase, f"card vs CPU at imgsz {imgsz} on {len(images)} images: head max abs "
        f"{worst['head']:.2e} (limit {HEAD_ATOL}), the same {n_det} detections, boxes max abs "
        f"{worst['box']:.2e} px (limit {BOX_ATOL}), scores {worst['score']:.2e} (limit "
        f"{SCORE_ATOL})"
        + (f", keypoints {worst['keypoint']:.2e} px (limit {BOX_ATOL}), visibilities "
           f"{worst['visibility']:.2e} (limit {SCORE_ATOL})" if model.task == "pose" else "")
        + f" | {card}")


def fuse_check(task: str, card: str, ckpt_path: Path = None) -> dict:
    """``YOLO(floor checkpoint).fuse()`` (or ``ckpt_path``'s) on the card
    against the unfused model on the card: head maps within
    ``FUSE_HEAD_ATOL`` and the same detections (boxes within ``BOX_ATOL``)
    on the floor set's val images; then both validated on the floor set
    (launch counts zeroed just before the fused run, read just after): each
    metric of the fused model within ``FUSE_METRIC_ATOL`` of the unfused
    one's, and the floor met (segment_ori has none). The segment tasks'
    validations launch the even-odd fill kernel."""
    floor_ckpt, floor_json, _, _, val_set, _ = FLOOR_RUNS[task]
    ckpt_path = ckpt_path or floor_ckpt
    record = json.loads(floor_json.read_text())
    images, labels = val_set()
    plain = YOLO(ckpt_path, device="cuda")
    fused = YOLO(ckpt_path, device="cuda").fuse()
    imgsz = plain.imgsz
    pred = predictor_of(plain)(imgsz=imgsz)
    worst_head = worst_box = 0.0
    n_det = 0
    for img in images[:8]:
        x, _, _ = pred.preprocess_u8(img, imgsz)
        xt = torch.from_numpy(x[None]).cuda()
        with torch.inference_mode():
            xf = xt.float().div(255.0).permute(0, 3, 1, 2).contiguous()
            for g, c in zip(head_maps(fused.model(xf)), head_maps(plain.model(xf))):
                worst_head = max(worst_head, float((g - c).abs().max()))
        og, oc = pred.eval_batch(fused.model, xt), pred.eval_batch(plain.model, xt)
        if not (torch.equal(og["valid"], oc["valid"]) and torch.equal(og["classes"], oc["classes"])):
            raise AssertionError(f"fuse {task}: fused and unfused keep different detections")
        worst_box = max(worst_box, float((og["boxes"] - oc["boxes"]).abs().max()))
        n_det += int(oc["valid"].sum())
    want = plain.val(images, labels, imgsz=imgsz, batch=VAL_B, conf=VAL_CONF, iou=VAL_IOU)
    zero_launch_counts()
    got = fused.val(images, labels, imgsz=imgsz, batch=VAL_B, conf=VAL_CONF, iou=VAL_IOU)
    counts = launch_counts()
    gaps = {k: abs(got[k] - want[k]) for k in want}
    below = {k: (got[k], record["floor"][n]) for k, n in record["floor_keys"].items()
             if task != "segment_ori" and not got[k] >= record["floor"][n]}
    metrics = ", ".join(f"{k.split('/')[1]} {x:.4f}" for k, x in got.items() if k != "fitness")
    log("fuse", f"{task} ({ckpt_path.parent.name}/{ckpt_path.name}) fused on the card vs "
        f"unfused on the card, "
        f"{min(len(images), 8)} images at imgsz {imgsz}: head max abs {worst_head:.2e} (limit "
        f"{FUSE_HEAD_ATOL}), the same {n_det} detections, boxes max abs {worst_box:.2e} px; "
        f"{plain.model.num_params} -> {fused.model.num_params} parameters | {card}")
    log("fuse", f"{task} fused, validated on the floor set at imgsz {imgsz} batch {VAL_B}: "
        f"{metrics}; worst gap to the unfused model {max(gaps.values()):.2e} (limit "
        f"{FUSE_METRIC_ATOL}); floor "
        f"{record['floor'] if task != 'segment_ori' else 'none (not held)'}; launches {counts} | "
        f"{card}")
    if worst_head > FUSE_HEAD_ATOL or worst_box > BOX_ATOL or n_det == 0:
        raise AssertionError(f"fuse {task}: head {worst_head:.2e}, boxes {worst_box:.2e}, "
                             f"{n_det} detections")
    if max(gaps.values()) > FUSE_METRIC_ATOL or below:
        raise AssertionError(f"fuse {task}: metric gaps {gaps}, below the floor {below}")
    if task in ("segment", "segment_ori") and counts["fill_polygons"] == 0:
        raise AssertionError("the fused validate path never launched the even-odd fill kernel")
    return counts


def detect_predict(card: str):
    """``YOLO(runs/floor_detect/best.ckpt).predict`` on the detect floor
    set's val images at imgsz 96 (batch 1) and on 480x640 frames at 640
    (batch 8), launch counts zeroed just before and read just after (the
    detect path has no kernel of its own); ms per image; then the card
    against the port on the CPU at 96."""
    model = YOLO(DETECT_CKPT, device="cuda")
    imgs96 = floor_detect_val_set()[0]
    imgs640 = shape_images(8, *RASTER_HW, seed=2)
    zero_launch_counts()
    n96 = sum(len(r) for r in model.predict(imgs96, imgsz=DETECT_IMGSZ))
    n640 = sum(len(r) for r in model.predict(imgs640, imgsz=640, batch=8))
    lat = {}
    for imgsz, images, batch in ((DETECT_IMGSZ, imgs96[:1], 1), (640, imgs640, 8)):
        predict_ms(model, images, imgsz, batch, masks=False)  # warm-up
        runs = [predict_ms(model, images, imgsz, batch, masks=False) for _ in range(10)]
        lat[imgsz] = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    counts = launch_counts()
    if n96 == 0:
        raise AssertionError("detect predict at 96 found nothing on the floor images")
    log("detect_predict", f"imgsz {DETECT_IMGSZ}: {n96} detections on {len(imgs96)} floor images; "
        f"imgsz 640 batch 8: {n640} detections on {len(imgs640)} frames (a model trained at 96); "
        f"launches {counts} | {card}")
    for imgsz, batch in ((DETECT_IMGSZ, 1), (640, 8)):
        parts = ", ".join(f"{k} {v:.3f}" for k, v in lat[imgsz].items())
        log("detect_predict", f"imgsz {imgsz} batch {batch}, ms per image (host clock, median of "
            f"10 calls): {parts} | {card}")
    card_vs_cpu_predict(model, YOLO(DETECT_CKPT, device="cpu"), imgs96[:8], DETECT_IMGSZ,
                        "detect_predict", card)
    return model


def validate_floor_jax(model, card: str, task: str):
    """``YOLO(floor checkpoint).val`` on the card over the task's floor set
    (detect, pose or rtdetr) at its imgsz, batch 4: the floor met (box
    mAP50-95, and for pose the keypoints' too), and each metric within
    ``DETECT_METRIC_ATOL`` of the JAX validator's (stored with the set)."""
    ckpt_path, floor_json, _, _, val_set, jax_metrics = FLOOR_RUNS[task]
    images, labels = val_set()
    record = json.loads(floor_json.read_text())
    want = jax_metrics()
    phase = f"{task}_validate"
    zero_launch_counts()
    res = model.val(images, labels, imgsz=model.imgsz, batch=VAL_B, conf=VAL_CONF, iou=VAL_IOU)
    counts = launch_counts()
    gaps = {k: abs(res[k] - want[k]) for k in want}
    metrics = ", ".join(f"{k.split('/')[-1]} {x:.4f} (JAX {want[k]:.4f})" for k, x in res.items())
    log(phase, f"floor set, {len(images)} images at imgsz {model.imgsz} batch {VAL_B} "
        f"on the card: {metrics}; worst gap {max(gaps.values()):.2e} (limit "
        f"{DETECT_METRIC_ATOL}); floor {record['floor']}; ms per image (host clock) "
        f"{', '.join(f'{k} {v:.3f}' for k, v in model.validator.speed.items())}; launches "
        f"{counts} | {card}")
    below = {k: (res[k], record["floor"][n]) for k, n in record["floor_keys"].items()
             if not res[k] >= record["floor"][n]}
    if below or set(gaps) != set(res) or max(gaps.values()) > DETECT_METRIC_ATOL:
        raise AssertionError(f"{task} validate on the card: gaps {gaps}, below the floor {below}")
    return res


def fresh_model(name: str, names: dict, seed: int, device="cuda") -> YOLO:
    """``YOLO(name)`` holding that published config at full width (nc
    ``len(names)``), initialized as the trainer initializes a fresh model
    (``init_weights``) from ``seed``, in eval mode."""
    handle = YOLO(name, device=device)
    model = build_model(yaml_model_load(name), nc=len(names))
    model.names = dict(names)
    init_weights(model, torch.Generator().manual_seed(seed))
    handle.model = model.to(device).eval()
    return handle


def fresh_nas(device="cuda", seed: int = 0) -> NAS:
    """``NAS("yolo_nas_s")`` holding the published s scale at full width (nc
    2, the shape classes), a fresh init from ``seed`` (``fresh_model``)."""
    handle = NAS("yolo_nas_s", device=device)
    handle.model = fresh_model("yolo_nas_s.yaml", SHAPE_NAMES, seed, device).model
    return handle


def fresh_pose_model(device="cuda") -> YOLO:
    """The published yolov8n-pose (nc 1, 17 keypoints) at full width, a
    fresh init from ``POSE_SEED`` (``fresh_model``)."""
    return fresh_model("yolov8n-pose.yaml", {0: "person"}, POSE_SEED, device)


def pose_predict(card: str):
    """``YOLO(runs/floor_pose/best.ckpt).predict`` on the pose floor set's
    val images at imgsz 96 (batch 1), and the fresh full-width yolov8n-pose
    (``fresh_pose_model``) on 480x640 frames at 640 (batch 8), launch counts
    zeroed just before and read just after (the pose path has no kernel of
    its own): every result's keypoints (n, K, 3) and finite; ms per image;
    then the floor model on the card against the port on the CPU at 96
    (heads, detections, boxes, scores, keypoints)."""
    model = YOLO(POSE_CKPT, device="cuda")
    full = fresh_pose_model()
    imgs96 = floor_pose_val_set()[0]
    imgs640 = shape_images(8, *RASTER_HW, seed=2)
    zero_launch_counts()
    res96 = model.predict(imgs96, imgsz=POSE_IMGSZ)
    res640 = full.predict(imgs640, imgsz=640, batch=8, conf=VAL_CONF)
    for res, k in ((res96, model.model.kpt_shape), (res640, full.model.kpt_shape)):
        bad = [r.keypoints.shape for r in res
               if r.keypoints.shape != (len(r), *k) or not np.isfinite(r.keypoints).all()]
        if bad:
            raise AssertionError(f"pose predict: keypoints of shapes {bad}, not (n, {k[0]}, 3)")
    n96, n640 = sum(len(r) for r in res96), sum(len(r) for r in res640)
    lat = {}
    for imgsz, m, images, batch in ((POSE_IMGSZ, model, imgs96[:1], 1), (640, full, imgs640, 8)):
        predict_ms(m, images, imgsz, batch, masks=False)  # warm-up
        runs = [predict_ms(m, images, imgsz, batch, masks=False) for _ in range(10)]
        lat[imgsz] = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    counts = launch_counts()
    if n96 == 0:
        raise AssertionError("pose predict at 96 found nothing on the floor images")
    log("pose_predict", f"floor_pose (K {model.model.kpt_shape[0]}) at imgsz {POSE_IMGSZ}: {n96} "
        f"detections with keypoints on {len(imgs96)} floor images; yolov8n-pose full width (K "
        f"{full.model.kpt_shape[0]}, {full.model.num_params} parameters, random weights from "
        f"seed {POSE_SEED}) at imgsz 640 batch 8, conf {VAL_CONF}: {n640} detections with "
        f"keypoints on {len(imgs640)} frames; launches {counts} | {card}")
    for imgsz, batch, name in ((POSE_IMGSZ, 1, "floor_pose"), (640, 8, "yolov8n-pose K 17")):
        parts = ", ".join(f"{k} {v:.3f}" for k, v in lat[imgsz].items())
        log("pose_predict", f"{name} imgsz {imgsz} batch {batch}, ms per image (host clock, "
            f"median of 10 calls, conf 0.25): {parts} | {card}")
    card_vs_cpu_predict(model, YOLO(POSE_CKPT, device="cpu"), imgs96[:8], POSE_IMGSZ,
                        "pose_predict", card)
    return model, full


def segori_predict(card: str):
    """The fresh full-width yolov8n-segori (``fresh_model``, nc 2, random
    weights from ``SEGORI_SEED``) on 480x640 frames at imgsz 640, batch 1
    and 8, conf ``VAL_CONF`` (random weights score below 0.25), launch
    counts zeroed just before and read just after (predict fills no
    polygon: its masks are the prototypes' crops, upsampled on the card):
    every result's masks (n, 480, 640) bool, ms per image. (The card
    against the CPU is held on the trained model, ``segori_card_vs_cpu``:
    random weights give many scores and overlaps within float rounding of
    the gates.)"""
    model = fresh_model("yolov8n-segori.yaml", SHAPE_NAMES, SEGORI_SEED)
    frames = shape_images(8, *RASTER_HW, seed=2)
    zero_launch_counts()
    res = model.predict(frames, imgsz=640, batch=8, conf=VAL_CONF)
    bad = [None if r.masks is None else r.masks.data.shape for r in res
           if len(r) and (r.masks is None or r.masks.data.shape != (len(r), *RASTER_HW))]
    n_det, n_px = sum(len(r) for r in res), sum(int(r.masks.data.sum()) for r in res if len(r))
    lat = {}
    for batch in (1, 8):
        images = frames[:batch]
        predict_ms(model, images, 640, batch, masks=False, conf=VAL_CONF)  # warm-up
        runs = [predict_ms(model, images, 640, batch, masks=False, conf=VAL_CONF)
                for _ in range(5)]
        lat[batch] = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    counts = launch_counts()
    if bad or n_det == 0:
        raise AssertionError(f"segment_ori predict: {n_det} detections, masks of shapes {bad}")
    log("segori_predict", f"yolov8n-segori full width ({model.model.num_params} parameters, "
        f"random weights from seed {SEGORI_SEED}) at imgsz 640, conf {VAL_CONF}: {n_det} "
        f"detections with masks on {len(frames)} frames ({n_px} mask pixels); launches {counts} "
        f"| {card}")
    for batch in (1, 8):
        parts = ", ".join(f"{k} {v:.3f}" for k, v in lat[batch].items())
        log("segori_predict", f"imgsz 640 batch {batch}, conf {VAL_CONF}, ms per image (host "
            f"clock, median of 5 calls; postprocess holds the masks' matmul, crop and upsample "
            f"and their copy to the host): {parts} | {card}")
    return model, counts


def segori_card_vs_cpu(path: Path, card: str):
    """The segment_ori checkpoint ``path`` (the trainer's best.ckpt) on the
    card against the port on the CPU, on the seg160 val images at its imgsz
    (heads and prototypes within ``HEAD_ATOL``, the same detections, boxes,
    scores; ``card_vs_cpu_predict``), and how many pixels of the two
    predicts' masks differ (printed: a pixel at the 0.5 edge may)."""
    model, cpu = YOLO(path, device="cuda"), YOLO(path, device="cpu")
    images = floor_val_set()[0][:8]
    card_vs_cpu_predict(model, cpu, images, model.imgsz, "segori_trainer", card)
    got, want = model.predict(images), cpu.predict(images)
    n_diff = sum(int((g.masks.data != w.masks.data).sum()) for g, w in zip(got, want) if len(w))
    n_all = sum(w.masks.data.size for w in want if len(w))
    log("segori_trainer", f"predict masks of the trained model, card vs CPU on the same "
        f"{len(images)} images: {n_diff} of {n_all} pixels differ (printed, not held) | {card}")


def floor_cls_set(path):
    """The committed decoded images and class indices of a classify floor
    split (``make_cls_dataset(n_train=48, n_val=16, imgsz=64, seed=0)``)."""
    with np.load(path) as z:
        return list(z["images"]), z["labels"]


def floor_cls_jax_metrics() -> dict:
    """The JAX validator's metrics of ``runs/floor_classify/best.ckpt`` on
    the classify floor set at imgsz 64, batch 16, stored with the set."""
    return _jax_metrics(FLOOR_CLS_VAL)


def classify_phases(card: str) -> dict:
    """The classify task (no kernel of its own; launch counts printed, all
    0): (a) ``YOLO(runs/floor_classify/best.ckpt).val`` on the card over the
    32 committed val images at 64, batch 16: the JAX validator's metrics
    exactly (top-1 0.78125, top-5 1.0), and the floor; the probabilities,
    card against CPU, within ``PROB_ATOL``; (b) predict at imgsz 224 on
    480x640 frames, batch 1 and 8, ms per image; (c) the deploy fuse: the
    fused model's probabilities within ``FUSE_PROB_ATOL`` of the unfused
    ones', its metrics the same; (d) ``YOLO("yolov8n-cls.yaml").train``
    from scratch on the floor set (96 train images) at the ``floor.json``
    config (60 epochs at 64, batch 16, seed 0): the stripped best.ckpt must
    meet the floor (top-1) and predict."""
    record = json.loads(CLS_FLOOR_JSON.read_text())
    images, labels = floor_cls_set(FLOOR_CLS_VAL)
    want = floor_cls_jax_metrics()
    model = YOLO(CLS_CKPT, device="cuda")
    zero_launch_counts()
    res = model.val(images, labels, imgsz=model.imgsz, batch=16)
    counts = launch_counts()
    log("classify_validate", f"floor_classify on the {len(images)} committed val images at "
        f"imgsz {model.imgsz} batch 16 on the card: {res} (JAX {want}); ms per image (host clock) "
        f"{', '.join(f'{k} {v:.3f}' for k, v in model.validator.speed.items())}; launches "
        f"{counts} | {card}")
    if res != want or res["metrics/accuracy_top1"] < record["floor"]["accuracy_top1"]:
        raise AssertionError(f"classify validate on the card: {res}, not JAX's {want}")
    cpu = YOLO(CLS_CKPT, device="cpu")
    got = np.stack([r.probs.data for r in model.predict(images, batch=8)])
    ref = np.stack([r.probs.data for r in cpu.predict(images, batch=8)])
    worst = float(np.abs(got - ref).max())
    log("classify_validate", f"probabilities, card vs CPU on the {len(images)} val images: max "
        f"abs {worst:.2e} (limit {PROB_ATOL}), the same top-1 on "
        f"{int((got.argmax(1) == ref.argmax(1)).sum())} of {len(images)} | {card}")
    if worst > PROB_ATOL or not (got.argmax(1) == ref.argmax(1)).all():
        raise AssertionError(f"classify card vs CPU: probabilities {worst:.2e} apart")

    frames = shape_images(8, *RASTER_HW, seed=2)
    lat = {}
    for batch in (1, 8):
        predict_ms(model, frames[:batch], CLS_PREDICT_IMGSZ, batch, masks=False)  # warm-up
        runs = [predict_ms(model, frames[:batch], CLS_PREDICT_IMGSZ, batch, masks=False)
                for _ in range(10)]
        lat[batch] = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        parts = ", ".join(f"{k} {v:.3f}" for k, v in lat[batch].items())
        log("classify_predict", f"imgsz {CLS_PREDICT_IMGSZ} batch {batch} on 480x640 frames, ms "
            f"per image (host clock, median of 10 calls; preprocess is the grayscale transform "
            f"on the host): {parts} | {card}")

    fused = YOLO(CLS_CKPT, device="cuda").fuse()
    fp = np.stack([r.probs.data for r in fused.predict(images, batch=8)])
    gap = float(np.abs(fp - got).max())
    fres = fused.val(images, labels, imgsz=model.imgsz, batch=16)
    log("fuse", f"classify (floor_classify) fused on the card: probabilities max abs {gap:.2e} "
        f"from the unfused (limit {FUSE_PROB_ATOL}); {model.model.num_params} -> "
        f"{fused.model.num_params} parameters; validated: {fres} | {card}")
    if gap > FUSE_PROB_ATOL or fres != res:
        raise AssertionError(f"classify fuse: probabilities {gap:.2e} apart, metrics {fres}")

    ckpt = load_checkpoint(CLS_CKPT)
    over = {**{k: ckpt["train_args"][k] for k in CLS_TRAIN_KEYS},
            "save_last_every": SAVE_LAST_EVERY}
    data = {"train": floor_cls_set(FLOOR_CLS_TRAIN), "val": (images, labels),
            "names": ckpt["names"]}
    timer = TrainTotals(skip=len(data["train"][0]) // over["batch"])
    with tempfile.TemporaryDirectory() as d:
        m = YOLO("yolov8n-cls.yaml", device="cuda")
        zero_launch_counts()
        t = time.perf_counter()
        tres = m.train(data=data, mark=timer, project=d, name="floor", **over)
        wall = time.perf_counter() - t
        tcounts = launch_counts()
        trainer = m.trainer
        best = YOLO(trainer.wdir / "best.ckpt", device="cuda")
        pred = best.predict(frames[:2] + images[:6], imgsz=over["imgsz"])
    tot = epoch_split(trainer)["sum"]
    log("classify_trainer", f"yolov8n-cls from scratch on the classify floor set "
        f"({len(data['train'][0])} train, {len(images)} val images), {over}: "
        f"{len(trainer.epoch_times)} epochs, {timer.seen} steps in {wall:.2f}s wall; final eval of "
        f"the stripped best.ckpt: {tres}; floor {record['floor']}; host clock, s summed: "
        + ", ".join(f"{k} {v:.2f}" for k, v in tot.items())
        + f"; device ms per step by CUDA events after the first epoch: "
        + ", ".join(f"{k} {v:.3f}" for k, v in timer.per_step().items())
        + f"; launches {tcounts} | {card}")
    if tres["metrics/accuracy_top1"] < record["floor"]["accuracy_top1"]:
        raise AssertionError(f"classify trainer: top-1 {tres['metrics/accuracy_top1']} below the "
                             f"floor {record['floor']['accuracy_top1']}")
    if not all(r.probs is not None and np.isfinite(r.probs.data).all() for r in pred):
        raise AssertionError("classify: predict from the trained best.ckpt gave no probabilities")
    log("classify_trainer", f"YOLO(best.ckpt).predict on {len(pred)} images: top-1 classes "
        f"{[r.probs.top1 for r in pred]} | {card}")
    return {k: counts[k] + tcounts[k] for k in counts}


class EncoderOrder:
    """Context manager: the RT-DETR encoder's token order of each forward of
    ``model`` inside it (a hook on ``enc_score_head``; the stable descending
    sort of the best class score the decoder selects its queries by):
    ``order`` (B, nq) token indices and ``scores`` (B, V), of the last
    forward, on the CPU."""

    def __init__(self, model):
        self.head = model.model[-1]

    def _hook(self, module, inputs, out):
        best = out.detach().amax(-1).float().cpu()
        nq = min(self.head.nq, best.shape[1])
        self.order = torch.sort(best, dim=-1, descending=True, stable=True)[1][:, :nq]
        self.scores = best

    def __enter__(self):
        self.handle = self.head.enc_score_head.register_forward_hook(self._hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()


def query_perm(got: EncoderOrder, want: EncoderOrder, what: str) -> torch.Tensor:
    """(B, nq) indices that put ``got``'s queries in ``want``'s order, their
    tokens matched. The decoder treats its queries as a set (its output
    rows follow them), so two sides whose encoder scores sort near-equal
    tokens in other orders agree up to this permutation. Raises if the two
    select other tokens, naming each and its score's distance to the
    selection's edge."""
    perm = []
    for b, (g, w) in enumerate(zip(got.order.tolist(), want.order.tolist())):
        if set(g) != set(w):
            edge = want.scores[b][w[-1]].item()
            diff = {t: want.scores[b][t].item() - edge for t in set(g) ^ set(w)}
            raise AssertionError(f"{what}: image {b} selects other encoder tokens: {diff} (score "
                                 f"minus the {len(w)}th's)")
        pos = {t: i for i, t in enumerate(g)}
        perm.append([pos[t] for t in w])
    return torch.tensor(perm)


def take_rows(x: torch.Tensor, perm: torch.Tensor, start: int = 0) -> torch.Tensor:
    """x (B, T, ...) with rows ``start:`` permuted by ``perm`` (B, T - start)."""
    idx = torch.cat([torch.arange(start).expand(len(perm), start), perm + start], 1)
    return x.gather(1, idx.view(*idx.shape, *([1] * (x.dim() - 2))).expand_as(x))


def fresh_rtdetr_model(device="cuda") -> YOLO:
    """The published yolov8n-rtdetr at full width (nc 2), a fresh init from
    ``RTDETR_SEED`` (``fresh_model``)."""
    return fresh_model("yolov8n-rtdetr.yaml", SHAPE_NAMES, RTDETR_SEED, device)


def rtdetr_pair(a, b, images, imgsz: int, phase: str, conf: float = 0.25,
                batch: int = 1) -> dict:
    """Two RT-DETR handles (``a`` on the card; ``b`` on the card or the
    CPU) on the same letterboxed images through ``RTDETRPredictor``,
    ``batch`` images a forward: the largest gap of their decoder outputs,
    their queries matched by encoder token (``query_perm``), then of the
    predictions (queries scoring ``conf`` or more), which must be the same
    ones. Returns the gaps, the kept count and the images whose queries
    were reordered."""
    pred = RTDETRPredictor(imgsz=imgsz, conf=conf)
    out = dict.fromkeys(("decoder", "box", "score", "kept", "reordered"), 0)
    dev_b = next(b.model.parameters()).device
    for i in range(0, len(images), batch):
        chunk = images[i:i + batch]
        prep = [pred.preprocess_u8(img, imgsz) for img in chunk]
        xt = torch.from_numpy(np.stack([x for x, _, _ in prep]))
        with EncoderOrder(a.model) as oa:
            pa = pred.eval_batch(a.model, xt.cuda())["pred"].cpu()
        with EncoderOrder(b.model) as ob:
            pb = pred.eval_batch(b.model, xt.to(dev_b))["pred"].cpu()
        perm = query_perm(oa, ob, phase)
        out["reordered"] += int((perm != torch.arange(perm.shape[1])).any(1).sum())
        pa = take_rows(pa, perm)
        out["decoder"] = max(out["decoder"], float((pa - pb).abs().max()))
        for bi, (img, (_, gain, pad)) in enumerate(zip(chunk, prep)):
            ra, rb = (pred.postprocess({"pred": p.numpy()}, bi, img, "a", gain, pad,
                                       a.model.names, "cpu").boxes.data for p in (pa, pb))
            if ra.shape != rb.shape or not np.array_equal(ra[:, 5], rb[:, 5]):
                raise AssertionError(f"{phase}: the two keep different queries ({len(ra)} and "
                                     f"{len(rb)})")
            if len(rb):
                out["box"] = max(out["box"], float(np.abs(ra[:, :4] - rb[:, :4]).max()))
                out["score"] = max(out["score"], float(np.abs(ra[:, 4] - rb[:, 4]).max()))
            out["kept"] += len(rb)
    return out


def rtdetr_card_vs_cpu_predict(model, cpu, images, imgsz: int, phase: str, card: str,
                               conf: float = 0.25, batch: int = 1):
    """``rtdetr_pair`` of the card and the port on the CPU: decoder outputs
    within ``HEAD_ATOL``, the same kept queries, boxes within ``BOX_ATOL``
    px, scores within ``SCORE_ATOL``."""
    worst = rtdetr_pair(model, cpu, images, imgsz, phase, conf=conf, batch=batch)
    limits = {"decoder": HEAD_ATOL, "box": BOX_ATOL, "score": SCORE_ATOL}
    if any(worst[k] > limits[k] for k in limits) or worst["kept"] == 0:
        raise AssertionError(f"{phase} card vs CPU: {worst} (limits {limits})")
    log(phase, f"card vs CPU at imgsz {imgsz} batch {batch} on {len(images)} images: decoder "
        f"output max abs "
        f"{worst['decoder']:.2e} (limit {HEAD_ATOL}; {worst['reordered']} images with near-equal "
        f"encoder tokens sorted in another order, matched by token), the same {worst['kept']} "
        f"kept queries, boxes max abs {worst['box']:.2e} px (limit {BOX_ATOL}), scores "
        f"{worst['score']:.2e} (limit {SCORE_ATOL}) | {card}")


def rtdetr_predict(card: str):
    """``YOLO(runs/floor_rtdetr/best.ckpt).predict`` on the RT-DETR floor
    set's val images at imgsz 192 (batch 1), and the fresh full-width
    yolov8n-rtdetr (``fresh_rtdetr_model``) on 480x640 frames at 640, batch 1
    and 8 (conf ``VAL_CONF``: random weights score near the 0.01 prior),
    launch counts zeroed just before and read just after (RT-DETR reaches no
    kernel: all 0); ms per image; then the floor model on the card against
    the port on the CPU at 192."""
    model = YOLO(RTDETR_CKPT, device="cuda")
    full = fresh_rtdetr_model()
    imgs192 = floor_rtdetr_val_set()[0]
    frames = shape_images(8, *RASTER_HW, seed=2)
    zero_launch_counts()
    n192 = sum(len(r) for r in model.predict(imgs192, imgsz=RTDETR_IMGSZ))
    res640 = full.predict(frames, imgsz=640, batch=8, conf=VAL_CONF)
    boxes = np.concatenate([r.boxes.data for r in res640])
    lat = {}
    for name, m, images, imgsz, batch, conf in (
            ("floor_rtdetr", model, imgs192[:1], RTDETR_IMGSZ, 1, 0.25),
            ("yolov8n-rtdetr", full, frames[:1], 640, 1, VAL_CONF),
            ("yolov8n-rtdetr", full, frames, 640, 8, VAL_CONF)):
        predict_ms(m, images, imgsz, batch, masks=False, conf=conf)  # warm-up
        runs = [predict_ms(m, images, imgsz, batch, masks=False, conf=conf) for _ in range(10)]
        lat[(name, imgsz, batch)] = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    counts = launch_counts()
    if n192 == 0 or len(boxes) == 0 or not np.isfinite(boxes).all() or any(counts.values()):
        raise AssertionError(f"rtdetr predict: {n192} detections at 192, {len(boxes)} at 640, "
                             f"launches {counts}")
    log("rtdetr_predict", f"floor_rtdetr at imgsz {RTDETR_IMGSZ}: {n192} detections on "
        f"{len(imgs192)} floor images; yolov8n-rtdetr full width ({full.model.num_params} "
        f"parameters, random weights from seed {RTDETR_SEED}) at imgsz 640 batch 8, conf "
        f"{VAL_CONF}: {len(boxes)} kept queries on {len(frames)} frames, all finite; launches "
        f"{counts} | {card}")
    for (name, imgsz, batch), parts in lat.items():
        parts = ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        log("rtdetr_predict", f"{name} imgsz {imgsz} batch {batch}, ms per image (host clock, "
            f"median of 10 calls): {parts} | {card}")
    rtdetr_card_vs_cpu_predict(model, YOLO(RTDETR_CKPT, device="cpu"), imgs192[:8],
                               RTDETR_IMGSZ, "rtdetr_predict", card)
    return model, full, counts


def rtdetr_train_card_vs_cpu(ckpt, card: str, b: int = 4, dtype=torch.float64, model=None,
                             imgsz: int = RTDETR_IMGSZ, phase: str = "rtdetr_train"):
    """floor_rtdetr in train mode at imgsz 192, batch ``b``, N_pad 8, with
    one set of dn groups drawn on the CPU and used on both sides: the loss
    (relative ``TRAIN_LOSS_RTOL``), every layer's assignment (as encoder
    tokens, the two sides' queries matched by ``query_perm``) and every
    gradient (``TRAIN_GRAD_TOL`` of its tensor's largest) on the card
    against the CPU, the networks in ``dtype``, printed and held. In float32
    on an H100 the gradient of a neck BatchNorm bias (``model.18.cv2.bn``)
    came out 1.5e-3 of its largest from the CPU's, whose float32 is within
    8e-5 of its float64: the card's float32 sums, not the port, so the step
    is held in float64 (the float32 step, once printed and not held, was
    cut to make room for the ddp phases). With ``model`` (and no
    ``ckpt``), a copy of that model at ``imgsz``, its class count its own."""
    images, batch = shape_batch(b, imgsz, 8, seed=3)
    batch = {k: batch[k] for k in ("cls", "bboxes", "mask_gt")}
    nc = model.nc if model is not None else ckpt["model_yaml"]["nc"]
    dn = get_cdn_group({k: torch.from_numpy(v) for k, v in batch.items()}, nc, cdn_generator(0))
    dn_q = int(np.prod(dn["labels"].shape[1:]))
    res = {}
    for dev in ("cpu", "cuda"):
        net = (ckpt_model(ckpt, dev) if model is None
               else copy.deepcopy(model).to(dev).train()).to(dtype)
        x, bt = to_device(images, batch, dev)
        with EncoderOrder(net) as order:
            outs = net(x.to(dtype).permute(0, 3, 1, 2).contiguous(),
                       dn={k: v.to(dev) for k, v in dn.items()})
        assign = rtdetr_assign(outs, bt, dn_q)
        total, _ = rtdetr_loss(outs, bt, nc, dn=dn, assign=assign)
        total.backward()
        res[dev] = (total.item(), assign.cpu(), order,
                    {n: p.grad.cpu() for n, p in net.named_parameters()})
        del net
    (lc, ac, oc, gc), (lg, ag, og, gg) = res["cpu"], res["cuda"]
    query_perm(og, oc, phase)  # the same tokens selected
    tok = lambda a, o: torch.where(a >= 0, o.order[None].expand(a.shape[0], -1, -1).gather(  # noqa: E731
        2, a.clamp_min(0)), -1)
    same = torch.equal(tok(ac, oc), tok(ag, og)) and bool((ac >= 0).any())
    loss_rel = abs(lg - lc) / abs(lc)
    # the attention key biases have no gradient (a softmax does not see a
    # shift common to its row), nor has a shift that a train-mode BatchNorm
    # takes out again (rtdetr-l's BatchNorm biases without an activation
    # after them, AIFI's last LayerNorm bias): both sides' are rounding
    # noise, held to ZERO_GRAD_TOL of the largest gradient of any tensor
    scale = max(float(g.abs().max()) for g in gc.values())
    zero = [n for n in gc if n.endswith("key.bias")
            or float(gc[n].abs().max()) <= ZERO_GRAD_TOL * scale]
    noise = max(float(t[n].abs().max()) for t in (gc, gg) for n in zero) / scale
    grad_rel, worst = max((float((gg[n] - gc[n]).abs().max()
                                 / gc[n].abs().max().clamp_min(1e-30)), n)
                          for n in gc if n not in zero)
    what = "floor_rtdetr" if model is None else f"a fresh {type(model).__name__} of " \
        f"{model.num_params} parameters"
    log(phase, f"card vs CPU, {what} "
        f"({str(dtype)[6:]}) at imgsz {imgsz} "
        f"batch {b}, {dn_q} dn queries drawn on the CPU: loss {lg:.6f} vs {lc:.6f} (rel "
        f"{loss_rel:.2e}, limit {TRAIN_LOSS_RTOL}); the same assignment in every layer: {same} "
        f"({int((ac >= 0).sum())} matches over {ac.shape[0]} layers); worst gradient "
        f"{grad_rel:.2e} of its tensor's max, {worst} (limit {TRAIN_GRAD_TOL}); the {len(zero)} "
        f"gradients that are 0 in exact arithmetic (key biases, shifts a BatchNorm takes out) "
        f"at most {noise:.2e} of the largest gradient (limit {ZERO_GRAD_TOL}) | {card}")
    if (not same or loss_rel > TRAIN_LOSS_RTOL or grad_rel > TRAIN_GRAD_TOL
            or noise > ZERO_GRAD_TOL):
        raise AssertionError(f"{phase} card vs CPU: same assignment {same}, loss rel "
                             f"{loss_rel:.2e}, grad {grad_rel:.2e} at {worst}, key-bias noise "
                             f"{noise:.2e}")


def kernel_family(name: str) -> str:
    """A device kernel's name without its namespaces, template arguments and
    parameters (``void at::native::elementwise_kernel<...>(...)`` ->
    ``elementwise_kernel``)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1]


def rtdetr_step_kernels(state, ckpt, card: str):
    """One more RT-DETR train step of ``state`` at 640 batch 16 under
    ``torch.profiler``: how many device kernels it launches, their device
    time summed against the step's host-clock time (the profiler's cost
    included), and the costliest kernel families (``kernel_family``)."""
    from torch.profiler import ProfilerActivity, profile

    hyp = train_hyp(ckpt, optimizer="AdamW", warmup_epochs=0.0, batch=TRAIN_B)
    step = make_train_step(state.model, state.optimizer, hyp)
    x, b = to_device(*shape_batch(TRAIN_B, TRAIN_IMGSZ, TRAIN_NPAD, seed=4), "cuda")
    step(state, x, b)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, x, b)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log("rtdetr_train", f"one step under torch.profiler: no device activity recorded "
            f"(kernels not measured) | {card}")
        return
    by_family = {}
    for e in events:
        n, total = by_family.get(kernel_family(e.name), (0, 0.0))
        by_family[kernel_family(e.name)] = (n + 1, total + e.time_range.elapsed_us())
    top = sorted(by_family.items(), key=lambda kv: -kv[1][1])[:8]
    busy = sum(us for _, us in by_family.values()) / 1e3
    log("rtdetr_train", f"one step at {TRAIN_IMGSZ} batch {TRAIN_B} under torch.profiler: "
        f"{len(events)} device kernels of {len(by_family)} families, {busy:.3f} ms of device "
        f"time against {wall:.3f} ms on the host clock (profiled); the costliest families "
        f"(launches, ms summed): " + ", ".join(f"{n} ({c}, {us / 1e3:.3f})" for n, (c, us) in top)
        + f" | {card}")


def rtdetr_fuse_check(card: str) -> dict:
    """``YOLO(runs/floor_rtdetr/best.ckpt).fuse()`` on the card against the
    unfused model there on the floor images (``rtdetr_pair``): decoder
    outputs within ``FUSE_HEAD_ATOL``, the same kept queries, boxes within
    ``BOX_ATOL``; then both validated on the floor set (launch counts zeroed
    just before the fused run, read just after): each metric within
    ``FUSE_METRIC_ATOL`` of the unfused model's, and the floor met."""
    record = json.loads(RTDETR_FLOOR_JSON.read_text())
    images, labels = floor_rtdetr_val_set()
    plain = YOLO(RTDETR_CKPT, device="cuda")
    fused = YOLO(RTDETR_CKPT, device="cuda").fuse()
    worst = rtdetr_pair(fused, plain, images[:8], RTDETR_IMGSZ, "rtdetr_fuse")
    want = plain.val(images, labels, imgsz=RTDETR_IMGSZ, batch=VAL_B, conf=VAL_CONF, iou=VAL_IOU)
    zero_launch_counts()
    got = fused.val(images, labels, imgsz=RTDETR_IMGSZ, batch=VAL_B, conf=VAL_CONF, iou=VAL_IOU)
    counts = launch_counts()
    gaps = {k: abs(got[k] - want[k]) for k in want}
    below = {k: (got[k], record["floor"][n]) for k, n in record["floor_keys"].items()
             if not got[k] >= record["floor"][n]}
    metrics = ", ".join(f"{k.split('/')[1]} {x:.4f}" for k, x in got.items() if k != "fitness")
    log("rtdetr_fuse", f"floor_rtdetr fused on the card vs unfused on the card, 8 images at "
        f"imgsz {RTDETR_IMGSZ}: decoder output max abs {worst['decoder']:.2e} (limit "
        f"{FUSE_HEAD_ATOL}), the same {worst['kept']} kept queries, boxes max abs "
        f"{worst['box']:.2e} px; {plain.model.num_params} -> {fused.model.num_params} "
        f"parameters | {card}")
    log("rtdetr_fuse", f"fused, validated on the floor set at imgsz {RTDETR_IMGSZ} batch {VAL_B}: "
        f"{metrics}; worst gap to the unfused model {max(gaps.values()):.2e} (limit "
        f"{FUSE_METRIC_ATOL}); floor {record['floor']}; launches {counts} | {card}")
    if worst["decoder"] > FUSE_HEAD_ATOL or worst["box"] > BOX_ATOL or worst["kept"] == 0:
        raise AssertionError(f"rtdetr fuse: {worst}")
    if max(gaps.values()) > FUSE_METRIC_ATOL or below or any(counts.values()):
        raise AssertionError(f"rtdetr fuse: metric gaps {gaps}, below the floor {below}, "
                             f"launches {counts}")
    return counts


def rtdetr_phases(card: str) -> dict:
    """The RT-DETR phases: predict, validate (the floor set against JAX's
    stored metrics and the floor; the full-width model at 640), the train
    step (card against CPU at 192, then full width at 640), the fuse. Their
    launch counts, all 0, by phase."""
    model, full, predict_counts = rtdetr_predict(card)
    validate_floor_jax(model, card, "rtdetr")
    floor_counts = launch_counts()
    _, val640_counts, _, _ = validate_full_width(full, card, phase="rtdetr_validate")
    ckpt = load_checkpoint(RTDETR_CKPT)
    rtdetr_train_card_vs_cpu(ckpt, card)
    state, step_counts, _, _ = train_full_width(ckpt, card, phase="rtdetr_train")
    rtdetr_step_kernels(state, ckpt, card)
    fuse_counts = rtdetr_fuse_check(card)
    out = {"predict": predict_counts,
           "validate": {k: floor_counts[k] + val640_counts[k] for k in KERNEL_WRAPPERS},
           "train step": step_counts, "fused validate": fuse_counts}
    if any(v for c in out.values() for v in c.values()):
        raise AssertionError(f"RT-DETR reaches no kernel, yet launched {out}")
    return out


def host_samples(images, labels, imgsz: int):
    """Raw samples of a set at ``imgsz`` as the host chain reads them
    (``TrainDataset.load_raw``: long side at imgsz, labels in pixels)."""
    ds = TrainDataset(images, labels, imgsz=imgsz, device_augment=False, hyp=get_cfg(None, {}))
    return [ds.load_raw(i) for i in range(len(ds))]


def _fresh(samples, i):
    s = samples[i % len(samples)]
    return augment.Sample(s.img.copy(), s.inst.copy())


def transform_ms(samples, imgsz: int, reps: int = 4) -> dict:
    """Host ms a sample (median of ``reps`` calls, each on fresh copies) of
    each transform of the host chain on ``samples`` at ``imgsz``: the two
    mosaics, copy-paste (p 0.5, on a mosaic), the warp after a mosaic (2
    imgsz -> imgsz, affine and perspective) and after a letterbox, MixUp,
    each pixel branch (blur and median at k 7) and the four forced
    together (k 3), HSV, the flips, and the whole chain at the
    default settings with mosaic9 and copy-paste 0.5 (its plan, the
    draws without pixels, apart)."""
    rng = random.Random(0)
    hyp = get_cfg(None, {"mosaic9": 0.5, "copy_paste": 0.5})
    n = len(samples)
    mos = augment.mosaic4([_fresh(samples, i) for i in range(4)], imgsz, rng)
    warped = augment.random_perspective(
        augment.Sample(mos.img.copy(), mos.inst.copy()), imgsz, rng, border=(-imgsz // 2,) * 2)
    img = warped.img
    branches = {
        "mosaic4": lambda i: augment.mosaic4([_fresh(samples, i + k) for k in range(4)], imgsz,
                                             rng),
        "mosaic9": lambda i: augment.mosaic9([_fresh(samples, i + k) for k in range(9)], imgsz,
                                             rng),
        "copy_paste": lambda i: augment.copy_paste(augment.Sample(mos.img, mos.inst.copy()), 0.5,
                                                   rng),
        "warp_affine_mosaic": lambda i: augment.random_perspective(
            augment.Sample(mos.img, mos.inst.copy()), imgsz, rng, 10.0, 0.1, 0.5, 2.0, 0.0,
            (-imgsz // 2, -imgsz // 2)),
        "warp_perspective_mosaic": lambda i: augment.random_perspective(
            augment.Sample(mos.img, mos.inst.copy()), imgsz, rng, 10.0, 0.1, 0.5, 2.0, 0.0005,
            (-imgsz // 2, -imgsz // 2)),
        "letterbox_warp": lambda i: augment.random_perspective(
            augment.letterbox_sample(_fresh(samples, i), imgsz), imgsz, rng),
        "mixup": lambda i: augment.mixup(warped, warped, np.random.default_rng(i)),
        "blur": lambda i: imgproc.box_blur(img, 7),
        "median_blur": lambda i: imgproc.median_blur(img, 7),
        "gray": lambda i: np.repeat(augment.bgr_to_gray(img)[..., None], 3, -1),
        "clahe_lab": lambda i: _clahe_lab(img),
        "pixel_augment_all4": lambda i: augment.pixel_augment(img, _Always(), p=1.0),
        "hsv": lambda i: augment.random_hsv(img, rng),
        "flip": lambda i: augment.random_flip(augment.Sample(img, warped.inst.copy()), rng, 0.5,
                                              0.5),
        "train_transform": lambda i: augment.train_transform(
            lambda j: _fresh(samples, j), i % n, n, imgsz, hyp, rng, np.random.default_rng(i)),
        "train_transform_plan": lambda i: augment.train_transform(
            lambda j: augment.Sample(None, samples[j].inst.copy(), hw=samples[j].hw), i % n, n,
            imgsz, hyp, rng, np.random.default_rng(i)),
    }
    out = {}
    for name, fn in branches.items():
        times = []
        for i in range(reps):
            t = time.perf_counter()
            fn(i)
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = statistics.median(times)
    return out


def _clahe_lab(img):
    """``pixel_augment``'s CLAHE branch alone: L of Lab equalized."""
    lab = imgproc.bgr_to_lab(img)
    lab[..., 0] = imgproc.clahe(lab[..., 0])
    return imgproc.lab_to_bgr(lab)


class _Always(random.Random):
    """A generator whose ``random()`` is 0 and picks the first of a choice:
    forces every ``pixel_augment`` branch, at kernel 3."""

    def random(self):
        return 0.0

    def choice(self, seq):
        return seq[0]


def host_pipeline(card: str) -> dict:
    """The host train chain: ``transform_ms`` at imgsz 160 (the seg160
    set) and 640 (480x640 frames); then ``YOLO("yolov8n-seg.yaml").train``
    from scratch on the seg160 floor set at the floor checkpoint's
    train_args with ``HOST_TRAIN`` (the host chain: device_augment off,
    mosaic9 and copy_paste 0.5) and ``HOST_WORKERS`` loader threads,
    launch counts zeroed just before and read just after: finite losses
    that fall from the first epoch to the last, a results.csv row an epoch,
    and the GT-ray and fill kernels launched (the step's assigner, the
    validator's mask IoU)."""
    train, val = floor_train_set(), floor_val_set()
    frames = shape_val_set(16, *VAL640_HW, seed=7)
    for imgsz, (images, labels), what in ((160, train, "the seg160 set"),
                                          (640, frames, "480x640 frames")):
        ms = transform_ms(host_samples(images, labels, imgsz), imgsz)
        log("host_pipeline", f"host ms a sample at imgsz {imgsz} on {what} (median of 4): "
            + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" | {card}")
    ckpt = load_checkpoint(CKPT)
    over = {**{k: ckpt["train_args"][k] for k in FLOOR_TRAIN_KEYS}, **HOST_TRAIN,
            "workers": HOST_WORKERS}
    timer = TrainTotals(skip=len(train[0]) // over["batch"])
    with tempfile.TemporaryDirectory() as d:
        model = YOLO("yolov8n-seg.yaml", device="cuda")
        zero_launch_counts()
        t = time.perf_counter()
        res = model.train(data={"train": train, "val": val, "names": ckpt["names"]}, mark=timer,
                          project=d, name="host", **over)
        wall = time.perf_counter() - t
        counts = launch_counts()
        with open(model.trainer.csv) as fh:
            rows = list(csv.DictReader(fh))
    trainer = model.trainer
    losses = [float(r["train/loss"]) for r in rows]
    split = epoch_split(trainer)
    metrics = ", ".join(f"{k.split('/')[1]} {x:.4f}" for k, x in res.items() if k != "fitness")
    log("host_pipeline", f"yolov8n-seg from scratch on the seg160 set, host chain {over}: "
        f"{len(rows)} results.csv rows, train loss by epoch {[round(v, 3) for v in losses]}, "
        f"{wall:.2f}s wall; final eval {metrics} (printed, not held); launches {counts} | {card}")
    log("host_pipeline", "host clock, s summed over the epochs: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split["sum"].items())
        + "; ms per step by the host clock "
        + f"{1e3 * split['sum']['train_s'] / max(timer.seen, 1):.3f}"
        + "; device ms per step by CUDA events after the first epoch: "
        + ", ".join(f"{k} {v:.3f}" for k, v in timer.per_step().items()) + f" | {card}")
    if trainer.device_augment or len(rows) != over["epochs"]:
        raise AssertionError(f"host_pipeline: device_augment {trainer.device_augment}, "
                             f"{len(rows)} rows")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"host_pipeline: losses by epoch {losses} are not finite and falling")
    if counts["gt_rays_rows"] == 0 or counts["fill_polygons"] == 0:
        raise AssertionError(f"host_pipeline: a kernel of the path never launched: {counts}")
    return counts


def rtdetr_trainer(card: str) -> dict:
    """``YOLO("yolov8n-rtdetr.yaml").train`` from scratch on the RT-DETR
    floor set (``FLOOR_RTDETR_TRAIN``, validated on ``FLOOR_RTDETR_VAL``)
    at JAX's floor recipe (the floor checkpoint's train_args of
    ``RTDETR_TRAIN_KEYS``; ``HOST_WORKERS`` loader threads), launch counts
    zeroed just before and read just after (all 0): the final validation of
    the stripped ``best.ckpt`` must meet ``RTDETR_FLOOR_JSON``. Prints the
    metrics, the wall time, the train / val / save split and every 25th
    epoch's train loss beside the JAX run's."""
    record = json.loads(RTDETR_FLOOR_JSON.read_text())
    ckpt = load_checkpoint(RTDETR_CKPT)
    over = {k: ckpt["train_args"][k] for k in RTDETR_TRAIN_KEYS}
    over.update(close_mosaic=0, mixup=0.0, workers=HOST_WORKERS)
    train, val = _decoded_set(FLOOR_RTDETR_TRAIN), floor_rtdetr_val_set()
    timer = TrainTotals(skip=len(train[0]) // over["batch"])
    with tempfile.TemporaryDirectory() as d:
        model = YOLO("yolov8n-rtdetr.yaml", device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        t = time.perf_counter()
        res = model.train(data={"train": train, "val": val, "names": ckpt["names"]}, mark=timer,
                          project=d, name="floor", **over)
        wall = time.perf_counter() - t
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        with open(model.trainer.csv) as fh:
            rows = list(csv.DictReader(fh))
        n_det = sum(len(r) for r in model.predict(val[0], imgsz=over["imgsz"]))
    trainer = model.trainer
    split = epoch_split(trainer)
    metrics = ", ".join(f"{k.split('/')[1]} {x:.4f}" for k, x in res.items() if k != "fitness")
    best = max(range(len(rows)), key=lambda e: float(rows[e]["metrics/mAP50-95(B)"]))
    log("rtdetr_trainer", f"yolov8n-rtdetr from scratch on the RT-DETR floor set "
        f"({len(train[0])} train, {len(val[0])} val images at {over['imgsz']}), {over}: "
        f"{len(rows)} epochs, {timer.seen} steps in {wall:.2f}s wall; final eval of the stripped "
        f"best.ckpt: {metrics}; best epoch {best} (box mAP50-95 "
        f"{float(rows[best]['metrics/mAP50-95(B)']):.4f}); floor {record['floor']}; predict "
        f"from it: {n_det} detections on the val images; launches {counts}; peak memory "
        f"{peak / 2**30:.3f} GiB | {card}")
    with open(RTDETR_CKPT.parent / "results.csv") as fh:
        jax_rows = list(csv.DictReader(fh))
    pairs = [f"{e}: {float(rows[e]['train/loss']):.3f} vs {float(jax_rows[e]['train/loss']):.3f}"
             f" (mAP50-95 {float(rows[e]['metrics/mAP50-95(B)']):.3f} vs "
             f"{float(jax_rows[e]['metrics/mAP50-95(B)']):.3f})"
             for e in range(24, min(len(rows), len(jax_rows)), 25)]
    log("rtdetr_trainer", f"every 25th epoch, this run vs the JAX run's results.csv (bf16 on a "
        f"TPU; a yardstick, not a gate): {'; '.join(pairs)} | {card}")
    tot = split["sum"]
    log("rtdetr_trainer", "host clock, s summed over the run: "
        + ", ".join(f"{k} {v:.2f}" for k, v in tot.items())
        + f"; wall {wall:.2f}; ms per step by the host clock "
        f"{1e3 * tot['train_s'] / max(timer.seen, 1):.3f}; device ms per step by CUDA events "
        "after the first epoch: " + ", ".join(f"{k} {v:.3f}" for k, v in timer.per_step().items())
        + f" | {card}")
    below = {k: (res[k], record["floor"][n]) for k, n in record["floor_keys"].items()
             if not res[k] >= record["floor"][n]}
    if below or any(counts.values()) or n_det == 0:
        raise AssertionError(f"rtdetr_trainer: below the floor {below}, launches {counts}, "
                             f"{n_det} detections")
    return counts


def off_the_pixel_grid(model, std: float = 1e-3, seed: int = 0):
    """A copy of a fresh RT-DETR with its deformable attention's
    ``sampling_offsets`` moved by a seeded draw: N(0, std) for the kernels
    (zero at init) and added to the biases (the directional grid at
    init). At init every sampling point sits on a quarter-pixel of its map
    (the grid's offsets from anchor centres), often on a pixel's edge, where
    the bilinear sample has no derivative (its one-sided ones differ) and
    the card's and the CPU's ``grid_sample``, rounding the point's
    coordinate in other orders, take different sides; the draw moves every
    point off those edges."""
    model = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".sampling_offsets." in name:
                p.add_(torch.randn(p.shape, generator=gen, dtype=p.dtype) * std)
    return model


def rtdetr_l(card: str) -> dict:
    """A fresh rtdetr-l (nc 80, ``RTDETR_L_SEED``) on the card: its
    parameter count (``RTDETR_L_PARAMS``, JAX's); predict at 640, batch 1
    and 8, against the port on the CPU (``rtdetr_card_vs_cpu_predict`` at
    conf ``VAL_CONF``: random weights score near the 0.01 prior) with ms an
    image and peak memory, launch counts zeroed before and read after (0);
    one train step at ``RTDETR_L_TRAIN`` in float64, card against CPU
    (``rtdetr_train_card_vs_cpu``, the sampling offsets moved off the pixel
    edges by ``off_the_pixel_grid``); the fused model against the unfused on
    the card (decoder outputs within ``FUSE_HEAD_ATOL``)."""
    names = {i: f"class{i}" for i in range(80)}
    model = fresh_model("rtdetr-l.yaml", names, RTDETR_L_SEED)
    cpu = fresh_model("rtdetr-l.yaml", names, RTDETR_L_SEED, device="cpu")
    n_params = model.model.num_params
    if n_params != RTDETR_L_PARAMS:
        raise AssertionError(f"rtdetr-l has {n_params} parameters, JAX's build {RTDETR_L_PARAMS}")
    frames = shape_images(8, *RASTER_HW, seed=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    kept = sum(len(r) for r in model.predict(frames, imgsz=640, batch=8, conf=VAL_CONF))
    lat = {}
    for batch, images in ((1, frames[:1]), (8, frames)):
        predict_ms(model, images, 640, batch, masks=False, conf=VAL_CONF)  # warm-up
        runs = [predict_ms(model, images, 640, batch, masks=False, conf=VAL_CONF)
                for _ in range(10)]
        lat[batch] = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log("rtdetr_l", f"rtdetr-l fresh from seed {RTDETR_L_SEED}: {n_params} parameters (JAX's "
        f"build {RTDETR_L_PARAMS}); predict at 640 batch 8, conf {VAL_CONF}: {kept} kept queries "
        f"on {len(frames)} frames; peak memory {peak / 2**30:.3f} GiB; launches {counts} | {card}")
    for batch, parts in lat.items():
        log("rtdetr_l", f"imgsz 640 batch {batch}, ms per image (host clock, median of 10 "
            f"calls): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + f" | {card}")
    for batch, images in ((1, frames[:2]), (8, frames)):
        rtdetr_card_vs_cpu_predict(model, cpu, images, 640, "rtdetr_l", card, conf=VAL_CONF,
                                   batch=batch)
    imgsz, b = RTDETR_L_TRAIN
    rtdetr_train_card_vs_cpu(None, card, b=b, model=off_the_pixel_grid(cpu.model), imgsz=imgsz,
                             phase="rtdetr_l")
    fused = YOLO("rtdetr-l.yaml", device="cuda")
    fused.model = fuse_model(copy.deepcopy(model.model))
    worst = rtdetr_pair(fused, model, frames, 640, "rtdetr_l_fuse", conf=VAL_CONF, batch=8)
    log("rtdetr_l", f"fused vs unfused on the card at 640 batch 8: decoder output max abs "
        f"{worst['decoder']:.2e} (limit {FUSE_HEAD_ATOL}), the same {worst['kept']} kept "
        f"queries, boxes max abs {worst['box']:.2e} px; {n_params} -> "
        f"{fused.model.num_params} parameters | {card}")
    if worst["decoder"] > FUSE_HEAD_ATOL or worst["kept"] == 0 or any(counts.values()):
        raise AssertionError(f"rtdetr_l: fuse {worst}, launches {counts}")
    return counts


# --- SAM, MobileSAM, everything mode, FastSAM and YOLO-NAS --------------------


def sam_model(variant: str, img_size: int = SAM_IMG):
    """``variant`` on the CPU with its seeded weights (``SAM_SEED``, as
    ``SAM(variant)`` draws them) and the relative-position tables and
    TinyViT attention biases drawn at std ``SAM_REL_STD`` from a second seed
    (JAX initializes them to 0, which would leave that path unexercised), in
    eval mode; ``copy.deepcopy(...).cuda()`` puts the same weights on the
    card."""
    model = SAM(variant, img_size=img_size, device="cpu", seed=SAM_SEED).model
    gen = torch.Generator().manual_seed(SAM_SEED + 1)
    with torch.no_grad():
        for m in model.modules():
            for name in ("rel_pos_h", "rel_pos_w", "attention_biases"):
                if hasattr(m, name):
                    p = getattr(m, name)
                    p.copy_(torch.randn(p.shape, generator=gen) * SAM_REL_STD)
    return model.eval()


def frame_logits(pred: "SamPredictor", low: torch.Tensor) -> np.ndarray:
    """The predictor's full-frame logits of its low-res ones (the path of
    its ``predict``: the square, the crop, the frame)."""
    h, w = pred._orig_hw
    s = pred.model.img_size
    full = augment.resize_linear_f32(low.float(), s, s)
    crop = full[:, : round(h * pred._scale), : round(w * pred._scale)].contiguous()
    return augment.resize_linear_f32(crop, h, w).cpu().numpy()


def sam_phase(card: str, variant: str = "sam_b") -> dict:
    """``variant`` at img_size 1024 (``sam_model``) on a 480x640 frame:
    ``set_image`` and ``predict`` with a point, a box, and a point with the
    CPU's previous low-res logits as ``mask_input``, card against the port
    on the CPU (embeddings within ``SAM_EMB_RTOL`` of their largest entry,
    low-res logits and IoU within ``SAM_LOGIT_ATOL``, masks equal except
    pixels whose logit lies within ``SAM_THRESH_BAND`` of 0, counted); the
    parameter count (JAX's, ``SAM_PARAMS``); the encoder's ms at batch 1
    and the decoder's for 1 and ``SAM_DECODE_BATCH`` prompts by CUDA
    events, the CPU encoder's seconds, the peak memory. Launches no kernel
    (counts printed, all 0)."""
    phase = variant
    frame = shape_images(1, *RASTER_HW, seed=21)[0]
    cpu_model = sam_model(variant)
    n_params = cpu_model.num_params
    if n_params != SAM_PARAMS[variant]:
        raise AssertionError(f"{variant}: {n_params} parameters, JAX's {SAM_PARAMS[variant]}")
    gp = SamPredictor(copy.deepcopy(cpu_model), device="cuda")
    cp = SamPredictor(cpu_model, device="cpu")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    gp.set_image(frame)
    t = time.perf_counter()
    cp.set_image(frame)
    cpu_s = time.perf_counter() - t
    emb_err = float((gp._emb.cpu() - cp._emb).abs().max())
    emb_max = float(cp._emb.abs().max())
    worst = {"emb": emb_err / emb_max, "logits": 0.0, "iou": 0.0}
    flips, bad = {}, {}
    prev = None
    cases = {"point": dict(point_coords=[[320, 240]], point_labels=[1]),
             "box": dict(box=[200, 120, 460, 380]),
             "point+mask_input": dict(point_coords=[[320, 240]], point_labels=[1])}
    for name, kw in cases.items():
        if name == "point+mask_input":
            kw = dict(kw, mask_input=prev)
        gm, gi, gl = gp.predict(**kw, return_logits=True)
        cm, ci, cl = cp.predict(**kw, return_logits=True)
        worst["logits"] = max(worst["logits"], float(np.abs(gl - cl).max()))
        worst["iou"] = max(worst["iou"], float(np.abs(gi - ci).max()))
        near = np.abs(frame_logits(cp, torch.from_numpy(cl))) <= SAM_THRESH_BAND
        diff = gm != cm
        flips[name], bad[name] = int(diff.sum()), int((diff & ~near).sum())
        prev = cl[int(np.argmax(ci))]
    dec_ms = {}
    with torch.inference_mode():
        x = torch.zeros(1, 3, SAM_IMG, SAM_IMG, device="cuda")
        enc_ms = time_ms(lambda: gp.model.encode_image(x), reps=10)
        thr, off = torch.zeros((), device="cuda"), torch.tensor(0.95, device="cuda")
        for n in (1, SAM_DECODE_BATCH):
            pts = torch.rand(n, 2, generator=torch.Generator().manual_seed(n)).cuda() * SAM_IMG
            dec_ms[n] = time_ms(lambda: gp._amg_batch(gp._emb, pts, thr, off), reps=10)
    peak = torch.cuda.max_memory_allocated()
    counts = launch_counts()
    log(phase, f"{variant} at {SAM_IMG} on seeded weights (seed {SAM_SEED}, relative "
        f"positions std {SAM_REL_STD}): {n_params} parameters (JAX's {SAM_PARAMS[variant]}); "
        f"card vs CPU on a {RASTER_HW[0]}x{RASTER_HW[1]} frame: embeddings {worst['emb']:.2e} of "
        f"their largest {emb_max:.3f} (limit {SAM_EMB_RTOL}), low-res logits max abs "
        f"{worst['logits']:.2e} and IoU {worst['iou']:.2e} (limit {SAM_LOGIT_ATOL}); mask "
        f"pixels that differ {flips}, of them off the +-{SAM_THRESH_BAND} threshold band "
        f"{bad} | {card}")
    log(phase, f"ms by CUDA events (median of 10): encoder at batch 1 {enc_ms:.3f}; decoder "
        + ", ".join(f"{n} prompt{'s' if n > 1 else ''} {v:.3f}" for n, v in dec_ms.items())
        + f" ({dec_ms[SAM_DECODE_BATCH] / SAM_DECODE_BATCH:.4f} a prompt); the CPU's "
        f"set_image {cpu_s:.2f}s; peak memory {peak / 2**30:.3f} GiB; launches {counts} | "
        f"{card}")
    if (worst["emb"] > SAM_EMB_RTOL or worst["logits"] > SAM_LOGIT_ATOL
            or worst["iou"] > SAM_LOGIT_ATOL or any(bad.values()) or any(counts.values())):
        raise AssertionError(f"{phase}: card vs CPU {worst}, off-band mask pixels {bad}, "
                             f"launches {counts}")
    return {"encoder_ms": enc_ms, "decode_ms": dec_ms, "cpu_set_image_s": cpu_s,
            "peak_gib": peak / 2**30, "models": (gp.model, cp.model)}


def match_generated(got, want, conf_thres: float) -> dict:
    """Pairs of the card's and the CPU's ``generate`` outputs: each CPU mask
    with the unpaired card mask of the largest mask IoU among those whose
    score is within ``SCORE_ATOL`` and box within ``SAM_BOX_PX``; the
    pairs' smallest IoU and largest box and score differences. A mask kept
    on one side only is allowed where its score lies within
    ``SAM_LOGIT_ATOL`` of ``conf_thres`` (a near-tie of the filter), and
    counted."""
    (gm, gs, gb), (cm, cs, cb) = got, want
    gm_t = torch.from_numpy(gm).reshape(len(gm), -1)
    cm_t = torch.from_numpy(cm).reshape(len(cm), -1)
    used = set()
    out = {"pairs": 0, "min_iou": 1.0, "box": 0.0, "score": 0.0, "unmatched": 0, "bad": 0}
    for i in range(len(cm)):
        cands = [j for j in range(len(gm)) if j not in used
                 and abs(float(gs[j]) - float(cs[i])) <= SCORE_ATOL
                 and np.abs(gb[j] - cb[i]).max() <= SAM_BOX_PX]
        if not cands:
            out["unmatched"] += 1
            out["bad"] += int(abs(float(cs[i]) - conf_thres) > SAM_LOGIT_ATOL)
            continue
        c = gm_t[cands]
        inter = (c & cm_t[i]).sum(1).double()
        union = (c | cm_t[i]).sum(1).double().clamp(min=1)
        k = int(torch.argmax(inter / union))
        j = cands[k]
        used.add(j)
        out["pairs"] += 1
        out["min_iou"] = min(out["min_iou"], float(inter[k] / union[k]))
        out["box"] = max(out["box"], float(np.abs(gb[j] - cb[i]).max()))
        out["score"] = max(out["score"], abs(float(gs[j]) - float(cs[i])))
    for j in set(range(len(gm))) - used:
        out["unmatched"] += 1
        out["bad"] += int(abs(float(gs[j]) - conf_thres) > SAM_LOGIT_ATOL)
    return out


def sam_generate(card: str, card_model, cpu_model) -> dict:
    """Everything mode with sam_b at 1024 (``sam_phase``'s models, card and
    CPU) on a 480x640 frame of planted shapes: ``SAM_GEN`` (points_stride
    32, 1,024 prompts in batches of 64, the thresholds set so seeded
    weights keep masks, NMS off) at crop_n_layers 0 and 1 on the card,
    timed (ms an image, the masks kept, the peak); crop_n_layers 0 held
    against the port on the CPU (``match_generated``: every kept mask paired
    with IoU >= ``SAM_GEN_IOU``, boxes within ``SAM_BOX_PX``, scores within
    ``SCORE_ATOL``) at ``SAM_GEN_CPU``'s fewer prompts on both sides
    (points_stride 8)."""
    frame = shape_images(1, *RASTER_HW, seed=22)[0]
    gp = SamPredictor(card_model, device="cuda")
    cp = SamPredictor(cpu_model, device="cpu")
    zero_launch_counts()
    res = {}
    for layers in (0, 1):
        kw = dict(SAM_GEN, crop_n_layers=layers)
        gp.generate(frame, **kw)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed = {}
        ms = host_ms(lambda: timed.__setitem__("out", gp.generate(frame, **kw)))
        peak = torch.cuda.max_memory_allocated()
        kept = len(timed["out"][0])
        res[layers] = {"ms": ms, "peak_gib": peak / 2**30, "kept": kept}
        line = (f"crop_n_layers {layers}, {SAM_GEN}: {ms:.1f} ms an image on the card (host "
                f"clock, NMS off, {kept} masks kept at points_stride {SAM_GEN['points_stride']}), "
                f"peak memory {peak / 2**30:.3f} GiB")
        if layers not in SAM_GEN_CPU:
            log("sam_generate", f"{line}; no CPU reference at this layer | {card}")
            continue
        kw = dict(kw, **SAM_GEN_CPU[layers])
        got = gp.generate(frame, **kw)
        t = time.perf_counter()
        want = cp.generate(frame, **kw)
        cpu_s = time.perf_counter() - t
        m = match_generated(got, want, SAM_GEN["conf_thres"])
        res[layers].update(compared=len(got[0]), **m)
        log("sam_generate", f"{line}; card vs CPU at "
            f"points_stride {kw['points_stride']}, NMS {kw['iou_thres']} in a crop and "
            f"{kw['crop_nms_thresh']} across ({len(got[0])} card and {len(want[0])} CPU masks, "
            f"the CPU {cpu_s:.1f}s): {m['pairs']} pairs, mask IoU min {m['min_iou']:.4f} (limit "
            f"{SAM_GEN_IOU}), boxes max {m['box']:.1f} px (limit {SAM_BOX_PX}), scores "
            f"{m['score']:.2e} (limit {SCORE_ATOL}), {m['unmatched']} unmatched ({m['bad']} "
            f"not at the confidence threshold) | {card}")
        if (m["bad"] or m["min_iou"] < SAM_GEN_IOU or m["pairs"] == 0
                or m["box"] > SAM_BOX_PX or m["score"] > SCORE_ATOL):
            raise AssertionError(f"sam_generate crop_n_layers {layers}: {m}")
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"sam_generate launched kernels: {counts}")
    return res


def fastsam_phase(card: str) -> dict:
    """``FastSAM(runs/floor_seg160/best.ckpt)`` predicting agnostically on
    the seg160 floor images, card and CPU: the same detections (boxes within
    ``BOX_ATOL``), and ``box_prompt``, ``point_prompt`` and
    ``everything_prompt`` selecting the same masks (mask IoU >=
    ``SAM_GEN_IOU`` a pair, differing pixels counted), at the default
    ``boxes=True`` (the masks of the cv2-rule fill kernel) and with
    ``boxes=False`` (``_masks`` fills the contours with the even-odd
    kernel); launch counts zeroed just before and read just after, both
    fills > 0. Then a fresh yolov8s-seg (FastSAM's published width, nc 2,
    seed 0) timed at 640, batch 1 and 8, conf ``VAL_CONF``, every result's
    masks read."""
    images = floor_val_set()[0][:8]
    card_fs, cpu_fs = FastSAM(CKPT, device="cuda"), FastSAM(CKPT, device="cpu")
    zero_launch_counts()
    worst = {"box": 0.0, "iou": 1.0, "pixels": 0, "prompts": 0, "detections": 0}
    for boxes in (True, False):
        for img in images:
            gres, cres = card_fs.predict(img, boxes=boxes), cpu_fs.predict(img, boxes=boxes)
            if len(gres[0]) != len(cres[0]):
                raise AssertionError(f"fastsam: card {len(gres[0])} and CPU {len(cres[0])} "
                                     f"detections")
            if not len(cres[0]):
                continue
            worst["detections"] += len(cres[0])
            worst["box"] = max(worst["box"], float(np.abs(gres[0].boxes.xyxy
                                                          - cres[0].boxes.xyxy).max()))
            gp, cp = FastSAMPrompt(img, gres), FastSAMPrompt(img, cres)
            b = cres[0].boxes.xyxy[0]
            centre = [(b[0] + b[2]) / 2, (b[1] + b[3]) / 2]
            for fn in (lambda p: p.everything_prompt(), lambda p: p.box_prompt(b + [-4, -4, 4, 4]),
                       lambda p: p.point_prompt([centre], [1])):
                g, c = fn(gp), fn(cp)
                if g.shape != c.shape:
                    raise AssertionError(f"fastsam: prompt shapes {g.shape} vs {c.shape}")
                for gm, cm in zip(g, c):
                    iou = np.logical_and(gm, cm).sum() / max(np.logical_or(gm, cm).sum(), 1)
                    worst["iou"] = min(worst["iou"], float(iou))
                    worst["pixels"] += int((gm != cm).sum())
                worst["prompts"] += 1
    counts = launch_counts()
    log("fastsam", f"FastSAM({CKPT.relative_to(ROOT)}) agnostic at conf 0.4 on "
        f"{len(images)} floor images, boxes True and False: {worst['detections']} detections, "
        f"card vs CPU boxes max abs {worst['box']:.2e} px (limit {BOX_ATOL}); {worst['prompts']} "
        f"prompts select the same masks: IoU min {worst['iou']:.4f} (limit {SAM_GEN_IOU}), "
        f"{worst['pixels']} differing pixels; launches {counts} (the cv2 fill at boxes=True, "
        f"the even-odd fill at boxes=False) | {card}")
    if (worst["box"] > BOX_ATOL or worst["iou"] < SAM_GEN_IOU or worst["detections"] == 0
            or counts["fill_polygons_cv2"] == 0 or counts["fill_polygons"] == 0):
        raise AssertionError(f"fastsam: {worst}, launches {counts}")
    fresh = FastSAM(device="cuda")
    fresh.model = fresh_model("yolov8s-seg.yaml", SHAPE_NAMES, 0).model
    frames = shape_images(8, *RASTER_HW, seed=2)
    lat = {}
    for batch, imgs in ((1, frames[:1]), (8, frames)):
        predict_ms(fresh, imgs, 640, batch, masks=True, conf=VAL_CONF)  # warm-up
        runs = [predict_ms(fresh, imgs, 640, batch, masks=True, conf=VAL_CONF) for _ in range(5)]
        lat[batch] = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    for batch, parts in lat.items():
        log("fastsam", f"yolov8s-seg fresh ({fresh.model.num_params} parameters), agnostic, conf "
            f"{VAL_CONF}, imgsz 640 batch {batch}, ms per image (host clock, median of 5 calls): "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + f" | {card}")
    return counts


def calibrate_batchnorm(model, images, imgsz: int):
    """``model``'s BatchNorm running statistics set to the batch statistics
    of one train-mode forward of ``images`` letterboxed to ``imgsz``
    (momentum 1 for that pass), on the model's device; then eval mode. A
    fresh deep RepConv graph in eval mode with unit running statistics
    grows its activations layer by layer (three branches summed a RepConv):
    yolo_nas_s's head maps reach 5e4 at a fresh init, ~16 once calibrated
    (measured on the CPU), where float32's rounding is no longer amplified."""
    pred = DetectionPredictor(imgsz=imgsz)
    x = np.stack([pred.preprocess_u8(img, imgsz)[0] for img in images])
    dev = next(model.parameters()).device
    xf = torch.from_numpy(x).to(dev).float().div(255.0).permute(0, 3, 1, 2).contiguous()
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        model.train()(xf)
    for m, mom in zip(bns, saved):
        m.momentum = mom
    return model.eval()


def nas_f64(model, images, imgsz: int, device):
    """A float64 copy of ``model`` on ``device``: its head maps and its NMS
    outputs (the decoded predictions cast to float32 for NMS at
    ``NAS_CONF``, as the predictor's) on ``images`` letterboxed to
    ``imgsz``, on the CPU; and the fused copy's head maps."""
    pred = DetectionPredictor(imgsz=imgsz, conf=NAS_CONF)
    x = np.stack([pred.preprocess_u8(img, imgsz)[0] for img in images])
    m = copy.deepcopy(model).double().to(device).eval()
    xf = torch.from_numpy(x).to(device).double().div(255.0).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        hs = m(xf)
        y = head_mod.decode_detect(hs, m.strides, m.nc, m.reg_max)  # = m.predict(xf)
        out = non_max_suppression(detect_xyxy(y).float(), nc=m.nc, **pred.nms_kw)
        fused = [h.cpu() for h in fuse_model(m)(xf)]
    return [h.cpu() for h in hs], {k: v.cpu() for k, v in out.items()}, fused


def nas_phase(card: str) -> dict:
    """A fresh yolo_nas_s (nc 2, ``fresh_nas``, its BatchNorm statistics
    calibrated on the CPU by ``calibrate_batchnorm`` on four frames and
    copied to the card): its parameter count (JAX's, ``NAS_PARAMS``); on
    ``NAS_F64_FRAMES`` 480x640 frames at 640, card against the port on the
    CPU with both networks in float64 (heads within ``HEAD_ATOL``, the
    same detections at ``NAS_CONF``, boxes within ``BOX_ATOL``, scores
    within ``SCORE_ATOL``; the fused float64 copies' heads within
    ``FUSE_HEAD_ATOL`` of the unfused); the facade's float32 predict on
    eight frames at batch 1 and 8 on both, the same detections and boxes
    within ``BOX_ATOL`` (float32's rounding moves this net's frame-wide
    boxes by ~0.04 px on the CPU alone), the scores' differences printed
    beside the CPU's own float32-from-float64 heads, with ms an image; the
    float32 fused model on the card keeping the unfused one's detections,
    boxes within ``BOX_ATOL``; one
    train step card against CPU in float64 at ``F64_STEP_IMGSZ`` batch ``NAS_F64_B``
    (``train_card_vs_cpu``); the train step at 640 batch 16 timed
    (``train_full_width``, floor_detect's train_args). Launches no
    kernel."""
    frames = shape_images(8, *RASTER_HW, seed=2)
    cpu = fresh_nas("cpu")
    calibrate_batchnorm(cpu.model, frames[4:], 640)
    nas = NAS("yolo_nas_s", device="cuda")
    nas.model = copy.deepcopy(cpu.model).to("cuda").eval()
    n_params = nas.model.num_params
    if n_params != NAS_PARAMS:
        raise AssertionError(f"yolo_nas_s has {n_params} parameters, JAX's {NAS_PARAMS}")
    zero_launch_counts()
    (gh, gout, gfused), (ch, cout, cfused) = (nas_f64(cpu.model, frames[:NAS_F64_FRAMES], 640,
                                                      d) for d in ("cuda", "cpu"))
    worst64 = {"head": max(float((g - c).abs().max()) for g, c in zip(gh, ch)),
               "fused": max(float((f - h).abs().max()) for f, h in zip(gfused, gh)),
               "box": float((gout["boxes"] - cout["boxes"]).abs().max()),
               "score": float((gout["scores"] - cout["scores"]).abs().max())}
    same64 = (torch.equal(gout["valid"], cout["valid"])
              and torch.equal(gout["classes"], cout["classes"]))
    n64 = int(cout["valid"].sum())
    f32, ref = {}, {}
    for batch in (1, 8):
        gres = nas.predict(frames, imgsz=640, batch=batch, conf=NAS_CONF)
        cres = cpu.predict(frames, imgsz=640, batch=batch, conf=NAS_CONF)
        if [len(r) for r in gres] != [len(r) for r in cres] or not all(
                np.array_equal(g.boxes.cls, c.boxes.cls) for g, c in zip(gres, cres)):
            raise AssertionError(f"nas: card and CPU keep different detections at batch {batch}")
        f32[batch] = (max(float(np.abs(g.boxes.xyxy - c.boxes.xyxy).max()) for g, c in
                          zip(gres, cres) if len(c)),
                      max(float(np.abs(g.boxes.conf - c.boxes.conf).max()) for g, c in
                          zip(gres, cres) if len(c)))
    pred = DetectionPredictor(imgsz=640, conf=NAS_CONF)
    x = np.stack([pred.preprocess_u8(img, 640)[0] for img in frames])
    with torch.inference_mode():
        xf = torch.from_numpy(x[:NAS_F64_FRAMES]).float().div(255.0).permute(0, 3, 1, 2)
        c32 = cpu.model(xf.contiguous())
    ref["head"] = max(float((a.double() - b).abs().max()) for a, b in zip(c32, ch))
    lat = {}
    for batch, imgs in ((1, frames[:1]), (8, frames)):
        predict_ms(nas, imgs, 640, batch, masks=False, conf=NAS_CONF)
        runs = [predict_ms(nas, imgs, 640, batch, masks=False, conf=NAS_CONF) for _ in range(10)]
        lat[batch] = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    fused = NAS("yolo_nas_s", device="cuda")
    fused.model = fuse_model(copy.deepcopy(nas.model))
    fres = fused.predict(frames, imgsz=640, batch=8, conf=NAS_CONF)
    ures = nas.predict(frames, imgsz=640, batch=8, conf=NAS_CONF)
    same_fused = [len(r) for r in fres] == [len(r) for r in ures] and all(
        np.array_equal(f.boxes.cls, u.boxes.cls) for f, u in zip(fres, ures))
    fused_box = max((float(np.abs(f.boxes.xyxy - u.boxes.xyxy).max()) for f, u in
                     zip(fres, ures) if same_fused and len(u)), default=math.inf)
    log("nas", f"yolo_nas_s fresh (nc 2, seed 0, BatchNorm statistics calibrated on 4 frames): "
        f"{n_params} parameters (JAX's {NAS_PARAMS}); card vs CPU in float64 on "
        f"{NAS_F64_FRAMES} frames at 640, conf {NAS_CONF}: heads max abs {worst64['head']:.2e} "
        f"(limit {HEAD_ATOL}), the same {n64} detections {same64}, boxes {worst64['box']:.2e} "
        f"px (limit {BOX_ATOL}), scores {worst64['score']:.2e} (limit {SCORE_ATOL}); fused vs "
        f"unfused in float64 {worst64['fused']:.2e} (limit {FUSE_HEAD_ATOL}) | {card}")
    log("nas", f"the facade's float32 predict on {len(frames)} frames, card vs CPU: the same "
        "detections at batch 1 and 8; boxes max abs (limit " + f"{BOX_ATOL}) / scores max abs "
        + ", ".join(f"batch {b} {v[0]:.2e} px / {v[1]:.2e}" for b, v in f32.items())
        + f" (the CPU's float32 heads against its float64 ones: {ref['head']:.2e}); fused "
        f"float32 on the card keeps the unfused detections and classes {same_fused}, boxes max "
        f"abs {fused_box:.2e} px (limit {BOX_ATOL}); {n_params} -> {fused.model.num_params} "
        f"parameters | {card}")
    for batch, parts in lat.items():
        log("nas", f"imgsz 640 batch {batch}, ms per image (host clock, median of 10 calls): "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + f" | {card}")
    if (not same64 or n64 == 0 or worst64["head"] > HEAD_ATOL or worst64["box"] > BOX_ATOL
            or worst64["score"] > SCORE_ATOL or worst64["fused"] > FUSE_HEAD_ATOL
            or not same_fused or fused_box > BOX_ATOL
            or max(v[0] for v in f32.values()) > BOX_ATOL):
        raise AssertionError(f"nas: float64 card vs CPU {worst64}, same {same64}; float32 card "
                             f"vs CPU boxes and scores {f32}; fused same {same_fused}, boxes "
                             f"{fused_box}")
    detect_ckpt = load_checkpoint(DETECT_CKPT)
    train_card_vs_cpu(detect_ckpt, card, imgsz=F64_STEP_IMGSZ, phase="nas_train", b=NAS_F64_B,
                      model=cpu.model, dtype=torch.float64)
    del cpu
    _, step_counts, split, step_ms = train_full_width(detect_ckpt, card, phase="nas_train",
                                                      model=nas.model, label="yolo_nas_s")
    counts = launch_counts()
    if any(counts.values()) or any(step_counts.values()):
        raise AssertionError(f"nas launched kernels: {counts}, {step_counts}")
    return {"step_ms": step_ms, "split": split}


def gap_conf(scores: torch.Tensor, lo: int, hi: int):
    """A confidence halfway across the widest gap between two neighbours
    among the ``lo``-th to ``hi``-th highest of ``scores``, and that gap."""
    s = scores.flatten().double().sort(descending=True).values
    r = torch.arange(lo, min(hi, len(s) - 1) + 1)
    gaps = s[r - 1] - s[r]
    i = int(r[int(gaps.argmax())])
    return float((s[i - 1] + s[i]) / 2), float(gaps.max())


def predict_from(model, outs, x: torch.Tensor):
    """``model.predict(x)`` on head maps ``outs`` already computed from
    ``x`` (its forward not run again: the CPU's float64 forward of a full
    width config costs seconds)."""
    model.forward = lambda *a, **k: outs
    try:
        return model.predict(x)
    finally:
        del model.forward


def config_nms(model, x: torch.Tensor, conf: float, outs=None) -> dict:
    """The predictor's ``eval_batch`` on a float input of the model's dtype:
    the decode, made xyxy and cast to float32, through NMS at ``conf``
    (``outs``: the head maps of ``x``, already computed)."""
    with torch.inference_mode():
        y = detect_xyxy(model.predict(x) if outs is None else predict_from(model, outs, x)).float()
    return {k: v.cpu() for k, v in non_max_suppression(
        y, nc=model.nc, conf_thres=conf, iou_thres=0.7, pre_nms=1024, max_det=300).items()}


def config_pair(name: str, card: str) -> dict:
    """One config fresh from seed 0 at full width on the CPU and, the same
    weights, on the card: its parameters (JAX's ``CONFIG_PARAMS``); at 640
    on 480x640 frames, batch 1 (yolov3) or 2, the float32 head maps card
    against CPU (``HEAD_ATOL`` of the largest head); then float64 copies:
    heads card against CPU (``HEAD_ATOL``), the same detections at a
    ``gap_conf`` confidence, boxes and keypoints within ``BOX_ATOL``,
    scores and visibilities within ``SCORE_ATOL``, and the fused card copy
    against the unfused one (heads ``FUSE_HEAD_ATOL``, the same detections,
    boxes ``BOX_ATOL``). A fresh net's scores sit at its class prior (about
    1.6e-4 at nc 80), where neighbouring float32 scores lie as close as
    float32's own differences (1.6e-10 at yolov6n, on the CPU): hence
    float64 for the detections, as the fresh segment_ori, RT-DETR and NAS
    steps are held. Last the facade's float32 predict timed at 640, batch
    1 and 8, conf 0.001 (median of 5 calls), with the peak memory."""
    cfg = yaml_model_load(name)
    cpu = fresh_model(name, {i: f"class{i}" for i in range(cfg["nc"])}, 0, device="cpu")
    n_params = cpu.model.num_params
    if n_params != CONFIG_PARAMS[name]:
        raise AssertionError(f"{name}: {n_params} parameters, JAX's {CONFIG_PARAMS[name]}")
    gpu = YOLO(name, device="cuda")
    gpu.model = copy.deepcopy(cpu.model).to("cuda").eval()
    frames = shape_images(8, *RASTER_HW, seed=2)
    b = 1 if name == "yolov3.yaml" else 2
    pre = predictor_of(cpu.model)(imgsz=640)
    xt = torch.from_numpy(np.stack([pre.preprocess_u8(img, 640)[0] for img in frames[:b]]))
    xf = xt.float().div(255.0).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        c32 = cpu.model(xf)
        g32 = [h.cpu() for h in gpu.model(xf.cuda())]
    scale = max(1.0, max(float(c.abs().max()) for c in c32))  # limits of the largest head
    head32 = max(float((g - c).abs().max()) for g, c in zip(g32, c32))
    m64 = {d: copy.deepcopy(cpu.model).double().to(d).eval() for d in ("cpu", "cuda")}
    fused = fuse_model(copy.deepcopy(m64["cuda"]))
    x64 = xf.double()
    with torch.inference_mode():
        c64 = m64["cpu"](x64)
        g64 = [h.cpu() for h in m64["cuda"](x64.cuda())]
        f64 = [h.cpu() for h in fused(x64.cuda())]
        scores = predict_from(m64["cpu"], c64, x64)[:, 4:4 + cpu.model.nc].amax(1).float()
    conf, gap = gap_conf(scores, *CONFIG_GAP)
    oc = config_nms(m64["cpu"], x64, conf, outs=c64)
    og = config_nms(m64["cuda"], x64.cuda(), conf)
    of = config_nms(fused, x64.cuda(), conf)
    keep = oc["valid"]

    def gap_of(a, b_):
        d = (a - b_)[keep].abs()
        return float(d.max()) if d.numel() else 0.0

    worst = {"head f32": head32, "head": max(float((g - c).abs().max()) for g, c in zip(g64, c64)),
             "box": gap_of(og["boxes"], oc["boxes"]), "score": gap_of(og["scores"], oc["scores"]),
             "fused head": max(float((f - g).abs().max()) for f, g in zip(f64, g64)),
             "fused box": gap_of(of["boxes"], og["boxes"])}
    if cpu.model.task == "pose":
        kg, kc = (o["extras"].reshape(*o["extras"].shape[:2], -1, 3) for o in (og, oc))
        worst["keypoint"] = gap_of(kg[..., :2], kc[..., :2])
        worst["visibility"] = gap_of(kg[..., 2], kc[..., 2])
    same = all(torch.equal(o["valid"], oc["valid"]) and torch.equal(o["classes"], oc["classes"])
               for o in (og, of))
    limits = {"head f32": HEAD_ATOL * scale, "head": HEAD_ATOL * scale, "box": BOX_ATOL,
              "score": SCORE_ATOL, "fused head": FUSE_HEAD_ATOL * scale, "fused box": BOX_ATOL,
              "keypoint": BOX_ATOL, "visibility": SCORE_ATOL}
    n_det = int(keep.sum())
    log("configs", f"{name} fresh (seed 0, nc {cpu.model.nc}): {n_params} parameters (JAX's "
        f"{CONFIG_PARAMS[name]}), fused {fused.num_params}, strides {cpu.model.strides}; card vs "
        f"CPU at 640 batch {b}, max abs: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f" (limits: heads {HEAD_ATOL} of the largest, {scale:.2f}; boxes and keypoints "
        f"{BOX_ATOL} px; scores {SCORE_ATOL}; the rest in float64); the same {n_det} "
        f"detections (card, fused card) {same} at conf {conf:.9f}, in a gap of {gap:.2e} "
        f"between neighbouring float32 scores | {card}")
    if (not same or n_det == 0 or not gap > 0
            or any(v > limits[k] for k, v in worst.items())):
        raise AssertionError(f"configs {name}: same {same}, {n_det} detections, gap {gap}, "
                             f"{worst}")
    del m64, fused
    torch.cuda.reset_peak_memory_stats()
    lat = {}
    for batch, imgs in ((1, frames[:1]), (8, frames)):
        predict_ms(gpu, imgs, 640, batch, masks=False, conf=0.001)
        runs = [predict_ms(gpu, imgs, 640, batch, masks=False, conf=0.001) for _ in range(5)]
        lat[batch] = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("configs", f"{name} float32 predict at imgsz 640, conf 0.001, ms per image (host clock, "
        f"median of 5 calls): "
        + "; ".join(f"batch {bb}: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
                    for bb, parts in lat.items())
        + f"; peak memory {peak:.2f} GiB | {card}")
    return {"model": cpu.model, "ms": {bb: parts["total"] for bb, parts in lat.items()},
            "peak_gib": peak}


def configs_phase(card: str) -> dict:
    """The seven configs the port builds beside the others (``CONFIG_PARAMS``),
    each by ``config_pair``; then one train step of each four-level config
    (``CONFIG_STEPS``: p2 at strides 4-32, p6 and pose-p6 at 8-64) at
    ``CONFIG_STEP_IMGSZ`` batch ``CONFIG_STEP_B``, card against CPU in
    float64 (``train_card_vs_cpu``, the floor_detect and floor_pose
    checkpoints' train_args). Detect and pose launch no kernel: the counts
    over the phase must be 0."""
    zero_launch_counts()
    hyps = {task: load_checkpoint(path)["train_args"]
            for task, path in (("detect", DETECT_CKPT), ("pose", POSE_CKPT))}
    out = {}
    for name in CONFIG_PARAMS:
        out[name] = config_pair(name, card)
        model = out[name].pop("model")
        if name in CONFIG_STEPS:
            ckpt = {"model_yaml": model.yaml, "train_args": hyps[model.task]}
            train_card_vs_cpu(ckpt, card, imgsz=CONFIG_STEP_IMGSZ, phase="configs",
                              b=CONFIG_STEP_B, model=model, dtype=torch.float64)
        del model
    counts = launch_counts()
    log("configs", f"launches over the phase {counts} | {card}")
    if any(counts.values()):
        raise AssertionError(f"the detect and pose configs launched kernels: {counts}")
    return out


def nas_trainer(card: str) -> dict:
    """``NAS("yolo_nas_s").train`` from scratch on the detect floor set (64
    train and 16 val images at 96) at the detect floor recipe
    (``FLOOR_TRAIN_KEYS`` of floor_detect's train_args) for
    ``NAS_TRAIN_EPOCHS`` epochs (cut from its 100 to keep the smoke inside
    its limit): the train loss must fall from the first epoch to the last
    and stay finite; the final metrics, the wall time and the epoch split
    are recorded (no NAS floor is committed, so none is held). Launches no
    kernel."""
    ckpt = load_checkpoint(DETECT_CKPT)
    over = {k: ckpt["train_args"][k] for k in FLOOR_TRAIN_KEYS}
    over["epochs"] = NAS_TRAIN_EPOCHS
    over["save_last_every"] = SAVE_LAST_EVERY
    over["close_mosaic"] = min(over["close_mosaic"], NAS_TRAIN_EPOCHS // 4)
    train, val = floor_detect_train_set(), floor_detect_val_set()
    with tempfile.TemporaryDirectory() as d:
        model = NAS("yolo_nas_s", device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        t = time.perf_counter()
        res = model.train(data={"train": train, "val": val, "names": ckpt["names"]},
                          project=d, name="nas", **over)
        wall = time.perf_counter() - t
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        trainer = model.trainer
        with open(trainer.csv) as fh:
            rows = list(csv.DictReader(fh))
        n_det = sum(len(r) for r in model.predict(val[0], imgsz=over["imgsz"]))
    losses = [float(r["train/loss"]) for r in rows]
    split = epoch_split(trainer)
    metrics = ", ".join(f"{k.split('/')[1]} {x:.4f}" for k, x in res.items() if k != "fitness")
    log("nas_trainer", f"yolo_nas_s from scratch on the detect floor set ({len(train[0])} train, "
        f"{len(val[0])} val images), {over}: {len(rows)} epochs in {wall:.2f}s wall; train loss "
        f"{losses[0]:.3f} at epoch 1, {losses[-1]:.3f} at epoch {len(losses)}; final eval of the "
        f"stripped best.ckpt: {metrics}; {n_det} detections predicted on the val images at conf "
        f"0.25; no NAS floor committed (recorded, not held); launches {counts}; peak memory "
        f"{peak / 2**30:.3f} GiB | {card}")
    log("nas_trainer", "host clock, s an epoch (median of the epochs): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split["median"].items()) + "; summed: "
        + ", ".join(f"{k} {v:.2f}" for k, v in split["sum"].items()) + f" | {card}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0] or any(
            counts.values()):
        raise AssertionError(f"nas_trainer: losses {losses}, launches {counts}")
    return {"wall_s": wall, "metrics": res}


def paper_comparison(card: str) -> dict:
    """The fork's headline, printed and not gated: ms an image on the card
    at imgsz 640, batch 1 and batch 8, of yolov8n-seg polar (boxes, scores
    and contours, no masks) and yolov8n detect, each unfused and fused:
    the predictor's device evaluation (the conv graph, the decode and NMS,
    and the polar contours of the survivors) from letterboxed uint8 frames
    on the card, CUDA events, median of 20; TF32 off as in the whole run;
    and the ratio seg / detect."""
    frames = shape_images(8, *RASTER_HW, seed=9)
    out = {}
    for name, path in (("seg", CKPT), ("detect", DETECT_CKPT)):
        for fused in (False, True):
            m = YOLO(path, device="cuda")
            if fused:
                m.fuse()
            pred = predictor_of(m)(imgsz=640)
            x = torch.from_numpy(np.stack([pred.preprocess_u8(f, 640)[0] for f in frames])).cuda()
            for b in COMPARE_BATCHES:
                xb = x[:b]
                out[(name, fused, b)] = time_ms(lambda: pred.eval_batch(m.model, xb), reps=20) / b
    rows = []
    for fused in (False, True):
        for b in COMPARE_BATCHES:
            seg, det = out[("seg", fused, b)], out[("detect", fused, b)]
            rows.append(f"{'fused' if fused else 'unfused'} batch {b}: seg {seg:.3f}, detect "
                        f"{det:.3f}, seg/detect {seg / det:.3f}")
    log("compare", "imgsz 640, ms an image on the card (forward + decode + NMS, polar contours "
        "of the survivors, no masks; CUDA events, median of 20): " + "; ".join(rows) + f" | {card}")
    return out


SERVE_LOAD = dict(imgsz=640, max_batch=32, max_delay_ms=5.0)  # the closed-loop load
SERVE_CONCURRENCY = (1, 8, 32)
# seconds of load at each concurrency (3 until the ddp phases needed room)
SERVE_LOAD_S = 2.0
SERVE_HTTP_CLIENTS = 8  # the closed loop through the HTTP front end
# its seconds (6 until the ddp phases needed room): a reply takes seconds while 8
# decodes share the GIL
SERVE_HTTP_S = 4.0
SERVE_ATOL = 1e-4  # served against direct: boxes, contours, keypoints (px) and scores
SEGORI_NARROW_CKPT = ROOT / "tests" / "data" / "torch_port_segori_narrow64.ckpt"


def served_vs_direct(got, want, what: str) -> dict:
    """Served results against the direct predictor's: the same counts and
    classes, boxes, contours and keypoints within ``SERVE_ATOL`` px, scores
    and probabilities within ``SERVE_ATOL``, masks equal (read on both
    sides, which fills lazy ones). Raises on a difference."""
    err = {"dets": 0, "px": 0.0, "score": 0.0, "mask_px": 0}
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} served results, {len(want)} direct")
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w):
            raise AssertionError(f"{what} image {i}: {len(g)} served detections, {len(w)} direct")
        err["dets"] += len(g)
        if w.probs is not None:
            err["score"] = max(err["score"], float(np.abs(g.probs.data - w.probs.data).max()))
            if g.probs.top1 != w.probs.top1:
                raise AssertionError(f"{what} image {i}: top-1 {g.probs.top1} != {w.probs.top1}")
            continue
        if not len(g):
            continue
        if not np.array_equal(g.boxes.cls, w.boxes.cls):
            raise AssertionError(f"{what} image {i}: classes differ")
        pairs = [(g.boxes.xyxy, w.boxes.xyxy)]
        if w.contours is not None:
            pairs.append((g.contours.points, w.contours.points))
            if not np.array_equal(g.contours.valid, w.contours.valid):
                raise AssertionError(f"{what} image {i}: contour validity differs")
        if w.keypoints is not None:
            pairs.append((g.keypoints[..., :2], w.keypoints[..., :2]))
            err["score"] = max(err["score"], float(np.abs(g.keypoints[..., 2]
                                                          - w.keypoints[..., 2]).max()))
        err["px"] = max([err["px"]] + [float(np.abs(a - b).max()) for a, b in pairs])
        err["score"] = max(err["score"], float(np.abs(g.boxes.conf - w.boxes.conf).max()))
        if w.masks is not None:
            err["mask_px"] += int((g.masks.data != w.masks.data).sum())
    if err["px"] > SERVE_ATOL or err["score"] > SERVE_ATOL or err["mask_px"]:
        raise AssertionError(f"{what}: served against direct {err} (limits {SERVE_ATOL} px and "
                             f"score, 0 mask pixels)")
    return err


def serve_direct(handle, images, imgsz: int, batch: int, what: str, card: str,
                 conf=None) -> dict:
    """``images`` through an ``InferenceServer`` (buckets [batch], every
    bucket warmed first) against ``handle.predict`` at ``batch`` on the same
    fused weights: every formed batch is padded to the predictor's batch
    shape, so each image meets the same kernels on both paths. Returns the
    launch counts of the served path alone: zeroed before ``infer``, read
    once the served results' masks are read."""
    kw = {} if conf is None else {"conf": conf}
    with InferenceServer(handle, imgsz=imgsz, max_batch=batch, buckets=[batch],
                         max_delay_ms=20.0, **kw) as srv:
        srv.warmup()
        zero_launch_counts()
        got = srv.infer(images, timeout=300.0)
        for r in got:
            r.masks  # noqa: B018 -- fills lazy masks, as a client reading them does
        counts = launch_counts()
        stats = srv.stats()
    want = handle.predict(images, imgsz=imgsz, batch=batch, **kw)
    err = served_vs_direct(got, want, what)
    log("serve", f"{what}: {len(images)} images at {imgsz}, bucket {batch}, {stats['batches']} "
        f"batches, {err['dets']} detections served = direct (max {err['px']:.2e} px, scores "
        f"{err['score']:.2e}, {err['mask_px']} differing mask pixels; limits {SERVE_ATOL}), "
        f"warm-up {srv.warmup_ms[batch]:.1f} ms; launches of the served path {counts} | {card}")
    return counts


def closed_loop(srv, frames, concurrency: int, seconds: float) -> dict:
    """``concurrency`` clients, each submitting a frame and waiting for its
    result, again and again for ``seconds``: the server's stats of the run."""
    srv.reset_stats()
    stop = time.perf_counter() + seconds
    errors = []

    def client(i):
        k = i
        while time.perf_counter() < stop:
            try:
                srv.submit(frames[k % len(frames)]).result(timeout=120.0)
            except Exception as e:  # noqa: BLE001 -- raised below, after the join
                errors.append(e)
                return
            k += concurrency

    threads = [threading.Thread(target=client, args=(i,)) for i in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return srv.stats()


def serve_load(card: str) -> dict:
    """The closed-loop load on yolov8n-seg (the fused seg160 checkpoint) at
    640 on 480x640 frames, ``SERVE_LOAD``: each bucket warmed, then each
    concurrency for ``SERVE_LOAD_S`` seconds; latency quantiles, rps, mean
    batch, padded rows, and the completion thread's time overlapped with the
    dispatcher's. Recorded, not limited."""
    handle = YOLO(CKPT, device="cuda")
    frames = shape_images(16, *RASTER_HW, seed=31)
    out = {}
    with InferenceServer(handle, **SERVE_LOAD) as srv:
        srv.warmup()
        warm = ", ".join(f"{b} {ms:.1f}" for b, ms in srv.warmup_ms.items())
        log("serve_load", f"warm-up ms by bucket (imgsz 640): {warm} | {card}")
        for c in SERVE_CONCURRENCY:
            s = closed_loop(srv, frames, c, SERVE_LOAD_S)
            share = s["overlap_ms"] / s["complete_ms"] if s["complete_ms"] else 0.0
            out[c] = s
            log("serve_load", f"concurrency {c}: p50 {s['latency_ms_p50']} p95 "
                f"{s['latency_ms_p95']} p99 {s['latency_ms_p99']} ms, {s['throughput_rps']} rps, "
                f"mean batch {s['mean_batch']}, {s['requests']} requests in {s['batches']} "
                f"batches, padded rows {s['padded_rows']}, batch_hist {s['batch_hist']}; "
                f"dispatch {s['dispatch_ms'] / max(s['batches'], 1):.2f} ms a batch, completion "
                f"{s['complete_ms'] / max(s['batches'], 1):.2f} ms a batch, {share:.1%} of the "
                f"completion overlapped with the dispatcher; last_error {s['last_error']} | "
                f"{card}")
            if s["requests"] == 0 or s["last_error"]:
                raise AssertionError(f"serve_load concurrency {c}: {s}")
    return out


def http_json(port: int, path: str, data: bytes = None):
    """(status, JSON reply) of a GET, or with ``data`` a POST, to localhost."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_http_check(card: str) -> dict:
    """``serve_http`` on port 0 with the seg160 checkpoint at 160: the
    committed JPEG and PNG files posted; their decodes (``imcodec``, what
    the handler runs) byte-equal to the committed cv2 decodes; each reply's
    rows held to ``tojson`` of a direct predict of the committed decode
    (names and classes equal, numbers within ``SERVE_ATOL``); then
    ``/stats``, ``/healthz``, a 404 and the 400s."""
    data = ROOT / "tests" / "data"
    with np.load(data / SERVE_DECODES) as z:
        decodes = {k: z[k] for k in z.files}
    handle = YOLO(CKPT, device="cuda")
    httpd = serve_http(handle, port=0, imgsz=160, max_batch=1)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    rows = 0
    try:
        for name in SERVE_FIXTURES:
            raw = (data / name).read_bytes()
            if not np.array_equal(imdecode(raw), decodes[name]):
                raise AssertionError(f"serve_http: {name} decodes differently from cv2")
            code, payload = http_json(port, "/predict", raw)
            want = json.loads(handle.predict(decodes[name], imgsz=160)[0].tojson())
            got = payload.get("results")
            if code != 200 or got is None or len(got) != len(want):
                raise AssertionError(f"serve_http {name}: {code} {payload} against {len(want)} "
                                     f"direct rows")
            for g, w in zip(got, want):
                if (g["name"], g["class"]) != (w["name"], w["class"]):
                    raise AssertionError(f"serve_http {name}: {g} against {w}")
                nums = [abs(g["confidence"] - w["confidence"])] + [
                    abs(g["box"][k] - w["box"][k]) for k in w["box"]] + [
                    abs(a - b) for ax in "xy" for a, b in zip(g["segments"][ax],
                                                              w["segments"][ax])]
                if max(nums) > SERVE_ATOL:
                    raise AssertionError(f"serve_http {name}: row off by {max(nums)}")
            rows += len(got)
        code, stats = http_json(port, "/stats")
        health = http_json(port, "/healthz")
        bad = [http_json(port, "/nope")[0], http_json(port, "/predict", b"")[0],
               http_json(port, "/predict", b"GIF89a")[0]]
        if code != 200 or stats["requests"] != len(SERVE_FIXTURES) or health != (200, {"ok": True}) \
                or bad != [404, 400, 400]:
            raise AssertionError(f"serve_http: stats {code} {stats}, healthz {health}, {bad}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.engine.close()
    log("serve_http", f"{len(SERVE_FIXTURES)} posted files ({', '.join(SERVE_FIXTURES)}) decoded "
        f"byte-equal to their cv2 decodes; {rows} reply rows = tojson of direct predict (limit "
        f"{SERVE_ATOL}); /stats {stats['requests']} requests p50 {stats.get('latency_ms_p50')} "
        f"ms, /healthz ok, 404 and 400s | {card}")
    return stats


class SyntheticCapture:
    """A capture (cv2's VideoCapture API) over a list of frames."""

    def __init__(self, frames):
        self.frames, self.i, self.grabbed = list(frames), 0, None

    def isOpened(self):
        return self.i <= len(self.frames)

    def grab(self):
        if self.i >= len(self.frames):
            return False
        self.grabbed, self.i = self.frames[self.i], self.i + 1
        return True

    def retrieve(self):
        return self.grabbed is not None, self.grabbed

    def read(self):
        return self.retrieve() if self.grab() else (False, None)

    def release(self):
        self.i = len(self.frames) + 1


def serve_streams(card: str) -> dict:
    """``_stream_batched``: two synthetic captures of 4 frames each through
    ``YOLO.predict(LoadStreams(...))`` (one batch-2 forward a step), each
    result held to a predict of its frame alone (``SERVE_ATOL``). Returns
    the launch counts of the streamed predict and its masks' reading."""
    handle = YOLO(CKPT, device="cuda")
    frames = {s: shape_images(4, 120, 200, seed=40 + i) for i, s in enumerate(("cam0", "cam1"))}
    loader = LoadStreams(list(frames), buffer=True,
                         open_fn=lambda s: SyntheticCapture(frames[s]))
    zero_launch_counts()
    got = handle.predict(loader, imgsz=160)
    for r in got:
        r.masks  # noqa: B018 -- fills lazy masks, as a client reading them does
    counts = launch_counts()
    order = [f"{s}#frame{j}" for j in range(4) for s in frames]
    if [r.path for r in got] != order:
        raise AssertionError(f"serve_streams: paths {[r.path for r in got]}")
    want = [handle.predict(frames[r.path.split("#")[0]][int(r.path.split("frame")[1])],
                           imgsz=160)[0] for r in got]
    err = served_vs_direct(got, want, "serve_streams")
    log("serve_streams", f"2 synthetic captures x 4 frames, one batch-2 forward a step: "
        f"{err['dets']} detections = per-frame predict (max {err['px']:.2e} px, scores "
        f"{err['score']:.2e}, {err['mask_px']} differing mask pixels); launches of the streamed "
        f"predict {counts} | {card}")
    return counts


def decode_ms(card: str) -> dict:
    """The host decode (``imcodec.imdecode``) of the committed 480x640 JPEG
    (quality 95, 4:2:0) and PNG, and of the posted files: median of 5."""
    out = {}
    for name in SERVE_TIMED + SERVE_FIXTURES:
        raw = (ROOT / "tests" / "data" / name).read_bytes()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            img = imdecode(raw)
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = statistics.median(times)
        log("serve_decode", f"{name} ({len(raw)} bytes -> {img.shape}): "
            f"{out[name]:.2f} ms on the host (median of 5) | {card}")
    return out


def serve_http_load(card: str, decode: dict) -> dict:
    """A closed loop through the HTTP front end: ``SERVE_HTTP_CLIENTS``
    clients, each posting the committed 480x640 JPEG (quality 95) to
    ``serve_http`` (yolov8n-seg at 640, ``SERVE_LOAD``) and waiting for its
    reply, for ``SERVE_HTTP_S`` seconds. Each request is decoded in Python in
    its handler thread, so one process is capped near 1000 / (decode ms)
    rps. Recorded, not limited."""
    raw = (ROOT / "tests" / "data" / SERVE_TIMED[0]).read_bytes()
    httpd = serve_http(YOLO(CKPT, device="cuda"), port=0, **SERVE_LOAD)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    lats, errors = [], []
    try:
        httpd.engine.reset_stats()
        start = time.perf_counter()
        stop = start + SERVE_HTTP_S

        def client():
            while time.perf_counter() < stop:
                t = time.perf_counter()
                code, payload = http_json(port, "/predict", raw)
                if code != 200 or "results" not in payload:
                    errors.append((code, payload))
                    return
                lats.append(time.perf_counter() - t)

        threads = [threading.Thread(target=client) for _ in range(SERVE_HTTP_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - start
        stats = httpd.engine.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.engine.close()
    if errors or not lats:
        raise AssertionError(f"serve_http_load: {len(lats)} replies, errors {errors[:2]}")
    ms = np.percentile(np.array(lats) * 1e3, [50, 95, 99])
    cap = 1e3 / decode[SERVE_TIMED[0]]
    log("serve_http_load", f"concurrency {SERVE_HTTP_CLIENTS}, {SERVE_TIMED[0]} ({len(raw)} "
        f"bytes) posted to serve_http at {SERVE_LOAD['imgsz']}: {len(lats)} replies in {wall:.2f} s, "
        f"{len(lats) / wall:.2f} rps; client latency p50 {ms[0]:.2f} p95 {ms[1]:.2f} p99 "
        f"{ms[2]:.2f} ms; the server's own p50 {stats['latency_ms_p50']} ms, mean batch "
        f"{stats['mean_batch']}; the decode alone caps one process at {cap:.2f} rps | {card}")
    return {"rps": len(lats) / wall, "p50": float(ms[0]), "server": stats}


def serve_phase(card: str) -> tuple:
    """Serving on the card: the fused seg160 checkpoint at 160 on the 16
    floor val frames through ``InferenceServer`` against the direct
    predictor (masks read on both sides); one floor checkpoint each of
    detect, pose, classify and rtdetr, and the committed narrow segment_ori
    checkpoint, at batch 2; the closed-loop load at 640; the HTTP front end
    on the committed files; two synthetic streams batched; the host decode
    times; the closed loop through the HTTP front end. Returns the launch
    counts of the served and streamed paths summed, and by path: each zeroed
    just before its path and read just after its results' masks are read."""
    images, _ = floor_val_set()
    seg = YOLO(CKPT, device="cuda").fuse()
    parts = {"segment": serve_direct(seg, images, 160, 8, "segment (seg160, fused)", card)}
    if parts["segment"]["fill_polygons_cv2"] == 0:
        raise AssertionError(f"serve: the served masks launched no cv2 fill: {parts}")
    cases = (("detect", DETECT_CKPT, floor_detect_val_set()[0][:4], DETECT_IMGSZ, None),
             ("pose", POSE_CKPT, floor_pose_val_set()[0][:4], POSE_IMGSZ, None),
             ("segment_ori", SEGORI_NARROW_CKPT, shape_images(4, 48, 64, 41), 64, 0.001),
             ("classify", CLS_CKPT, floor_cls_set(FLOOR_CLS_VAL)[0][:4], 64, None),
             ("rtdetr", RTDETR_CKPT, floor_rtdetr_val_set()[0][:4], RTDETR_IMGSZ, None))
    for task, ckpt, imgs, imgsz, conf in cases:
        handle = YOLO(ckpt, device="cuda")
        if handle.task != task:
            raise AssertionError(f"serve: {ckpt} is {handle.task}, not {task}")
        parts[task] = serve_direct(handle, imgs, imgsz, 2,
                                   f"{task} ({ckpt.parent.name}/{ckpt.name})", card, conf=conf)
    serve_load(card)
    serve_http_check(card)
    parts["streams"] = serve_streams(card)
    decode = decode_ms(card)
    serve_http_load(card, decode)
    counts = {k: sum(c[k] for c in parts.values()) for k in KERNEL_WRAPPERS}
    return counts, parts


# the ddp phase: (a) the seg trainer on one card, with and without a
# one-rank NCCL process group, DDP_EPOCHS epochs at the seg160 floor
# config; (b) two gloo ranks sharing cuda:0 against one process: DDP_STEPS
# float64 steps of the seg160 model at 160 on a batch of DDP_B (each rank
# its 4 rows), held to the CPU test's limits (tests/test_torch_port_parallel.py)
DDP_EPOCHS = 2
DDP_B, DDP_STEPS = 8, 3
DDP_LOSS_RTOL, DDP_GRAD_TOL, DDP_STATS_ATOL = 1e-10, 1e-9, 1e-12
DDP_NOISE = 1e-12  # a gradient this far below the model's largest is rounding noise


def _tree_diff(a, b, path="") -> list:
    """The paths at which two nested dicts of arrays differ (bit for bit)."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path} keys"]
        return [d for k in a for d in _tree_diff(a[k], b[k], f"{path}/{k}")]
    if a is None or b is None:
        return [] if a is b else [path]
    a, b = np.asarray(a), np.asarray(b)
    return [] if a.dtype == b.dtype and np.array_equal(a, b) else [path]


def state_snapshot(state) -> dict:
    """A train state's weights and BatchNorm statistics, EMA, optimizer
    moments and step, cloned on its device."""
    return {"model": {k: v.detach().clone() for k, v in state.model.state_dict().items()
                      if not k.endswith("num_batches_tracked")},
            "ema": {k: v.detach().clone() for k, v in state.ema.items()},
            "opt": {k: v.detach().clone()
                    for k, v in optim.moment_tensors(state.optimizer, state.model).items()},
            "step": state.step}


def snapshot_diff(a: dict, b: dict) -> list:
    """The entries at which two ``state_snapshot``s differ (bit for bit)."""
    out = [] if a["step"] == b["step"] else [f"step {a['step']} vs {b['step']}"]
    for part in ("model", "ema", "opt"):
        if set(a[part]) != set(b[part]):
            out.append(f"{part} keys")
            continue
        out += [f"{part}/{k}" for k in a[part] if not torch.equal(a[part][k], b[part][k])]
    return out


class StepCapture:
    """An ``on_train_start`` callback: at optimizer step ``at`` it keeps
    the state before the step (and the trainer's best fitness and start
    epoch), the batch and the state after; with ``feed`` (another
    capture's batch) the step takes that batch in place of the loader's."""

    def __init__(self, at: int, feed=None):
        self.at, self.feed, self.before = at, feed, None

    def __call__(self, trainer):
        step_of = trainer.train_step

        def train_step(step_fn, state, images, batch):
            if state.step != self.at or self.before is not None:
                return step_of(step_fn, state, images, batch)
            if self.feed is not None:
                images, batch = self.feed
            self.before, self.best = state_snapshot(state), trainer.best_fitness
            self.start_epoch = trainer.start_epoch
            self.batch = (images.clone(), {k: v.clone() for k, v in batch.items()})
            out = step_of(step_fn, state, images, batch)
            self.after = state_snapshot(state)
            return out

        trainer.train_step = train_step


def ddp_resume(card: str, data: dict, d: str, first: dict, over: dict):
    """(a)'s resume: the run without a group (``first``) resumed from its
    ``epoch1.ckpt`` into a fresh trainer in its directory, its first step
    fed the batch the uninterrupted run took there."""
    cap = first["capture"]
    again = StepCapture(cap.at, feed=cap.batch)
    m = YOLO(Path(d) / "nogroup" / "weights" / "epoch1.ckpt", device="cuda")
    m.add_callback("on_train_start", again)
    t = time.perf_counter()
    m.train(data=data, resume=True, epochs=over["epochs"], project=d, name="nogroup")
    wall = time.perf_counter() - t
    with open(m.trainer.csv) as fh:
        rows = list(csv.DictReader(fh))
    restored = snapshot_diff(again.before, cap.before)
    stepped = snapshot_diff(again.after, cap.after)
    same_batch = (torch.equal(again.batch[0], cap.batch[0])
                  and all(torch.equal(again.batch[1][k], v) for k, v in cap.batch[1].items()))
    carried = rows[:len(first["rows"])] == first["rows"] and [r["epoch"] for r in rows[len(
        first["rows"]):]] == [str(e) for e in range(1, over["epochs"])]
    n = sum(t.numel() for part in ("model", "ema", "opt") for t in cap.before[part].values())
    log("ddp", f"(a) resumed from epoch1.ckpt into a fresh trainer ({wall:.2f}s; start epoch "
        f"{again.start_epoch}, step {again.before['step']}, best fitness {again.best:.6f} vs "
        f"{cap.best:.6f} saved): restored weights, BatchNorm statistics, EMA and optimizer "
        f"moments ({n:,} numbers) differing in {len(restored)} tensors; the first resumed step on "
        f"the uninterrupted run's batch (equal {same_batch}) differs from that run's in "
        f"{len(stepped)} tensors (required 0, cuDNN deterministic); results.csv carries on "
        f"{carried} ({len(rows)} rows) | {card}")
    if (restored or stepped or not same_batch or not carried or again.best != cap.best
            or again.start_epoch != 1):
        raise AssertionError(f"ddp (a) resume: restored {restored[:5]}, stepped {stepped[:5]}, "
                             f"batch {same_batch}, csv {carried}, best {again.best} vs {cap.best}, "
                             f"start epoch {again.start_epoch}")


def ddp_one_card(card: str) -> dict:
    """(a) ``YOLO("yolov8n-seg.yaml").train`` on the seg160 floor set at its
    config for ``DDP_EPOCHS`` epochs (``save_period=1``), once with no
    process group and once inside a one-rank NCCL group (an all-reduce
    through it first): at world size 1 the trainer makes no collective, so
    the two runs' metrics, results.csv rows and stripped best.ckpt (weights
    and BatchNorm statistics) must be equal bit for bit (cuDNN
    deterministic for both); then ``ddp_resume`` of the run without a
    group. Returns the grouped run's launch counts."""
    ckpt = load_checkpoint(CKPT)
    over = {**{k: ckpt["train_args"][k] for k in FLOOR_TRAIN_KEYS}, "epochs": DDP_EPOCHS,
            "save_last_every": SAVE_LAST_EVERY, "save_period": 1}
    data = {"train": floor_train_set(), "val": floor_val_set(), "names": ckpt["names"]}
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        with tempfile.TemporaryDirectory() as d:
            def run(name, capture=None):
                zero_launch_counts()
                m = YOLO("yolov8n-seg.yaml", device="cuda")
                if capture is not None:
                    m.add_callback("on_train_start", capture)
                t = time.perf_counter()
                res = m.train(data=data, project=d, name=name, **over)
                wall = time.perf_counter() - t
                best = load_checkpoint(m.trainer.wdir / "best.ckpt")
                with open(m.trainer.csv) as fh:
                    rows = list(csv.DictReader(fh))
                return {"metrics": res, "rows": rows, "counts": launch_counts(), "wall": wall,
                        "capture": capture,
                        "best": {k: best[k] for k in ("params", "batch_stats", "ema_params",
                                                      "epoch", "step")}}

            # the first step of the second epoch (the steps of one, as the trainer counts)
            at = trainer_mod.schedule(len(data["train"][0]), over["batch"], over["nbs"], 1)[1]
            runs["none"] = run("nogroup", StepCapture(at))
            store = torch.distributed.FileStore(str(Path(d) / "store"), 1)
            torch.distributed.init_process_group("nccl", store=store, rank=0, world_size=1)
            try:
                probe = torch.arange(4.0, device="cuda")
                torch.distributed.all_reduce(probe)
                backend = torch.distributed.get_backend()
                if probe.tolist() != [0.0, 1.0, 2.0, 3.0] or parallel.world_size() != 1:
                    raise AssertionError(f"ddp: the one-rank NCCL group gave {probe.tolist()}")
                runs["nccl"] = run("nccl")
            finally:
                torch.distributed.destroy_process_group()
            a, b = runs["none"], runs["nccl"]
            metric_diff = [k for k in a["metrics"] if a["metrics"][k] != b["metrics"][k]]
            leaf_diff = _tree_diff(a["best"], b["best"])
            rows_same = a["rows"] == b["rows"]
            metrics = ", ".join(f"{k.split('/')[1]} {v:.4f}" for k, v in b["metrics"].items()
                                if k != "fitness")
            log("ddp", f"(a) yolov8n-seg on the seg160 floor set, {DDP_EPOCHS} epochs at its "
                f"config, with no group ({a['wall']:.2f}s) and in a one-rank {backend} group "
                f"({b['wall']:.2f}s): {metrics}; metrics differing {metric_diff}, results.csv "
                f"rows equal {rows_same}, best.ckpt leaves differing {len(leaf_diff)}; launches "
                f"{b['counts']} | {card}")
            if metric_diff or leaf_diff or not rows_same:
                raise AssertionError(f"ddp (a): the trainer in a one-rank group is not the "
                                     f"trainer: metrics {metric_diff}, leaves {leaf_diff[:5]}, "
                                     f"rows {rows_same}")
            zero_launch_counts()
            ddp_resume(card, data, d, a, over)
            resume_counts = launch_counts()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    if b["counts"]["gt_rays_rows"] == 0 or b["counts"]["fill_polygons"] == 0:
        raise AssertionError(f"ddp (a): a kernel of the path never launched: {b['counts']}")
    if resume_counts["gt_rays_rows"] == 0 or resume_counts["fill_polygons"] == 0:
        raise AssertionError(f"ddp (a) resume: a kernel of the path never launched: "
                             f"{resume_counts}")
    return {k: b["counts"][k] + resume_counts[k] for k in KERNEL_WRAPPERS}


def ddp_f64_steps(job: dict, device) -> dict:
    """``DDP_STEPS`` float64 steps of ``make_train_step`` (the loss math in
    float64 too) of the seg160 model on this rank's rows of ``job``'s batch
    (all of it without a group): each step's metrics; after the first the
    gradients and buffers; after the last the state dict; the GT-ray kernel's
    launches; the host clock (``time.time``) as it starts and ends."""
    t_enter = time.time()
    model = ckpt_model(load_checkpoint(job["ckpt"]), device).double()
    hyp = SimpleNamespace(**job["hyp"])
    opt = optim.build_optimizer(model, copy.copy(hyp), 10, 100)
    state = init_train_state(model, opt, device=device)
    step = make_train_step(model, opt, hyp, cand=hyp.cand_per_gt)
    r, world = parallel.rank(), parallel.world_size()
    images = parallel.rank_rows(torch.from_numpy(job["images"]).double(), r, world)
    batch = parallel.rank_rows({k: torch.from_numpy(v) for k, v in job["batch"].items()}, r,
                               world)
    n0 = gt_rays.gt_rays_rows_fast.launches
    out = {"metrics": []}
    t = time.perf_counter()
    for k in range(DDP_STEPS):
        m = step(state, images, batch)
        out["metrics"].append({n: float(v) for n, v in m.items()})
        if k == 0:
            out["grads"] = {n: p.grad.detach().cpu().clone()
                            for n, p in model.named_parameters() if p.grad is not None}
            out["buffers"] = {n: b.detach().cpu().clone() for n, b in model.named_buffers()}
    out["s"] = time.perf_counter() - t
    out["state"] = {n: v.detach().cpu().clone() for n, v in model.state_dict().items()}
    out["gt_rays_launches"] = gt_rays.gt_rays_rows_fast.launches - n0
    out["t_enter"], out["t_exit"] = t_enter, time.time()
    return out


def ddp_rank(r: int, device, job: dict) -> dict:
    """A rank of ``ddp_two_ranks`` (``parallel.launch``'s target)."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return ddp_f64_steps(job, device)


def ddp_job() -> dict:
    """The float64 step job of ``ddp_two_ranks``: the seg160 checkpoint, a
    batch of ``DDP_B`` at 160, its train_args with AdamW past warmup."""
    ckpt = load_checkpoint(CKPT)
    images, batch = shape_batch(DDP_B, 160, 8, seed=12)
    return {"ckpt": str(CKPT), "images": images, "batch": batch,
            "hyp": vars(train_hyp(ckpt, warmup_epochs=0.0, loss_dtype=torch.float64))}


def ddp_launch(job: dict) -> tuple:
    """Two gloo ranks on ``cuda:0`` (NCCL refuses two ranks on one card)
    running ``job``: their results, the launch's seconds and its start on
    the host clock."""
    t, t_wall = time.perf_counter(), time.time()
    ranks = parallel.launch(ddp_rank, ["cuda:0", "cuda:0"], args=(job,), timeout_s=600)
    return ranks, time.perf_counter() - t, t_wall


def ddp_two_ranks(card: str, job: dict, launched) -> int:
    """(b) Two gloo ranks on ``cuda:0``, each with its 4 rows of a batch of
    ``DDP_B`` at 160 (``launched``: ``ddp_launch``'s result), against one
    process on all 8, float64 (``ddp_f64_steps``; AdamW without warmup):
    the first step's loss and items within ``DDP_LOSS_RTOL``, every
    gradient within ``DDP_GRAD_TOL`` of its tensor's largest, the BatchNorm
    statistics within ``DDP_STATS_ATOL``; after ``DDP_STEPS`` steps the two
    ranks' states bit-identical. Returns the GT-ray kernel's launches in
    the ranks."""
    ranks, launch_s, t_wall = launched
    start_s = max(r["t_enter"] for r in ranks) - t_wall  # spawn, imports, CUDA, the group
    end_s = t_wall + launch_s - max(r["t_exit"] for r in ranks)  # results back, ranks gone
    one = ddp_f64_steps(job, torch.device("cuda"))
    r0, r1 = ranks
    want = one["metrics"][0]
    loss_rel = max(abs(r0["metrics"][0][k] - v) / max(abs(v), 1e-300) for k, v in want.items())
    same_report = r0["metrics"] == r1["metrics"]
    top = max(float(g.abs().max()) for g in one["grads"].values())
    grad_gap, worst = 0.0, ""
    for n, g in one["grads"].items():
        scale = float(g.abs().max())
        gap = (float((r0["grads"][n] - g).abs().max()) / max(scale, DDP_NOISE * top))
        if gap > grad_gap:
            grad_gap, worst = gap, n
    stats_gap = max(float((r0["buffers"][n].double() - b.double()).abs().max())
                    for n, b in one["buffers"].items() if n.endswith(("running_mean", "running_var")))
    ranks_same = all(torch.equal(v, r1["state"][n]) for n, v in r0["state"].items())
    launches = r0["gt_rays_launches"] + r1["gt_rays_launches"]
    log("ddp", f"(b) 2 gloo ranks sharing cuda:0 (launch and {DDP_STEPS} steps {launch_s:.2f}s: "
        f"until both ranks run {start_s:.2f}s, a rank's steps {r0['s']:.2f}s, from the last "
        f"rank's return to the launcher's {end_s:.2f}s) vs one process ({one['s']:.2f}s for "
        f"{DDP_STEPS} steps), "
        f"the seg160 model in float64 at 160 batch {DDP_B}: loss {r0['metrics'][0]['loss']:.12f} "
        f"vs {want['loss']:.12f}, items and loss max rel {loss_rel:.2e} (limit {DDP_LOSS_RTOL}); "
        f"gradients max {grad_gap:.2e} of their tensor's largest at {worst} (limit "
        f"{DDP_GRAD_TOL}); BatchNorm statistics max abs {stats_gap:.2e} (limit "
        f"{DDP_STATS_ATOL}); ranks report the same losses {same_report}; ranks' states "
        f"bit-identical after {DDP_STEPS} steps {ranks_same}; gt_rays_rows launches in the "
        f"ranks {r0['gt_rays_launches']} + {r1['gt_rays_launches']} | {card}")
    if (loss_rel > DDP_LOSS_RTOL or grad_gap > DDP_GRAD_TOL or stats_gap > DDP_STATS_ATOL
            or not same_report or not ranks_same or not r0["gt_rays_launches"]
            or not r1["gt_rays_launches"]):
        raise AssertionError(f"ddp (b): loss {loss_rel}, grads {grad_gap} ({worst}), stats "
                             f"{stats_gap}, same report {same_report}, same states {ranks_same}, "
                             f"launches {r0['gt_rays_launches']}, {r1['gt_rays_launches']}")
    return launches


def ddp_phase(card: str) -> dict:
    """The data-parallel trainer and step on the card: ``ddp_one_card`` and
    ``ddp_two_ranks``, (b)'s ranks launched first, so that they start up
    (spawn, imports, CUDA, the group: 18 s of the card's 40) while (a)
    runs. Returns the launch counts of (a)'s grouped run with (b)'s GT-ray
    launches added."""
    job = ddp_job()
    with ThreadPoolExecutor(1) as ex:
        launched = ex.submit(ddp_launch, job)
        counts = ddp_one_card(card)
        counts["gt_rays_rows"] += ddp_two_ranks(card, job, launched.result())
    return counts


def serve_mesh_phase(card: str) -> dict:
    """``InferenceServer(mesh=create_mesh(["cuda:0", "cuda:0"]))``: the fused
    seg160 weights replicated twice on the card, the 16 floor val frames in
    one batch of bucket 16 (two shards of 8, one a replica), against
    ``predict`` at batch 8 on the same weights: 0 px, 0 score difference,
    masks equal. Returns the launch counts of the served path (zeroed before
    ``infer``, read once the served masks are read)."""
    images, _ = floor_val_set()
    handle = YOLO(CKPT, device="cuda")
    mesh = parallel.create_mesh(["cuda:0", "cuda:0"])
    with InferenceServer(handle, imgsz=160, max_batch=16, buckets=[16], max_delay_ms=2000.0,
                         mesh=mesh) as srv:
        srv.warmup()
        zero_launch_counts()
        got = srv.infer(images, timeout=300.0)
        for r in got:
            r.masks  # noqa: B018 -- fills lazy masks, as a client reading them does
        counts = launch_counts()
        stats = srv.stats()
    want = handle.predict(images, imgsz=160, batch=8)
    err = served_vs_direct(got, want, "serve_mesh")
    log("serve_mesh", f"2 replicas on cuda:0 (buckets {srv.buckets}), {len(images)} frames at 160 "
        f"in batches {stats['batch_hist']}: {err['dets']} detections served = direct predict at "
        f"batch 8 (max {err['px']:.2e} px, scores {err['score']:.2e}, {err['mask_px']} differing "
        f"mask pixels; required 0), warm-up {srv.warmup_ms[16]:.1f} ms; launches of the served "
        f"path {counts} | {card}")
    if err["px"] or err["score"] or err["mask_px"] or stats["batch_hist"] != {16: 1}:
        raise AssertionError(f"serve_mesh: {err}, batches {stats['batch_hist']}")
    if counts["fill_polygons_cv2"] == 0:
        raise AssertionError(f"serve_mesh: the served masks launched no cv2 fill: {counts}")
    return counts


class SaveCheck:
    """(b) of the lifecycle phase: every checkpoint that a trainer's
    asynchronous saver writes in this run, against the checkpoint that a
    synchronous save builds from the same state.

    ``install`` wraps ``BaseTrainer._save`` on the training thread: before
    the saver takes its snapshot, the state's tensors
    (``trainer_mod.checkpoint_tensors``) are copied on the card into one
    flat buffer (``torch._foreach_copy_``), with the save's fields and the
    optimizer's ``optimizer_spec``; a thread of this check copies the buffer
    to shared memory (``utils/checkpoint.py:to_host``: pinned, on a side
    stream). It also wraps ``AsyncCheckpointSaver.submit`` and
    ``wait``: when a save's ``wait`` returns, its files are hard-linked
    aside, so that the next save cannot replace them unseen. A process of
    this check (``save_check_main``: the comparison's interpreter time stays
    off the training process; its jobs go through the copy thread alone, so
    a full pipe never blocks the training thread) builds the synchronous
    checkpoint from the copy (``trainer_mod.train_checkpoint``,
    what a save without ``async_save`` writes), compares it with the first
    file leaf for leaf (every key but the date) and the other paths of the
    save byte for byte with the first, and drops the links and the copy.
    ``finish`` waits for the last and gives, by trainer, the saves, the
    files verified, the training thread's seconds in ``_save`` and the
    worker's seconds (``saver.write_s``); it raises on any difference, a
    save not verified or the process failing."""

    def __init__(self, root: Path):
        self.root = root
        self.written, self.saves, self.copy_errors = 0, 0, []
        self.pinned: dict = {}  # to_host's buffer
        self.by_trainer: dict = {}
        self.free: dict = {}  # flat device buffers and their views by layout, reused
        self.copies: "queue.Queue" = queue.Queue()
        self.child = None
        self.copier = threading.Thread(target=self._copy_all, daemon=True, name="save-check-copy")

    def install(self):
        self.root.mkdir(parents=True, exist_ok=True)
        # a fresh interpreter reading pickled jobs on its stdin (multiprocessing's
        # spawn would import this run's main module again)
        self.child = subprocess.Popen([sys.executable, "-c", "import chip_smoke; "
                                       "chip_smoke.save_check_main()"], cwd=ROOT,
                                      stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self.copier.start()
        saver = ckpt_mod.AsyncCheckpointSaver
        self._save, self._submit, self._wait = (trainer_mod.BaseTrainer._save, saver.submit,
                                                saver.wait)
        check = self

        def _save(trainer, state, epoch, fitness):
            label = f"{trainer.task} {trainer.save_dir.name} ({id(trainer):x})"
            rec = check.by_trainer.setdefault(label, {"saves": 0, "verified": 0, "submit_s": 0.0,
                                                      "trainer": trainer})
            check.copies.put((check.saves, label, check._reference(trainer, state, epoch)))
            check.saves += 1
            t = time.perf_counter()
            check._save(trainer, state, epoch, fitness)
            rec["submit_s"] += time.perf_counter() - t
            rec["saves"] += 1

        def submit(saver, paths, *args):
            check._submit(saver, paths, *args)  # waits for the save before it first
            saver._check_paths = [Path(p) for p in paths]

        def wait(saver):
            check._wait(saver)  # raises if the save failed
            paths = saver.__dict__.pop("_check_paths", None)
            if paths is not None:
                n, check.written = check.written, check.written + 1
                links = []
                for i, path in enumerate(paths):
                    links.append(str(check.root / f"{n}_{i}.ckpt"))
                    os.link(path, links[-1])
                check.copies.put(("files", n, links))  # the copy thread sends it on

        trainer_mod.BaseTrainer._save = _save
        saver.submit, saver.wait = submit, wait

    def _reference(self, trainer, state, epoch) -> dict:
        """The state's tensors copied into a flat buffer on the card (16-byte
        aligned), with what ``train_checkpoint`` needs besides them."""
        tensors = trainer_mod.checkpoint_tensors(state)
        layout, offset = [], 0
        for g, d in tensors.items():
            for k, t in d.items():
                layout.append((g, k, str(t.dtype).split(".")[1], tuple(t.shape), offset,
                               t.element_size() * t.numel()))
                offset += -(-layout[-1][5] // 16) * 16
        key = tuple(layout)
        pool = self.free.setdefault(key, [])
        srcs = [t.detach() for d in tensors.values() for t in d.values()]
        if pool:
            flat, views = pool.pop()
        else:
            flat = torch.empty(max(offset, 16), dtype=torch.uint8, device=state.device)
            views = [flat[o:o + n].view(t.dtype).view(t.shape) for (_, _, _, _, o, n), t
                     in zip(layout, srcs)]
        torch._foreach_copy_(views, srcs)
        event = torch.cuda.Event()
        event.record()
        return {"flat": (key, flat, views), "event": event, "layout": layout,
                "spec": optim.optimizer_spec(state.optimizer, state.step),
                "meta": trainer.save_meta(state, epoch)}

    def _copy_all(self):
        """The copy thread: each reference to a shared-memory segment, then
        to the process."""
        from multiprocessing import resource_tracker, shared_memory
        while True:
            job = self.copies.get()
            if job is None:
                self.send(None)
                return
            if job[0] == "files":  # only this thread writes to the process: a full pipe
                self.send(job)     # blocks it, never the training thread
                continue
            n, label, ref = job
            try:
                key, flat, views = ref.pop("flat")
                shm = shared_memory.SharedMemory(create=True, size=flat.numel())
                resource_tracker.unregister(shm._name, "shared_memory")  # the process unlinks it
                host = torch.frombuffer(shm.buf, dtype=torch.uint8)
                host.copy_(ckpt_mod.to_host(flat, ref.pop("event"), self.pinned))
                del host  # the segment's buffer is no longer exported
                self.free[key].append((flat, views))
                self.send(("reference", n, label, shm.name, ref))
                shm.close()  # the process unlinks it
            except Exception as e:  # reported by finish
                self.copy_errors.append(f"{label} save {n}: {type(e).__name__}: {e}")

    def send(self, job):
        pickle.dump(job, self.child.stdin, protocol=pickle.HIGHEST_PROTOCOL)
        self.child.stdin.flush()

    def finish(self) -> dict:
        self.copies.put(None)
        self.copier.join()
        trainer_mod.BaseTrainer._save = self._save
        ckpt_mod.AsyncCheckpointSaver.submit = self._submit
        ckpt_mod.AsyncCheckpointSaver.wait = self._wait
        errors = list(self.copy_errors)
        self.child.stdin.close()
        while True:  # every result, until the process ends
            try:
                n, label, diff = pickle.load(self.child.stdout)
            except EOFError:
                break
            if diff:
                errors.append(f"{label} save {n}: {diff}")
            else:
                self.by_trainer[label]["verified"] += 1
        if self.child.wait(timeout=60) != 0:
            errors.append(f"the checking process exited with {self.child.returncode}")
        out = {}
        for label, rec in self.by_trainer.items():
            t = rec.pop("trainer")
            out[label] = {**rec, "save_s": sum(e.get("save_s", 0.0) for e in t.epoch_times),
                          "write_s": sum(t.saver.write_s) if t.saver is not None else 0.0}
        verified = sum(r["verified"] for r in out.values())
        if errors or verified != self.saves or self.written != self.saves:
            raise AssertionError(f"lifecycle (b): {self.saves} saves, {self.written} written, "
                                 f"{verified} verified; {errors[:5]}")
        return out


def _reference_checkpoint(shm, ref: dict) -> dict:
    """The synchronous save's checkpoint of a reference in shared memory
    (its leaves are copies: the segment can close after)."""
    tensors: dict = {}
    for g, k, dtype, shape, off, nbytes in ref["layout"]:
        a = np.frombuffer(shm.buf, dtype=np.uint8, count=nbytes, offset=off)
        tensors.setdefault(g, {})[k] = torch.from_numpy(a.view(np.dtype(dtype)).reshape(shape))
    return trainer_mod.train_checkpoint(tensors, ref["spec"], ref["meta"])


def save_check_main():
    """``SaveCheck``'s process: pairs each save's reference (a shared-memory
    copy of its tensors) with its files, builds the synchronous checkpoint
    from the reference and compares (see ``SaveCheck``); jobs are read
    pickled from stdin, results written pickled to stdout."""
    from multiprocessing import shared_memory
    jobs, results = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr
    torch.set_num_threads(1)
    refs, files = {}, {}
    while True:
        try:
            job = pickle.load(jobs)
        except EOFError:
            break
        if job is None:
            break
        if job[0] == "reference":
            refs[job[1]] = job[2:]
        else:
            files[job[1]] = job[2]
        for n in sorted(set(refs) & set(files)):
            (label, shm_name, ref), links = refs.pop(n), files.pop(n)
            shm = shared_memory.SharedMemory(name=shm_name)
            try:
                want = _reference_checkpoint(shm, ref)
                got = load_checkpoint(links[0])
                diff = [k for k in sorted(set(want) | set(got)) if k != "date"
                        and not _same_leaves(want.get(k), got.get(k))]
                first = Path(links[0]).read_bytes()
                diff += [Path(x).name for x in links[1:] if Path(x).read_bytes() != first]
            except Exception as e:
                diff = [f"{type(e).__name__}: {e}"]
            finally:
                shm.close()
                shm.unlink()
                for x in links:
                    os.unlink(x)
            pickle.dump((n, label, diff), results)
            results.flush()


def _same_leaves(a, b) -> bool:
    """Two checkpoint values equal leaf for leaf: the same nesting (dicts,
    tuples and the optax classes by name), arrays equal with their dtype and
    shape, anything else by ``==``."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and set(a) == set(b)
                and all(_same_leaves(a[k], b[k]) for k in a))
    if isinstance(a, tuple) or isinstance(b, tuple):
        return (isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b)
                and type(a).__name__ == type(b).__name__
                and all(_same_leaves(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return a == b


def save_lines(saves: dict, card: str):
    """(b)'s lines: by trainer, the saves verified and their seconds."""
    for label, r in saves.items():
        log("lifecycle", f"(b) {label}: {r['saves']} asynchronous saves, {r['verified']} "
            f"verified leaf for leaf against a synchronous save of the same state; save_s "
            f"{r['save_s']:.3f} (training thread: snapshot and submit, {r['submit_s']:.3f} in "
            f"_save), worker {r['write_s']:.3f} s (name map, pickle, writes) | {card}")
    log("lifecycle", f"(b) {sum(r['saves'] for r in saves.values())} checkpoints over "
        f"{len(saves)} trainer runs, every one equal to its synchronous save; save_s summed "
        f"{sum(r['save_s'] for r in saves.values()):.2f} s on the training threads, "
        f"{sum(r['write_s'] for r in saves.values()):.2f} s on the workers | {card}")


# the lifecycle phase's optimizers (the five the port adds), their updates
LIFECYCLE_OPTIMIZERS = ("Adam", "NAdam", "RAdam", "Adamax", "RMSProp")
LIFECYCLE_STEPS, LIFECYCLE_B = 5, 4
# each parameter after an update, card against the CPU fed the same float64
# gradients: of the tensor's largest entry
LIFECYCLE_PARAM_RTOL = 1e-12


def optimizers_card_vs_cpu(card: str) -> dict:
    """(c) Each of ``LIFECYCLE_OPTIMIZERS`` (the seg160 checkpoint's
    train_args, warmup included) takes ``LIFECYCLE_STEPS`` float64 train
    steps of the seg160 model at 160 batch 4 on the card; the first step's
    loss and gradients are held against the CPU's at the train-step limits
    (the same for every optimizer: the same weights), and after every update
    each parameter against the same optimizer on the CPU fed the card's
    gradients (``LIFECYCLE_PARAM_RTOL``). Returns the card's launch
    counts."""
    ckpt = load_checkpoint(CKPT)
    images, batch = shape_batch(LIFECYCLE_B, 160, 8, seed=21)
    hyp = train_hyp(ckpt, loss_dtype=torch.float64)
    cpu = ckpt_model(ckpt, "cpu").double()
    x, bt = to_device(images, batch, "cpu")
    total, _ = loss_and_assign(cpu, cpu(x.double().permute(0, 3, 1, 2).contiguous()), bt, hyp)
    total.backward()
    cpu_grads = {n: p.grad.clone() for n, p in cpu.named_parameters()}
    init = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    zero_launch_counts()
    out = {}
    t0 = time.perf_counter()
    for name in LIFECYCLE_OPTIMIZERS:
        h = copy.copy(hyp)
        h.optimizer = name
        model = ckpt_model(ckpt, "cuda").double()
        opt = optim.build_optimizer(model, copy.copy(h), 10, 100)
        state = init_train_state(model, opt, device="cuda")
        step = make_train_step(model, opt, h, cand=h.cand_per_gt)
        grads = []
        step_of = opt.step

        def keep_then_step(k, step_of=step_of, model=model, grads=grads):
            grads.append({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()})
            step_of(k)

        opt.step = keep_then_step
        xc, bc = to_device(images, batch, "cuda")
        losses = [float(step(state, xc.double(), bc)["loss"]) for _ in range(LIFECYCLE_STEPS)]
        ref = copy.deepcopy(cpu)
        with torch.no_grad():
            for n, p in ref.named_parameters():
                p.copy_(init[n])
        ref_opt = optim.build_optimizer(ref, copy.copy(h), 10, 100)
        card_params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        worst = 0.0
        for k, g in enumerate(grads):
            for n, p in ref.named_parameters():
                p.grad = g[n].clone()
            ref_opt.step(k)
        for n, p in ref.named_parameters():
            p = p.detach()
            worst = max(worst, float((card_params[n] - p).abs().max()
                                     / p.abs().max().clamp_min(1e-300)))
        grad0 = max(float((grads[0][n] - g).abs().max() / g.abs().max().clamp_min(1e-300))
                    for n, g in cpu_grads.items())
        loss0 = abs(losses[0] - float(total)) / abs(float(total))
        moved = max(float((card_params[n] - init[n]).abs().max()) for n in init)
        out[name] = {"loss0_rel": loss0, "grad0": grad0, "param": worst, "losses": losses,
                     "moved": moved}
        if loss0 > TRAIN_LOSS_RTOL or grad0 > TRAIN_GRAD_TOL or worst > LIFECYCLE_PARAM_RTOL \
                or not moved or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"lifecycle (c) {name}: {out[name]}")
    counts = launch_counts()
    for name, r in out.items():
        log("lifecycle", f"(c) {name}, {LIFECYCLE_STEPS} float64 updates of the seg160 model at "
            f"160 batch {LIFECYCLE_B} on the card: first loss {r['losses'][0]:.9f} vs the CPU's "
            f"(rel {r['loss0_rel']:.2e}, limit {TRAIN_LOSS_RTOL}), first gradients "
            f"{r['grad0']:.2e} of their tensor's largest (limit {TRAIN_GRAD_TOL}); after the "
            f"updates every parameter within {r['param']:.2e} of its largest (limit "
            f"{LIFECYCLE_PARAM_RTOL}) of the CPU optimizer's on the card's gradients; the "
            f"largest move {r['moved']:.3e}; losses {', '.join(f'{v:.6f}' for v in r['losses'])} "
            f"| {card}")
    log("lifecycle", f"(c) {time.perf_counter() - t0:.2f}s for the five on the card; launches "
        f"{counts} | {card}")
    return counts


def start_version_cli() -> tuple:
    """``python -m yolo_contour_regression_tpu_torch version`` started in
    the background (a fresh interpreter importing torch and the port takes
    seconds; ``main`` starts it beside the kernels' build) and its start
    time, for ``facade_and_cli`` to wait for."""
    proc = subprocess.Popen([sys.executable, "-m", "yolo_contour_regression_tpu_torch",
                             "version"], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def facade_and_cli(card: str, data_yaml: Path, version_cli: tuple = None) -> dict:
    """(d) ``YOLO(seg160).fuse().save(p)``, then ``YOLO(p)`` predicts the
    16 floor frames bit-identically to the fused model; ``entrypoint([
    "segment", "val", ...])`` on the datasets phase's yaml prints
    ``YOLO(seg160).val``'s metrics exactly; ``python -m
    yolo_contour_regression_tpu_torch version`` (``start_version_cli``'s,
    or started here) exits 0 with the version. Returns the launch counts of
    the CLI's validation."""
    images, _ = floor_val_set()
    fused = YOLO(CKPT, device="cuda").fuse()
    want = fused.predict(images, imgsz=160, batch=8)
    with tempfile.TemporaryDirectory() as d:
        path = fused.save(Path(d) / "fused.ckpt")
        back = YOLO(path, device="cuda")
        got = back.predict(images, imgsz=160, batch=8)
        deploy = load_checkpoint(path)["deploy"]
    err = served_vs_direct(got, want, "lifecycle (d)")
    facade_val = YOLO(CKPT, device="cuda").val(data=str(data_yaml), imgsz=160, batch=4)
    out = io.StringIO()
    zero_launch_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = entrypoint(["segment", "val", f"model={CKPT}", f"data={data_yaml}", "imgsz=160",
                         "batch=4"])
    cli_s = time.perf_counter() - t
    counts = launch_counts()
    cli_val = ast.literal_eval(out.getvalue().strip().splitlines()[-1])
    proc, t = version_cli or start_version_cli()
    try:
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        proc.kill()
    res = SimpleNamespace(returncode=proc.returncode, stdout=stdout, stderr=stderr)
    module_s = time.perf_counter() - t
    from yolo_contour_regression_tpu_torch import __version__
    log("lifecycle", f"(d) YOLO(seg160).fuse().save(p) (deploy {deploy!r}), YOLO(p).predict on "
        f"the {len(images)} floor frames: {err['dets']} detections, max {err['px']:.2e} px, "
        f"scores {err['score']:.2e}, {err['mask_px']} differing mask pixels against the fused "
        f"model (required 0); yolo segment val on the datasets yaml ({cli_s:.2f}s, exit {rc}): "
        f"mask {cli_val['metrics/mAP50-95(M)']:.4f}, box {cli_val['metrics/mAP50-95(B)']:.4f}, "
        f"equal to YOLO.val {cli_val == facade_val}; python -m yolo_contour_regression_tpu_torch "
        f"version: exit {res.returncode}, {res.stdout.strip()!r} ({module_s:.2f}s from its start, "
        f"beside the other phases); launches "
        f"{counts} | {card}")
    if err["px"] or err["score"] or err["mask_px"] or deploy != "fused":
        raise AssertionError(f"lifecycle (d): the saved fused model predicts otherwise: {err}")
    if rc != 0 or cli_val != facade_val:
        raise AssertionError(f"lifecycle (d): yolo segment val {cli_val} (exit {rc}) vs "
                             f"{facade_val}")
    if res.returncode != 0 or res.stdout.strip() != __version__:
        raise AssertionError(f"lifecycle (d): python -m ... version: {res.returncode} "
                             f"{res.stdout!r} {res.stderr[-500:]}")
    if counts["fill_polygons"] == 0:
        raise AssertionError(f"lifecycle (d): the CLI's validation launched no fill: {counts}")
    return counts


def tune_phase(card: str) -> dict:
    """(e) ``YOLO("yolov8n-seg.yaml").tune(data, iterations=2, epochs=1)``
    at the seg160 floor config on its floor set: two trainings (the middle
    of the search space, then a mutation), each with a finite fitness.
    Returns their launch counts."""
    ckpt = load_checkpoint(CKPT)
    over = {k: ckpt["train_args"][k] for k in FLOOR_TRAIN_KEYS if k != "epochs"}
    data = {"train": floor_train_set(), "val": floor_val_set(), "names": ckpt["names"]}
    with tempfile.TemporaryDirectory() as d:
        m = YOLO("yolov8n-seg.yaml", device="cuda")
        zero_launch_counts()
        t = time.perf_counter()
        hyp, fit = m.tune(data, iterations=2, epochs=1, project=d, **over)
        wall = time.perf_counter() - t
        counts = launch_counts()
        runs = sorted(p.name for p in Path(d).iterdir())
    log("lifecycle", f"(e) tune(iterations=2, epochs=1) at the seg160 config ({wall:.2f}s): "
        f"best fitness {fit:.6f}, runs {runs}, best lr0 {hyp['lr0']:.6f}, mosaic "
        f"{hyp['mosaic']:.4f}, copy_paste {hyp['copy_paste']:.4f}; launches {counts} | {card}")
    if not math.isfinite(fit) or fit < 0 or len(runs) != 2 or set(hyp) != set(tuner.SPACE):
        raise AssertionError(f"lifecycle (e): fitness {fit}, runs {runs}")
    if counts["gt_rays_rows"] == 0 or counts["fill_polygons"] == 0:
        raise AssertionError(f"lifecycle (e): a kernel of the path never launched: {counts}")
    return counts


def lifecycle_phase(card: str, data_yaml: Path, version_cli: tuple = None) -> dict:
    """(c), (d) and (e) of the lifecycle phase ((a) runs in ``ddp``, (b)
    throughout). Returns their launch counts, summed."""
    parts = [optimizers_card_vs_cpu(card), facade_and_cli(card, data_yaml, version_cli),
             tune_phase(card)]
    return {k: sum(c[k] for c in parts) for k in KERNEL_WRAPPERS}


def png_bytes(img: np.ndarray) -> bytes:
    """An HWC uint8 BGR image as an 8-bit RGB PNG (filter 0 on every row,
    ``zlib`` level 6): the smoke writes its datasets with this; the port
    has no image encoder."""
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img[..., ::-1]).reshape(h, w * 3)], 1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(tag + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def datasets_phase(card: str, d: Path) -> tuple:
    """Datasets on disk, under ``d``: the seg160 floor val set written as
    PNG files with its label files and a yaml, ``YOLO(seg160).val(data=
    yaml)`` against ``val`` of the same images in memory; the classify
    floor val set as PNG files in class folders, ``YOLO(floor_classify)
    .val(data=root)`` against the in-memory ``val``: the metrics equal
    exactly. Returns the launch counts of the seg yaml validation and the
    yaml's path (the lifecycle phase's CLI reads it)."""
    images, labels = floor_val_set()
    with np.load(FLOOR_VAL) as z:
        texts = [str(t) for t in z["labels"]]
    cls_images, cls_labels = floor_cls_set(FLOOR_CLS_VAL)
    root = Path(d) / "seg160"
    for sub in ("images/val", "labels/val"):
        (root / sub).mkdir(parents=True)
    t = time.perf_counter()
    for i, (img, text) in enumerate(zip(images, texts)):
        (root / "images" / "val" / f"{i:04d}.png").write_bytes(png_bytes(img))
        (root / "labels" / "val" / f"{i:04d}.txt").write_text(text)
    yaml = root / "data.yaml"
    yaml.write_text(f"path: {root}\ntrain: images/val\nval: images/val\n"
                    f"names:\n  0: circle\n  1: rect\n")
    cls_root = Path(d) / "classify"
    cls_names = load_checkpoint(CLS_CKPT)["names"]
    if sorted(cls_names.values()) != [cls_names[i] for i in sorted(cls_names)]:
        raise AssertionError(f"datasets: class folders would not sort as {cls_names}")
    for i, (img, c) in enumerate(zip(cls_images, cls_labels)):
        folder = cls_root / cls_names[int(c)]
        folder.mkdir(parents=True, exist_ok=True)
        (folder / f"{i:04d}.png").write_bytes(png_bytes(img))
    write_s = time.perf_counter() - t
    decoded = all(np.array_equal(imread(p), img) for p, img in zip(
        sorted((root / "images" / "val").iterdir()), images))
    seg = YOLO(CKPT, device="cuda")
    mem = seg.val(images, labels, imgsz=160, batch=4)
    zero_launch_counts()
    t = time.perf_counter()
    disk = seg.val(data=str(yaml), imgsz=160, batch=4)
    disk_s = time.perf_counter() - t
    counts = launch_counts()
    cls = YOLO(CLS_CKPT, device="cuda")
    cls_mem = cls.val(cls_images, cls_labels, imgsz=64)
    cls_disk = cls.val(data=str(cls_root), imgsz=64)
    seg_same, cls_same = disk == mem, cls_disk == cls_mem
    log("datasets", f"{len(images)} seg160 and {len(cls_images)} classify val frames written as "
        f"PNG with their label files ({write_s:.2f}s), decoded back byte-equal {decoded}; "
        f"YOLO(seg160).val(data=yaml) {disk_s:.2f}s: mask mAP50-95 "
        f"{disk['metrics/mAP50-95(M)']:.4f}, box {disk['metrics/mAP50-95(B)']:.4f}, equal to the "
        f"in-memory val {seg_same}; classify val(data=folder) top-1 "
        f"{cls_disk['metrics/accuracy_top1']:.5f}, equal {cls_same}; launches {counts} | {card}")
    if not (decoded and seg_same and cls_same):
        raise AssertionError(f"datasets: decoded {decoded}; seg {disk} vs {mem}; classify "
                             f"{cls_disk} vs {cls_mem}")
    if counts["fill_polygons"] == 0:
        raise AssertionError(f"datasets: the yaml validation launched no fill: {counts}")
    return counts, yaml


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run needs one card")
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")

    # 2. build: one nvcc per source, all started together (and the lifecycle
    # phase's `python -m ... version`, a fresh interpreter, beside them)
    phase_start = {"build": time.perf_counter()}
    version_cli = start_version_cli()
    t = time.perf_counter()

    def build(name):
        t0 = time.perf_counter()
        return cuda_build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        futures = {name: ex.submit(build, name) for name in KERNEL_SOURCES}
        built = {name: f.result() for name, f in futures.items()}
    for name, (lib, secs) in built.items():
        log("build", f"{name}.cu -> {lib.relative_to(ROOT)} in {secs:.2f}s | {card}")
    log("build", f"all in {time.perf_counter() - t:.2f}s (nvcc {' '.join(cuda_build.NVCC_FLAGS)}) "
        f"| {card}")

    # every checkpoint that the trainers' savers write, held to a synchronous save
    # (the lifecycle phase's (b)), from here to the report
    check_dir = tempfile.TemporaryDirectory()
    save_check = SaveCheck(Path(check_dir.name) / "links")
    save_check.install()

    # 3. kernels against their plain versions
    phase_start["kernels"] = time.perf_counter()
    fill_rows = {
        "fill_polygons": check_fill("fill_polygons", "raster_fill_polygons", raster.fill_polygons,
                                    raster.fill_polygons_plain, "even_odd", 1, card,
                                    hw=VAL_GRID_HW),
        "fill_polygons_480x640": check_fill("fill_polygons", "raster_fill_polygons",
                                            raster.fill_polygons, raster.fill_polygons_plain,
                                            "even_odd", 1, card),
        "fill_polygons_cv2": check_fill("fill_polygons_cv2", "raster_fill_polygons_cv2",
                                        raster.fill_polygons_cv2, raster.fill_polygons_cv2_plain,
                                        "cv2", 2, card),
    }
    segori_fill = {n: check_fill("fill_polygons", "raster_fill_polygons", raster.fill_polygons,
                                 raster.fill_polygons_plain, "even_odd", 1, card,
                                 hw=SEGORI_PROTO_HW, inputs=segori_fill_inputs(n))
                   for n in SEGORI_FILL_N}
    rows_checks = {}
    for n_pad, k in RAY_SHAPES:
        r = TRAIN_B * n_pad
        rows_checks[n_pad] = check_gt_rays("rows", *ray_inputs(r, k, seed=k), card,
                                       f"R={r} (batch {TRAIN_B} x N_pad {n_pad}) K={k}")
    contours, c, rad = ray_contours(RAY_PAIRS, seed=5)
    centers = (c + np.random.default_rng(5).uniform(-1.5, 1.5, (RAY_PAIRS, 2)) * rad[:, None])
    pairs_check = check_gt_rays("pairs", contours, centers.astype(np.float32), None, card,
                                f"P={RAY_PAIRS}")
    check_ray_scenes(card)
    phase_inputs = {f"R={TRAIN_B * n_pad} K={k}": ("rows", *(
        torch.from_numpy(a).cuda() for a in ray_inputs(TRAIN_B * n_pad, k, seed=k)))
        for n_pad, k in RAY_SHAPES}
    phase_inputs[f"P={RAY_PAIRS}"] = ("pairs", torch.from_numpy(contours).cuda(),
                                      torch.from_numpy(centers.astype(np.float32)).cuda(), None)
    gt_rays_phases(phase_inputs, card)
    atan2f_instr = gt_rays_sass(built["gt_rays"][0], card)
    atan2f_floor(rows_checks[TRAIN_NPAD], "rows", atan2f_instr, card)
    atan2f_floor(pairs_check, "pairs", atan2f_instr, card)

    # 4. the main path: predict on the card
    phase_start["predict"] = time.perf_counter()
    model = YOLO(CKPT, device="cuda")
    imgs160 = shape_images(4, 120, 200, seed=1)
    imgs640 = shape_images(8, *RASTER_HW, seed=2)
    zero_launch_counts()
    res160 = model.predict(imgs160, imgsz=160)
    n_det = sum(len(r) for r in res160)
    n_px = sum(int(r.masks.data.sum()) for r in res160)
    if n_det == 0 or n_px == 0:
        raise AssertionError(f"imgsz 160: {n_det} detections, {n_px} mask pixels")
    res640 = model.predict(imgs640, imgsz=640, batch=8)
    n_det640 = sum(len(r) for r in res640)
    n_px640 = sum(int(r.masks.data.sum()) for r in res640)

    lat = {}
    for imgsz, images, batch in ((160, imgs160[:1], 1), (640, imgs640, 8)):
        predict_ms(model, images, imgsz, batch, masks=True)  # warm-up
        runs = [predict_ms(model, images, imgsz, batch, masks=True) for _ in range(10)]
        lat[imgsz] = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    predict_counts = launch_counts()
    if predict_counts["fill_polygons_cv2"] == 0:
        raise AssertionError("the predict path never launched the cv2 fill kernel")
    log("predict", f"imgsz 160: {n_det} detections, {n_px} mask pixels over {len(res160)} "
        f"images; imgsz 640 batch 8: {n_det640} detections, {n_px640} mask pixels; "
        f"launches {predict_counts} | {card}")
    for imgsz, batch in ((160, 1), (640, 8)):
        parts = ", ".join(f"{k} {v:.3f}" for k, v in lat[imgsz].items())
        log("predict", f"imgsz {imgsz} batch {batch}, ms per image (host clock, median of 10 "
            f"calls): {parts} | {card}")
    split = mask_breakdown(res640)
    parts = ", ".join(f"{k} {v:.4f}" for k, v in split.items())
    log("predict", f"imgsz 640 batch 8, masks split, ms per image ({n_det640 / len(res640):.1f} "
        f"polygons of {RASTER_HW[0]}x{RASTER_HW[1]} each; median of 5 passes): {parts} | {card}")

    # the card against the port on the CPU, from the same letterboxed input
    cpu = YOLO(CKPT, device="cpu")
    card_vs_cpu_predict(model, cpu, imgs160, 160, "predict", card)

    # 5. the main path: validate on the card
    phase_start["validate"] = time.perf_counter()
    _, val_counts = validate_floor(model, cpu, card)
    _, val640_counts, _, _ = validate_full_width(model, card)
    validate_counts = {k: val_counts[k] + val640_counts[k] for k in KERNEL_WRAPPERS}

    # 6. the main path: the train step on the card
    phase_start["train"] = time.perf_counter()
    ckpt = load_checkpoint(CKPT)
    train_card_vs_cpu(ckpt, card)
    state, train_counts, _, _ = train_full_width(ckpt, card)
    save_and_predict(ckpt, state, imgs160, card)

    # 7. the main path: the trainer, from scratch to the seg160 floor, then at 640
    phase_start["trainer"] = time.perf_counter()
    floor_counts = train_floor(card)
    t640_counts = train_640(card)
    trainer_counts = {k: floor_counts[k] + t640_counts[k] for k in KERNEL_WRAPPERS}

    # 8. the deploy form: both floor checkpoints fused on the card
    phase_start["fuse"] = time.perf_counter()
    fuse_runs = [fuse_check(task, card) for task in ("segment", "detect", "pose")]
    fuse_counts = {k: sum(c[k] for c in fuse_runs) for k in KERNEL_WRAPPERS}

    # 9-12. the detect task: predict, validate, the train step, the trainer
    phase_start["detect_predict"] = time.perf_counter()
    detect = detect_predict(card)
    phase_start["detect_validate"] = time.perf_counter()
    validate_floor_jax(detect, card, "detect")
    validate_full_width(detect, card, phase="detect_validate")
    phase_start["detect_train"] = time.perf_counter()
    detect_ckpt = load_checkpoint(DETECT_CKPT)
    train_card_vs_cpu(detect_ckpt, card, imgsz=DETECT_IMGSZ, phase="detect_train")
    train_full_width(detect_ckpt, card, phase="detect_train")
    phase_start["detect_trainer"] = time.perf_counter()
    train_floor(card, "detect")

    # 13-16. the pose task: predict, validate, the train step, the trainer
    # (no kernel of its own: each run's launch counts are printed, all 0)
    phase_start["pose_predict"] = time.perf_counter()
    pose, pose17 = pose_predict(card)
    phase_start["pose_validate"] = time.perf_counter()
    validate_floor_jax(pose, card, "pose")
    validate_full_width(pose17, card, phase="pose_validate")
    phase_start["pose_train"] = time.perf_counter()
    pose_ckpt = load_checkpoint(POSE_CKPT)
    train_card_vs_cpu(pose_ckpt, card, imgsz=POSE_IMGSZ, phase="pose_train")
    train_full_width(pose_ckpt, card, phase="pose_train", model=pose17.model)
    phase_start["pose_trainer"] = time.perf_counter()
    train_floor(card, "pose")

    # 17-20. the segment_ori task: predict, validate, the train step, the
    # trainer and the fuse; its loss and validator fill the GT masks with
    # the even-odd kernel
    phase_start["segori_predict"] = time.perf_counter()
    segori, segori_predict_counts = segori_predict(card)
    phase_start["segori_validate"] = time.perf_counter()
    _, segori_val_counts, _, _ = validate_full_width(segori, card, phase="segori_validate")
    phase_start["segori_train"] = time.perf_counter()
    train_card_vs_cpu(ckpt, card, imgsz=F64_STEP_IMGSZ, phase="segori_train", b=SEGORI_F64_B,
                      model=segori.model, dtype=torch.float64)
    _, segori_step_counts, _, _ = train_full_width(ckpt, card, phase="segori_train",
                                                   model=segori.model)
    phase_start["segori_trainer"] = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        segori_best = Path(d) / "segori_best.ckpt"
        segori_trainer_counts = train_floor(card, "segment_ori", keep=segori_best)
        segori_card_vs_cpu(segori_best, card)
        segori_fuse_counts = fuse_check("segment_ori", card, ckpt_path=segori_best)

    # 21. the classify task: validate, predict, fuse, the trainer
    phase_start["classify"] = time.perf_counter()
    classify_counts = classify_phases(card)

    # 22-25. RT-DETR: predict, validate, the train step and the fuse (no
    # kernel: each phase's launch counts are printed, all 0)
    phase_start["rtdetr"] = time.perf_counter()
    rtdetr_counts = rtdetr_phases(card)

    # 26-28. the host train chain (a seg trainer on it launches both
    # kernels), the RT-DETR trainer to its floor, and rtdetr-l
    phase_start["host_pipeline"] = time.perf_counter()
    host_counts = host_pipeline(card)
    phase_start["rtdetr_trainer"] = time.perf_counter()
    rtdetr_counts["trainer"] = rtdetr_trainer(card)
    phase_start["rtdetr_l"] = time.perf_counter()
    rtdetr_counts["rtdetr-l"] = rtdetr_l(card)

    # 29-34. SAM (ViT-B), MobileSAM, everything mode, FastSAM (its masks and
    # prompts on both fill kernels), YOLO-NAS and its trainer
    phase_start["sam"] = time.perf_counter()
    sam_b = sam_phase(card, "sam_b")
    phase_start["mobile_sam"] = time.perf_counter()
    sam_phase(card, "mobile_sam")
    phase_start["sam_generate"] = time.perf_counter()
    sam_generate(card, *sam_b.pop("models"))
    phase_start["fastsam"] = time.perf_counter()
    fastsam_counts = fastsam_phase(card)
    phase_start["nas"] = time.perf_counter()
    nas_phase(card)
    phase_start["nas_trainer"] = time.perf_counter()
    nas_trainer(card)

    # 35. the other configs: yolov3, v5, v6, det-rep and the four-level p2,
    # p6 and pose-p6 (no kernel: the counts over the phase must be 0)
    phase_start["configs"] = time.perf_counter()
    configs_phase(card)

    # 36. the fork's headline comparison, seg against detect, at 640
    phase_start["compare"] = time.perf_counter()
    paper_comparison(card)

    # 37. serving: the InferenceServer against direct predict for every task,
    # the closed-loop load at 640, the HTTP front end, batched streams, decoding
    phase_start["serve"] = time.perf_counter()
    serve_counts, serve_parts = serve_phase(card)

    # 38-40. data parallelism: the trainer in a one-rank NCCL group and two
    # gloo ranks sharing the card; serving over a two-replica mesh; datasets
    # on disk (PNG files, a yaml) validated against the same data in memory
    phase_start["ddp"] = time.perf_counter()
    ddp_counts = ddp_phase(card)
    phase_start["serve_mesh"] = time.perf_counter()
    serve_mesh_counts = serve_mesh_phase(card)
    phase_start["datasets"] = time.perf_counter()
    data_dir = tempfile.TemporaryDirectory()
    datasets_counts, data_yaml = datasets_phase(card, Path(data_dir.name))

    # 41. the training lifecycle: (c) the five optimizers the port adds, (d)
    # the facade's save and the CLI, (e) the tuner; (a) ran in ddp, and (b),
    # every checkpoint of the run against a synchronous save, ends here
    phase_start["lifecycle"] = time.perf_counter()
    lifecycle_counts = lifecycle_phase(card, data_yaml, version_cli)
    data_dir.cleanup()
    save_lines(save_check.finish(), card)
    check_dir.cleanup()

    # 42. report: launches summed over the main paths' runs
    phase_start["report"] = time.perf_counter()
    segori_counts = {"predict": segori_predict_counts, "validate": segori_val_counts,
                     "train step": segori_step_counts, "trainer": segori_trainer_counts,
                     "fused validate": segori_fuse_counts}
    launches = {k: predict_counts[k] + validate_counts[k] + train_counts[k] + trainer_counts[k]
                + fuse_counts[k] + sum(c[k] for c in segori_counts.values())
                + classify_counts[k] + sum(c[k] for c in rtdetr_counts.values())
                + host_counts[k] + fastsam_counts[k] + serve_counts[k] + ddp_counts[k]
                + serve_mesh_counts[k] + datasets_counts[k] + lifecycle_counts[k]
                for k in KERNEL_WRAPPERS}
    serve_other = sum(c["fill_polygons_cv2"] for k, c in serve_parts.items()
                      if k not in ("segment", "streams"))
    at_480 = fill_rows["fill_polygons_480x640"]
    at_segori = {f"{key}_N{n}_V360_160x160": segori_fill[n][key] for n in SEGORI_FILL_N
                 for key in ("ms", "plain_ms", "bound_ms", "bound_by")}
    src = "yolo_contour_regression_tpu_torch/csrc/"
    kernels = [
        {"name": "fill_polygons", "route": "cuda", "source": src + "raster.cu",
         "replaces": "yolo_contour_regression_tpu/ops/pallas_raster.py:58",
         "launches": launches["fill_polygons"], **fill_rows["fill_polygons"], "library_ms": None,
         "ms_480x640": at_480["ms"], "plain_ms_480x640": at_480["plain_ms"],
         "bound_ms_480x640": at_480["bound_ms"], **at_segori,
         "launches_segment_ori": {k: c["fill_polygons"] for k, c in segori_counts.items()},
         "launches_host_pipeline": host_counts["fill_polygons"],
         "launches_fastsam": fastsam_counts["fill_polygons"],
         "launches_ddp": ddp_counts["fill_polygons"],
         "launches_datasets": datasets_counts["fill_polygons"],
         "launches_lifecycle": lifecycle_counts["fill_polygons"]},
        {"name": "fill_polygons_cv2", "route": "cuda", "source": src + "raster.cu",
         "replaces": "yolo_contour_regression_tpu/engine/results.py:115 (host cv2.fillPoly; "
                     "no TPU kernel)",
         "launches": launches["fill_polygons_cv2"], **fill_rows["fill_polygons_cv2"],
         "library_ms": None, "launches_fastsam": fastsam_counts["fill_polygons_cv2"],
         "launches_serve": serve_counts["fill_polygons_cv2"],
         "launches_serve_mesh": serve_mesh_counts["fill_polygons_cv2"]},
        {"name": "gt_rays_rows", "route": "cuda", "source": src + "gt_rays.cu",
         "replaces": "yolo_contour_regression_tpu/ops/pallas_polar.py:217",
         "launches": launches["gt_rays_rows"], **report_row(rows_checks[TRAIN_NPAD]),
         "library_ms": None, "launches_host_pipeline": host_counts["gt_rays_rows"],
         "launches_ddp": ddp_counts["gt_rays_rows"],
         "launches_lifecycle": lifecycle_counts["gt_rays_rows"],
         **{f"{k}_R512_K48": v for k, v in report_row(rows_checks[TRAINER_NPAD]).items()
            if k in ("ms", "plain_ms", "bound_ms")}},
        {"name": "gt_rays_pairs", "route": "cuda", "source": src + "gt_rays.cu",
         "replaces": "yolo_contour_regression_tpu/ops/pallas_polar.py:333",
         "launches": launches["gt_rays_pairs"], **report_row(pairs_check), "library_ms": None},
    ]
    log("report", f"launches on the main paths: predict {predict_counts}, validate "
        f"{validate_counts} (floor set at 160 and one pass at 640), train step {train_counts}, "
        f"trainer {trainer_counts} (the floor run and 640), fused validate {fuse_counts} (the "
        f"seg160, detect and pose floor sets; the detect and pose paths have no kernel of their "
        f"own), segment_ori {segori_counts} (its GT masks: one fill a train step and a "
        f"validated batch), classify {classify_counts} (no kernel of its own), rtdetr "
        f"{rtdetr_counts} (no kernel of its own; its trainer and rtdetr-l included), host "
        f"pipeline {host_counts} (the seg trainer on the host chain: its assigner's GT rays, its "
        f"validator's fill), FastSAM {fastsam_counts} (its masks by the cv2 fill, its "
        f"contours-only results by the even-odd fill; SAM and NAS have no kernel of their "
        f"own), serve {serve_counts} (the cv2 fill of served and streamed results' masks, each "
        f"path counted alone: served seg160 {serve_parts['segment']['fill_polygons_cv2']}, "
        f"batched streams {serve_parts['streams']['fill_polygons_cv2']}, the other tasks' "
        f"served paths {serve_other}), ddp {ddp_counts} (the seg trainer in a one-rank NCCL "
        f"group; the GT rays of the two gloo ranks' float64 steps), serve_mesh "
        f"{serve_mesh_counts} (the masks served by two replicas), datasets {datasets_counts} "
        f"(the seg160 yaml's validation), lifecycle {lifecycle_counts} (the five optimizers' "
        f"float64 steps, the CLI's validation, the tuner's two trainings; ddp's counts hold (a)'s "
        f"resumed run); "
        "fill_polygons (even-odd, the validator's mask IoU): ms a launch at N=300 V=36 on the "
        "validator's 640x640 grid, at 480x640 (the *_480x640 keys), and at the segment_ori GT "
        "masks' N=128 and N=768, V=360 on 160x160 (the *_V360_160x160 keys); "
        "fill_polygons_cv2 (the "
        "predict path's masks): ms a launch at N=300 480x640; gt_rays_rows: ms, plain_ms and "
        "bound at the train step's R=128 K=128, and at the trainer's R=512 K=48 (the *_R512_K48 "
        "keys); gt_rays_pairs "
        "(also the counterpart of pallas_polar.py:101) at P=16,384 | wall "
        f"{time.perf_counter() - T0:.2f}s | {card}")
    names = list(phase_start)
    secs = {a: phase_start[b] - phase_start[a] for a, b in zip(names, names[1:])}
    log("report", "seconds by phase: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + f" | {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
