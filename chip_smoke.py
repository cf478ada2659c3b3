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
     path's masks with the edge cases of ``raster_inputs``, each with the
     device kernels one call launches (``torch.profiler``); the GT rays,
     rows form, at the trainer's two shapes (imgsz 640, batch 16, N_pad 8
     -> K 128 and N_pad 48 -> K 48), and per pair at P 16,384, each with
     its device kernels, then both entries on ``ray_scenes``' hard cases
     and the GT-ray kernel's own per-phase clock (``gt_rays_phases``);
     atan2f's instruction count from ``cuobjdump -sass`` (a probe built with
     the kernels' flags) and the share of the GT-ray bound it leaves.
  4. predict: ``YOLO(runs/floor_seg160/best.ckpt).predict`` on synthetic
     circle/rectangle images at imgsz 160 (batch 1) and 640 (batch 8),
     reading every result's masks; launch counts are zeroed just before and
     read just after. Then the masks of the 640 phase are split into their
     steps (copies, kernels, numpy), each timed apart, and the card's head
     outputs and detections are held against the port on the CPU at imgsz
     160.
  5. train: (a) the seg160 model at imgsz 160, batch 4: one loss, the
     assignment and every gradient on the card against the CPU; (b) the
     same model at full width, imgsz 640, batch 16: 3 warm-up steps of
     ``make_train_step`` with AdamW, then 20 timed steps on one repeated
     batch (launch counts zeroed just before and read just after; the loss
     must stay finite and fall), each split by CUDA events at the step's
     own stage marks into forward, assigner (and the GT-ray kernel in it),
     loss, backward and clip + optimizer + EMA; (c) ``save_checkpoint`` of
     the trained state and ``YOLO(path).predict`` from it.
  6. report: a JSON line of the kernels (launches summed over the predict
     and train runs), the card's line, and last ``{"ok": true, "device":
     {...}}``.
Any failure raises and exits non-zero.
"""
from __future__ import annotations

import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine.predictor import SegmentationPredictor
from yolo_contour_regression_tpu_torch.engine.results import Masks, contours_to_masks
from yolo_contour_regression_tpu_torch.engine.step import init_train_state, make_train_step
from yolo_contour_regression_tpu_torch.nn.tasks import SegmentationModel
from yolo_contour_regression_tpu_torch.ops import gt_rays, polar, raster
from yolo_contour_regression_tpu_torch.utils import cuda_build, optim
from yolo_contour_regression_tpu_torch.utils.checkpoint import (
    checkpoint_variables, load_checkpoint, load_jax_variables, save_checkpoint, to_jax_variables)
from yolo_contour_regression_tpu_torch.utils.loss import polar_loss, polar_targets

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "runs" / "floor_seg160" / "best.ckpt"
T0 = time.perf_counter()

# H100 SXM published peaks (dense): HBM bytes/s, and fp32 (non-tensor)
# instructions/s: the data sheet's 67 TFLOP/s counts an FMA as two operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_INSTR_PER_S = 67e12 / 2

# mask shape of the main path's 640 phase (a 480x640 camera frame) and the
# most polygons one image can give (max_det)
RASTER_N, RASTER_V, RASTER_HW = 300, 36, (480, 640)
# the card against the port on the CPU, both in float32
HEAD_ATOL = 1e-3  # raw head outputs: cuDNN and CPU conv sum orders differ
BOX_ATOL = 0.05  # px
# train step, card against CPU: loss (relative) and each gradient (of its
# tensor's largest entry); f32 convs and BatchNorm summed in other orders
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3

KERNEL_SOURCES = ("raster", "gt_rays")
# the trainer at imgsz 640, batch 16, cand_per_gt 128 with cand_balance:
# GT rows padded to N_pad 8 give K = 128 candidates a row, to N_pad 48 K = 48
TRAIN_IMGSZ, TRAIN_B, TRAIN_NPAD, TRAIN_K = 640, 16, 8, 128
RAY_SHAPES = ((8, 128), (48, 48))
RAY_PAIRS = 16384  # the per-pair entry, as many pairs as the rows form at K 128
TRAIN_STEPS = 20


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


def shape_batch(n: int, imgsz: int, n_pad: int, seed: int):
    """A train batch of n square images of filled circles (class 0) and
    rectangles (class 1), drawn as ``shape_images`` draws them, with exact
    360-point contours, in the train step's layout (numpy): images (n,
    imgsz, imgsz, 3) f32 in [0, 1]; cls (n, n_pad) int32, bboxes (n, n_pad,
    4) normalized xywh, segments (n, n_pad, 360, 2) normalized, mask_gt (n,
    n_pad) bool. Each image holds 1 to min(3, n_pad) shapes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:imgsz, :imgsz]
    imgs = np.full((n, imgsz, imgsz, 3), 40, np.uint8)
    batch = {"cls": np.zeros((n, n_pad), np.int32),
             "bboxes": np.zeros((n, n_pad, 4), np.float32),
             "segments": np.zeros((n, n_pad, 360, 2), np.float32),
             "mask_gt": np.zeros((n, n_pad), bool)}
    for i in range(n):
        for j in range(rng.integers(1, min(3, n_pad) + 1)):
            cx, cy = rng.uniform(0.3, 0.7, 2) * imgsz
            r = rng.uniform(0.08, 0.2) * imgsz
            color = rng.integers(100, 256, 3).astype(np.uint8)
            if rng.integers(2) == 0:
                imgs[i][(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = color
                contour = circle_contour(cx, cy, r)
            else:
                x0, y0, x1, y1 = int(cx - r), int(cy - r), int(cx + r), int(cy + r)
                imgs[i, y0:y1, x0:x1] = color
                contour = rect_contour(x0, y0, x1, y1)
                batch["cls"][i, j] = 1
            lo, hi = contour.min(0), contour.max(0)
            batch["bboxes"][i, j] = np.concatenate([(lo + hi) / 2, hi - lo]) / imgsz
            batch["segments"][i, j] = contour / imgsz
            batch["mask_gt"][i, j] = True
    return imgs.astype(np.float32) / 255.0, batch


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


def raster_inputs(seed: int = 0, device="cuda"):
    """Seeded star-shaped polygons at the path's shapes, plus edge cases:
    an all-invalid polygon, invalid runs at the start and the end,
    horizontal edges, vertices on integer pixel rows, a polygon that leaves
    the image and a degenerate one."""
    n, v, (h, w) = RASTER_N, RASTER_V, RASTER_HW
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


def kernels_of_one_call(name: str, fn, n_kernels: int):
    """``device_kernels(fn)``, which must be ``n_kernels`` where the profiler
    records them (a second session where the first records no device
    activity); the profiler's own failure is a gap in the report ("not
    measured"), not in the kernel."""
    try:
        kernels = device_kernels(fn) or device_kernels(fn)
    except Exception as e:
        kernels = f"not measured ({type(e).__name__}: {e})"
    if isinstance(kernels, list) and len(kernels) != n_kernels:
        raise AssertionError(f"{name}: one call launched {kernels}, not {n_kernels} kernels")
    return kernels


def check_fill(name: str, entry: str, fast, plain, rule: str, n_kernels: int, card: str) -> dict:
    """One polygon-fill entry against its plain version on the card, at the
    predict path's masks and the edge cases of ``raster_inputs``: 0
    differing pixels; the kernel's time per launch (``launch_ms``), the
    wrapper's per call, the plain version's and the bound; the device
    kernels of one call, which must be ``n_kernels`` where the profiler
    records them."""
    pts, valid = raster_inputs()
    h, w = RASTER_HW
    got, want = fast(pts, valid, h, w), plain(pts, valid, h, w)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    if n_diff or not want[1:].any() or want[0].any():
        raise AssertionError(f"{name}: {n_diff} pixels differ from the plain version")
    ms = launch_ms(entry, pts, valid, h, w)
    call_ms = time_ms(lambda: fast(pts, valid, h, w))
    plain_ms = time_ms(lambda: plain(pts, valid, h, w), reps=10)
    bound_ms, bound_by = raster_bound_ms(pts, valid, h, w, rule)
    kernels = kernels_of_one_call(name, lambda: fast(pts, valid, h, w), n_kernels)
    log("kernels", f"{name} N={RASTER_N} V={RASTER_V} {h}x{w}: {n_diff} of {got.numel()} pixels "
        f"differ from the plain version; kernel {ms:.4f} ms a launch ({bound_ms / ms:.1%} of the "
        f"bound), wrapper {call_ms:.4f} ms a call, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by}); device kernels of one call: {kernels if kernels else 'not measured'}; "
        f"library ms: none (no PyTorch call fills polygons) | {card}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": float((got.int() - want.int()).abs().max())}


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


def seg160_model(ckpt, device):
    model = SegmentationModel(ckpt["model_yaml"])
    model.names = dict(ckpt["names"])
    load_jax_variables(model, *checkpoint_variables(ckpt))
    return model.to(device).train()


def to_device(images, batch, device):
    return (torch.from_numpy(images).to(device),
            {k: torch.from_numpy(v).to(device) for k, v in batch.items()})


def train_card_vs_cpu(ckpt, card: str):
    """One loss, the assignment and every gradient of the seg160 model at
    imgsz 160, batch 4, on the card and on the CPU (f32, TF32 off)."""
    images, batch = shape_batch(4, 160, 8, seed=3)
    hyp = train_hyp(ckpt)
    res = {}
    for dev in ("cpu", "cuda"):
        model = seg160_model(ckpt, dev)
        x, b = to_device(images, batch, dev)
        feats = model(x.permute(0, 3, 1, 2).contiguous())
        tg = polar_targets(feats, b, model.strides, model.nc, hyp, cand=hyp.cand_per_gt)
        out = polar_loss(tg, hyp)
        out.total.backward()
        res[dev] = (out.total.item(), tg.assign.fg_mask.cpu(), tg.assign.target_gt_idx.cpu(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
    (lc, fc, ic, gc), (lg, fg, ig, gg) = res["cpu"], res["cuda"]
    loss_rel = abs(lg - lc) / abs(lc)
    grad_rel = max(float((gg[n] - gc[n]).abs().max() / gc[n].abs().max().clamp_min(1e-30))
                   for n in gc)
    same = torch.equal(fc, fg) and torch.equal(ic[fc], ig[fg])
    if not same or loss_rel > TRAIN_LOSS_RTOL or grad_rel > TRAIN_GRAD_TOL:
        raise AssertionError(f"train card vs CPU: same assignment {same}, loss rel {loss_rel:.2e} "
                             f"(limit {TRAIN_LOSS_RTOL}), grad {grad_rel:.2e} of the tensor max "
                             f"(limit {TRAIN_GRAD_TOL})")
    log("train", f"card vs CPU, seg160 at imgsz 160 batch 4: loss {lg:.6f} vs {lc:.6f} (rel "
        f"{loss_rel:.2e}, limit {TRAIN_LOSS_RTOL}); same assignment ({int(fc.sum())} fg anchors); "
        f"worst gradient {grad_rel:.2e} of its tensor's max (limit {TRAIN_GRAD_TOL}) | {card}")


class StageTimer:
    """The ``mark`` hook of ``make_train_step``: a CUDA event as each stage
    of the step starts. ``split()`` reads the step just run, ms per stage:
    forward, assigner (the GT-ray kernel's wrapper included), gt_rays_kernel
    (that wrapper alone), loss, backward, clip_optimizer_ema, total."""

    def __init__(self):
        self.marks = []

    def __call__(self, stage: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((stage, ev))

    def split(self) -> dict:
        marks, self.marks = self.marks, []
        marks[-1][1].synchronize()
        out = dict.fromkeys(("forward", "assigner", "gt_rays", "loss", "backward",
                             "clip_optimizer_ema"), 0.0)
        for (stage, a), (_, b) in zip(marks, marks[1:]):
            out[stage] += a.elapsed_time(b)
        out["gt_rays_kernel"] = out.pop("gt_rays")
        out["assigner"] += out["gt_rays_kernel"]
        out["total"] = marks[0][1].elapsed_time(marks[-1][1])
        return out


def train_full_width(ckpt, card: str):
    """yolov8n-seg at full width from the seg160 checkpoint, imgsz 640,
    batch 16, N_pad 8, AdamW from the checkpoint's train_args with no
    warmup: 3 warm-up steps, then TRAIN_STEPS steps of ``make_train_step``
    on one repeated batch (counts zeroed just before, read just after), each
    timed on the host clock and split into its stages by the step's own
    marks (``StageTimer``)."""
    hyp = train_hyp(ckpt, optimizer="AdamW", warmup_epochs=0.0, batch=TRAIN_B)
    model = seg160_model(ckpt, "cuda")
    opt = optim.build_optimizer(model, hyp, steps_per_epoch=1000, iterations=1000)
    state = init_train_state(model, opt, device="cuda")
    timer = StageTimer()
    step = make_train_step(model, opt, hyp, cand=hyp.cand_per_gt, mark=timer)
    images, batch = shape_batch(TRAIN_B, TRAIN_IMGSZ, TRAIN_NPAD, seed=4)
    x, b = to_device(images, batch, "cuda")
    losses = [step(state, x, b)["loss"].item() for _ in range(3)]
    timer.marks = []
    zero_launch_counts()
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
        raise AssertionError(f"train at 640: losses {losses}")
    if counts["gt_rays_rows"] == 0:
        raise AssertionError("the train path never launched the GT-ray kernel")
    log("train", f"yolov8n-seg full width, imgsz {TRAIN_IMGSZ} batch {TRAIN_B} N_pad "
        f"{TRAIN_NPAD}, AdamW lr0 {hyp.lr0}: loss {losses[0]:.4f} at step 0, {losses[-1]:.4f} "
        f"at step {len(losses) - 1}, all finite; {int(batch['mask_gt'].sum())} GT instances; "
        f"launches {counts}; ms per step (host clock, median of {TRAIN_STEPS}) "
        f"{statistics.median(times):.3f} (min {min(times):.3f}, max {max(times):.3f}); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
    med = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    parts = ", ".join(f"{k} {v:.3f}" for k, v in med.items())
    log("train", f"imgsz {TRAIN_IMGSZ} batch {TRAIN_B}, ms per step split by CUDA events at the "
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

    # 2. build: one nvcc per source, all started together
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

    # 3. kernels against their plain versions
    fill_rows = {
        "fill_polygons": check_fill("fill_polygons", "raster_fill_polygons", raster.fill_polygons,
                                    raster.fill_polygons_plain, "even_odd", 1, card),
        "fill_polygons_cv2": check_fill("fill_polygons_cv2", "raster_fill_polygons_cv2",
                                        raster.fill_polygons_cv2, raster.fill_polygons_cv2_plain,
                                        "cv2", 2, card),
    }
    rows_checks = {}
    for n_pad, k in RAY_SHAPES:
        r = TRAIN_B * n_pad
        rows_checks[k] = check_gt_rays("rows", *ray_inputs(r, k, seed=k), card,
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
    atan2f_floor(rows_checks[TRAIN_K], "rows", atan2f_instr, card)
    atan2f_floor(pairs_check, "pairs", atan2f_instr, card)

    # 4. the main path: predict on the card
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

    def run(images, imgsz, batch):
        """One predict call plus every mask; per-image ms of each stage."""
        t = time.perf_counter()
        res = model.predict(images, imgsz=imgsz, batch=batch)
        t_masks = time.perf_counter()
        for r in res:
            r.masks  # noqa: B018 (rasterize)
        torch.cuda.synchronize()
        end = time.perf_counter()
        n = len(images)
        stages = {k: statistics.fmean(r.speed[k] for r in res)
                  for k in ("preprocess", "inference", "postprocess")}
        return {"total": (end - t) * 1e3 / n, "masks": (end - t_masks) * 1e3 / n, **stages}

    lat = {}
    for imgsz, images, batch in ((160, imgs160[:1], 1), (640, imgs640, 8)):
        run(images, imgsz, batch)  # warm-up
        runs = [run(images, imgsz, batch) for _ in range(10)]
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
    pred = SegmentationPredictor(imgsz=160)
    worst_head, worst_box = 0.0, 0.0
    for img in imgs160:
        x, gain, pad = pred.preprocess_u8(img, 160)
        xt = torch.from_numpy(x[None])
        with torch.inference_mode():
            xf = xt.float().div(255.0).permute(0, 3, 1, 2).contiguous()
            head_gpu = model.model(xf.cuda())
            head_cpu = cpu.model(xf)
        for g, c in zip(head_gpu, head_cpu):
            worst_head = max(worst_head, float((g.cpu() - c).abs().max()))
        out_gpu = pred.eval_batch(model.model, xt.cuda())
        out_cpu = pred.eval_batch(cpu.model, xt)
        vg, vc = out_gpu["valid"].cpu(), out_cpu["valid"]
        if not torch.equal(vg, vc) or not torch.equal(out_gpu["classes"].cpu(), out_cpu["classes"]):
            raise AssertionError("card and CPU keep different detections")
        worst_box = max(worst_box, float((out_gpu["boxes"].cpu() - out_cpu["boxes"]).abs().max()))
    if worst_head > HEAD_ATOL or worst_box > BOX_ATOL:
        raise AssertionError(f"card vs CPU: head {worst_head:.2e} (limit {HEAD_ATOL}), "
                             f"boxes {worst_box:.2e} px (limit {BOX_ATOL})")
    log("predict", f"card vs CPU at imgsz 160: head max abs {worst_head:.2e} (limit {HEAD_ATOL}), "
        f"same detections, boxes max abs {worst_box:.2e} px (limit {BOX_ATOL}) | {card}")

    # 5. the main path: the train step on the card
    ckpt = load_checkpoint(CKPT)
    train_card_vs_cpu(ckpt, card)
    state, train_counts, _, _ = train_full_width(ckpt, card)
    save_and_predict(ckpt, state, imgs160, card)

    # 6. report: launches summed over the two main paths' runs
    launches = {k: predict_counts[k] + train_counts[k] for k in KERNEL_WRAPPERS}
    src = "yolo_contour_regression_tpu_torch/csrc/"
    kernels = [
        {"name": "fill_polygons", "route": "cuda", "source": src + "raster.cu",
         "replaces": "yolo_contour_regression_tpu/ops/pallas_raster.py:58",
         "launches": launches["fill_polygons"], **fill_rows["fill_polygons"], "library_ms": None},
        {"name": "fill_polygons_cv2", "route": "cuda", "source": src + "raster.cu",
         "replaces": "yolo_contour_regression_tpu/engine/results.py:115 (host cv2.fillPoly; "
                     "no TPU kernel)",
         "launches": launches["fill_polygons_cv2"], **fill_rows["fill_polygons_cv2"],
         "library_ms": None},
        {"name": "gt_rays_rows", "route": "cuda", "source": src + "gt_rays.cu",
         "replaces": "yolo_contour_regression_tpu/ops/pallas_polar.py:217",
         "launches": launches["gt_rays_rows"], **report_row(rows_checks[TRAIN_K]),
         "library_ms": None},
        {"name": "gt_rays_pairs", "route": "cuda", "source": src + "gt_rays.cu",
         "replaces": "yolo_contour_regression_tpu/ops/pallas_polar.py:333",
         "launches": launches["gt_rays_pairs"], **report_row(pairs_check), "library_ms": None},
    ]
    log("report", f"launches on the main paths: predict {predict_counts}, train {train_counts}; "
        "fill_polygons (even-odd; the validator's and the segment_ori loss's rule, on neither "
        "path yet) and fill_polygons_cv2 (the predict path's masks): ms a launch, at N=300 "
        "480x640; gt_rays_rows: ms, plain_ms and bound at the train path's R=128 K=128; "
        "gt_rays_pairs "
        "(also the counterpart of pallas_polar.py:101) at P=16,384 | wall "
        f"{time.perf_counter() - T0:.2f}s | {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
