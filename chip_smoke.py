#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one timestamped line each (elapsed seconds):
  1. device: fail without CUDA (there is no CPU path); print the card's name
     and power limit; turn TF32 off for convolutions and matmuls, so the
     card computes in full float32 like the CPU it is compared with.
  2. build: nvcc every kernel of the port from ``csrc/`` (timed).
  3. kernels: each kernel's wrapper against its plain PyTorch version on the
     card, at the main path's shapes, with its time, the plain version's
     time and the card's least time for the same work (its bound).
  4. predict: ``YOLO(runs/floor_seg160/best.ckpt).predict`` on synthetic
     circle/rectangle images at imgsz 160 (batch 1) and 640 (batch 8),
     reading every result's masks; launch counts are zeroed just before and
     read just after. Then the masks of the 640 phase are split into their
     steps (copies, collapse, kernel, numpy), each timed apart, and the
     card's head outputs and detections are held against the port on the
     CPU at imgsz 160.
  5. report: a JSON line of the kernels, the card's line, and last
     ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine.predictor import SegmentationPredictor
from yolo_contour_regression_tpu_torch.engine.results import Masks, contours_to_masks
from yolo_contour_regression_tpu_torch.ops import raster
from yolo_contour_regression_tpu_torch.utils import cuda_build

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
    invalid-vertex collapse and the kernel alone (CUDA events), the wrapper
    ``fill_polygons`` as a whole (collapse, checks and kernel; CUDA events),
    the masks to the host (CUDA events, which span the host's side of the
    synchronous copy too, and the host clock with the host allocation),
    numpy's view and ``Masks`` (host clock), and ``contours_to_masks`` whole
    (host clock), once per image with its masks dropped and once over all
    images with every mask kept, as ``Results`` keeps them. Median of
    ``reps`` passes over ``results``. It launches the kernel, so it runs
    after the main path's launch count is read."""
    lib = raster._raster_lib()
    passes = []
    for _ in range(reps):
        acc = dict.fromkeys(("to_card", "collapse", "kernel", "fill_polygons", "to_host_events",
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
            acc["collapse"] += event_ms(lambda: raster.collapse_invalid_vertices(pts, ok))
            col = raster.collapse_invalid_vertices(pts, ok).contiguous()
            out = torch.empty((n, h, w), dtype=torch.bool, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            if n:
                acc["kernel"] += event_ms(lambda: box.__setitem__("err", lib.raster_fill_polygons(
                    col.data_ptr(), ok.data_ptr(), out.data_ptr(), n, v, h, w, stream)))
                if box["err"] != 0:
                    raise RuntimeError(f"raster kernel launch failed: CUDA error {box['err']}")
            acc["fill_polygons"] += event_ms(lambda: raster.fill_polygons(pts, ok, h, w))
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


def raster_bound_ms(pts, valid, h: int, w: int):
    """Least time for the polygon fill on this card, from this run's data,
    and what sets it: max(bytes / HBM rate, ops / fp32 issue rate).

    Bytes: points and valid read once, masks written once. Ops: the work the
    function needs, not what the kernel does. Whether an edge spans a row
    (two compares and an inequality) is one value per (row, edge) of a
    polygon with a valid vertex: 3 ops. Its crossing ``xi`` is one value per
    spanning (row, edge): 3 subtractions, a division, a multiply and an add,
    6 ops. Each (pixel, spanning edge) then takes a compare and a parity
    flip: 2 ops. None of these is an FMA, so the rate is the data sheet's
    fp32 rate halved (it counts an FMA as two operations)."""
    n, v = valid.shape
    ok = valid.any(-1)
    col = raster.collapse_invalid_vertices(pts, valid)
    y0 = col[..., 1]
    y1 = torch.roll(y0, -1, dims=-1)
    rows = torch.arange(h, device=pts.device, dtype=pts.dtype)
    spans = ((y0[..., None] > rows) != (y1[..., None] > rows)) & ok[:, None, None]
    n_spans = int(spans.sum())
    ops = 3 * int(ok.sum()) * v * h + 6 * n_spans + 2 * n_spans * w
    nbytes = pts.numel() * 4 + valid.numel() + n * h * w
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_INSTR_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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

    # 2. build
    t = time.perf_counter()
    lib = cuda_build.build("raster")
    log("build", f"raster.cu -> {lib.relative_to(ROOT)} in {time.perf_counter() - t:.2f}s "
        f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")

    # 3. kernels against their plain versions
    pts, valid = raster_inputs()
    h, w = RASTER_HW
    got = raster.fill_polygons(pts, valid, h, w)
    want = raster.fill_polygons_plain(pts, valid, h, w)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    if mismatches or not want[1:].any() or want[0].any():
        raise AssertionError(f"raster kernel: {mismatches} pixels differ from the plain version")
    ms = time_ms(lambda: raster.fill_polygons(pts, valid, h, w))
    plain_ms = time_ms(lambda: raster.fill_polygons_plain(pts, valid, h, w))
    bound_ms, bound_by = raster_bound_ms(pts, valid, h, w)
    log("kernels", f"fill_polygons N={RASTER_N} V={RASTER_V} {h}x{w}: 0 of {got.numel()} "
        f"pixels differ; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}) | {card}")

    # 4. the main path: predict on the card
    model = YOLO(CKPT, device="cuda")
    imgs160 = shape_images(4, 120, 200, seed=1)
    imgs640 = shape_images(8, *RASTER_HW, seed=2)
    raster.fill_polygons.launches = 0
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
    launches = raster.fill_polygons.launches
    if launches == 0:
        raise AssertionError("the predict path never launched the raster kernel")
    log("predict", f"imgsz 160: {n_det} detections, {n_px} mask pixels over {len(res160)} "
        f"images; imgsz 640 batch 8: {n_det640} detections, {n_px640} mask pixels; "
        f"raster launches {launches} | {card}")
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
        f"same detections, boxes max abs {worst_box:.2e} px (limit {BOX_ATOL})")

    # 5. report
    kernels = [{
        "name": "fill_polygons",
        "route": "cuda",
        "source": "yolo_contour_regression_tpu_torch/csrc/raster.cu",
        "replaces": "yolo_contour_regression_tpu/ops/pallas_raster.py:58",
        "launches": launches,
        "max_abs_err": float((got.int() - want.int()).abs().max()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    log("report", f"wall {time.perf_counter() - T0:.2f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
