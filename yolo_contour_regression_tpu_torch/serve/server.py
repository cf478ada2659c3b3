"""Dynamic-batching inference server (counterpart of the JAX package's
``serve/server.py``).

- **Shape buckets.** Each formed batch is padded with zero images up to the
  next bucket (powers of two up to ``max_batch``, and ``max_batch``
  itself); the padded rows' outputs are dropped. On the card a bucket
  costs no compile, but a fixed set of batch shapes keeps cuDNN's choice of
  algorithm and the allocator's blocks warm: ``warmup()`` runs every bucket
  once and logs its milliseconds.
- **Two threads.** Request threads enqueue numpy images and wait on
  futures. The dispatcher coalesces the queue (up to ``max_batch``
  requests, or ``max_delay_ms`` after the first), letterboxes on the host,
  runs the task's ``eval_batch`` and starts the copy of its outputs to the
  host (pinned, asynchronous) with a ``torch.cuda.Event`` recorded after
  it; the completion thread waits on that event, runs each request's host
  postprocess and completes its future. The port's NMS waits on the host at
  every sweep (``ops/nms.py``), so the dispatcher returns only once the
  device work is done; the completion of batch N still overlaps the
  preprocess of batch N + 1, which ``stats()`` reports as ``overlap_ms``.
- **Per-thread CUDA state.** Both threads enter the model's device
  (``torch.cuda.device``), so a ``cuda:1`` model runs on card 1;
  ``eval_batch`` runs under ``inference_mode`` in the dispatcher.
- **Failures stay local.** A request whose image cannot be preprocessed or
  postprocessed fails its own future; a batch whose evaluation fails fails
  its batch (``stats()["last_error"]``) and the server keeps serving.

- **Several devices** (``mesh=``, ``parallel/mesh.py:create_mesh``; JAX's
  data-parallel serving): the fused weights are replicated, one copy per
  device of the mesh (two entries may name one card: two replicas on it);
  the buckets are rounded up to multiples of the mesh size, with
  ``max_batch`` at least that size, as JAX rounds them; each formed batch is
  split into equal shards of consecutive rows and shard i is evaluated on
  device i, each by a thread of its own that enters its device, so all
  shards are launched before any is read back. Each shard's copy to the host
  has its own ``torch.cuda.Event``, which the completion thread waits on;
  results come back in request order. Without a mesh the dispatcher
  evaluates the one shard itself.

The device side is each task's predictor (``engine/model.py:TASK_MAP``):
segment, detect, pose, segment_ori, classify and rtdetr, and NAS and FastSAM
through their handles.
"""
from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

LOGGER = logging.getLogger(__name__)


def _default_buckets(max_batch: int) -> List[int]:
    """Powers of two up to max_batch, and max_batch itself."""
    b, out = 1, []
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return sorted(set(out))


def _overlap(a: Sequence, b: Sequence) -> float:
    """Total time two sorted lists of disjoint (start, end) intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class ServerStats:
    """Rolling serving metrics: request latency quantiles, batch fill,
    throughput, and each thread's busy time and their overlap."""

    def __init__(self, window: int = 10000):
        self._lock = threading.Lock()
        self._latencies = deque(maxlen=window)  # seconds, per request
        self._dispatch = deque(maxlen=window)  # (start, end) of each batch's dispatch
        self._complete = deque(maxlen=window)  # (start, end) of each batch's completion
        self.batch_hist: Dict[int, int] = {}  # formed (pre-pad) batch size -> count
        self.requests = 0
        self.batches = 0
        self.padded_rows = 0
        self._t0 = time.perf_counter()

    def record_dispatch(self, start: float, end: float):
        with self._lock:
            self._dispatch.append((start, end))

    def record_batch(self, n_real: int, n_padded: int, latencies: Sequence[float],
                     span: tuple):
        with self._lock:
            self.requests += n_real
            self.batches += 1
            self.padded_rows += n_padded - n_real
            self.batch_hist[n_real] = self.batch_hist.get(n_real, 0) + 1
            self._latencies.extend(latencies)
            self._complete.append(span)

    def snapshot(self) -> Dict:
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            elapsed = time.perf_counter() - self._t0
            dispatch, complete = list(self._dispatch), list(self._complete)
            out = {
                "requests": self.requests,
                "batches": self.batches,
                "padded_rows": self.padded_rows,
                "batch_hist": dict(sorted(self.batch_hist.items())),
                "elapsed_s": round(elapsed, 3),
                "throughput_rps": round(self.requests / elapsed, 2) if elapsed > 0 else 0.0,
                "mean_batch": round(self.requests / self.batches, 2) if self.batches else 0.0,
            }
        if lat.size:
            out.update(
                latency_ms_p50=round(float(np.percentile(lat, 50)) * 1e3, 2),
                latency_ms_p95=round(float(np.percentile(lat, 95)) * 1e3, 2),
                latency_ms_p99=round(float(np.percentile(lat, 99)) * 1e3, 2),
            )
        out.update(
            dispatch_ms=round(sum(e - s for s, e in dispatch) * 1e3, 3),
            complete_ms=round(sum(e - s for s, e in complete) * 1e3, 3),
            overlap_ms=round(_overlap(dispatch, complete) * 1e3, 3),
        )
        return out


class _Request:
    __slots__ = ("image", "future", "t_submit")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class InferenceServer:
    """Dynamic-batching inference server over a ``YOLO`` handle (or a
    checkpoint path, loaded on ``device``)::

        srv = InferenceServer("best.ckpt", imgsz=640, max_batch=32)
        srv.start()                  # or: with InferenceServer(...) as srv:
        fut = srv.submit(bgr_image)  # thread-safe, a Future[Results]
        res = fut.result()
        srv.infer([im1, im2, im3])   # blocking: [Results]
        srv.stats()                  # latency, throughput, batch fill
        srv.close()
    """

    def __init__(self, weights, imgsz: int = 640, max_batch: int = 32,
                 max_delay_ms: float = 5.0, buckets: Optional[Sequence[int]] = None,
                 conf: Optional[float] = None, iou: Optional[float] = None, fuse: bool = True,
                 queue_size: int = 1024, mesh=None, device="cuda"):
        from ..engine.model import TASK_MAP, YOLO
        from ..parallel.mesh import Mesh, replicate

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh (create_mesh), not {type(mesh)}")
        self.handle = weights if isinstance(weights, YOLO) else YOLO(weights, device=device)
        self.model = self.handle._weights()
        if fuse and not getattr(self.model, "quantized", False):
            self.handle.fuse()  # a no-op on a fused model; an int8 one is served as it is
        if mesh is None:
            self.replicas = [self.model]
            self.devices = [next(self.model.parameters()).device]
        else:  # one copy of the weights a device of the mesh
            self.replicas = replicate(self.model, mesh.devices)
            self.devices = list(mesh.devices)
        self.device = self.devices[0]
        n_dev = len(self.replicas)
        self.names = self.handle.names
        self.imgsz = int(imgsz)
        self.max_batch = max(int(max_batch), n_dev)
        self.max_delay = float(max_delay_ms) / 1e3
        raw = set(int(b) for b in (buckets or _default_buckets(self.max_batch)))
        raw.add(self.max_batch)  # the capacity bucket, rounded with the rest
        if n_dev > 1:  # every device gets the same shard shape
            raw = {max(n_dev, (b + n_dev - 1) // n_dev * n_dev) for b in raw}
        self.buckets = sorted(raw)
        self._shard_pool = ThreadPoolExecutor(n_dev, thread_name_prefix="serve-shard") \
            if n_dev > 1 else None
        kw = {} if conf is None else {"conf": conf}
        if iou is not None:
            kw["iou"] = iou
        self._predictor = TASK_MAP[self.handle.task]["predictor"](imgsz=self.imgsz, **kw)
        self.warmup_ms: Dict[int, float] = {}
        self._queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stats = ServerStats()
        self._thread: Optional[threading.Thread] = None
        self._closing = threading.Event()
        self._last_error: Optional[str] = None  # observability, not a gate

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "InferenceServer":
        if self._thread is not None:
            return self
        self._closing.clear()  # a restart after close()
        self._last_error = None
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True,
                                        name="serve-dispatch")
        self._thread.start()
        return self

    def _on_device(self, device=None):
        """``device`` (default: the first replica's) as this thread's
        current CUDA device."""
        device = self.device if device is None else device
        if device.type == "cuda":
            return torch.cuda.device(device)
        return contextlib.nullcontext()

    def _eval_shard(self, i: int, x: np.ndarray):
        """Replica i on rows ``x``: its outputs' copy to the host started,
        and the event recorded after it (None on the CPU)."""
        with self._on_device(self.devices[i]):
            out = self._predictor.eval_batch(self.replicas[i],
                                             torch.from_numpy(x).to(self.devices[i]))
            host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
            event = None
            if self.devices[i].type == "cuda":
                event = torch.cuda.Event()
                event.record()
        return host, event

    def _eval(self, stacked: np.ndarray):
        """The padded batch in equal shards, shard i on replica i (all
        launched before any is read) -> [(host outputs, event)] a shard."""
        n_dev = len(self.replicas)
        if n_dev == 1:
            return [self._eval_shard(0, stacked)]
        rows = stacked.shape[0] // n_dev
        futs = [self._shard_pool.submit(self._eval_shard, i, stacked[i * rows:(i + 1) * rows])
                for i in range(n_dev)]
        return [f.result() for f in futs]

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> "InferenceServer":
        """Run every bucket once at the requests' input dtype (uint8, or
        classify's float32), so the first requests do not pay for cuDNN's
        choice of algorithm and the allocator's growth. Logs and keeps
        (``warmup_ms``) the milliseconds of each."""
        x0, _, _ = self._predictor.preprocess_u8(np.zeros((32, 32, 3), np.uint8), self.imgsz)
        with self._on_device():
            for b in buckets or self.buckets:
                t0 = time.perf_counter()
                for _, event in self._eval(np.zeros((b,) + x0.shape, x0.dtype)):
                    if event is not None:
                        event.synchronize()
                self.warmup_ms[b] = (time.perf_counter() - t0) * 1e3
                LOGGER.info(f"serve: warmed bucket {b} in {self.warmup_ms[b]:.1f} ms")
        return self

    def close(self, drain: bool = True):
        """Stop the dispatcher. With ``drain`` (the default) queued requests
        are served first; otherwise they fail with RuntimeError."""
        if self._thread is None:
            return
        self._closing.set()
        if not drain:
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req is not None:
                    req.future.set_exception(RuntimeError("server closed"))
        self._queue.put(None)  # the sentinel wakes the dispatcher
        self._thread.join()
        self._thread = None
        # a submit() racing close() can land behind the sentinel: fail it
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                req.future.set_exception(RuntimeError("server closed"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- request paths -----------------------------------------------------
    def submit(self, image_bgr: np.ndarray) -> Future:
        """Enqueue one BGR uint8 image (H, W, 3); returns Future[Results]."""
        if self._thread is None or self._closing.is_set():
            raise RuntimeError("server not running (call start(), not after close())")
        req = _Request(np.asarray(image_bgr))
        self._queue.put(req)
        return req.future

    def infer(self, images: Sequence[np.ndarray], timeout: Optional[float] = None):
        """Submit all, wait for all: [Results]."""
        futs = [self.submit(im) for im in images]
        return [f.result(timeout=timeout) for f in futs]

    def stats(self) -> Dict:
        s = self._stats.snapshot()
        s["buckets"] = self.buckets
        s["queue_depth"] = self._queue.qsize()
        s["last_error"] = self._last_error
        return s

    def reset_stats(self):
        """A fresh metrics window (e.g. between load levels)."""
        self._stats = ServerStats()

    # -- dispatcher --------------------------------------------------------
    def _take_batch(self) -> Optional[List[_Request]]:
        """Wait for the first request, then coalesce until max_batch or the
        delay window closes. None: shut down."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        if first is None:
            return None
        batch = [first]
        deadline = time.perf_counter() + self.max_delay
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-post the sentinel for the outer loop
                break
            batch.append(nxt)
        return batch

    def _dispatch_loop(self):
        """Form, preprocess and evaluate batches; hand each to the completion
        thread with its outputs on their way to the host. The hand-off queue
        holds 2 batches: the backpressure."""
        done_q: queue.Queue = queue.Queue(maxsize=2)
        comp = threading.Thread(target=self._completion_loop, args=(done_q,), daemon=True,
                                name="serve-complete")
        comp.start()
        try:
            with self._on_device():
                while True:
                    batch = self._take_batch()
                    if batch is None or (not batch and self._closing.is_set()):
                        return
                    if batch:
                        item = self._dispatch(batch)
                        if item is not None:
                            done_q.put(item)
        finally:
            done_q.put(None)  # drain: queued batches complete before the join
            comp.join()

    def _dispatch(self, batch: List[_Request]):
        t0 = time.perf_counter()
        xs, gains, pads, ok = [], [], [], []
        for req in batch:  # one malformed image fails only its own future
            try:
                x, gain, pad = self._predictor.preprocess_u8(req.image, self.imgsz)
            except Exception as e:
                req.future.set_exception(e)
                continue
            xs.append(x)
            gains.append(gain)
            pads.append(pad)
            ok.append(req)
        if not ok:
            return None
        try:
            n = len(ok)
            bucket = next(b for b in self.buckets if b >= n)
            stacked = np.zeros((bucket,) + xs[0].shape, xs[0].dtype)
            stacked[:n] = np.stack(xs)
            # the copies to the host started; the completion thread waits on the events
            shards = self._eval(stacked)
        except Exception as e:  # fail this batch, keep serving
            for req in ok:
                if not req.future.done():
                    req.future.set_exception(e)
            self._last_error = f"{type(e).__name__}: {e}"
            LOGGER.error(f"serve: batch failed: {self._last_error}")
            return None
        self._stats.record_dispatch(t0, time.perf_counter())
        return shards, ok, gains, pads, bucket

    def _completion_loop(self, done_q: queue.Queue):
        """Wait for each batch's outputs on the host, then postprocess each
        request."""
        with self._on_device():
            while True:
                item = done_q.get()
                if item is None:
                    return
                self._complete(*item)

    def _complete(self, shards, batch, gains, pads, bucket):
        t0 = time.perf_counter()
        try:
            outs = []
            for host, event in shards:
                if event is not None:
                    event.synchronize()
                outs.append({k: v.numpy() for k, v in host.items()})
            rows = bucket // len(shards)
            lats = []
            for bi, req in enumerate(batch):
                s = bi // rows  # the shard, and the row in it, of request bi
                try:
                    res = self._predictor.postprocess(outs[s], bi - s * rows, req.image,
                                                      f"request-{bi}", gains[bi], pads[bi],
                                                      self.names, self.devices[s])
                    req.future.set_result(res)
                    # a request's latency ends when its own result is set: it
                    # includes its postprocess and its wait behind the batch's earlier ones
                    lats.append(time.perf_counter() - req.t_submit)
                except Exception as e:  # one bad postprocess must not sink the batch
                    req.future.set_exception(e)
            self._stats.record_batch(len(batch), bucket, lats, (t0, time.perf_counter()))
        except Exception as e:
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
            self._last_error = f"{type(e).__name__}: {e}"
            LOGGER.error(f"serve: batch readback failed: {self._last_error}")
        else:
            self._last_error = None
