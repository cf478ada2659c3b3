"""Threaded multi-stream ingestion (counterpart of the JAX package's
``data/streams.py``): N live sources, one daemon reader thread each, and a
batch of the freshest frame of every stream per step, so N streams ride one
batch-N forward instead of N batch-1 forwards.

The stream count is fixed at construction and the batch shape never
changes: a stream that ends re-serves its last frame. ``open_fn`` takes a
spec and returns any capture-like object (``isOpened``, ``grab``,
``retrieve``, ``read``, ``release``, cv2's ``VideoCapture`` API). The port
has no video decoder, so without ``open_fn`` a spec raises
``NotImplementedError`` (JAX's default is cv2's ``VideoCapture``).
"""
from __future__ import annotations

import logging
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

__all__ = ["LoadStreams"]

LOGGER = logging.getLogger(__name__)


def _no_decoder(src: str):
    raise NotImplementedError(
        f"stream {src!r}: no video or camera decoder is ported (JAX opens it with cv2's "
        f"VideoCapture); pass open_fn, a spec -> capture-like object")


class LoadStreams:
    """Read N streams concurrently; iterate batches of their latest frames.

    Args:
        sources: stream specs, one spec, or the path of a ``*.streams`` text
            file with one spec per line.
        vid_stride: keep every vid_stride-th frame of each stream.
        buffer: True keeps every kept frame in a FIFO of at most 30 per
            stream; False keeps only the newest (live cameras: stale frames
            are dropped and counted in ``frames_dropped``).
        open_fn: ``spec -> capture``.
        poll_s: the reader's sleep while its buffer is full, and the
            consumer's while a live stream has no frame yet.

    Iteration yields ``(paths, frames)``: one ``"<spec>#frame<i>"`` and one
    BGR frame per stream. It stops once every stream has ended and its
    buffer is drained.
    """

    MAX_BUFFER = 30

    def __init__(self, sources: Union[str, Path, Sequence], vid_stride: int = 1,
                 buffer: bool = False, open_fn: Optional[Callable] = None,
                 poll_s: float = 0.002):
        if isinstance(sources, (str, Path)) and str(sources).endswith(".streams"):
            sources = [s.strip() for s in Path(sources).read_text().splitlines() if s.strip()]
        elif isinstance(sources, (str, Path, int)):
            sources = [sources]
        self.sources = [str(s) for s in sources]
        n = len(self.sources)
        if n == 0:
            raise ValueError("LoadStreams needs at least one source")
        self.vid_stride = max(1, int(vid_stride))
        self.buffer = buffer
        self.poll_s = poll_s
        self._open = open_fn or _no_decoder
        self.running = True
        self._locks = [threading.Lock() for _ in range(n)]
        self._bufs: List[List[np.ndarray]] = [[] for _ in range(n)]
        self._last: List[Optional[np.ndarray]] = [None] * n
        self._alive = [True] * n
        self.frames_read = [0] * n
        self.frames_dropped = [0] * n
        self._caps = []
        self._threads = []
        for i, s in enumerate(self.sources):
            try:
                cap = self._open(s)
            except BaseException:
                self.close()
                raise
            if cap is None or not cap.isOpened():
                self.close()
                raise ConnectionError(f"cannot open stream {i}: {s}")
            ok, frame = cap.read()
            if not ok or frame is None:
                self.close()
                raise ConnectionError(f"stream {i} opened but yields no frames: {s}")
            self._bufs[i].append(frame)
            self._last[i] = frame
            self.frames_read[i] = 1
            self._caps.append(cap)
        for i, cap in enumerate(self._caps):
            t = threading.Thread(target=self._reader, args=(i, cap), daemon=True,
                                 name=f"stream-{i}")
            self._threads.append(t)
            t.start()
        LOGGER.info(f"LoadStreams: {n} stream(s) up, vid_stride={self.vid_stride}")

    def _reader(self, i: int, cap):
        """Grab every frame, retrieve every vid_stride-th."""
        n = 0
        try:
            while self.running and cap.isOpened():
                if self.buffer and len(self._bufs[i]) >= self.MAX_BUFFER:
                    time.sleep(self.poll_s)  # the consumer is behind
                    continue
                n += 1
                if not cap.grab():
                    break
                if n % self.vid_stride:
                    continue
                ok, frame = cap.retrieve()
                if not ok or frame is None:
                    break
                with self._locks[i]:
                    if self.buffer:
                        self._bufs[i].append(frame)
                    else:
                        if self._bufs[i]:
                            self.frames_dropped[i] += 1
                        self._bufs[i] = [frame]
                    self._last[i] = frame
                    self.frames_read[i] += 1
        finally:
            self._alive[i] = False
            try:
                cap.release()
            except Exception:
                pass

    def _pending(self, i: int) -> bool:
        return bool(self._bufs[i]) or self._alive[i]

    def __iter__(self):
        return self

    def __next__(self):
        if not self.running or not any(self._pending(i) for i in range(len(self.sources))):
            raise StopIteration
        frames, paths = [], []
        for i, s in enumerate(self.sources):
            while self._alive[i] and not self._bufs[i]:
                time.sleep(self.poll_s)
            with self._locks[i]:
                # an ended stream re-serves its last frame: the batch keeps its shape
                frame = self._bufs[i].pop(0) if self._bufs[i] else self._last[i]
            frames.append(frame)
            paths.append(f"{s}#frame{self.frames_read[i] - len(self._bufs[i]) - 1}")
        return paths, frames

    def __len__(self):
        return len(self.sources)

    def close(self):
        self.running = False
        for t in getattr(self, "_threads", []):
            t.join(timeout=2.0)
        for cap in getattr(self, "_caps", []):
            try:
                cap.release()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
