"""Loaders (counterparts of the JAX package's ``data/build.py:DataLoader``):
``TrainLoader``, infinite and shuffled, collated by worker threads ahead of
the step; ``ValLoader``, one pass in dataset order, collated on the calling
thread. ``use_device_augment`` says whether a config takes the train path
with the augmentation on the device; the others take the host path, the
host chain in ``TrainDataset`` (classify's transforms in
``ClassificationDataset``) read by ``TrainLoader(..., in_order=True)``."""
from __future__ import annotations

import multiprocessing
import queue
import random
import threading
from typing import Dict, Iterator, List

import numpy as np

from .augment import collate


# the tasks whose train transforms the device augmentation covers (classify
# has transforms of its own, on the host)
DEVICE_AUGMENT_TASKS = ("detect", "segment", "segment_ori", "pose")


def use_device_augment(cfg) -> bool:
    """True where the JAX package would augment on the device (its
    ``data/build.py:use_device_augment``): ``device_augment`` on, a task of
    ``DEVICE_AUGMENT_TASKS`` (``detect`` when the config names none), no
    ``mosaic9`` and no ``copy_paste``. Otherwise the host train chain
    (``data/augment.py:train_transform``)."""
    return (bool(getattr(cfg, "device_augment", False))
            and getattr(cfg, "task", "detect") in DEVICE_AUGMENT_TASKS
            and float(getattr(cfg, "mosaic9", 0.0) or 0.0) == 0.0
            and float(getattr(cfg, "copy_paste", 0.0) or 0.0) == 0.0)


_RENDER_DATASET = None  # the dataset of a render process


def _hold_dataset(dataset):
    global _RENDER_DATASET
    _RENDER_DATASET = dataset


def _render(job):
    return _RENDER_DATASET.render(job)


class TrainLoader:
    """Endless batches of ``batch_size`` samples, each epoch in a new order
    drawn by ``random.Random(seed).shuffle`` (the JAX loader's order for the
    same seed), the last partial batch dropped. ``workers`` threads load
    and collate batches ahead into a bounded queue; they are handed out in
    index order whatever thread finishes first, so a run repeats itself with
    any number of workers (the JAX loader's order is that only with one). A
    worker's error is raised in the consumer, and an abandoned iterator
    stops its workers. ``in_order``: a dataset that draws its own
    randomness as it is read (``ClassificationDataset``, the host chain's
    ``TrainDataset``) is read by one thread at a time, batch after batch, so
    its draws follow the batch order as in the JAX loader with one worker;
    the collate stays parallel. A dataset with ``plan`` and ``render`` (see
    ``TrainDataset.plan``) has only its plans made in order: its pixels
    are rendered by ``workers`` forked processes, so the host chain's numpy
    work neither waits for one thread nor holds the interpreter lock the
    train step's launches need (the processes fork from this one, hold
    the dataset as it is then, and touch no CUDA).

    ``rank`` and ``world`` (data parallelism, ``parallel/mesh.py``):
    ``batch_size`` is the global batch; every rank walks the same order from
    the same seed and yields rows ``[rank * b, (rank + 1) * b)`` of each
    global batch (``b = batch_size // world``), rendering only those. A
    dataset that draws as it is read has its draws made for the whole global
    batch on every rank (``plan`` for all of it, else every sample read), so
    a sample's draws do not depend on ``world``."""

    def __init__(self, dataset, batch_size: int, workers: int = 4, seed: int = 0,
                 in_order: bool = False, rank: int = 0, world: int = 1):
        self.dataset = dataset
        self.batch_size = max(int(batch_size), 1)
        self.workers = max(int(workers), 1)
        self.rng = random.Random(seed)
        self.in_order = bool(in_order)
        if self.batch_size % int(world):
            raise ValueError(f"batch {self.batch_size} does not split over {world} ranks")
        b = self.batch_size // int(world)
        self.rows = slice(int(rank) * b, (int(rank) + 1) * b)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def _chunks(self) -> Iterator[List[int]]:
        while True:
            idx = list(range(len(self.dataset)))
            self.rng.shuffle(idx)
            idx = idx[: len(idx) - len(idx) % self.batch_size]
            for i in range(0, len(idx), self.batch_size):
                yield idx[i: i + self.batch_size]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if len(self) == 0:
            raise ValueError(f"{len(self.dataset)} samples make no batch of {self.batch_size}")
        chunks = enumerate(self._chunks())
        q: "queue.Queue" = queue.Queue(maxsize=self.workers * 2)
        stop = threading.Event()
        lock = threading.Lock()

        def qput(item) -> bool:
            # a put that gives up once the consumer is gone, so a worker
            # blocked on a full queue never outlives an abandoned iterator
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        plan = getattr(self.dataset, "plan", None) if self.in_order else None
        pool = None
        if plan is not None:  # forked here, before the loader's threads start
            pool = multiprocessing.get_context("fork").Pool(
                self.workers, initializer=_hold_dataset, initargs=(self.dataset,))

        def worker():
            while not stop.is_set():
                samples = jobs = None
                with lock:
                    seq, chunk = next(chunks)
                    if self.in_order:
                        try:
                            if plan is not None:
                                jobs = [plan(j) for j in chunk][self.rows]
                            else:
                                samples = [self.dataset[j] for j in chunk][self.rows]
                        except Exception as e:  # handed to the consumer, raised there
                            qput((seq, e))
                            return
                try:
                    if jobs is not None:
                        samples = [r.get() for r in [pool.apply_async(_render, (j,))
                                                     for j in jobs]]
                    elif samples is None:
                        samples = [self.dataset[j] for j in chunk[self.rows]]
                    item = collate(samples)
                except Exception as e:  # handed to the consumer, raised there
                    qput((seq, e))
                    return
                if not qput((seq, item)):
                    return

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.workers)]
        for t in threads:
            t.start()
        ahead, want = {}, 0
        try:
            while True:
                while want not in ahead:
                    seq, item = q.get()
                    ahead[seq] = item
                item = ahead.pop(want)
                want += 1
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            try:  # unblock a worker sitting in q.put
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            for t in threads:
                t.join(timeout=2.0)
            if pool is not None:
                pool.terminate()
                pool.join()


class ValLoader:
    """One pass over ``dataset`` in order, ``batch_size`` samples a batch.
    The last batch may be short; the JAX loader pads it to a fixed shape
    and reads only its first ``n_valid`` images, so the metrics are the
    same."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = max(int(batch_size), 1)

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for b0 in range(0, len(self.dataset), self.batch_size):
            stop = min(b0 + self.batch_size, len(self.dataset))
            yield collate([self.dataset[i] for i in range(b0, stop)])
