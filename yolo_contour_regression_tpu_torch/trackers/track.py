"""Trackers on a prediction stream (counterpart of the JAX package's
``trackers/track.py``): ``track_results`` runs one tracker over a
predictor's results and gives each result ``track_ids``, aligned with its
boxes: the id of the activated track whose box overlaps it with IoU above
0.5 (the best such), else -1. BOT-SORT also reads the frame for its camera
motion."""
from __future__ import annotations

from typing import Iterator

import numpy as np

from .bot_sort import BOTSORT
from .byte_tracker import BYTETracker
from .utils.matching import bbox_ious

TRACKERS = {"bytetrack": BYTETracker, "botsort": BOTSORT}


def build_tracker(name: str = "botsort", **kw):
    key = str(name).replace(".yaml", "")
    if key not in TRACKERS:
        raise ValueError(f"tracker '{name}' not in {list(TRACKERS)}")
    return TRACKERS[key](**kw)


def track_results(results_iter, tracker=None, tracker_type: str = "botsort") -> Iterator:
    """Yield each result of ``results_iter`` with ``track_ids`` set."""
    tracker = tracker or build_tracker(tracker_type)
    for res in results_iter:
        if res.boxes is None or len(res.boxes) == 0:
            res.track_ids = np.zeros((0,), int)
            yield res
            continue
        frame = res.orig_img if isinstance(tracker, BOTSORT) else None
        kw = {"frame": frame} if frame is not None else {}
        tracks = tracker.update(
            res.boxes.xyxy.copy(), res.boxes.conf.copy(), res.boxes.cls.copy(), **kw
        )
        ids = np.full(len(res.boxes), -1, int)
        if tracks.shape[0]:
            iou = bbox_ious(res.boxes.xyxy, tracks[:, :4])
            best = iou.argmax(1)
            ok = iou.max(1) > 0.5
            ids[ok] = tracks[best[ok], 4].astype(int)
        res.track_ids = ids
        yield res


__all__ = ["BYTETracker", "BOTSORT", "build_tracker", "track_results"]
