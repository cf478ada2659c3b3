"""Track base class and lifecycle states (counterpart of the JAX package's
``trackers/basetrack.py``). ``_count`` is class-level: every tracker resets
it when it is built, so ids start at 1 per tracker."""
from __future__ import annotations


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


class BaseTrack:
    _count = 0

    def __init__(self):
        self.track_id = 0
        self.state = TrackState.New
        self.frame_id = 0
        self.start_frame = 0

    @property
    def end_frame(self):
        return self.frame_id

    @staticmethod
    def next_id() -> int:
        BaseTrack._count += 1
        return BaseTrack._count

    @staticmethod
    def reset_id():
        BaseTrack._count = 0

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed
