"""Multi-object trackers of the PyTorch port (host numpy): ByteTrack and
BoT-SORT, and ``track_results`` for ``YOLO.track``."""
from .bot_sort import BOTSORT
from .byte_tracker import BYTETracker
from .track import build_tracker, track_results

__all__ = ["BOTSORT", "BYTETracker", "build_tracker", "track_results"]
