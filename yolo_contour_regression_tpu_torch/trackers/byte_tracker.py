"""BYTETracker, the two-stage (high and low score) association tracker
(counterpart of the JAX package's ``trackers/byte_tracker.py``, host numpy):
``STrack`` with the XYAH Kalman state, the three association stages (high
scores against tracked and lost tracks, low scores against the tracked
rest, unconfirmed tracks against the high scores left), the low-score
rescue and the expiry of tracks lost for longer than ``track_buffer``
frames. Boxes are float32 where JAX's are and the track lists keep
insertion order (``_joint``, ``_sub``): both decide which ids survive.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .basetrack import BaseTrack, TrackState
from .utils.kalman_filter import KalmanFilterXYAH
from .utils import matching


class STrack(BaseTrack):
    shared_kalman = KalmanFilterXYAH()

    def __init__(self, xywh, score, cls):
        super().__init__()
        self._tlwh = np.asarray(
            [xywh[0] - xywh[2] / 2, xywh[1] - xywh[3] / 2, xywh[2], xywh[3]],
            np.float32,
        )
        self.kalman_filter = None
        self.mean, self.covariance = None, None
        self.is_activated = False
        self.score = float(score)
        self.cls = int(cls)
        self.tracklet_len = 0
        self.idx = -1

    # -- geometry ----------------------------------------------------------
    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        x, y, a, h = self.mean[:4]
        w = a * h
        return np.asarray([x - w / 2, y - h / 2, w, h], np.float32)

    @property
    def xyxy(self):
        t = self.tlwh
        return np.asarray([t[0], t[1], t[0] + t[2], t[1] + t[3]], np.float32)

    @property
    def xywh(self):
        t = self.tlwh
        return np.asarray([t[0] + t[2] / 2, t[1] + t[3] / 2, t[2], t[3]], np.float32)

    @staticmethod
    def tlwh_to_xyah(tlwh):
        return np.asarray(
            [tlwh[0] + tlwh[2] / 2, tlwh[1] + tlwh[3] / 2, tlwh[2] / max(tlwh[3], 1e-6), tlwh[3]],
            np.float32,
        )

    # -- lifecycle ---------------------------------------------------------
    def activate(self, kalman_filter, frame_id: int):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = kalman_filter.initiate(self.tlwh_to_xyah(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = frame_id == 1
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track: "STrack", frame_id: int, new_id: bool = False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xyah(new_track.tlwh)
        )
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.cls = new_track.cls

    def update(self, new_track: "STrack", frame_id: int):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xyah(new_track.tlwh)
        )
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls

    def predict(self):
        mean = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean[7] = 0  # zero height-velocity when lost
        self.mean, self.covariance = self.kalman_filter.predict(mean, self.covariance)

    @staticmethod
    def multi_predict(tracks: List["STrack"]):
        for t in tracks:
            t.predict()

    @property
    def result(self):
        return np.concatenate(
            [self.xyxy, [self.track_id, self.score, self.cls]]
        ).astype(np.float32)


class BYTETracker:
    """The BYTE tracker; ``update`` takes one frame's detections."""

    def __init__(self, track_high_thresh=0.5, track_low_thresh=0.1, new_track_thresh=0.6,
                 track_buffer=30, match_thresh=0.8, frame_rate=30, fuse_score_flag=True):
        self.tracked: List[STrack] = []
        self.lost: List[STrack] = []
        self.removed: List[STrack] = []
        self.frame_id = 0
        self.track_high_thresh = track_high_thresh
        self.track_low_thresh = track_low_thresh
        self.new_track_thresh = new_track_thresh
        self.match_thresh = match_thresh
        self.fuse_score_flag = fuse_score_flag
        self.max_time_lost = int(frame_rate / 30.0 * track_buffer)
        self.kalman_filter = self._kf()
        BaseTrack.reset_id()

    def _kf(self):
        return KalmanFilterXYAH()

    def _new_tracks(self, xywhs, scores, clss):
        return [STrack(b, s, c) for b, s, c in zip(xywhs, scores, clss)]

    def update(self, boxes_xyxy: np.ndarray, scores: np.ndarray, classes: np.ndarray):
        """One frame. Returns (M, 7) [x1,y1,x2,y2,track_id,score,cls] of
        activated tracks."""
        self.frame_id += 1
        xywhs = np.concatenate(
            [(boxes_xyxy[:, :2] + boxes_xyxy[:, 2:4]) / 2, boxes_xyxy[:, 2:4] - boxes_xyxy[:, :2]],
            -1,
        ) if boxes_xyxy.size else np.zeros((0, 4), np.float32)

        hi = scores >= self.track_high_thresh
        lo = (scores > self.track_low_thresh) & ~hi
        dets_hi = self._new_tracks(xywhs[hi], scores[hi], classes[hi])
        dets_lo = self._new_tracks(xywhs[lo], scores[lo], classes[lo])

        unconfirmed = [t for t in self.tracked if not t.is_activated]
        tracked = [t for t in self.tracked if t.is_activated]
        pool = self._joint(tracked, self.lost)
        STrack.multi_predict(pool)

        activated, refind, lost, removed = [], [], [], []

        # stage 1: high-score
        dists = matching.iou_distance(pool, dets_hi)
        if self.fuse_score_flag:
            dists = matching.fuse_score(dists, dets_hi)
        matches, u_track, u_det = matching.linear_assignment(dists, self.match_thresh)
        for it, idet in matches:
            t, d = pool[it], dets_hi[idet]
            if t.state == TrackState.Tracked:
                t.update(d, self.frame_id)
                activated.append(t)
            else:
                t.re_activate(d, self.frame_id)
                refind.append(t)

        # stage 2: low-score against remaining previously-tracked
        r_tracked = [pool[i] for i in u_track if pool[i].state == TrackState.Tracked]
        dists = matching.iou_distance(r_tracked, dets_lo)
        matches, u_track2, _ = matching.linear_assignment(dists, 0.5)
        for it, idet in matches:
            t, d = r_tracked[it], dets_lo[idet]
            if t.state == TrackState.Tracked:
                t.update(d, self.frame_id)
                activated.append(t)
            else:
                t.re_activate(d, self.frame_id)
                refind.append(t)
        for i in u_track2:
            t = r_tracked[i]
            if t.state != TrackState.Lost:
                t.mark_lost()
                lost.append(t)

        # stage 3: unconfirmed vs leftover high-score dets
        dets_left = [dets_hi[i] for i in u_det]
        dists = matching.iou_distance(unconfirmed, dets_left)
        if self.fuse_score_flag:
            dists = matching.fuse_score(dists, dets_left)
        matches, u_unconf, u_det2 = matching.linear_assignment(dists, 0.7)
        for it, idet in matches:
            unconfirmed[it].update(dets_left[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for i in u_unconf:
            unconfirmed[i].mark_removed()
            removed.append(unconfirmed[i])

        # new tracks
        for i in u_det2:
            d = dets_left[i]
            if d.score >= self.new_track_thresh:
                d.activate(self.kalman_filter, self.frame_id)
                activated.append(d)

        # expire lost
        for t in self.lost:
            if self.frame_id - t.frame_id > self.max_time_lost:
                t.mark_removed()
                removed.append(t)

        self.tracked = [t for t in self.tracked if t.state == TrackState.Tracked]
        self.tracked = self._joint(self.tracked, activated)
        self.tracked = self._joint(self.tracked, refind)
        self.lost = self._sub(self.lost, self.tracked)
        self.lost.extend(lost)
        self.lost = self._sub(self.lost, removed)
        self.removed.extend(removed)

        out = [t.result for t in self.tracked if t.is_activated]
        return np.stack(out) if out else np.zeros((0, 7), np.float32)

    @staticmethod
    def _joint(a: List, b: List) -> List:
        seen = {t.track_id for t in a}
        return list(a) + [t for t in b if t.track_id not in seen]

    @staticmethod
    def _sub(a: List, b: List) -> List:
        ids = {t.track_id for t in b}
        return [t for t in a if t.track_id not in ids]
