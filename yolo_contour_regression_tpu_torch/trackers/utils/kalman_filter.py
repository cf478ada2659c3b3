"""Constant-velocity Kalman filters for multi-object tracking (counterpart
of the JAX package's ``trackers/utils/kalman_filter.py``), numpy in float64
as there: ``KalmanFilterXYAH`` (ByteTrack's state: centre x, centre y,
aspect, height and their velocities) and ``KalmanFilterXYWH`` (BoT-SORT's:
centre, width, height). Measurements enter as the tracks' float32 boxes and
are promoted where JAX's are, so the gates see the same numbers.
"""
from __future__ import annotations

import numpy as np


class KalmanFilterXYAH:
    """8-dim state (x, y, a, h, vx, vy, va, vh), 4-dim measurement."""

    ndim = 4

    def __init__(self):
        dt = 1.0
        self._motion_mat = np.eye(8)
        for i in range(4):
            self._motion_mat[i, 4 + i] = dt
        self._update_mat = np.eye(4, 8)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def _pos_scale(self, mean):
        return mean[3]  # height drives the noise scale

    def initiate(self, measurement: np.ndarray):
        mean = np.concatenate([measurement, np.zeros(4)])
        s = self._pos_scale(measurement)
        std = [
            2 * self._std_weight_position * s, 2 * self._std_weight_position * s,
            1e-2, 2 * self._std_weight_position * s,
            10 * self._std_weight_velocity * s, 10 * self._std_weight_velocity * s,
            1e-5, 10 * self._std_weight_velocity * s,
        ]
        return mean, np.diag(np.square(std))

    def _motion_cov(self, mean):
        s = self._pos_scale(mean)
        std_pos = [
            self._std_weight_position * s, self._std_weight_position * s,
            1e-2, self._std_weight_position * s,
        ]
        std_vel = [
            self._std_weight_velocity * s, self._std_weight_velocity * s,
            1e-5, self._std_weight_velocity * s,
        ]
        return np.diag(np.square(np.concatenate([std_pos, std_vel])))

    def _innovation_cov(self, mean):
        s = self._pos_scale(mean)
        std = [
            self._std_weight_position * s, self._std_weight_position * s,
            1e-1, self._std_weight_position * s,
        ]
        return np.diag(np.square(std))

    def predict(self, mean, covariance):
        mean = self._motion_mat @ mean
        covariance = (
            self._motion_mat @ covariance @ self._motion_mat.T + self._motion_cov(mean)
        )
        return mean, covariance

    def multi_predict(self, means, covariances):
        out_m, out_c = [], []
        for m, c in zip(means, covariances):
            m2, c2 = self.predict(m, c)
            out_m.append(m2)
            out_c.append(c2)
        return np.asarray(out_m), np.asarray(out_c)

    def project(self, mean, covariance):
        pm = self._update_mat @ mean
        pc = self._update_mat @ covariance @ self._update_mat.T + self._innovation_cov(mean)
        return pm, pc

    def update(self, mean, covariance, measurement):
        pm, pc = self.project(mean, covariance)
        K = np.linalg.solve(pc.T, (covariance @ self._update_mat.T).T).T
        innovation = measurement - pm
        new_mean = mean + K @ innovation
        new_cov = covariance - K @ pc @ K.T
        return new_mean, new_cov

    def gating_distance(self, mean, covariance, measurements, only_position=False):
        pm, pc = self.project(mean, covariance)
        if only_position:
            pm, pc = pm[:2], pc[:2, :2]
            measurements = measurements[:, :2]
        L = np.linalg.cholesky(pc)
        d = measurements - pm
        z = np.linalg.solve(L, d.T)
        return np.sum(z * z, axis=0)


class KalmanFilterXYWH(KalmanFilterXYAH):
    """BoT-SORT variant: state (x, y, w, h, ...); noise scales by w and h."""

    def initiate(self, measurement):
        mean = np.concatenate([measurement, np.zeros(4)])
        w, h = measurement[2], measurement[3]
        std = [
            2 * self._std_weight_position * w, 2 * self._std_weight_position * h,
            2 * self._std_weight_position * w, 2 * self._std_weight_position * h,
            10 * self._std_weight_velocity * w, 10 * self._std_weight_velocity * h,
            10 * self._std_weight_velocity * w, 10 * self._std_weight_velocity * h,
        ]
        return mean, np.diag(np.square(std))

    def _motion_cov(self, mean):
        w, h = mean[2], mean[3]
        std_pos = [
            self._std_weight_position * w, self._std_weight_position * h,
            self._std_weight_position * w, self._std_weight_position * h,
        ]
        std_vel = [
            self._std_weight_velocity * w, self._std_weight_velocity * h,
            self._std_weight_velocity * w, self._std_weight_velocity * h,
        ]
        return np.diag(np.square(np.concatenate([std_pos, std_vel])))

    def _innovation_cov(self, mean):
        w, h = mean[2], mean[3]
        std = [
            self._std_weight_position * w, self._std_weight_position * h,
            self._std_weight_position * w, self._std_weight_position * h,
        ]
        return np.diag(np.square(std))
