"""``linear_sum_assignment`` without scipy: the same assignment as
``scipy.optimize.linear_sum_assignment``, not only one of the same cost.

scipy solves the rectangular problem by the shortest augmenting path of
Crouse (2016), "On implementing 2D rectangular assignment algorithms"
(``scipy/optimize/_lsap``); this module follows it step for step, in
float64 and in its order:

- A matrix with more rows than columns is solved transposed; the pairs then
  come back sorted by their row.
- Rows are added one at a time, ``cur_row`` 0, 1, ... For each, Dijkstra's
  search over the columns keeps ``remaining`` columns in a list filled in
  reverse (``nc - 1`` first) and removes a column by moving the list's last
  entry into its slot. A column's reduced cost is ``min_val + cost[i, j] -
  u[i] - v[j]``, evaluated left to right; among columns of equal lowest
  cost the first in the list wins, unless a later one is unassigned (it
  ends the path).
- An infeasible matrix (no finite path for some row) raises ``ValueError``,
  as do NaN and -inf entries.

Ties are the normal case in tracking: ``matching.linear_assignment`` sets
every cost above its gate to the same value, so the order above decides
which ids survive.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def _augmenting_path(nc: int, cost: List[List[float]], u: List[float], v: List[float],
                     path: List[int], row4col: List[int], spc: List[float], i: int,
                     sr: List[bool], sc: List[bool], remaining: List[int]):
    """One row's shortest augmenting path: ``(sink, min_val)``, sink -1
    when no finite path exists."""
    min_val = 0.0
    num_remaining = nc
    for it in range(nc):
        remaining[it] = nc - it - 1  # reversed: a constant matrix gives the identity
    for k in range(len(sr)):
        sr[k] = False
    for k in range(nc):
        sc[k] = False
        spc[k] = math.inf
    sink = -1
    while sink == -1:
        index, lowest = -1, math.inf
        sr[i] = True
        row, ui = cost[i], u[i]
        for it in range(num_remaining):
            j = remaining[it]
            r = min_val + row[j] - ui - v[j]
            if r < spc[j]:
                path[j] = i
                spc[j] = r
            if spc[j] < lowest or (spc[j] == lowest and row4col[j] == -1):
                lowest = spc[j]
                index = it
        min_val = lowest
        if min_val == math.inf:
            return -1, min_val
        j = remaining[index]
        if row4col[j] == -1:
            sink = j
        else:
            i = row4col[j]
        sc[j] = True
        num_remaining -= 1
        remaining[index] = remaining[num_remaining]
    return sink, min_val


def linear_sum_assignment(cost_matrix) -> Tuple[np.ndarray, np.ndarray]:
    """``(row_ind, col_ind)`` of a minimum-cost assignment of the 2-D
    ``cost_matrix`` (converted to float64), equal to scipy's."""
    c = np.asarray(cost_matrix)
    if c.ndim != 2:
        raise ValueError(f"expected a matrix (2-D array), got a {c.ndim} array")
    c = c.astype(np.float64)
    nr, nc = c.shape
    if nr == 0 or nc == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    transpose = nc < nr
    if transpose:
        c = c.T
        nr, nc = nc, nr
    if np.isnan(c).any() or (c == -np.inf).any():
        raise ValueError("matrix contains invalid numeric entries")
    cost = c.tolist()
    u, v = [0.0] * nr, [0.0] * nc
    spc = [math.inf] * nc
    path, col4row, row4col = [-1] * nc, [-1] * nr, [-1] * nc
    sr, sc, remaining = [False] * nr, [False] * nc, [0] * nc
    for cur_row in range(nr):
        sink, min_val = _augmenting_path(nc, cost, u, v, path, row4col, spc, cur_row, sr, sc,
                                         remaining)
        if sink < 0:
            raise ValueError("cost matrix is infeasible")
        u[cur_row] += min_val
        for i in range(nr):
            if sr[i] and i != cur_row:
                u[i] += min_val - spc[col4row[i]]
        for j in range(nc):
            if sc[j]:
                v[j] -= min_val - spc[j]
        j = sink
        while True:
            i = path[j]
            row4col[j] = i
            col4row[i], j = j, col4row[i]
            if i == cur_row:
                break
    if transpose:
        order = sorted(range(nr), key=lambda k: col4row[k])
        return (np.asarray([col4row[k] for k in order], np.int64),
                np.asarray(order, np.int64))
    return np.arange(nr, dtype=np.int64), np.asarray(col4row, np.int64)
