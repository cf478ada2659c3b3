"""Outer contours of binary masks without cv2 (host numpy and Python).

``find_contours_external(mask)`` is ``cv2.findContours(mask,
cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]`` and ``contour_area`` is
``cv2.contourArea``; ``largest_contour`` is ``max(contours,
key=cv2.contourArea)`` (the first on a tie), the rule of the JAX package's
``Masks.xy``, ``auto_annotate`` and ``convert_coco``.

The border following is Suzuki and Abe's (1985) as OpenCV implements it:

- The mask is binarized (nonzero is 1) and framed by one row and column of
  zeros, so a mask touching the image edge is traced like any other, and
  the points are shifted back by one.
- The scan runs in raster order. A pixel of value 1 whose left neighbour
  is 0 starts an outer border, unless the last traced border pixel met
  to its left on this row (``lnbd``; the frame at the row's start) is
  marked positive: then the pixel lies inside an outer border already
  traced (an island in a hole of another object) and RETR_EXTERNAL skips
  it. Holes are never traced.
- A border is followed from its start pixel with 8-connectivity: the first
  neighbour is searched clockwise from the upper-left (directions 3, 2, 1,
  0, 7, 6, 5, 4; 0 is +x, 2 is -y), then each next pixel counter-clockwise
  from the one after the direction back to the previous pixel. A pixel
  whose search passed its right neighbour (a 0) is marked negative, an
  unmarked one positive. A pixel with no neighbour is a contour of one
  point. The walk ends on returning to the start pixel about to leave it in
  the first direction again.
- CHAIN_APPROX_SIMPLE keeps a point where the chain changes direction.
- Contours come out in the reverse order of their start pixels (OpenCV
  prepends each to its list).
"""
from __future__ import annotations

from typing import List

import numpy as np

# chain code directions: 0 = +x, then counter-clockwise in image coordinates
DX = (1, 1, 0, -1, -1, -1, 0, 1)
DY = (0, -1, -1, -1, 0, 1, 1, 1)
MARK = 2  # OpenCV's nbd in this mode; -MARK marks a pixel right of its border


def _follow(img: np.ndarray, y0: int, x0: int) -> List[List[int]]:
    """Trace the outer border starting at padded pixel (y0, x0), marking
    ``img`` as OpenCV does; the points (x, y) in padded coordinates."""
    s_end = s = 4
    while True:
        s = (s - 1) & 7
        if img[y0 + DY[s], x0 + DX[s]] != 0 or s == s_end:
            break
    if s == s_end:  # no neighbour: a one-pixel contour
        img[y0, x0] = -MARK
        return [[x0, y0]]
    y1, x1 = y0 + DY[s], x0 + DX[s]
    pts = []
    y3, x3 = y0, x0
    prev_s = s ^ 4
    px, py = x0, y0
    while True:
        s_end = s
        while True:
            s += 1
            y4, x4 = y3 + DY[s & 7], x3 + DX[s & 7]
            if img[y4, x4] != 0:
                break
        s &= 7
        if (s - 1) & 0xFFFFFFFF < s_end:
            img[y3, x3] = -MARK
        elif img[y3, x3] == 1:
            img[y3, x3] = MARK
        if s != prev_s:
            pts.append([px, py])
            prev_s = s
        px += DX[s]
        py += DY[s]
        if (y4, x4) == (y0, x0) and (y3, x3) == (y1, x1):
            break
        y3, x3 = y4, x4
        s = (s + 4) & 7
    return pts


def find_contours_external(mask: np.ndarray) -> List[np.ndarray]:
    """The outer contours of a 2-D mask, each an (n, 1, 2) int32 array of
    (x, y) points, as ``cv2.findContours(mask, RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE)`` returns them (see the module docstring)."""
    m = np.asarray(mask)
    h, w = m.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = m != 0
    out = []
    for y in np.nonzero(img.any(1))[0]:
        row = img[y]  # a view: tracing marks it
        x, prev, lnbd = 1, 0, 0
        while x <= w:
            step = np.flatnonzero(row[x:w + 1] != prev)  # the next change of value
            if not len(step):
                break
            x += int(step[0])
            p = int(row[x])
            if prev == 0 and p == 1:
                if row[lnbd] <= 0:  # not inside an outer border traced before
                    out.append(_follow(img, y, x))
                    lnbd = x
                    p = int(row[x])
            elif p == 0 and prev >= 1 and prev != 1:  # a hole's start right of a mark
                lnbd = x - 1
            if p not in (0, 1):
                lnbd = x
            prev = p
            x += 1
    return [np.asarray(c, np.int32).reshape(-1, 1, 2) - 1 for c in reversed(out)]


def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea(contour)``: the absolute shoelace area, summed in
    float64 from the last point around, as OpenCV sums it."""
    p = np.asarray(contour, np.float64).reshape(-1, 2)
    if not len(p):
        return 0.0
    a = 0.0
    px, py = p[-1]
    for x, y in p:
        a += px * y - py * x
        px, py = x, y
    return abs(a * 0.5)


def largest_contour(mask: np.ndarray) -> np.ndarray:
    """The largest outer contour of ``mask`` as (n, 2) float32 pixels (the
    first of equal area), or (0, 2) when the mask is empty."""
    cs = find_contours_external(np.asarray(mask, np.uint8))
    if not cs:
        return np.zeros((0, 2), np.float32)
    return max(cs, key=contour_area).reshape(-1, 2).astype(np.float32)
