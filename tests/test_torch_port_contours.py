"""The port's contour finder (``ops/contours.py``, no cv2) against
``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``: the same
contours, points and order exactly, on the seg160 floor set's predicted
masks and on seeded blobs, rings with islands, one-pixel points and lines,
diagonal chains, masks touching the image edge and non-binary values;
``contour_area`` against ``cv2.contourArea`` to 1e-9; the largest contour
picked as ``max(..., key=cv2.contourArea)`` picks it (the first of equal
areas); ``Masks.xy`` and ``.xyn`` equal to the JAX ``Masks``'."""
import cv2
import numpy as np
import pytest
import torch

from chip_smoke import CKPT, floor_val_set
from yolo_contour_regression_tpu.engine.results import Masks as JaxMasks
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine.results import Masks
from yolo_contour_regression_tpu_torch.ops.contours import (contour_area,
                                                            find_contours_external,
                                                            largest_contour)

AREA_ATOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same_as_cv2(mask):
    want, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    got = find_contours_external(mask)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        assert abs(contour_area(g) - cv2.contourArea(w)) <= AREA_ATOL
    return len(want)


def _kind(kind, rng, h, w):
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((h, w), np.uint8)
    if kind == "blobs":
        for _ in range(rng.integers(1, 6)):
            cy, cx, r = rng.uniform(-5, h + 5), rng.uniform(-5, w + 5), rng.uniform(1, 12)
            m |= ((yy - cy) ** 2 / rng.uniform(0.5, 2) + (xx - cx) ** 2 <= r * r).astype(np.uint8)
    elif kind == "rings_with_islands":
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        d = np.hypot(yy - cy, xx - cx)
        r = rng.uniform(8, 14)
        m[(d < r) & (d > r - rng.uniform(2, 5))] = 1
        m[d < rng.uniform(1, 4)] = 1  # an island in the hole
        m[(d < 0.6)] = 0  # a hole in the island
    elif kind == "points_and_lines":
        for _ in range(rng.integers(1, 8)):
            y, x = rng.integers(0, h), rng.integers(0, w)
            if rng.random() < 0.5:
                m[y, x] = 1
            else:
                m[y, x:x + rng.integers(1, 12)] = 1 if rng.random() < 0.5 else 0
                m[y:y + rng.integers(1, 12), x] = 1
    elif kind == "diagonal_chains":
        for _ in range(rng.integers(1, 6)):
            y, x = rng.integers(0, h), rng.integers(0, w)
            dy, dx = rng.choice([-1, 1], 2)
            for i in range(rng.integers(1, 15)):
                if 0 <= y + i * dy < h and 0 <= x + i * dx < w:
                    m[y + i * dy, x + i * dx] = 1
    elif kind == "edge_touching":
        m[:rng.integers(1, h + 1), :rng.integers(1, 6)] = 1
        m[rng.integers(0, h):, rng.integers(0, w):] = 1
        m[0, :] = rng.random(w) < 0.5
    elif kind == "random":
        m = (rng.random((h, w)) < rng.uniform(0.1, 0.9)).astype(np.uint8)
    else:  # values other than 0 and 1
        m = (rng.random((h, w)) < 0.4).astype(np.uint8) * rng.integers(1, 256, (h, w)).astype(
            np.uint8)
    return m


@pytest.mark.parametrize("kind", ["blobs", "rings_with_islands", "points_and_lines",
                                  "diagonal_chains", "edge_touching", "random", "values"])
def test_find_contours_equals_cv2(kind):
    rng = np.random.default_rng(len(kind))
    n = 0
    for _ in range(60):
        h, w = rng.integers(1, 48, 2)
        n += _same_as_cv2(_kind(kind, rng, int(h), int(w)))
    assert n > 0


def test_one_pixel_and_empty_masks():
    assert find_contours_external(np.zeros((5, 7), np.uint8)) == []
    for h, w, y, x in ((1, 1, 0, 0), (3, 3, 1, 1), (4, 6, 0, 5), (4, 6, 3, 0)):
        m = np.zeros((h, w), np.uint8)
        m[y, x] = 1
        assert _same_as_cv2(m) == 1
    assert largest_contour(np.zeros((4, 4), np.uint8)).shape == (0, 2)


def test_floor_set_masks_equal_cv2():
    """The masks the seg160 checkpoint predicts on the 16 floor val images
    (CPU, the cv2-rule fill), each traced as cv2 traces it."""
    images, _ = floor_val_set()
    res = YOLO(CKPT, device="cpu").predict(images, imgsz=160, conf=0.1)
    n = 0
    for r in res:
        for m in r.masks.data.astype(np.uint8):
            n += _same_as_cv2(m)
            want, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
            np.testing.assert_array_equal(
                largest_contour(m), max(want, key=cv2.contourArea).reshape(-1, 2).astype(
                    np.float32))
    assert n >= 16


def test_largest_takes_the_first_of_equal_areas():
    m = np.zeros((20, 30), np.uint8)
    m[2:6, 2:6] = 1
    m[10:14, 20:24] = 1  # the same area, found first by cv2 (bottom up)
    m[15:17, 2:4] = 1
    want, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    np.testing.assert_array_equal(largest_contour(m),
                                  max(want, key=cv2.contourArea).reshape(-1, 2))


def test_masks_xy_equals_jax():
    rng = np.random.default_rng(3)
    data = np.stack([_kind(k, rng, 40, 64) for k in ("blobs", "rings_with_islands",
                                                     "edge_touching", "diagonal_chains")]
                    + [np.zeros((40, 64), np.uint8)]).astype(bool)
    got, want = Masks(data, (40, 64)), JaxMasks(data, (40, 64))
    assert len(got.xy) == len(want.xy) == 5
    for a, b in zip(got.xy + got.xyn, want.xy + want.xyn):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
