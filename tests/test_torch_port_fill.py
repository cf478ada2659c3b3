"""The port's facade masks and letterbox against the JAX package's, exactly,
on the CPU: ``fill_polygons_cv2_plain`` against ``cv2.fillPoly`` (the rule
of the JAX facade's ``contours_to_masks_host``), ``Results.masks`` against
the JAX facade's on the seg160 checkpoint, and ``letterbox`` against the
JAX ``letterbox`` (``cv2.resize`` INTER_LINEAR). Inputs are made from a seed
with numpy and handed to both."""
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import shape_images
from yolo_contour_regression_tpu.data import augment as jaug
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.engine.results import contours_to_masks_host
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.data import augment as taug
from yolo_contour_regression_tpu_torch.engine.results import contours_to_masks
from yolo_contour_regression_tpu_torch.ops import raster


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

CKPT = Path(__file__).resolve().parent.parent / "runs" / "floor_seg160" / "best.ckpt"
H, W = 120, 160


def _cv2_masks(pts, valid, h, w):
    """The JAX facade's rule, drawn by cv2 itself."""
    out = np.zeros((len(pts), h, w), bool)
    for i, (p, ok) in enumerate(zip(pts, valid)):
        q = p[ok]
        if len(q) >= 3:
            buf = np.zeros((h, w), np.uint8)
            cv2.fillPoly(buf, [np.round(q * 8).astype(np.int32)], 1, shift=3)
            out[i] = buf.astype(bool)
    return out


def _gons(seed, n=40, v=36, spread=0.3, center=(0.4, 0.6)):
    """n seeded star-shaped v-gons: sorted angles, radii up to ``spread`` of
    the image's smaller side, centers in ``center`` of each axis."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 2 * np.pi, (n, v)), axis=1)
    r = rng.uniform(2, min(H, W) * spread, (n, v))
    c = rng.uniform(*center, (n, 1, 2)) * np.array([W, H])
    pts = np.stack([np.cos(t), np.sin(t)], -1) * r[..., None] + c
    return pts.astype(np.float32), np.ones((n, v), bool)


def _case(name):
    if name == "inside":
        return _gons(0)
    if name in ("left", "right", "top", "bottom"):
        pts, valid = _gons(1, spread=0.6)
        axis, sign = {"left": (0, -1), "right": (0, 1), "top": (1, -1), "bottom": (1, 1)}[name]
        pts[..., axis] += sign * 0.45 * (W, H)[axis]
        return pts, valid
    if name == "all_sides":  # larger than the image, leaving it on every side
        return _gons(2, spread=1.2, center=(0.2, 0.8))
    if name == "horizontal_edges":
        pts, valid = _gons(3)
        pts[:, 4:9, 1] = pts[:, 4:5, 1]
        pts[:, 20:23, 1] = np.round(pts[:, 20:21, 1])
        return pts, valid
    if name == "integer_rows":
        pts, valid = _gons(4, spread=0.6)
        pts[..., 1] = np.round(pts[..., 1])
        return pts, valid
    if name == "invalid_runs":
        pts, valid = _gons(5, spread=0.6)
        rng = np.random.default_rng(5)
        valid[:] = rng.uniform(size=valid.shape) > 0.2
        valid[::2, :7] = False  # a run at the start
        valid[1::2, -7:] = False  # and at the end
        return pts, valid
    if name == "few_valid":  # 0, 1, 2 valid vertices: empty masks; 3: a triangle
        pts, valid = _gons(6, n=8)
        valid[:] = False
        for i, k in enumerate((0, 1, 2, 3, 1, 2, 3, 2)):
            valid[i, np.random.default_rng(i).choice(36, k, replace=False)] = True
        return pts, valid
    raise KeyError(name)


CASES = ("inside", "left", "right", "top", "bottom", "all_sides", "horizontal_edges",
         "integer_rows", "invalid_runs", "few_valid")


@pytest.mark.parametrize("name", CASES)
def test_fill_polygons_cv2_plain_matches_cv2(name):
    pts, valid = _case(name)
    want = _cv2_masks(pts, valid, H, W)
    got = raster.fill_polygons_cv2_plain(torch.from_numpy(pts), torch.from_numpy(valid), H, W)
    assert int((got.numpy() != want).sum()) == 0
    if name == "few_valid":
        assert not want[valid.sum(1) < 3].any() and want[valid.sum(1) == 3].any()
    elif name != "all_sides":
        assert want.any((1, 2)).all()


def test_fill_polygons_cv2_dispatch():
    """CPU tensors take the plain version and never launch; another device
    raises; an empty batch gives an empty stack of masks."""
    pts, valid = _case("invalid_runs")
    p, v = torch.from_numpy(pts), torch.from_numpy(valid)
    before = raster.fill_polygons_cv2.launches
    np.testing.assert_array_equal(raster.fill_polygons_cv2(p, v, H, W).numpy(),
                                  raster.fill_polygons_cv2_plain(p, v, H, W).numpy())
    assert raster.fill_polygons_cv2.launches == before
    with pytest.raises(ValueError):
        raster.fill_polygons_cv2(p.to("meta"), v.to("meta"), H, W)
    assert raster.fill_polygons_cv2(p[:0], v[:0], H, W).shape == (0, H, W)


def test_contours_to_masks_matches_jax_host():
    """The same contours into both facades' fills: equal masks."""
    pts = np.concatenate([_case("invalid_runs")[0], _case("all_sides")[0]])
    valid = np.concatenate([_case("invalid_runs")[1], _case("all_sides")[1]])
    np.testing.assert_array_equal(contours_to_masks(pts, valid, H, W, device="cpu"),
                                  contours_to_masks_host(pts, valid, H, W))


def test_results_masks_match_jax_facade():
    """``YOLO.predict`` end to end on the seg160 checkpoint: the port's lazy
    masks equal the JAX facade's, pixel for pixel."""
    images = shape_images(2, 120, 200, seed=8) + shape_images(2, 333, 517, seed=9)
    tres = YOLO(CKPT, device="cpu").predict(images)
    jres = JaxYOLO(str(CKPT)).predict(images)
    assert [len(r) for r in tres] == [len(r) for r in jres]
    assert sum(len(r) for r in tres) >= len(images)
    for t, j in zip(tres, jres):
        assert t.masks.data.shape == j.masks.data.shape
        np.testing.assert_array_equal(t.masks.data, j.masks.data)


@pytest.mark.parametrize("shape,new", [((120, 200), 160), ((97, 61), 128), ((64, 64), 64),
                                       ((300, 250), 160), ((333, 517), 640), ((100, 100), 160),
                                       ((481, 641), 160)])
def test_letterbox_equals_jax(shape, new):
    """Down- and upscales, integer and non-integer ratios: byte for byte."""
    rng = np.random.default_rng(sum(shape) + new)
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    img[: shape[0] // 3] = 40  # a flat band plus noise
    want, wr, wpad = jaug.letterbox(img, (new, new))
    got, gr, gpad = taug.letterbox(img, (new, new))
    assert gr == wr and gpad == wpad and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
