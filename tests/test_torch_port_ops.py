"""The PyTorch port's ops against the JAX package's (polar decode, boxes,
NMS, polygon fill, letterbox), on the CPU. Inputs are made from a seed with
numpy and handed to both."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from yolo_contour_regression_tpu.data import augment as jaug
from yolo_contour_regression_tpu.ops import boxes as jboxes
from yolo_contour_regression_tpu.ops import nms as jnms
from yolo_contour_regression_tpu.ops import polar as jpolar
from yolo_contour_regression_tpu.ops import raster as jraster
from yolo_contour_regression_tpu.ops.pallas_raster import fill_polygons_pallas
from yolo_contour_regression_tpu_torch.data import augment as taug
from yolo_contour_regression_tpu_torch.ops import boxes as tboxes
from yolo_contour_regression_tpu_torch.ops import nms as tnms
from yolo_contour_regression_tpu_torch.ops import polar as tpolar
from yolo_contour_regression_tpu_torch.ops import raster as traster

from tests.test_nms import numpy_greedy_nms

# f32 decode math in a different op order / fusion than XLA's: 1e-5 absolute
# on pixel-scale values (< 1e3) is a few ulps
DECODE_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_polar_constants_match():
    for name in ("NUM_RAYS", "RAY_STEP_DEG", "NUM_CONTOUR_POINTS", "ANGLE_TOPK",
                 "ANGLE_GAP_DEG", "RAY_EPS", "VALID_RAY_THRESH"):
        assert getattr(tpolar, name) == getattr(jpolar, name), name
    np.testing.assert_allclose(tpolar.ray_angles().numpy(), np.asarray(jpolar.ray_angles()),
                               atol=1e-7)


def test_make_anchors_matches():
    feat_hw, strides = [(20, 12), (10, 6), (5, 3)], [8, 16, 32]
    ja, js = jpolar.make_anchors(feat_hw, strides)
    ta, ts = tpolar.make_anchors(feat_hw, strides)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=DECODE_ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=DECODE_ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_rays_and_boxes_match(seed):
    rng = np.random.default_rng(seed)
    rays = rng.uniform(-2, 60, (2, 50, 36)).astype(np.float32)
    rays[0, 0, :5] = [0.0, 1.0, 1.5, -1.0, 0.5]  # clamp and threshold edges
    anc = rng.uniform(0, 320, (50, 2)).astype(np.float32)
    jp, jv, jb = jpolar.decode_rays(jnp.asarray(rays), jnp.asarray(anc))
    tp, tv, tb = tpolar.decode_rays(_t(rays), _t(anc))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=DECODE_ATOL)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=DECODE_ATOL)
    jbo = jpolar.decode_ray_boxes(jnp.asarray(rays), jnp.asarray(anc))
    np.testing.assert_allclose(tpolar.decode_ray_boxes(_t(rays), _t(anc)).numpy(),
                               np.asarray(jbo), atol=DECODE_ATOL)


def test_box_ops_match():
    rng = np.random.default_rng(3)
    xywh = np.concatenate([rng.uniform(0, 200, (40, 2)), rng.uniform(1, 50, (40, 2))], -1)
    xywh = xywh.astype(np.float32)
    np.testing.assert_allclose(tboxes.xywh2xyxy(_t(xywh)).numpy(),
                               np.asarray(jboxes.xywh2xyxy(jnp.asarray(xywh))), atol=1e-5)
    b = tboxes.xywh2xyxy(_t(xywh))
    want = np.asarray(jboxes.box_iou(jnp.asarray(b.numpy()[:25]), jnp.asarray(b.numpy()[10:])))
    np.testing.assert_allclose(tboxes.box_iou(b[:25], b[10:]).numpy(), want, atol=1e-6)


def _nms_inputs(seed, B=2, A=300, nc=3):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, 300, (B, A, 2))
    wh = rng.uniform(8, 80, (B, A, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    logits = rng.normal(-1.0, 2.0, (B, A, nc)).astype(np.float32)
    extras = rng.uniform(0, 100, (B, A, 38)).astype(np.float32)
    return boxes, logits, extras


@pytest.mark.parametrize("seed,pre_nms,max_det,agnostic", [
    (0, 1024, 300, False), (1, 64, 30, False), (2, 128, 300, True),
])
def test_nms_parts_matches_jax(seed, pre_nms, max_det, agnostic):
    """Same kept rows, scores, classes and carried extras as the JAX NMS,
    with raw logits as the predictor passes them."""
    boxes, logits, extras = _nms_inputs(seed)
    kw = dict(conf_thres=0.25, iou_thres=0.6, pre_nms=pre_nms, max_det=max_det,
              agnostic=agnostic, scores_are_logits=True)
    want = jnms.non_max_suppression_parts(
        jnp.asarray(boxes), jnp.asarray(logits), jnp.asarray(extras), **kw)
    got = tnms.non_max_suppression_parts(_t(boxes), _t(logits), _t(extras), **kw)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].sum() > 5
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-6)
    np.testing.assert_array_equal(got["boxes"].numpy(), np.asarray(want["boxes"]))
    np.testing.assert_array_equal(got["extras"].numpy(), np.asarray(want["extras"]))


@pytest.mark.parametrize("trial", range(5))
def test_nms_fixpoint_matches_sequential_greedy(trial):
    rng = np.random.default_rng(42 + trial)
    n = 64
    centers = rng.uniform(20, 200, (n, 2))
    wh = rng.uniform(10, 60, (n, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0.3, 1.0, n).astype(np.float32)
    want = numpy_greedy_nms(boxes, scores, 0.5)
    out = tnms.batched_nms(
        _t(boxes)[None], _t(scores)[None], torch.zeros(1, n, dtype=torch.long),
        torch.zeros(1, n, 1), conf_thres=0.0, iou_thres=0.5, pre_nms=n, max_det=n,
        agnostic=True,
    )
    got = out["scores"][0][out["valid"][0]].numpy()
    np.testing.assert_allclose(np.sort(got)[::-1], np.sort(scores[want])[::-1], atol=1e-6)


def test_nms_pads_past_candidates():
    boxes, logits, extras = _nms_inputs(5, B=1, A=10)
    out = tnms.non_max_suppression_parts(_t(boxes), _t(logits), _t(extras), max_det=16,
                                         conf_thres=0.0)
    assert out["valid"].shape == (1, 16) and not out["valid"][0, 10:].any()
    assert (out["classes"][0, 10:] == -1).all()


def _star_polygons(seed, N, V, H, W):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 2 * np.pi, (N, V)), axis=1)
    r = rng.uniform(2, min(H, W) * 0.45, (N, V))
    c = rng.uniform(0.2, 0.8, (N, 1, 2)) * np.array([W, H])
    pts = np.stack([np.cos(t), np.sin(t)], -1) * r[..., None] + c
    valid = rng.uniform(size=(N, V)) > 0.2
    return pts.astype(np.float32), valid


def test_collapse_invalid_vertices_matches():
    pts, valid = _star_polygons(0, 6, 36, 48, 64)
    valid[1, :5] = False  # leading run wraps to the last valid vertex
    valid[2, -7:] = False
    valid[3] = False
    want = np.asarray(jraster.collapse_invalid_vertices(jnp.asarray(pts), jnp.asarray(valid)))
    got = traster.collapse_invalid_vertices(_t(pts), _t(valid)).numpy()
    np.testing.assert_array_equal(got, want)


def _boundary_ok(got, want, pts, valid):
    """At most 0.01% of pixels differ, and each differing pixel lies within
    1e-3 px of an edge crossing of its row: XLA on the CPU may contract
    ``x0 + t * (x1 - x0)`` into an FMA, which moves xi by an ulp."""
    diff = np.argwhere(got != want)
    assert len(diff) <= 1e-4 * got.size, len(diff)
    col = traster.collapse_invalid_vertices(_t(pts), _t(valid)).numpy().astype(np.float64)
    for n, y, x in diff:
        p0, p1 = col[n], np.roll(col[n], -1, axis=0)
        cross = (p0[:, 1] > y) != (p1[:, 1] > y)
        xi = p0[cross, 0] + (y - p0[cross, 1]) / (p1[cross, 1] - p0[cross, 1]) * (
            p1[cross, 0] - p0[cross, 0])
        assert np.abs(xi - x).min() < 1e-3, (n, y, x)


@pytest.mark.parametrize("hw", [(32, 32), (48, 64), (61, 37)])
def test_fill_polygons_plain_matches_jax(hw):
    H, W = hw
    pts, valid = _star_polygons(1, 8, 36, H, W)
    valid[0] = False  # all-invalid: empty mask
    valid[1, :4] = False
    valid[2, -4:] = False
    pts[3, 5:9, 1] = 20.0  # a horizontal run on an integer pixel row
    pts[4, :, 1] = np.round(pts[4, :, 1])  # every vertex on an integer row
    got = traster.fill_polygons_plain(_t(pts), _t(valid), H, W).numpy()
    want = np.asarray(jraster.fill_polygons(jnp.asarray(pts), jnp.asarray(valid), H, W))
    assert not got[0].any() and got[1:].any()
    _boundary_ok(got, want, pts, valid)
    want_k = np.asarray(fill_polygons_pallas(jnp.asarray(pts), jnp.asarray(valid), H, W,
                                             interpret=True))
    _boundary_ok(got, want_k, pts, valid)


def test_fill_polygon_single_and_dispatch():
    pts, valid = _star_polygons(2, 3, 12, 24, 24)
    batch = traster.fill_polygons_plain(_t(pts), _t(valid), 24, 24)
    one = traster.fill_polygon(_t(pts[1]), _t(valid[1]), 24, 24)
    np.testing.assert_array_equal(one.numpy(), batch[1].numpy())
    before = traster.fill_polygons.launches
    np.testing.assert_array_equal(traster.fill_polygons(_t(pts), _t(valid), 24, 24).numpy(),
                                  batch.numpy())
    assert traster.fill_polygons.launches == before  # CPU tensors never launch
    with pytest.raises(ValueError):
        traster.fill_polygons(_t(pts).to("meta"), _t(valid).to("meta"), 24, 24)


@pytest.mark.parametrize("shape,new", [((120, 200), 160), ((97, 61), 128), ((64, 64), 64),
                                       ((300, 250), 160)])
def test_letterbox_matches_jax(shape, new):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    img[: shape[0] // 2] = 40  # flat area plus noise
    want, wr, wpad = jaug.letterbox(img, (new, new))
    got, gr, gpad = taug.letterbox(img, (new, new))
    assert gr == wr and gpad == wpad and got.shape == want.shape and got.dtype == np.uint8
    # cv2 resizes uint8 in 11-bit fixed point, interpolate in float32
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
