"""The PyTorch port's ops against the JAX package's (polar decode, GT rays
and polar geometry, boxes, NMS, polygon fill, letterbox), on the CPU. Inputs
are made from a seed with numpy and handed to both."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yolo_contour_regression_tpu.data import augment as jaug
from yolo_contour_regression_tpu.ops import boxes as jboxes
from yolo_contour_regression_tpu.ops import nms as jnms
from yolo_contour_regression_tpu.ops import polar as jpolar
from yolo_contour_regression_tpu.ops import raster as jraster
from yolo_contour_regression_tpu.ops import pallas_polar as jpallas_polar
from yolo_contour_regression_tpu.ops.pallas_raster import fill_polygons_pallas
from yolo_contour_regression_tpu_torch.data import augment as taug
from yolo_contour_regression_tpu_torch.ops import boxes as tboxes
from yolo_contour_regression_tpu_torch.ops import gt_rays as tgt_rays
from yolo_contour_regression_tpu_torch.ops import nms as tnms
from yolo_contour_regression_tpu_torch.ops import polar as tpolar
from yolo_contour_regression_tpu_torch.ops import raster as traster

from chip_smoke import ray_contours, ray_inputs, ray_mismatches
from tests.test_nms import numpy_greedy_nms


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# f32 decode math in a different op order / fusion than XLA's: 1e-5 absolute
# on pixel-scale values (< 1e3) is a few ulps
DECODE_ATOL = 1e-5
# GT rays: a ray is a distance picked from the same f32 arithmetic, so it
# agrees to a few ulps unless one rounding of atan2 (torch's against XLA's,
# or the Pallas kernels' polynomial) picks another point at the 3-degree gate
# or at a 4th/5th-nearest tie; at most 0.1% of the rays may do so, each one
# named and shown to sit within 1e-3 degrees of a gate or a tie
RAY_RTOL = 1e-5
RAY_MAX_FLIPS = 1e-3
# the polar geometry: elementwise f32 and sums over 36 rays
GEOM_TOL = 1e-6


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
    # the port resizes in cv2's own 11-bit fixed point: byte for byte
    np.testing.assert_array_equal(got, want)


def _assert_rays_match(got, want, contours, rows, centers, what):
    """``got`` equals ``want`` within RAY_RTOL, except for at most
    RAY_MAX_FLIPS of the rays, each at a gate or a tie (printed)."""
    got, want = np.asarray(got).reshape(-1, 36), np.asarray(want).reshape(-1, 36)
    assert got.shape == want.shape
    diffs = ray_mismatches(got, want, contours, rows, centers, rtol=RAY_RTOL)
    for d in diffs:
        print(f"{what}: pair {d[0]} ray {d[1]}: {d[2]:.6f} vs {d[3]:.6f}, at a gate or tie: {d[4]}")
    assert all(d[4] for d in diffs), f"{what}: a ray differs away from any gate or tie"
    assert len(diffs) <= RAY_MAX_FLIPS * got.size, f"{what}: {len(diffs)} rays differ"


def _ray_pairs(seed, P, size=256.0):
    """P seeded (contour, center) pairs, centers inside and outside."""
    rng = np.random.default_rng(seed + 100)
    contours, c, r = ray_contours(P, seed, size)
    centers = (c + rng.uniform(-1.5, 1.5, (P, 2)) * r[:, None]).astype(np.float32)
    return contours, centers


@pytest.mark.parametrize("seed,P", [(0, 64), (1, 257)])
def test_gt_rays_dense_and_chunked_match_jax(seed, P):
    contours, centers = _ray_pairs(seed, P)
    rows = np.arange(P)
    want = np.asarray(jpolar._gt_rays_dense(jnp.asarray(contours), jnp.asarray(centers)))
    got = tpolar._gt_rays_dense(_t(contours), _t(centers)).numpy()
    _assert_rays_match(got, want, contours, rows, centers, "_gt_rays_dense")
    # chunked: slabs of 100 pairs, the last one ragged
    want = np.asarray(jpolar.gt_rays_from_contour(jnp.asarray(contours), jnp.asarray(centers),
                                                  chunk=100))
    got = tpolar.gt_rays_from_contour(_t(contours), _t(centers), chunk=100).numpy()
    _assert_rays_match(got, want, contours, rows, centers, "gt_rays_from_contour")
    np.testing.assert_array_equal(tgt_rays.gt_rays_pairs_plain(_t(contours), _t(centers)).numpy(),
                                  tpolar._gt_rays_dense(_t(contours), _t(centers)).numpy())


def test_gt_rays_dense_ties_take_lowest_index():
    """A circle about its own center: the 4th and 5th nearest points of
    every ray tie in angle; the stable sort takes the lower index, as
    lax.top_k does, and the rays equal the JAX ones."""
    t = np.linspace(0, 2 * np.pi, 360, endpoint=False)
    r = 10.0 + np.arange(360) * 0.01  # distinct distances, so a pick shows
    contour = np.stack([50 + r * np.cos(t), 50 + r * np.sin(t)], -1).astype(np.float32)[None]
    center = np.full((1, 2), 50.0, np.float32)
    got = tpolar._gt_rays_dense(_t(contour), _t(center)).numpy()
    want = np.asarray(jpolar._gt_rays_dense(jnp.asarray(contour), jnp.asarray(center)))
    _assert_rays_match(got, want, contour, [0], center, "ties")


def test_gt_rays_rows_plain_matches_pallas3_interpret():
    """Rows form against the v3 kernel in interpret mode (K = 13 is not a
    multiple of its 8-pair blocks): equal at valid pairs within the
    allowance; RAY_EPS exactly at invalid ones."""
    contours, centers, valid = ray_inputs(6, 13, seed=3)
    valid[2, :] = False
    want = np.asarray(jpallas_polar.gt_rays_rows_fast(
        jnp.asarray(contours), jnp.asarray(centers), jnp.asarray(valid), interpret=True))
    got = tgt_rays.gt_rays_rows_plain(_t(contours), _t(centers), _t(valid)).numpy()
    assert got.shape == (6, 13, 36)
    rows = np.nonzero(valid)[0]
    _assert_rays_match(got[valid], want[valid], contours, rows, centers[valid], "rows vs v3")
    assert (got[~valid] == np.float32(tpolar.RAY_EPS)).all()
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = tgt_rays.gt_rays_rows_fast.launches
    np.testing.assert_array_equal(
        tgt_rays.gt_rays_rows_fast(_t(contours), _t(centers), _t(valid)).numpy(), got)
    assert tgt_rays.gt_rays_rows_fast.launches == before


def test_gt_rays_pairs_plain_matches_pallas_v1_v2_interpret():
    contours, centers = _ray_pairs(4, 21)  # not a multiple of the 8-pair blocks
    rows = np.arange(21)
    got = tgt_rays.gt_rays_pairs_plain(_t(contours), _t(centers)).numpy()
    for fn in (jpallas_polar.gt_rays_pallas, jpallas_polar.gt_rays_pallas2):
        want = np.asarray(fn(jnp.asarray(contours), jnp.asarray(centers), interpret=True))
        _assert_rays_match(got, want, contours, rows, centers, fn.__name__)
    before = tgt_rays.gt_rays_fast.launches
    np.testing.assert_array_equal(tgt_rays.gt_rays_fast(_t(contours), _t(centers)).numpy(), got)
    assert tgt_rays.gt_rays_fast.launches == before


def test_gt_ray_wrappers_refuse_mixed_devices():
    contours, centers, valid = ray_inputs(2, 4, seed=0)
    with pytest.raises(ValueError):
        tgt_rays.gt_rays_rows_fast(_t(contours), _t(centers).to("meta"), _t(valid))
    with pytest.raises(ValueError):
        tgt_rays.gt_rays_fast(_t(contours[:, 0:1].repeat(360, 1)).to("meta"),
                              _t(centers[:, 0]).to("meta"))


@pytest.mark.parametrize("seed", [0, 1])
def test_polar_geometry_matches(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 200, (3, 50, 2)).astype(np.float32)
    ctr = rng.uniform(50, 150, (3, 2)).astype(np.float32)
    np.testing.assert_allclose(tpolar.point_angles_deg(_t(pts), _t(ctr)).numpy(),
                               np.asarray(jpolar.point_angles_deg(jnp.asarray(pts),
                                                                  jnp.asarray(ctr))),
                               rtol=GEOM_TOL, atol=GEOM_TOL)
    a = rng.uniform(-1, 40, (4, 9, 36)).astype(np.float32)
    b = rng.uniform(1e-6, 40, (4, 9, 36)).astype(np.float32)
    a[0, 0, :3] = tpolar.RAY_EPS  # at the clamp
    w = rng.uniform(0, 1, (4, 9)).astype(np.float32)
    np.testing.assert_allclose(tpolar.polar_mask_iou(_t(a), _t(b)).numpy(),
                               np.asarray(jpolar.polar_mask_iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=GEOM_TOL, atol=GEOM_TOL)
    np.testing.assert_allclose(tpolar.polar_centerness(_t(b)).numpy(),
                               np.asarray(jpolar.polar_centerness(jnp.asarray(b))),
                               rtol=GEOM_TOL, atol=GEOM_TOL)
    # the loss and its gradient w.r.t. the predicted rays (jnp.clip's and
    # jnp.maximum's half-and-half split at equality included)
    ta = _t(a).requires_grad_()
    tl = tpolar.mask_iou_loss(ta, _t(b), _t(w), 3.0)
    tl.backward()
    jl, jg = jax.value_and_grad(lambda x: jpolar.mask_iou_loss(x, jnp.asarray(b), jnp.asarray(w),
                                                                3.0))(jnp.asarray(a))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=GEOM_TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg), rtol=GEOM_TOL, atol=GEOM_TOL)
