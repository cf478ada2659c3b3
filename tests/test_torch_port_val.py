"""The PyTorch port's segment validator against the JAX package's, on the
CPU: multi-label NMS, the inverse letterbox, ``polygon_mask_iou``, the
metrics, the label parsing and the val sample pipeline, one batch of
``eval_batch`` against JAX ``_make_eval_fn``, and ``YOLO.val`` end to end on
the seg160 floor set against the JAX validator. Inputs are made from a seed
with numpy (the floor set's JPEGs are decoded with cv2 here) and handed to
both packages; both hold the same weights."""
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import VAL_MASK_IOU_ATOL, compare_eval, eval_np, floor_val_set
from tests.helpers import make_shape_dataset
from yolo_contour_regression_tpu.cfg import get_cfg
from yolo_contour_regression_tpu.data import augment as jaug
from yolo_contour_regression_tpu.data import dataset as jdataset
from yolo_contour_regression_tpu.data import instance as jinstance
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.engine.validator import (
    SegmentationValidator as JaxSegmentationValidator)
from yolo_contour_regression_tpu.ops import boxes as jboxes
from yolo_contour_regression_tpu.ops import nms as jnms
from yolo_contour_regression_tpu.ops import raster as jraster
from yolo_contour_regression_tpu.utils import metrics as jmetrics
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.data import augment as taug
from yolo_contour_regression_tpu_torch.data import dataset as tdataset
from yolo_contour_regression_tpu_torch.data import instance as tinstance
from yolo_contour_regression_tpu_torch.data.build import ValLoader
from yolo_contour_regression_tpu_torch.engine.validator import SegmentationValidator
from yolo_contour_regression_tpu_torch.ops import boxes as tboxes
from yolo_contour_regression_tpu_torch.ops import nms as tnms
from yolo_contour_regression_tpu_torch.ops import raster as traster
from yolo_contour_regression_tpu_torch.utils import metrics as tmetrics


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs" / "floor_seg160" / "best.ckpt"
FLOOR = json.loads((ROOT / "runs" / "floor_seg160" / "floor.json").read_text())
FLOOR_NPZ = ROOT / "tests" / "data" / "torch_port_floor_seg160_val16.npz"
METRIC_KEYS = tuple(f"metrics/{m}({t})" for t in "BM"
                    for m in ("precision", "recall", "mAP50", "mAP50-95"))
# the port's validator against the JAX validator, each metric, absolute
METRIC_ATOL = 0.01
SCORE_ATOL = 1e-6  # NMS scores: one sigmoid of the same logit
GEOM_ATOL = 1e-6  # inverse letterbox and mask IoUs


@pytest.fixture(scope="module")
def floor_dir(tmp_path_factory):
    """The seg160 floor set as the JAX validator reads it (JPEGs and label
    files), made by ``make_shape_dataset`` at ``floor.json``'s config."""
    cfg = FLOOR["config"]
    root = tmp_path_factory.mktemp("floor_seg160")
    yaml = make_shape_dataset(root, n_train=cfg["n_train"], n_val=cfg["n_val"],
                              imgsz=cfg["imgsz"], seed=cfg["seed"])
    return root, yaml


def _val_files(root):
    files = sorted((root / "images" / "val").glob("*.jpg"))
    return files, [root / "labels" / "val" / (f.stem + ".txt") for f in files]


@pytest.fixture(scope="module")
def models():
    return JaxYOLO(str(CKPT)), YOLO(CKPT, device="cpu")


# --- multi-label NMS ------------------------------------------------------------


def _nms_inputs(seed, B=2, A=300, nc=2):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 120, (B, A, 2))
    wh = rng.uniform(8, 40, (B, A, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    logits = rng.normal(-3.0, 2.5, (B, A, nc)).astype(np.float32)
    extras = rng.uniform(0, 50, (B, A, 38)).astype(np.float32)
    return boxes, logits, extras


def _jax_thr(conf):
    c = jnp.float32(conf)
    safe = jnp.clip(c, 1e-12, 1.0 - 1e-7)
    return np.float32(jnp.log(safe) - jnp.log1p(-safe))


def _nms_case(name):
    """(boxes, logits, extras, keyword arguments) of one multi-label case."""
    kw = dict(conf_thres=0.001, iou_thres=0.7, pre_nms=1024, max_det=300)
    if name == "ties":  # equal logits for both classes of an anchor, and across anchors
        b, lg, ex = _nms_inputs(0)
        lg[:, :40, 1] = lg[:, :40, 0]
        lg[:, 40:80] = lg[:, 80:120]
        lg[0, 120:130] = 1.5
        return b, lg, ex, dict(kw, pre_nms=64)
    if name == "gate":  # logits exactly at the gate, and one ulp each side
        conf = 0.25
        thr = _jax_thr(conf)
        assert float(tnms.logit_threshold(conf)) == thr
        b, lg, ex = _nms_inputs(1)
        lg[:, 0:30, 0] = thr
        lg[:, 30:60, 1] = np.nextafter(thr, np.float32(np.inf))
        lg[:, 60:90, 0] = np.nextafter(thr, np.float32(-np.inf))
        return b, lg, ex, dict(kw, conf_thres=conf)
    if name == "conf_zero":
        b, lg, ex = _nms_inputs(2)
        return b, lg, ex, dict(kw, conf_thres=0.0, pre_nms=128, max_det=50)
    if name == "conf_negative":
        b, lg, ex = _nms_inputs(3)
        return b, lg, ex, dict(kw, conf_thres=-1.0, pre_nms=128, max_det=50)
    if name == "small":  # A * nc below pre_nms, and below max_det
        b, lg, ex = _nms_inputs(4, A=60, nc=3)
        return b, lg, ex, kw
    if name == "one_class":  # nc = 1: the best-class path
        b, lg, ex = _nms_inputs(5, nc=1)
        return b, lg, ex, kw
    if name == "val_shape":  # imgsz 160's 525 anchors, nc 2: the top-k cut at 1024
        b, lg, ex = _nms_inputs(6, B=4, A=525, nc=2)
        lg += 4.0
        return b, lg, ex, kw
    raise ValueError(name)


@pytest.mark.parametrize("name", ["ties", "gate", "conf_zero", "conf_negative", "small",
                                  "one_class", "val_shape"])
def test_multilabel_nms_matches_jax(name):
    """Multi-label NMS on logits against JAX ``non_max_suppression_parts``:
    the same valid rows, classes, boxes and extras (exactly), scores within
    ``SCORE_ATOL``."""
    b, lg, ex, kw = _nms_case(name)
    want = jnms.non_max_suppression_parts(jnp.asarray(b), jnp.asarray(lg), jnp.asarray(ex),
                                          multi_label=True, scores_are_logits=True, **kw)
    got = tnms.non_max_suppression_parts(torch.from_numpy(b), torch.from_numpy(lg),
                                         torch.from_numpy(ex), multi_label=True,
                                         scores_are_logits=True, **kw)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert want["valid"].any()
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for k in ("classes", "boxes", "extras"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=SCORE_ATOL, rtol=0)


def test_multilabel_nms_gate_and_ties_by_hand():
    """Two anchors, two classes, equal logits: both classes of the first
    anchor are candidates, the lower flat index first; a logit exactly at
    the gate is out, one ulp above it is in."""
    conf = 0.25
    thr = np.float32(tnms.logit_threshold(conf))
    up = np.nextafter(thr, np.float32(np.inf))
    boxes = torch.tensor([[[0, 0, 10, 10], [100, 100, 110, 110], [200, 0, 210, 10]]],
                         dtype=torch.float32)
    logits = torch.tensor([[[2.0, 2.0], [thr, up], [-9.0, 1.0]]], dtype=torch.float32)
    out = tnms.non_max_suppression_parts(boxes, logits, torch.zeros(1, 3, 1), conf_thres=conf,
                                         multi_label=True, scores_are_logits=True, max_det=5)
    v = out["valid"][0]
    assert out["classes"][0][v].tolist() == [0, 1, 1, 1]
    assert out["boxes"][0][v][:, 0].tolist() == [0.0, 0.0, 200.0, 100.0]


# --- geometry, mask IoU ---------------------------------------------------------


def test_scale_boxes_and_coords_match_jax():
    rng = np.random.default_rng(0)
    B, M, N, P = 3, 50, 4, 360
    ratio_pad = np.array([[0.5, 0.0, 80.0], [2.0, 13.0, 0.0], [4 / 3, 0.5, 7.5]], np.float32)
    ori = np.array([[480, 640], [100, 57], [300, 301]], np.float32)
    boxes = rng.uniform(-40, 700, (B, M, 4)).astype(np.float32)
    coords = rng.uniform(-40, 700, (B, N, P, 2)).astype(np.float32)
    want_b = np.asarray(jboxes.scale_boxes(jnp.asarray(boxes), jnp.asarray(ratio_pad),
                                           jnp.asarray(ori)))
    got_b = tboxes.scale_boxes(torch.from_numpy(boxes), torch.from_numpy(ratio_pad),
                               torch.from_numpy(ori)).numpy()
    np.testing.assert_allclose(got_b, want_b, atol=GEOM_ATOL, rtol=0)
    assert got_b.min() == 0.0 and (got_b[0, :, 2] <= 640).all() and (got_b[1, :, 3] <= 100).all()
    want_c = np.asarray(jboxes.scale_coords(jnp.asarray(coords), jnp.asarray(ratio_pad)))
    got_c = tboxes.scale_coords(torch.from_numpy(coords), torch.from_numpy(ratio_pad)).numpy()
    np.testing.assert_allclose(got_c, want_c, atol=GEOM_ATOL, rtol=0)
    assert got_c.min() < 0  # not clipped


def _iou_polygons(seed, n, v, h, w, off=False):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 2 * np.pi, (n, v)), axis=1)
    r = rng.uniform(1, 0.4 * max(h, w), (n, v))
    c = rng.uniform(0.2, 0.8, (n, 1, 2)) * np.array([w, h])
    if off:
        c += np.array([0.6 * w, -0.5 * h])
    pts = (np.stack([np.cos(t), np.sin(t)], -1) * r[..., None] + c).astype(np.float32)
    return pts, np.ones((n, v), bool)


def _iou_case(name):
    """(pts_a, valid_a, pts_b, valid_b, height, width)."""
    if name == "gt360_vs_pred36":
        return (*_iou_polygons(0, 5, 360, 64, 64), *_iou_polygons(1, 30, 36, 64, 64), 64, 64)
    if name == "invalid_runs":
        a, va = _iou_polygons(2, 4, 360, 48, 48)
        b, vb = _iou_polygons(3, 20, 36, 48, 48)
        va[0, :100], va[1, -50:], va[2, ::3] = False, False, False
        vb[:, :6], vb[3, 10:30] = False, False
        return a, va, b, vb, 48, 48
    if name == "all_invalid":
        a, va = _iou_polygons(4, 3, 360, 40, 40)
        b, vb = _iou_polygons(5, 6, 36, 40, 40)
        va[1], vb[0], vb[4] = False, False, False
        return a, va, b, vb, 40, 40
    if name == "off_grid":
        a, va = _iou_polygons(6, 3, 360, 50, 50, off=True)
        b, vb = _iou_polygons(7, 12, 36, 50, 50, off=True)
        return a, va, b, vb, 50, 50
    if name == "height_45_width_70":  # height not a multiple of the 32-row block
        return (*_iou_polygons(8, 4, 360, 45, 70), *_iou_polygons(9, 15, 36, 45, 70), 45, 70)
    if name == "one_row_block":
        return (*_iou_polygons(10, 2, 360, 20, 33), *_iou_polygons(11, 8, 36, 20, 33), 20, 33)
    raise ValueError(name)


IOU_CASES = ["gt360_vs_pred36", "invalid_runs", "all_invalid", "off_grid", "height_45_width_70",
             "one_row_block"]


@pytest.mark.parametrize("name", IOU_CASES)
def test_polygon_mask_iou_plain_matches_jax(name):
    """The plain version (the CPU path and the kernel path's oracle) against
    JAX ``polygon_mask_iou``, within ``GEOM_ATOL`` (the counts are exact, so
    it comes out equal); an all-invalid set has IoU 0."""
    a, va, b, vb, h, w = _iou_case(name)
    want = np.asarray(jraster.polygon_mask_iou(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                                               jnp.asarray(vb), h, w))
    got = traster.polygon_mask_iou(*(torch.from_numpy(x) for x in (a, va, b, vb)), h, w)
    assert got.dtype == torch.float32 and got.shape == (len(a), len(b))
    np.testing.assert_allclose(got.numpy(), want, atol=GEOM_ATOL, rtol=0)
    assert want.max() > 0
    dead_a, dead_b = ~va.any(-1), ~vb.any(-1)
    assert (got.numpy()[dead_a] == 0).all() and (got.numpy()[:, dead_b] == 0).all()


def test_polygon_mask_iou_block_rows_do_not_matter():
    """The plain version's row block changes nothing: the counts are exact."""
    a, va, b, vb, h, w = _iou_case("height_45_width_70")
    args = [torch.from_numpy(x) for x in (a, va, b, vb)]
    ref = traster.polygon_mask_iou_plain(*args, h, w)
    for block in (1, 7, 45, 64):
        assert torch.equal(traster.polygon_mask_iou_plain(*args, h, w, block=block), ref)


def test_polygon_mask_iou_rejects_other_devices():
    a = torch.zeros((1, 3, 2), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        traster.polygon_mask_iou(a, torch.ones((1, 3), dtype=torch.bool, device="meta"), a,
                                 torch.ones((1, 3), dtype=torch.bool, device="meta"), 8, 8)


# --- metrics --------------------------------------------------------------------


def _tp_tables(seed, n_img=12, nc=3):
    """Per image: (pred_cls, true_cls, iou (N, M), conf), with IoU ties,
    empty images and classes missing from either side."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_img):
        n, m = rng.integers(0, 6), rng.integers(0, 12)
        if i == 3:
            n = 0
        if i == 4:
            m = 0
        iou = rng.choice([0.0, 0.3, 0.5, 0.55, 0.7, 0.75, 0.9, 0.95, 0.99],
                         size=(n, m)).astype(np.float32)
        iou[:, ::3] = iou[:, :1] if n and m else iou[:, ::3]
        out.append((rng.integers(0, nc, m), rng.integers(0, nc - (i % 2), n), iou,
                    rng.choice([0.1, 0.5, 0.9, rng.uniform()], size=m).astype(np.float32)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_predictions_and_ap_match_jax(seed):
    """``match_predictions``, ``ap_per_class``, ``SegmentMetrics`` and the
    confusion matrix equal JAX's on seeded TP tables."""
    tm, jm = tmetrics.SegmentMetrics(), jmetrics.SegmentMetrics()
    tcm, jcm = tmetrics.ConfusionMatrix(3), jmetrics.ConfusionMatrix(3)
    rng = np.random.default_rng(seed + 100)
    for pred_cls, true_cls, iou, conf in _tp_tables(seed):
        got = tmetrics.match_predictions(pred_cls, true_cls, iou)
        want = jmetrics.match_predictions(pred_cls, true_cls, iou)
        np.testing.assert_array_equal(got, want)
        iou_m = np.clip(iou - 0.05, 0, 1).astype(np.float32)
        for m_, tp_b, tp_m in ((tm, got, tmetrics.match_predictions(pred_cls, true_cls, iou_m)),
                               (jm, want, jmetrics.match_predictions(pred_cls, true_cls, iou_m))):
            m_.box.update(tp_b, conf, pred_cls, true_cls)
            m_.seg.update(tp_m, conf, pred_cls, true_cls)
        pb = rng.uniform(0, 50, (len(pred_cls), 2)).astype(np.float32)
        gb = rng.uniform(0, 50, (len(true_cls), 2)).astype(np.float32)
        pb, gb = np.concatenate([pb, pb + 20], -1), np.concatenate([gb, gb + 20], -1)
        for cm in (tcm, jcm):
            cm.process_batch(pb, pred_cls, conf, gb, true_cls)
    tm.process()
    jm.process()
    assert tm.results_dict == jm.results_dict
    for key in ("classes", "precision", "recall", "ap"):
        np.testing.assert_array_equal(tm.box.results[key], jm.box.results[key])
        np.testing.assert_array_equal(tm.seg.results[key], jm.seg.results[key])
    np.testing.assert_array_equal(tm.seg.results["pr_curve"][1], jm.seg.results["pr_curve"][1])
    np.testing.assert_array_equal(tcm.matrix, jcm.matrix)
    assert tm.results_dict["metrics/mAP50-95(B)"] > 0


def test_compute_ap_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        rec = np.sort(rng.uniform(0, 1, 20))
        prec = rng.uniform(0, 1, 20)
        got, want = tmetrics.compute_ap(rec, prec), jmetrics.compute_ap(rec, prec)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


# --- labels and the sample pipeline ---------------------------------------------

LABEL_FILES = {
    "polygon": "0 0.1 0.1 0.5 0.1 0.5 0.6 0.1 0.6\n1 0.6 0.6 0.9 0.65 0.7 0.95\n",
    "box_only": "1 0.5 0.5 0.2 0.3\n0 0.25 0.75 0.1 0.1\n",
    "class_at_or_above_nc": "0 0.5 0.5 0.2 0.3\n2 0.1 0.1 0.4 0.1 0.4 0.4\n5 0.3 0.3 0.1 0.1\n",
    "empty": "",
    "short_lines": "0 0.5 0.5\n\n1 0.1 0.2 0.3 0.4\n",
    "keypoints_3": "0 0.5 0.5 0.2 0.2 0.5 0.5 2 0.6 0.5 1 0.5 0.6 0\n",
    "keypoints_2": "0 0.5 0.5 0.2 0.2 0.5 0.5 0.6 0.5 0.5 0.6\n",
}


@pytest.mark.parametrize("name", sorted(LABEL_FILES))
def test_parse_label_file_matches_jax(tmp_path, name):
    """Each line format, the ``c >= nc`` skip, empty, short lines and a
    missing file: the same arrays as JAX ``parse_label_file``."""
    path = tmp_path / "labels" / f"{name}.txt"
    path.parent.mkdir()
    path.write_text(LABEL_FILES[name])
    kpt = (3, 3) if name == "keypoints_3" else (3, 2) if name == "keypoints_2" else None
    for p, nc in ((path, None), (path, 2), (tmp_path / "missing.txt", 2)):
        got = tdataset.parse_label_file(str(p), nc=nc, kpt_shape=kpt)
        want = jdataset.parse_label_file(str(p), nc=nc, kpt_shape=kpt)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if name == "class_at_or_above_nc":
        assert len(tdataset.parse_label_file(str(path), nc=2)[0]) == 1


def test_resample_segment_and_label_path_match_jax():
    rng = np.random.default_rng(0)
    for m in (1, 3, 4, 24, 359, 360, 700):
        seg = rng.uniform(0, 1, (m, 2)).astype(np.float32)
        np.testing.assert_array_equal(tinstance.resample_segment(seg),
                                      jinstance.resample_segment(seg))
    np.testing.assert_array_equal(tinstance.resample_segment(np.zeros((0, 2))),
                                  jinstance.resample_segment(np.zeros((0, 2))))
    segs = rng.uniform(0, 1, (4, 360, 2)).astype(np.float32)
    np.testing.assert_array_equal(tinstance.segments2boxes(segs), jinstance.segments2boxes(segs))
    for p in ("/a/images/x/b.jpg", "/d/images/e/images/f.png", "rel/images/1.2.jpeg"):
        assert tdataset.img2label_path(p) == jdataset.img2label_path(p)


def _sample_pair(seed, h, w, n_inst):
    """The same image and pixel labels as a JAX and a port ``Sample``."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    xy = rng.uniform(0, 0.7, (n_inst, 2)) * np.array([w, h])
    xyxy = np.concatenate([xy, xy + rng.uniform(5, 30, (n_inst, 2))], -1).astype(np.float32)
    segs = rng.uniform(0, 1, (n_inst, 360, 2)).astype(np.float32) * np.array([w, h], np.float32)
    cls = rng.integers(0, 2, n_inst).astype(np.float32)
    return (jaug.Sample(img, jinstance.Instances(cls, xyxy, segs)),
            taug.Sample(img, tinstance.Instances(cls, xyxy, segs)))


@pytest.mark.parametrize("h,w,new,scaleup", [(120, 200, 160, False), (300, 500, 160, False),
                                             (90, 60, 160, True), (90, 60, 160, False),
                                             (160, 160, 160, False), (481, 641, 320, False)])
def test_letterbox_sample_and_format_match_jax(h, w, new, scaleup):
    """``letterbox(scaleup=...)``, ``letterbox_sample`` and ``format_sample``
    give JAX's arrays: the port's uint8 RGB image, as float / 255, equals
    JAX's float32 image bit for bit."""
    js, ts = _sample_pair(h + w, h, w, 5)
    jimg, jr, jpad = jaug.letterbox(js.img, (new, new), scaleup=scaleup)
    timg, tr, tpad = taug.letterbox(ts.img, (new, new), scaleup=scaleup)
    np.testing.assert_array_equal(timg, jimg)
    assert (tr, tpad) == (jr, jpad)
    jd = jaug.format_sample(jaug.letterbox_sample(js, new, scaleup=scaleup), 8)
    td = taug.format_sample(taug.letterbox_sample(ts, new, scaleup=scaleup), 8)
    assert set(td) == set(jd)
    assert td["img"].dtype == np.uint8
    np.testing.assert_array_equal(td["img"].astype(np.float32) / 255.0, jd["img"])
    for k in ("cls", "bboxes", "segments", "mask_gt", "ori_shape", "ratio_pad"):
        assert td[k].dtype == jd[k].dtype, k
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)


def test_collate_buckets_match_jax():
    """``collate`` trims the instance pad to the bucket of the batch's most
    instances, as JAX's."""
    for counts in ((1, 3), (9, 2), (17, 4), (33, 1), (48, 0), (0, 0)):
        jd, td = [], []
        for i, n in enumerate(counts):
            js, ts = _sample_pair(i + 10 * n, 64, 80, n)
            jd.append(jaug.format_sample(jaug.letterbox_sample(js, 64, scaleup=False), 48))
            td.append(taug.format_sample(taug.letterbox_sample(ts, 64, scaleup=False), 48))
        jb, tb = jaug.collate(jd), taug.collate(td)
        assert taug.INSTANCE_BUCKETS == jaug.INSTANCE_BUCKETS
        for k in ("cls", "bboxes", "segments", "mask_gt", "ori_shape", "ratio_pad"):
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=f"{counts} {k}")
        np.testing.assert_array_equal(tb["img"].astype(np.float32) / 255.0, jb["img"])


@pytest.mark.parametrize("imgsz", [160, 224])
def test_val_dataset_matches_jax_dataset(floor_dir, imgsz):
    """``ValDataset`` over the cv2-decoded floor images and their label
    files gives JAX ``YOLODataset``'s val samples, also where the image is
    first enlarged to ``imgsz`` (cv2's INTER_LINEAR, reproduced) or shrunk
    (cv2's INTER_AREA, reproduced: 160 to 80 takes its 2x2 fast path, to
    128 its fractional one)."""
    root, _ = floor_dir
    files, labels = _val_files(root)
    jds = jdataset.YOLODataset(str(root / "images" / "val"), imgsz=imgsz, augment=False,
                               cache=False)
    tds = tdataset.ValDataset([cv2.imread(str(f)) for f in files], labels, imgsz=imgsz)
    assert len(tds) == len(jds) == 16
    for i in (0, 5, 15):
        jd, td = jds[i], tds[i]
        np.testing.assert_array_equal(td["img"].astype(np.float32) / 255.0, jd["img"])
        for k in ("cls", "bboxes", "segments", "mask_gt", "ori_shape", "ratio_pad"):
            np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    for small in (80, 128):
        jds = jdataset.YOLODataset(str(root / "images" / "val"), imgsz=small, augment=False,
                                   cache=False)
        tds = tdataset.ValDataset([cv2.imread(str(f)) for f in files[:3]], labels[:3],
                                  imgsz=small)
        for i in range(3):
            jd, td = jds[i], tds[i]
            np.testing.assert_array_equal(td["img"].astype(np.float32) / 255.0, jd["img"])
            for k in ("bboxes", "segments", "ori_shape", "ratio_pad"):
                np.testing.assert_array_equal(td[k], jd[k], err_msg=k)


def test_floor_set_file_is_the_floor_set(floor_dir):
    """``tests/data/torch_port_floor_seg160_val16.npz`` (what the card run
    validates on, as the card's machine decodes no JPEG) holds exactly the
    floor set's val images, decoded by cv2, and their label files' text:
    regenerated here and compared byte for byte."""
    root, _ = floor_dir
    files, labels = _val_files(root)
    images = np.stack([cv2.imread(str(f)) for f in files])
    texts = np.array([p.read_text() for p in labels])
    z = np.load(FLOOR_NPZ)
    assert sorted(z.files) == ["images", "labels"]
    assert z["images"].dtype == np.uint8 and z["images"].shape == (16, 160, 160, 3)
    assert z["images"].tobytes() == images.tobytes()
    assert z["labels"].dtype == texts.dtype and z["labels"].tobytes() == texts.tobytes()
    got_images, got_labels = floor_val_set()
    for (c, b, s), p in zip(got_labels, labels):
        want = tdataset.parse_label_file(str(p))
        for g, w in zip((c, b, s), want):
            np.testing.assert_array_equal(g, w)


# --- eval_batch and the validator end to end --------------------------------------


def test_eval_batch_matches_jax_eval_fn(models):
    """One batch of 4 floor images through the port's ``eval_batch`` and JAX
    ``_make_eval_fn`` (the same collated batch, the same weights):
    ``compare_eval`` (the card run's check) holds, with no detection on one
    side only beyond the causes it names; GT boxes equal; matched masks' IoU
    within ``VAL_MASK_IOU_ATOL``."""
    jy, ty = models
    images, labels = floor_val_set()
    v = SegmentationValidator(imgsz=160, batch=4)
    batch = next(iter(v.loader(images, labels)))
    got = eval_np(v, ty.model, batch, "cpu")
    jv = JaxSegmentationValidator(get_cfg(overrides={"mode": "val", "imgsz": 160, "batch": 4}))
    fn = jax.jit(jv._make_eval_fn(jy.model, 1, 160))
    want = fn(jy.variables, jnp.asarray(batch["img"].astype(np.float32) / 255.0),
              *(jnp.asarray(batch[k]) for k in ("bboxes", "segments", "mask_gt", "ori_shape",
                                                "ratio_pad")))
    want = {k: np.asarray(x) for k, x in want.items()}
    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == want[k].shape, k
    cmp = compare_eval(got, want)
    assert cmp["ok"], cmp
    assert cmp["pairs"] >= 40 and cmp["ious_mask"] <= VAL_MASK_IOU_ATOL
    np.testing.assert_array_equal(got["gt_boxes"], want["gt_boxes"])


def test_yolo_val_matches_jax_validator(floor_dir, models):
    """``YOLO(..., device="cpu").val`` on the floor set's decoded images and
    label files against the JAX validator on the same files: each of the
    eight metrics within ``METRIC_ATOL``, and both floors met."""
    jy, ty = models
    root, yaml = floor_dir
    files, labels = _val_files(root)
    want = jy.val(data=str(yaml), imgsz=160, batch=4, project=str(root / "runs"))
    got = ty.val([cv2.imread(str(f)) for f in files], labels, imgsz=160, batch=4)
    assert set(got) == set(want)
    gaps = {k: abs(got[k] - want[k]) for k in METRIC_KEYS}
    print("port - JAX, per metric:", gaps)
    assert max(gaps.values()) <= METRIC_ATOL, gaps
    for key, name in FLOOR["floor_keys"].items():
        assert got[key] >= FLOOR["floor"][name], (key, got[key])
    assert set(ty.validator.speed) == {"preprocess", "eval", "matching"}


def test_val_loader_hands_over_the_short_batch():
    images, labels = floor_val_set()
    loader = ValLoader(tdataset.ValDataset(images[:7], labels[:7], imgsz=160), 3)
    sizes = [b["img"].shape[0] for b in loader]
    assert sizes == [3, 3, 1] and len(loader) == 3
