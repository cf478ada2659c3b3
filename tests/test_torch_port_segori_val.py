"""The PyTorch port's segment_ori validator, predictor, deploy fuse and
trainer against the JAX package on the CPU, and the ``agnostic_nms``
repair of every predictor. The narrow yolov8-segori graph with weights
trained by the port (``NARROW_CKPT``), a checkpoint both packages load; 48x64
frames of circles and rectangles written losslessly with their labels, so
both read the same pixels and the same polygons. The validator: one batch's
eval outputs (box and mask IoUs) against JAX's eval function, then the
metrics end to end. The predictor: boxes, scores, and masks equal except
pixels whose JAX value after cv2's float upsample lies within
``EDGE_TOL`` of the 0.5 threshold, each named. The trainer: 2 epochs on 8
images at 64 with the augmentation reduced to the identity, as
``test_torch_port_trainer.py`` runs the segment task."""
import contextlib
from functools import partial
from pathlib import Path

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import DETECT_CKPT, shape_images, shape_val_set
from tests.helpers import make_shape_dataset
from tests.test_torch_port_segori import NARROW
from tests.test_torch_port_trainer import IDENTITY_AUG, LOSS_RTOL, _np_tree, _rows
from tests.torch_port_jax_init import compiled_trainer_init
from yolo_contour_regression_tpu.cfg import get_cfg
from yolo_contour_regression_tpu.data import device_augment as jda
from yolo_contour_regression_tpu.engine import predictor as jpredictor
from yolo_contour_regression_tpu.engine import trainer as jtrainer
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.engine.validator import SegmentationOriValidator as JaxValidator
from yolo_contour_regression_tpu.nn import tasks as jtasks
from yolo_contour_regression_tpu.utils import checkpoint as jckpt
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine import predictor as tpredictor
from yolo_contour_regression_tpu_torch.engine import trainer as ttrainer
from yolo_contour_regression_tpu_torch.engine.validator import SegmentationOriValidator
from yolo_contour_regression_tpu_torch.nn.tasks import SegmentationOriModel
from yolo_contour_regression_tpu_torch.utils import checkpoint as tckpt

# each metric, absolute; one batch's eval outputs: boxes (px), scores, box
# IoUs, and mask IoUs (a mask pixel at the 0.5 edge may flip: one pixel of
# a 16x16 grid moves an IoU by up to 1/40 for the smallest shapes)
METRIC_ATOL = 0.01
BOX_PX, SCORE_ATOL, IOU_ATOL, MASK_IOU_ATOL = 0.05, 1e-4, 1e-3, 0.05
# a predicted mask pixel may differ from JAX's only where JAX's upsampled
# value is this close to 0.5 (the coefficients and prototypes differ by
# float32 summation order)
EDGE_TOL = 1e-4
IMGSZ, BATCH, H, W = 64, 4, 48, 64
PREDICT_CONF = 0.001  # the narrow model's scores are low (0.0001-0.03)
# the narrow graph trained by the port's ``SegmentationOriTrainer`` from
# scratch on the CPU: 150 epochs on ``shape_val_set(64, 48, 64, seed=1)`` at
# imgsz 64, batch 8, nbs 8, mixup 0, close_mosaic 20, validated on
# ``shape_val_set(8, 48, 64, seed=41)`` (the val set below; box mAP50 0.33,
# mask 0.31); its stripped best.ckpt
NARROW_CKPT = Path(__file__).resolve().parent / "data" / "torch_port_segori_narrow64.ckpt"
NAMES = {0: "circle", 1: "rect"}
# the trainers without their EMA validation (the validator is held to JAX's
# above; JAX's compile of it would double the test's time)
TRAIN = dict(task="segment_ori", model=NARROW, epochs=2, imgsz=64, batch=4, nbs=4, workers=1,
             amp=False, plots=False, verbose=False, seed=0, exist_ok=True, val=False,
             **IDENTITY_AUG)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _label_lines(lab):
    cls, _, segs = lab
    return "\n".join(f"{c} " + " ".join(f"{x:.6f} {y:.6f}" for x, y in s[::4])
                     for c, s in zip(cls, segs))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The narrow checkpoint ``NARROW_CKPT``, the val set on disk (PNG and
    label files) with its data yaml, and both facades."""
    tmp = tmp_path_factory.mktemp("segori_val")
    ckpt = NARROW_CKPT
    images, labels = shape_val_set(8, H, W, seed=41)
    for d in ("images/val", "labels/val", "images/train", "labels/train"):
        (tmp / "ds" / d).mkdir(parents=True)
    files = []
    for i, (img, lab) in enumerate(zip(images, labels)):
        cv2.imwrite(str(tmp / "ds" / "images" / "val" / f"{i:04d}.png"), img)
        files.append(tmp / "ds" / "labels" / "val" / f"{i:04d}.txt")
        files[-1].write_text(_label_lines(lab))
    yaml = tmp / "ds" / "data.yaml"
    yaml.write_text(f"path: {tmp / 'ds'}\ntrain: images/val\nval: images/val\n"
                    "names:\n  0: circle\n  1: rect\n")
    return {"ckpt": ckpt, "images": images, "labels": files, "yaml": yaml, "tmp": tmp,
            "jax": JaxYOLO(str(ckpt)), "port": YOLO(ckpt, device="cpu")}


def test_checkpoint_loads_as_segment_ori(setup):
    port = setup["port"]
    assert port.task == "segment_ori" and isinstance(port.model, SegmentationOriModel)
    assert port.imgsz == IMGSZ and port.names == NAMES


def test_eval_batch_matches_jax_eval_fn(setup):
    """One batch of 4 frames through the port's ``eval_batch`` and JAX
    ``_make_eval_fn`` (the same collated batch, the same weights): the same
    detections in the same slots, boxes, scores, box and mask IoUs within
    their tolerances (mask IoUs mostly equal), GT boxes equal."""
    port, jy = setup["port"], setup["jax"]
    v = SegmentationOriValidator(imgsz=IMGSZ, batch=BATCH)
    batch = next(iter(v.loader(setup["images"], setup["labels"])))
    dev = {k: torch.from_numpy(batch[k]) for k in v.eval_keys}
    got = {k: t.numpy() for k, t in v.eval_batch(port.model, dev).items()}
    jv = JaxValidator(get_cfg(overrides={"mode": "val", "imgsz": IMGSZ, "batch": BATCH}))
    fn = jax.jit(jv._make_eval_fn(jy.model, IMGSZ))
    want = fn(jy.variables, jnp.asarray(batch["img"].astype(np.float32) / 255.0),
              *(jnp.asarray(batch[k]) for k in
                ("bboxes", "segments", "mask_gt", "ori_shape", "ratio_pad")))
    want = {k: np.asarray(x) for k, x in want.items()}
    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=BOX_PX)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=SCORE_ATOL)
    np.testing.assert_allclose(got["ious_box"], want["ious_box"], atol=IOU_ATOL)
    np.testing.assert_array_equal(got["gt_boxes"], want["gt_boxes"])
    gap = np.abs(got["ious_mask"] - want["ious_mask"])
    print(f"mask IoUs: {int((gap > 0).sum())} of {gap.size} differ, at most {gap.max():.3e}")
    assert gap.max() <= MASK_IOU_ATOL and (gap > 0).mean() < 0.01
    assert int(got["valid"].sum()) >= 5 and float(got["ious_mask"].max()) > 0.5


def test_yolo_val_matches_jax_validator(setup):
    """``YOLO(..., device="cpu").val`` on the frames read back and their
    label files against the JAX validator on the same files: the eight
    metrics and fitness in JAX's order, each within ``METRIC_ATOL``; the
    stage marks in order."""
    want = setup["jax"].val(data=str(setup["yaml"]), imgsz=IMGSZ, batch=BATCH, plots=False,
                            project=str(setup["tmp"] / "jval"))
    files = sorted((setup["tmp"] / "ds" / "images" / "val").glob("*.png"))
    got = setup["port"].val([cv2.imread(str(f)) for f in files], setup["labels"], imgsz=IMGSZ,
                            batch=BATCH)
    assert list(got) == list(want)
    gaps = {k: abs(got[k] - want[k]) for k in want}
    print("port - JAX, per metric:", gaps, "JAX:", want)
    assert max(gaps.values()) <= METRIC_ATOL, gaps
    assert want["metrics/mAP50(B)"] > 0 and want["metrics/mAP50(M)"] > 0
    marks = []
    SegmentationOriValidator(imgsz=IMGSZ, batch=BATCH, mark=marks.append)(
        setup["port"].model, setup["images"], setup["labels"])
    assert marks[:4] == ["forward_nms", "scale_box_iou", "mask_iou", "end"]


class _ResizeRecorder:
    """cv2 with ``resize`` recording its float32 outputs (the JAX
    predictor's mask upsample), for the edge pixels' values."""

    def __init__(self):
        self.out = []

    def __getattr__(self, name):
        return getattr(cv2, name)

    def resize(self, src, dsize, *a, **kw):
        res = cv2.resize(src, dsize, *a, **kw)
        if src.dtype == np.float32:
            self.out.append(res)
        return res


def edge_mismatches(got: np.ndarray, want: np.ndarray, values: np.ndarray):
    """The pixels where the port's masks differ from JAX's, as (mask, y, x,
    JAX's upsampled value), and those of them not within ``EDGE_TOL`` of
    0.5."""
    diff = [(int(i), int(y), int(x), float(values[i, y, x]))
            for i, y, x in np.argwhere(got != want)]
    return diff, [d for d in diff if abs(d[3] - 0.5) > EDGE_TOL]


@pytest.fixture(scope="module")
def jax_predictions(setup):
    """Per frame size, the frames and the JAX facade's predict on them at
    ``PREDICT_CONF``, with the float values its mask upsample gave."""
    out = {}
    for shape in ((H, W), (120, 200)):
        images = setup["images"] if shape == (H, W) else shape_images(4, *shape, seed=42)
        rec = _ResizeRecorder()
        saved, jpredictor.cv2 = jpredictor.cv2, rec
        try:
            want = setup["jax"].predict(images, imgsz=IMGSZ, conf=PREDICT_CONF)
        finally:
            jpredictor.cv2 = saved
        out[shape] = (images, want, rec.out)
    return out


@pytest.mark.parametrize("shape", [(H, W), (120, 200)])
def test_predict_matches_jax(setup, jax_predictions, shape):
    """``YOLO.predict`` against the JAX facade's on frames of two sizes (the
    proto-grid crop, the pad stripped by ``int(round(pad * r))``, cv2's float
    INTER_LINEAR upsample): the same detections, boxes within ``BOX_PX``,
    scores within ``SCORE_ATOL``, masks (n, h, w) bool equal except pixels
    at the 0.5 edge (each named on failure)."""
    images, want, recorded = jax_predictions[shape]
    got = setup["port"].predict(images, imgsz=IMGSZ, conf=PREDICT_CONF)
    values = iter(recorded)
    n_det = n_edge = 0
    for g, w, img in zip(got, want, images):
        wd = np.asarray(w.boxes.data, np.float32)
        assert g.boxes.data.shape == wd.shape
        np.testing.assert_array_equal(g.boxes.cls, wd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, wd[:, :4], atol=BOX_PX)
        np.testing.assert_allclose(g.boxes.conf, wd[:, 4], atol=SCORE_ATOL)
        if not len(wd):
            assert g.masks is None and w.masks is None
            continue
        wm = np.asarray(w.masks.data)
        assert g.masks.data.shape == wm.shape == (len(wd), *img.shape[:2])
        vals = np.stack([next(values) for _ in range(len(wd))])
        diff, far = edge_mismatches(g.masks.data, wm, vals)
        assert not far, f"mask pixels off the 0.5 edge differ (mask, y, x, JAX value): {far[:20]}"
        n_det += len(wd)
        n_edge += len(diff)
    print(f"{n_det} detections, {n_edge} mask pixels at the 0.5 edge differ")
    assert n_det >= 5


def test_agnostic_nms_is_passed_through():
    """Every predictor hands ``agnostic_nms`` to NMS; on a frame of a circle
    over a rectangle, the floor_detect checkpoint's agnostic predict at conf
    0.05 and IoU 0.5 equals the JAX facade's, and differs from the
    per-class one (boxes of both classes overlap there)."""
    for cls in (tpredictor.SegmentationPredictor, tpredictor.DetectionPredictor,
                tpredictor.PosePredictor, tpredictor.SegmentationOriPredictor):
        assert cls(agnostic_nms=True).nms_kw["agnostic"] is True
        assert cls().nms_kw["agnostic"] is False
    img = np.full((96, 96, 3), 40, np.uint8)
    cv2.rectangle(img, (20, 20), (70, 70), (200, 120, 60), -1)
    cv2.circle(img, (52, 52), 24, (90, 220, 160), -1)
    port, jy = YOLO(DETECT_CKPT, device="cpu"), JaxYOLO(str(DETECT_CKPT))
    got = port.predict(img, conf=0.05, iou=0.5, agnostic_nms=True)[0]
    want = np.asarray(jy.predict(img, conf=0.05, iou=0.5, agnostic_nms=True)[0].boxes.data,
                      np.float32)
    per_class = port.predict(img, conf=0.05, iou=0.5)[0]
    assert got.boxes.data.shape == want.shape and len(got) >= 1
    assert len(np.unique(per_class.boxes.cls)) == 2
    assert (per_class.boxes.data.shape != got.boxes.data.shape
            or not np.allclose(per_class.boxes.data, got.boxes.data))
    np.testing.assert_array_equal(got.boxes.cls, want[:, 5])
    np.testing.assert_allclose(got.boxes.xyxy, want[:, :4], atol=BOX_PX)
    np.testing.assert_allclose(got.boxes.conf, want[:, 4], atol=SCORE_ATOL)


def test_fuse_keeps_the_heads_detections_and_metrics(setup, jax_predictions):
    """``YOLO.fuse`` folds the proto net's convs too: the fused model's head
    maps and prototypes within 1e-3 of the unfused, the same detections and
    masks, the same metrics; a JAX-fused and saved checkpoint loads fused,
    round-trips leaf for leaf, and predicts what the JAX model does (fusing
    moves the scores by float rounding)."""
    plain = YOLO(setup["ckpt"], device="cpu")
    fused = YOLO(setup["ckpt"], device="cpu").fuse()
    assert fused.model.fused and not any(isinstance(m, torch.nn.BatchNorm2d)
                                         for m in fused.model.modules())
    x = torch.from_numpy(np.random.default_rng(43).uniform(0, 1, (2, 3, 64, 64)).astype(
        np.float32))
    with torch.no_grad():
        (pl, pp), (fl, fp) = plain.model(x), fused.model(x)
    for a, b in zip(pl + [pp], fl + [fp]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-3)
    images = setup["images"][:3]
    for g, w in zip(fused.predict(images), plain.predict(images)):
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, atol=BOX_PX)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, atol=SCORE_ATOL)
        if len(w):
            assert (g.masks.data != w.masks.data).mean() < 1e-3
    want = plain.val(setup["images"], setup["labels"], imgsz=IMGSZ, batch=BATCH)
    got = fused.val(setup["images"], setup["labels"], imgsz=IMGSZ, batch=BATCH)
    assert max(abs(got[k] - want[k]) for k in want) <= METRIC_ATOL
    path = str(setup["tmp"] / "segori_fused.ckpt")
    jf = JaxYOLO(str(setup["ckpt"])).fuse()
    jf.save(path)
    ckpt = tckpt.load_checkpoint(path)
    ty = YOLO(path, device="cpu")
    assert ckpt["deploy"] == "fused" and ty.model.fused and ty.task == "segment_ori"
    params, _ = tckpt.to_jax_variables(ty.model.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(ckpt["params"])
    back = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(back) == len(leaves)
    for p, a in leaves:
        np.testing.assert_array_equal(back[p], a)
    images, want, _ = jax_predictions[(H, W)]
    for g, w in zip(ty.predict(images, conf=PREDICT_CONF), want):
        wd = np.asarray(w.boxes.data, np.float32)
        np.testing.assert_array_equal(g.boxes.cls, wd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, wd[:, :4], atol=BOX_PX)
        np.testing.assert_allclose(g.boxes.conf, wd[:, 4], atol=SCORE_ATOL)


# --- the trainer --------------------------------------------------------------

def _data(root):
    out = {"names": NAMES}
    for split in ("train", "val"):
        files = sorted((root / "images" / split).glob("*.jpg"))
        out[split] = ([cv2.imread(str(f)) for f in files],
                      [root / "labels" / split / (f.stem + ".txt") for f in files])
    return out


@contextlib.contextmanager
def recorded_jax_init():
    """JAX's trainer initializes its model once (``BaseModel.init`` from
    ``PRNGKey(seed)``): a numpy copy of those variables (taken before the
    step donates them) lands in the yielded dict's ``"v"``, so the port can
    start from them without a second init. The init stays eager: for the
    narrow classify config the compiled init (``compiled_trainer_init``,
    bit-identical) takes longer than the eager one."""
    seen, orig = {}, jtasks.BaseModel.init

    def init(self, *args, **kwargs):
        v = orig(self, *args, **kwargs)
        seen["v"] = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), v)
        return v

    jtasks.BaseModel.init = init
    try:
        yield seen
    finally:
        jtasks.BaseModel.init = orig


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both segment_ori trainers on the same data and initial weights,
    JAX's separable warp in float32 and its trainer one step per dispatch;
    the port's init replaced by JAX's (``PRNGKey(0)``, compiled: the same
    variables bit for bit as the eager init of this config), carried
    across."""
    tmp = tmp_path_factory.mktemp("segori_trainers")
    yaml = make_shape_dataset(tmp / "ds", n_train=8, n_val=4, imgsz=64, seed=0)
    warp = jda._warp_image_separable
    jda._warp_image_separable = partial(warp, dtype=jnp.float32)
    try:
        with compiled_trainer_init() as seen:
            jt = jtrainer.SegmentationOriTrainer(overrides={
                **TRAIN, "data": str(yaml), "steps_per_dispatch": 1,
                "project": str(tmp / "jax"), "name": "t"})
            jm = jt.train()
    finally:
        jda._warp_image_separable = warp
    init = seen["v"]

    def jax_init(model, generator):
        return tckpt.load_jax_variables(model, _np_tree(init["params"]),
                                        _np_tree(init["batch_stats"]))

    orig = ttrainer.init_weights
    ttrainer.init_weights = jax_init
    try:
        tt = ttrainer.SegmentationOriTrainer(
            overrides={**TRAIN, "project": str(tmp / "port"), "name": "t"}, device="cpu")
        tm = tt.train(_data(tmp / "ds"))
    finally:
        ttrainer.init_weights = orig
    return {"jax": (jt, jm), "port": (tt, tm), "yaml": yaml, "tmp": tmp}


def test_trainer_matches_jax(runs):
    """The same ``results.csv`` columns (box, cls, dfl and mask losses and
    the total) in JAX's order, each train loss within ``LOSS_RTOL``; both
    checkpoints with JAX's epoch, step and tree; ``YOLO(best.ckpt)``
    predicts masks."""
    (jt, jm), (tt, tm) = runs["jax"], runs["port"]
    jr, tr = _rows(jt.csv), _rows(tt.csv)
    assert list(tr[0]) == list(jr[0]) and len(tr) == len(jr) == 2
    assert {"train/mask_loss", "train/box_loss", "train/loss"} <= set(tr[0])
    for j, t in zip(jr, tr):
        for k in j:
            if k != "epoch":
                np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=LOSS_RTOL, err_msg=k)
    assert tm == jm == {} and tt.validator is None
    for name in ("best.ckpt", "last.ckpt"):
        j, t = jckpt.load_checkpoint(jt.wdir / name), tckpt.load_checkpoint(tt.wdir / name)
        assert (t["epoch"], t["step"]) == (j["epoch"], j["step"])
        jl = jax.tree_util.tree_leaves_with_path(j["params"])
        tl = jax.tree_util.tree_leaves_with_path(t["params"])
        assert [p for p, _ in jl] == [p for p, _ in tl]
        assert t["train_args"]["task"] == "segment_ori"
    m = YOLO(tt.wdir / "best.ckpt", device="cpu")
    res = m.predict(np.full((64, 64, 3), 40, np.uint8), imgsz=64, conf=0.0, max_det=5)
    assert m.task == "segment_ori" and res[0].masks.data.shape == (len(res[0].boxes), 64, 64)
