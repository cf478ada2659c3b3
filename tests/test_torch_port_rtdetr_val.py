"""The PyTorch port's RT-DETR validator and predictor against the JAX
package on the CPU, on the RT-DETR floor set (``make_shape_dataset`` at
``runs/floor_rtdetr/floor.json``'s config, decoded by cv2) with the
floor_rtdetr checkpoint: the committed copy of the val set (what the card
run validates on, as the card's machine decodes no JPEG) with the JAX
validator's metrics, one batch's eval outputs, the metrics end to end, the
fused model's, and the facade's predict against JAX's."""
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import (FLOOR_RTDETR_TRAIN, FLOOR_RTDETR_VAL, RTDETR_CKPT,
                        floor_rtdetr_jax_metrics, floor_rtdetr_val_set, shape_images)
from tests.helpers import make_shape_dataset
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.ops.boxes import box_iou as jbox_iou
from yolo_contour_regression_tpu.ops.boxes import scale_boxes as jscale_boxes
from yolo_contour_regression_tpu.ops.boxes import xywh2xyxy as jxywh2xyxy
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.data import dataset as tdataset
from yolo_contour_regression_tpu_torch.models.rtdetr import RTDETR, RTDETRPredictor, RTDETRValidator
from yolo_contour_regression_tpu_torch.nn.tasks import RTDETRDetectionModel

ROOT = Path(__file__).resolve().parent.parent
FLOOR = json.loads((ROOT / "runs" / "floor_rtdetr" / "floor.json").read_text())
METRIC_KEYS = ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
               "metrics/mAP50-95(B)", "fitness")
# the port's validator against the JAX validator, each metric, absolute
METRIC_ATOL = 0.01
# eval outputs and predictions: boxes (px), scores (a sigmoid of f32
# logits summed in other orders), IoUs with the GT
BOX_PX, SCORE_ATOL, IOU_ATOL = 0.05, 1e-4, 1e-3
IMGSZ, BATCH = 192, 4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_floor_set(root: Path):
    """The RT-DETR floor set as the JAX validator reads it (JPEGs and label
    files), made by ``make_shape_dataset`` at ``floor.json``'s config;
    returns the dataset yaml."""
    cfg = FLOOR["config"]
    return make_shape_dataset(root, n_train=cfg["n_train"], n_val=cfg["n_val"],
                              imgsz=cfg["imgsz"], seed=cfg["seed"])


def split_files(root: Path, split: str):
    files = sorted((root / "images" / split).glob("*.jpg"))
    return files, [root / "labels" / split / (f.stem + ".txt") for f in files]


def floor_arrays(root: Path, split: str):
    """A split's images, decoded by cv2 and stacked, and its label files'
    text."""
    files, labels = split_files(root, split)
    return (np.stack([cv2.imread(str(f)) for f in files]),
            np.array([p.read_text() for p in labels]))


def jax_floor_metrics(yaml: Path, project: Path) -> dict:
    return JaxYOLO(str(RTDETR_CKPT)).val(data=str(yaml), imgsz=IMGSZ, batch=BATCH, plots=False,
                                         project=str(project))


def write_floor_file(root: Path):
    """Write ``tests/data/torch_port_floor_rtdetr_val16.npz`` from a fresh
    floor set under ``root``: the decoded val images, their label text and
    the JAX validator's metrics of floor_rtdetr at batch 4."""
    yaml = make_floor_set(root)
    images, texts = floor_arrays(root, "val")
    want = jax_floor_metrics(yaml, root / "runs")
    np.savez_compressed(FLOOR_RTDETR_VAL, images=images, labels=texts,
                        jax_metric_names=np.array(list(want)),
                        jax_metrics=np.array([float(v) for v in want.values()]))


def write_train_file(root: Path):
    """Write ``tests/data/torch_port_floor_rtdetr_train64.npz`` from a fresh
    floor set under ``root``: the decoded train images and their label
    text (the set the card's floor run trains on)."""
    make_floor_set(root)
    images, texts = floor_arrays(root, "train")
    np.savez_compressed(FLOOR_RTDETR_TRAIN, images=images, labels=texts)


@pytest.fixture(scope="module")
def floor_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("floor_rtdetr")
    return root, make_floor_set(root)


@pytest.fixture(scope="module")
def jax_metrics(floor_dir):
    root, yaml = floor_dir
    return jax_floor_metrics(yaml, root / "runs")


@pytest.fixture(scope="module")
def models():
    return JaxYOLO(str(RTDETR_CKPT)), YOLO(RTDETR_CKPT, device="cpu")


def test_floor_set_file_is_the_floor_set(floor_dir):
    """The committed file holds exactly the floor set's 16 val images,
    decoded by cv2, and its label files' text: regenerated here and
    compared byte for byte; the parsed labels are ``parse_label_file``'s."""
    root, _ = floor_dir
    images, texts = floor_arrays(root, "val")
    with np.load(FLOOR_RTDETR_VAL) as z:
        assert z["images"].dtype == np.uint8 and z["images"].shape == (16, IMGSZ, IMGSZ, 3)
        assert z["images"].tobytes() == images.tobytes()
        assert z["labels"].dtype == texts.dtype and z["labels"].tobytes() == texts.tobytes()
    got_images, got_labels = floor_rtdetr_val_set()
    assert len(got_images) == 16
    for (c, b, s), p in zip(got_labels, split_files(root, "val")[1]):
        for g, w in zip((c, b, s), tdataset.parse_label_file(str(p))):
            np.testing.assert_array_equal(g, w)


def test_train_set_file_is_the_floor_set(floor_dir):
    """``tests/data/torch_port_floor_rtdetr_train64.npz`` (what the card's
    floor run trains on; ``write_train_file`` writes it) holds exactly the
    floor set's 64 train images, decoded by cv2, and their label files'
    text: regenerated here and compared byte for byte."""
    root, _ = floor_dir
    images, texts = floor_arrays(root, "train")
    z = np.load(FLOOR_RTDETR_TRAIN)
    assert sorted(z.files) == ["images", "labels"]
    assert z["images"].dtype == np.uint8 and z["images"].shape == (64, 192, 192, 3)
    assert z["images"].tobytes() == images.tobytes()
    assert z["labels"].dtype == texts.dtype and z["labels"].tobytes() == texts.tobytes()


def test_floor_set_file_holds_the_jax_metrics(jax_metrics):
    """The JAX validator's metrics stored with the set are what it gives on
    the regenerated set now, and meet the floor."""
    stored = floor_rtdetr_jax_metrics()
    assert list(stored) == list(jax_metrics) == list(METRIC_KEYS)
    for k in stored:
        assert stored[k] == pytest.approx(jax_metrics[k], rel=1e-9), k
    assert stored["metrics/mAP50-95(B)"] >= FLOOR["floor"]["box_mAP50-95"]


def test_yolo_loads_the_rtdetr_checkpoint(models):
    """The facade takes the task from the checkpoint; ``RTDETR`` is the
    same facade bound to the task, by default on rtdetr-l."""
    _, ty = models
    assert ty.task == "rtdetr" and isinstance(ty.model, RTDETRDetectionModel)
    assert ty.imgsz == IMGSZ and ty.names == {0: "circle", 1: "rect"}
    assert RTDETR(RTDETR_CKPT, device="cpu").task == "rtdetr"
    with pytest.raises(ValueError, match="rtdetr"):
        RTDETR(ROOT / "runs" / "floor_detect" / "best.ckpt", device="cpu")
    default = RTDETR(device="cpu")  # rtdetr-l, JAX's default, a fresh config
    assert default.task == "rtdetr" and default.overrides["model"] == "rtdetr-l.yaml"


def test_eval_batch_matches_jax(models):
    """One batch of 4 floor images through the port's ``eval_batch`` and
    the JAX validator's eval function (the same collated batch, the same
    weights): the same kept queries and classes, boxes in the image's
    frame, scores and box IoUs within their tolerances, GT boxes equal."""
    jy, ty = models
    images, labels = floor_rtdetr_val_set()
    v = RTDETRValidator(imgsz=IMGSZ, batch=BATCH)
    batch = next(iter(v.loader(images, labels)))
    got = {k: t.numpy() for k, t in v.eval_batch(
        ty.model, {k: torch.from_numpy(batch[k]) for k in v.eval_keys}).items()}
    imgs = jnp.asarray(batch["img"].astype(np.float32) / 255.0)
    pred = jax.jit(jy.model.predict)(jy.variables, imgs)  # eager: ~60 s of this test
    wh2 = jnp.asarray([IMGSZ, IMGSZ] * 2, jnp.float32)
    rp, osh = jnp.asarray(batch["ratio_pad"]), jnp.asarray(batch["ori_shape"])
    boxes = np.asarray(jscale_boxes(jxywh2xyxy(pred[..., :4]) * wh2, rp, osh))
    gt = jscale_boxes(jxywh2xyxy(jnp.asarray(batch["bboxes"])) * wh2, rp, osh)
    ious = np.asarray(jax.vmap(jbox_iou)(gt, jnp.asarray(boxes)))
    scores = np.asarray(pred[..., 4:])
    np.testing.assert_array_equal(got["classes"], scores.argmax(-1))
    np.testing.assert_array_equal(got["valid"], scores.max(-1) >= 0.001)
    np.testing.assert_allclose(got["scores"], scores.max(-1), atol=SCORE_ATOL)
    np.testing.assert_allclose(got["boxes"], boxes, atol=BOX_PX)
    np.testing.assert_allclose(got["ious_box"], ious, atol=IOU_ATOL)
    np.testing.assert_array_equal(got["gt_boxes"], np.asarray(gt))
    assert got["boxes"].shape == (BATCH, 300, 4)


def test_yolo_val_matches_jax_validator(floor_dir, models, jax_metrics):
    """``YOLO(floor_rtdetr, device="cpu").val`` on the floor set's JPEGs,
    decoded, and label files against the JAX validator on the same files:
    each metric within ``METRIC_ATOL`` (exact expected), and the floor met;
    no confusion matrix, as JAX's."""
    root, _ = floor_dir
    _, ty = models
    files, labels = split_files(root, "val")
    got = ty.val([cv2.imread(str(f)) for f in files], labels, imgsz=IMGSZ, batch=BATCH)
    assert list(got) == list(jax_metrics)
    gaps = {k: abs(got[k] - jax_metrics[k]) for k in METRIC_KEYS}
    print("port - JAX, per metric:", gaps)
    assert max(gaps.values()) <= METRIC_ATOL, gaps
    assert got["metrics/mAP50-95(B)"] >= FLOOR["floor"]["box_mAP50-95"]
    assert isinstance(ty.validator, RTDETRValidator) and ty.validator.confusion_matrix is None


def test_committed_floor_set_gives_the_stored_metrics(models):
    """The card run's input: the committed decoded set through the port's
    validator gives the stored JAX metrics within ``METRIC_ATOL``; the stage
    marks come in order; the fused model's metrics are the same."""
    _, ty = models
    marks = []
    v = RTDETRValidator(imgsz=IMGSZ, batch=BATCH, mark=marks.append)
    got = v(ty.model, *floor_rtdetr_val_set())
    want = floor_rtdetr_jax_metrics()
    assert max(abs(got[k] - want[k]) for k in METRIC_KEYS) <= METRIC_ATOL
    assert marks[:3] == ["forward", "scale_box_iou", "end"] and len(marks) == 12
    fused = YOLO(RTDETR_CKPT, device="cpu").fuse()
    got_f = fused.val(*floor_rtdetr_val_set(), imgsz=IMGSZ, batch=BATCH)
    assert max(abs(got_f[k] - got[k]) for k in METRIC_KEYS) <= METRIC_ATOL


def test_yolo_predict_matches_jax_facade(models):
    """``YOLO(floor_rtdetr).predict`` at imgsz 192 against the JAX facade, on
    floor-set images and on wider frames (letterboxed): the same kept
    queries in the same order, boxes within ``BOX_PX``, scores within
    ``SCORE_ATOL``; ``RTDETRPredictor`` is the facade's predictor."""
    jy, ty = models
    images = floor_rtdetr_val_set()[0][:4] + shape_images(2, 120, 200, seed=3)
    want = jy.predict(images, imgsz=IMGSZ)
    got = ty.predict(images, imgsz=IMGSZ, batch=3)
    assert len(got) == len(want) == len(images)
    n = 0
    for g, w in zip(got, want):
        assert g.masks is None and g.contours is None
        wd = np.asarray(w.boxes.data, np.float32)
        assert g.boxes.data.shape == wd.shape
        np.testing.assert_array_equal(g.boxes.cls, wd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, wd[:, :4], atol=BOX_PX)
        np.testing.assert_allclose(g.boxes.conf, wd[:, 4], atol=SCORE_ATOL)
        n += len(g)
    assert n >= 6
    direct = RTDETRPredictor(imgsz=IMGSZ, conf=0.25)(ty.model, images[:2], names=ty.names)
    for d, g in zip(direct, got):  # batch 1 against 3: other sum orders
        np.testing.assert_array_equal(d.boxes.cls, g.boxes.cls)
        np.testing.assert_allclose(d.boxes.xyxy, g.boxes.xyxy, atol=BOX_PX)
        np.testing.assert_allclose(d.boxes.conf, g.boxes.conf, atol=SCORE_ATOL)
