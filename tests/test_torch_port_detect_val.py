"""The PyTorch port's detect validator against the JAX package's on the
CPU, on the detect floor set (``make_shape_dataset`` at
``runs/floor_detect/floor.json``'s config, decoded by cv2) with the
floor_detect checkpoint: one batch's eval outputs, the metrics end to end,
the floor, and the committed copies of the set (what the card run
validates and trains on, as the card's machine decodes no JPEG)."""
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import (FLOOR_DETECT_TRAIN, FLOOR_DETECT_VAL, floor_detect_jax_metrics,
                        floor_detect_train_set, floor_detect_val_set)
from tests.helpers import make_shape_dataset
from yolo_contour_regression_tpu.cfg import get_cfg
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.data import dataset as tdataset
from yolo_contour_regression_tpu_torch.engine.validator import DetectionValidator


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
CKPT = ROOT / "runs" / "floor_detect" / "best.ckpt"
FLOOR = json.loads((ROOT / "runs" / "floor_detect" / "floor.json").read_text())
METRIC_KEYS = ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
               "metrics/mAP50-95(B)", "fitness")
# the port's validator against the JAX validator, each metric, absolute
METRIC_ATOL = 0.01
# one batch's eval outputs: boxes (px), scores (one sigmoid of f32 logits
# summed in other orders), and the box IoUs with the GT
BOX_PX, SCORE_ATOL, IOU_ATOL = 0.05, 1e-4, 1e-3
IMGSZ, BATCH = 96, 4


def make_floor_set(root: Path):
    """The detect floor set as the JAX trainer and validator read it (JPEGs
    and label files), made by ``make_shape_dataset`` at ``floor.json``'s
    config; returns the dataset yaml."""
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
    return JaxYOLO(str(CKPT)).val(data=str(yaml), imgsz=IMGSZ, batch=BATCH, plots=False,
                                  project=str(project))


def write_floor_files(root: Path):
    """Write ``tests/data/torch_port_floor_detect_{train64,val16}.npz`` from
    a fresh floor set under ``root``: the decoded images, the label text,
    and with the val split the JAX validator's metrics."""
    yaml = make_floor_set(root)
    images, texts = floor_arrays(root, "train")
    np.savez_compressed(FLOOR_DETECT_TRAIN, images=images, labels=texts)
    images, texts = floor_arrays(root, "val")
    want = jax_floor_metrics(yaml, root / "runs")
    np.savez_compressed(FLOOR_DETECT_VAL, images=images, labels=texts,
                        jax_metric_names=np.array(list(want)),
                        jax_metrics=np.array([float(v) for v in want.values()]))


@pytest.fixture(scope="module")
def floor_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("floor_detect")
    return root, make_floor_set(root)


@pytest.fixture(scope="module")
def jax_metrics(floor_dir):
    root, yaml = floor_dir
    return jax_floor_metrics(yaml, root / "runs")


@pytest.fixture(scope="module")
def port():
    return YOLO(CKPT, device="cpu")


@pytest.mark.parametrize("split,n,path", [("train", 64, FLOOR_DETECT_TRAIN),
                                          ("val", 16, FLOOR_DETECT_VAL)])
def test_floor_set_file_is_the_floor_set(floor_dir, split, n, path):
    """The committed file holds exactly the floor set's images, decoded by
    cv2, and its label files' text: regenerated here and compared byte for
    byte; the parsed labels are ``parse_label_file``'s."""
    root, _ = floor_dir
    images, texts = floor_arrays(root, split)
    with np.load(path) as z:
        assert z["images"].dtype == np.uint8 and z["images"].shape == (n, 96, 96, 3)
        assert z["images"].tobytes() == images.tobytes()
        assert z["labels"].dtype == texts.dtype and z["labels"].tobytes() == texts.tobytes()
    got_images, got_labels = (floor_detect_train_set if split == "train"
                              else floor_detect_val_set)()
    assert len(got_images) == n
    for (c, b, s), p in zip(got_labels, split_files(root, split)[1]):
        for g, w in zip((c, b, s), tdataset.parse_label_file(str(p))):
            np.testing.assert_array_equal(g, w)


def test_floor_set_file_holds_the_jax_metrics(jax_metrics):
    """The JAX validator's metrics stored with the val set are what it gives
    on the regenerated set now, and meet the floor."""
    stored = floor_detect_jax_metrics()
    assert list(stored) == list(jax_metrics) == list(METRIC_KEYS)
    for k in stored:
        assert stored[k] == pytest.approx(jax_metrics[k], rel=1e-9), k
    assert stored["metrics/mAP50-95(B)"] >= FLOOR["floor"]["box_mAP50-95"]


def test_eval_batch_matches_jax_eval_fn(port):
    """One batch of 4 floor images through the port's ``eval_batch`` and
    JAX ``_make_eval_fn`` (the same collated batch, the same weights): the
    same detections in the same slots, boxes, scores and box IoUs within
    their tolerances, GT boxes equal."""
    images, labels = floor_detect_val_set()
    v = DetectionValidator(imgsz=IMGSZ, batch=BATCH)
    batch = next(iter(v.loader(images, labels)))
    import torch
    dev = {k: torch.from_numpy(batch[k]) for k in v.eval_keys}
    got = {k: t.numpy() for k, t in v.eval_batch(port.model, dev).items()}
    jy = JaxYOLO(str(CKPT))
    jv = JaxValidator(get_cfg(overrides={"mode": "val", "imgsz": IMGSZ, "batch": BATCH}))
    fn = jax.jit(jv._make_eval_fn(jy.model, IMGSZ))
    want = fn(jy.variables, jnp.asarray(batch["img"].astype(np.float32) / 255.0),
              *(jnp.asarray(batch[k]) for k in ("bboxes", "ori_shape", "ratio_pad")))
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
    assert int(got["valid"].sum()) >= 20


def test_yolo_val_matches_jax_validator(floor_dir, port, jax_metrics):
    """``YOLO(..., device="cpu").val`` on the floor set's JPEGs, decoded, and
    label files against the JAX validator on the same files: each metric
    within ``METRIC_ATOL``, and the floor met."""
    root, _ = floor_dir
    files, labels = split_files(root, "val")
    got = port.val([cv2.imread(str(f)) for f in files], labels, imgsz=IMGSZ, batch=BATCH)
    assert list(got) == list(jax_metrics)
    gaps = {k: abs(got[k] - jax_metrics[k]) for k in METRIC_KEYS}
    print("port - JAX, per metric:", gaps)
    assert max(gaps.values()) <= METRIC_ATOL, gaps
    assert got["metrics/mAP50-95(B)"] >= FLOOR["floor"]["box_mAP50-95"]
    assert set(port.validator.speed) == {"preprocess", "eval", "matching"}
    assert isinstance(port.validator, DetectionValidator)


def test_committed_floor_set_gives_the_stored_metrics(port):
    """The card run's input: the committed decoded set through the port's
    validator gives the stored JAX metrics within ``METRIC_ATOL``; the
    stage marks come in order."""
    marks = []
    v = DetectionValidator(imgsz=IMGSZ, batch=BATCH, mark=marks.append)
    got = v(port.model, *floor_detect_val_set())
    want = floor_detect_jax_metrics()
    assert max(abs(got[k] - want[k]) for k in METRIC_KEYS) <= METRIC_ATOL
    assert marks[:3] == ["forward_nms", "scale_box_iou", "end"] and len(marks) == 12
