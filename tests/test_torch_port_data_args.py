"""``single_cls`` and ``fraction`` in the PyTorch port against the JAX
package on the CPU: the port's train and val sets (as its trainer and
validator build them) against JAX's ``build_yolo_dataset`` on the same
image files, the ``max(1, round(n * fraction))`` edge at small n, val
ignoring ``fraction``, and a checkpoint trained with ``single_cls`` that
keeps it through the facade's load and validates as JAX's does."""
import pickle
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from tests.helpers import make_shape_dataset
from tests.test_torch_port_detect_val import CKPT, IMGSZ, make_floor_set, split_files
from yolo_contour_regression_tpu.cfg import get_cfg as jget_cfg
from yolo_contour_regression_tpu.data.build import build_yolo_dataset
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.data.dataset import ValDataset
from yolo_contour_regression_tpu_torch.engine.trainer import DetectionTrainer, PoseTrainer
from yolo_contour_regression_tpu_torch.engine.validator import DetectionValidator
from yolo_contour_regression_tpu_torch.utils.checkpoint import load_checkpoint


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the metrics of a single_cls checkpoint's validation against JAX's
METRIC_ATOL = 0.01


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    """Seven train and three val images of two classes (JPEG files and
    label files, as JAX reads them), and list files naming the first n
    train images."""
    root = tmp_path_factory.mktemp("shapes")
    make_shape_dataset(root, n_train=7, n_val=3, imgsz=64, seed=3)
    files, _ = split_files(root, "train")
    lists = {}
    for n in (1, 2, 3, 7):
        lists[n] = root / f"train{n}.txt"
        lists[n].write_text("".join(f"{f}\n" for f in files[:n]))
    return root, lists


def _port_inputs(files):
    return [cv2.imread(str(f)) for f in files], [
        Path(str(f).replace("/images/", "/labels/")).with_suffix(".txt") for f in files]


def _jax_set(img_path, mode, **over):
    """JAX's set, its label cache removed first: the cache is keyed by the
    image files alone, so a cache written without ``single_cls`` would be
    read back with it."""
    for cache in Path(img_path).parent.rglob(".label_cache_*.npz"):
        cache.unlink()
    cfg = jget_cfg(overrides={"mode": mode, "task": "detect", "imgsz": 64, **over})
    return build_yolo_dataset(cfg, str(img_path), 2, {"names": {0: "a", 1: "b"}}, mode=mode)


def _trainer(tmp_path, trainer=DetectionTrainer, **over):
    t = trainer(overrides={"model": "yolov8n.yaml", "imgsz": 64, "project": str(tmp_path), **over},
                device="cpu")
    t.model = None  # the trainer builds it in train(); the train set needs no model
    return t


@pytest.mark.parametrize("n", [1, 2, 3, 7])
@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.3, 0.25, 0.01])
def test_fraction_keeps_jaxs_train_samples(shapes, tmp_path, n, fraction):
    """The trainer's train set keeps the first ``max(1, round(n *
    fraction))`` samples (Python's rounding: n 2 at 0.25 keeps 1, n 7 at
    0.5 keeps 4), the same files as JAX's train set, with their labels."""
    _, lists = shapes
    want = _jax_set(lists[n], "train", fraction=fraction)
    images, labels = _port_inputs(lists[n].read_text().split())
    got = _trainer(tmp_path, fraction=fraction).get_dataset({"train": (images, labels)})
    assert len(got) == len(want.im_files) == max(1, round(n * fraction))
    for g, w in zip(got.labels, want.labels):
        np.testing.assert_array_equal(g["cls"], w["cls"])
        np.testing.assert_allclose(g["bboxes"], w["bboxes"], atol=1e-6)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_single_cls_reads_every_class_as_0(shapes, tmp_path, mode):
    """``single_cls`` sets every label's class to 0 in the train set (the
    trainer's) and in the val set (the validator's), as JAX's sets read
    them; without it the two classes stay."""
    root, _ = shapes
    files, _ = split_files(root, mode)
    images, labels = _port_inputs(files)
    for single in (False, True):
        want = _jax_set(root / "images" / mode, mode, single_cls=single)
        if mode == "train":
            got = _trainer(tmp_path, single_cls=single).get_dataset({"train": (images, labels)})
        else:
            got = DetectionValidator(imgsz=64, single_cls=single).loader(images, labels).dataset
        assert len(got.labels) == len(want.labels)
        cls = np.concatenate([g["cls"] for g in got.labels])
        np.testing.assert_array_equal(cls, np.concatenate([w["cls"] for w in want.labels]))
        assert (cls.max() == 0) == single and len(cls) > len(files)


def test_val_ignores_fraction(shapes, tmp_path):
    """JAX builds its val set with fraction 1.0, whatever the setting: the
    trainer's validator reads every val image."""
    root, _ = shapes
    want = _jax_set(root / "images" / "val", "val", fraction=0.3)
    files, _ = split_files(root, "val")
    v = _trainer(tmp_path, fraction=0.3, single_cls=True).get_validator()
    got = v.loader(*_port_inputs(files)).dataset
    assert isinstance(got, ValDataset) and len(got) == len(want.im_files) == 3
    assert v.single_cls and all((g["cls"] == 0).all() for g in got.labels)


def test_pose_trainer_passes_both(shapes, tmp_path):
    """The pose trainer's train set takes both settings too (keypoints
    beside the labels)."""
    root, _ = shapes
    files, _ = split_files(root, "train")
    images, _ = _port_inputs(files)
    labels = [(np.array([0, 1]), np.full((2, 4), 0.3, np.float32),
               np.zeros((2, 360, 2), np.float32), np.full((2, 5, 3), 0.5, np.float32))] * 7
    t = _trainer(tmp_path, PoseTrainer, model="yolov8n-pose.yaml", single_cls=True,
                 fraction=0.5)
    t.model = type("M", (), {"kpt_shape": (5, 3)})()
    got = t.get_dataset({"train": (images, labels)})
    assert len(got) == 4 and all((g["cls"] == 0).all() for g in got.labels)


@pytest.fixture(scope="module")
def single_cls_ckpt(tmp_path_factory):
    """The detect floor checkpoint with ``single_cls`` and a ``data`` path
    in its train args, and the detect floor set's files."""
    tmp = tmp_path_factory.mktemp("single_cls")
    ckpt = load_checkpoint(CKPT)
    ckpt["train_args"] = {**ckpt["train_args"], "single_cls": True, "data": "shapes.yaml"}
    path = tmp / "single_cls.ckpt"
    with open(path, "wb") as fh:
        pickle.dump(ckpt, fh)
    root = tmp / "floor"
    return path, root, make_floor_set(root)


def test_load_keeps_single_cls_and_validates_as_jax(single_cls_ckpt):
    """The facade keeps ``single_cls`` and ``data`` from the checkpoint's
    train args, as JAX's does, and its validation reads every label as
    class 0: the metrics equal JAX's facade's on the same files (and differ
    from the two-class ones); an explicit ``single_cls=False`` reads the
    classes again."""
    path, root, yaml = single_cls_ckpt
    port = YOLO(path, device="cpu")
    assert port.overrides["single_cls"] is True and port.overrides["data"] == "shapes.yaml"
    files, labels = split_files(root, "val")
    images = [cv2.imread(str(f)) for f in files]
    got = port.val(images, labels, imgsz=IMGSZ, batch=4)
    assert port.validator.single_cls
    want = JaxYOLO(str(path)).val(data=str(yaml), imgsz=IMGSZ, batch=4, plots=False,
                                  project=str(root / "runs"))
    assert max(abs(got[k] - want[k]) for k in want) <= METRIC_ATOL, (got, want)
    two = port.val(images, labels, imgsz=IMGSZ, batch=4, single_cls=False)
    assert not port.validator.single_cls
    assert abs(two["metrics/mAP50-95(B)"] - got["metrics/mAP50-95(B)"]) > 1e-3
