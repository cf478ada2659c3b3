"""The port's trainers on the host train chain against the JAX package's on
the CPU: a narrow yolov8-seg here, a narrow yolov8-rtdetr in
``test_torch_port_rtdetr_trainer.py`` (each scaled to [0.33, 0.125, 256];
RT-DETR keeps its full decoder), trained for 2 epochs on
8 images at imgsz 64, batch 4, with ``device_augment=false`` and
``copy_paste`` 0.5 (so mosaic, copy-paste, the warp, HSV and the flips all
run on the host, byte for byte as JAX's), MixUp off (its beta comes from
numpy's global state in JAX), JAX's loader with one worker, the same
initial weights, and for RT-DETR JAX's CDN draws handed to the port's step
(``dn_fn``). Compared: ``results.csv`` (losses and metrics), the final
metrics, and the checkpoints' weights as norms of their updates from the
common init (ROADMAP Queue 3: train-step parity); the JAX package validates
the port's ``best.ckpt``. Then the ``close_mosaic`` switch on the host
dataset."""
import copy
import csv

import cv2
import numpy as np
import pytest

import jax
import torch

from tests.helpers import make_shape_dataset
from tests.test_torch_port_rtdetr_loss import _jax_draws
from tests.torch_port_jax_init import compiled_trainer_init
from yolo_contour_regression_tpu.engine import trainer as jtrainer
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.engine.model import TASK_MAP as JAX_TASK_MAP
from yolo_contour_regression_tpu.utils import checkpoint as jckpt
from yolo_contour_regression_tpu_torch.data import dataset as tdataset
from yolo_contour_regression_tpu_torch.engine import trainer as ttrainer
from yolo_contour_regression_tpu_torch.models.utils import ops as tops
from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8_RTDETR, YOLOV8_SEG
from yolo_contour_regression_tpu_torch.utils import checkpoint as tckpt


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NARROW = {}
for _task, _cfg in (("segment", YOLOV8_SEG), ("rtdetr", YOLOV8_RTDETR)):
    NARROW[_task] = copy.deepcopy(_cfg)
    NARROW[_task].update(nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})
# results.csv: the train losses (relative; the same float32 steps summed in
# other orders) and the val metrics (absolute). RT-DETR at a fresh init:
# its encoder's top-k query selection and its auction meet near-equal
# scores and costs, which the two sides' float32 sums order differently,
# so its matched losses part by about 1% by the second step (its dn box
# losses, which no selection or matching touches, stay within 1e-5 there:
# ``DN_RTOL``) and about 3% by the fourth
LOSS_RTOL = {"segment": 1e-3, "rtdetr": 0.05}
DN_RTOL = 1e-4
METRIC_ATOL = 0.01
# the stripped weights (the EMA): the norm of the difference of the two
# updates from the common init over the norm of JAX's update (AdamW moves
# near-zero gradients by about lr whatever their sign; 0.18 measured for
# RT-DETR, whose trajectories part as above), and the BatchNorm statistics'
# (0.06 measured for RT-DETR, which follow its weights)
UPDATE_RTOL = {"segment": {"params": 0.1, "batch_stats": 1e-3},
               "rtdetr": {"params": 0.3, "batch_stats": 0.1}}
HOST = dict(device_augment=False, copy_paste=0.5, mixup=0.0)
TRAIN = dict(epochs=2, imgsz=64, batch=4, nbs=4, workers=1, amp=False, plots=False,
             verbose=False, seed=0, exist_ok=True, **HOST)
TASK_TRAIN = {"segment": dict(task="segment"),
              "rtdetr": dict(task="rtdetr", optimizer="AdamW", lr0=2e-4, warmup_epochs=1.0)}
TRAINERS = {"segment": ttrainer.SegmentationTrainer, "rtdetr": ttrainer.RTDETRTrainer}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(root):
    out = {"names": {0: "circle", 1: "rect"}}
    for split in ("train", "val"):
        files = sorted((root / "images" / split).glob("*.jpg"))
        out[split] = ([cv2.imread(str(f)) for f in files],
                      [root / "labels" / split / (f.stem + ".txt") for f in files])
    return out


def _jax_dn(batch, step):
    """JAX's dn dict of this step: its draws from ``PRNGKey(17)`` folded
    with the step, on the port's batch."""
    B, N = batch["cls"].shape
    key = jax.random.fold_in(jax.random.PRNGKey(17), step)
    draws = _jax_draws(key, B, tops.num_groups(N), N, 2)
    return tops.cdn_group_from_draws(batch, {k: torch.from_numpy(v) for k, v in draws.items()})


def train_both(task, tmp):
    """Both trainers of ``task`` on the same data and initial weights under
    ``tmp``: JAX's trainer's init (``PRNGKey(0)``, compiled) carried into the
    port's."""
    yaml = make_shape_dataset(tmp / "ds", n_train=8, n_val=4, imgsz=64, seed=0)
    over = {**TRAIN, **TASK_TRAIN[task], "model": NARROW[task]}
    jcls = jtrainer.SegmentationTrainer if task == "segment" else JAX_TASK_MAP[task]["trainer"]
    with compiled_trainer_init() as seen:
        jt = jcls(overrides={**over, "data": str(yaml), "project": str(tmp / "jax"),
                             "name": "t"})
        jm = jt.train()
    init = seen["v"]

    def jax_init(model, generator):
        return tckpt.load_jax_variables(model, init["params"], init["batch_stats"])

    orig = ttrainer.init_weights
    ttrainer.init_weights = jax_init
    try:
        tt = TRAINERS[task](overrides={**over, "project": str(tmp / "port"), "name": "t"},
                            device="cpu", dn_fn=_jax_dn if task == "rtdetr" else None)
        tm = tt.train(_data(tmp / "ds"))
    finally:
        ttrainer.init_weights = orig
    return {"task": task, "jax": (jt, jm), "port": (tt, tm), "yaml": yaml, "tmp": tmp,
            "init": init}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return train_both("segment", tmp_path_factory.mktemp("host_segment"))


def _rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


def test_results_csv_matches_jax(runs):
    """The host path was taken; the same columns in the same order, the
    train losses within ``LOSS_RTOL``, the val metrics within
    ``METRIC_ATOL``."""
    (jt, _), (tt, _) = runs["jax"], runs["port"]
    assert not tt.device_augment and not getattr(jt, "used_multistep", False)
    jr, tr = _rows(jt.csv), _rows(tt.csv)
    assert list(tr[0]) == list(jr[0]) and len(tr) == len(jr) == 2
    for k in ("train/dn_giou_loss", "train/dn_l1_loss"):
        if k in jr[0]:
            np.testing.assert_allclose(float(tr[0][k]), float(jr[0][k]), rtol=DN_RTOL, err_msg=k)
    for j, t in zip(jr, tr):
        for k in j:
            if k.startswith("train/"):
                np.testing.assert_allclose(float(t[k]), float(j[k]), err_msg=k,
                                           rtol=LOSS_RTOL[runs["task"]])
            elif k != "epoch":
                assert abs(float(t[k]) - float(j[k])) <= METRIC_ATOL, k


def test_final_metrics_match_jax(runs):
    """The final validation of the stripped best.ckpt within
    ``METRIC_ATOL`` of JAX's."""
    (_, jm), (_, tm) = runs["jax"], runs["port"]
    assert list(tm) == list(jm)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= METRIC_ATOL, k


def test_checkpoint_weights_match_jax(runs):
    """The stripped last.ckpt's weights (the EMA) and BatchNorm statistics:
    each update from the common init within ``UPDATE_RTOL`` of JAX's; the
    same epoch and step."""
    (jt, _), (tt, _) = runs["jax"], runs["port"]
    j = jckpt.load_checkpoint(jt.wdir / "last.ckpt")
    t = tckpt.load_checkpoint(tt.wdir / "last.ckpt")
    assert (t["epoch"], t["step"]) == (j["epoch"], j["step"]) == (1, 4)
    for key, rtol in UPDATE_RTOL[runs["task"]].items():
        leaves = [jax.tree_util.tree_leaves_with_path(tree)
                  for tree in (j[key], t[key], runs["init"][key])]
        assert len({len(x) for x in leaves}) == 1 and leaves[0], key
        diff = norm = 0.0
        for (path, a), (_, b), (_, c) in zip(*leaves):
            if _zero_gradient(path):
                continue
            a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
            diff += np.square(b - a).sum()
            norm += np.square(a - c).sum()
        assert norm > 0 and (diff / norm) ** 0.5 <= rtol, (key, (diff / norm) ** 0.5)


def _zero_gradient(path) -> bool:
    """A self-attention key bias: its gradient is 0 in exact arithmetic (a
    softmax does not see a shift common to its row), so each side's AdamW
    moves it by about lr in the direction of its rounding noise."""
    keys = [getattr(p, "key", None) for p in path]
    return keys[-2:] == ["key", "bias"]


def test_jax_validates_the_port_checkpoint(runs):
    """The JAX package loads the port's stripped best.ckpt; its validator's
    metrics on it are the port's within ``METRIC_ATOL``."""
    tt, tm = runs["port"]
    jm = JaxYOLO(str(tt.wdir / "best.ckpt")).val(data=str(runs["yaml"]), imgsz=64, batch=4,
                                                 plots=False, project=str(runs["tmp"] / "jval"))
    for k in tm:
        assert abs(tm[k] - jm[k]) <= METRIC_ATOL, k


def test_close_mosaic_switches_the_host_dataset(tmp_path, monkeypatch):
    """On the host path the trainer calls ``close_mosaic`` on its dataset
    once, as the last ``close_mosaic`` epochs start, and keeps its step."""
    calls = []
    real = tdataset.TrainDataset.close_mosaic

    def spy(self):
        calls.append(len(tt.epoch_times))
        real(self)

    monkeypatch.setattr(tdataset.TrainDataset, "close_mosaic", spy)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(4)]
    t = np.linspace(0, 2 * np.pi, 360, endpoint=False)
    seg = np.stack([0.5 + 0.2 * np.cos(t), 0.5 + 0.3 * np.sin(t)], -1).astype(np.float32)
    labels = [(np.array([0]), np.array([[0.5, 0.5, 0.4, 0.6]], np.float32), seg[None])] * 4
    tt = ttrainer.SegmentationTrainer(overrides={
        **TRAIN, "model": NARROW["segment"], "epochs": 3, "close_mosaic": 1, "val": False,
        "project": str(tmp_path)}, device="cpu")
    tt.train({"train": (images, labels), "val": (images, labels), "names": {0: "a", 1: "b"}})
    assert calls == [2] and not tt.device_augment and tt.state.step == 3
