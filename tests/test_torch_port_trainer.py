"""The PyTorch port's trainer against the JAX package's on the CPU: both
trainers train the narrow yolov8-seg graph from the same initial weights for
2 epochs on 8 images at imgsz 64, batch 4, with the augmentation reduced to
the identity (mosaic, mixup, flips, HSV, scale and translate 0, so the warp
is the identity), and are compared by their ``results.csv``, final states,
and final metrics; the JAX package loads and validates the port's
``best.ckpt``. Then the pieces: the schedule counts, early stopping, the
``close_mosaic`` swap, the micro-batch stacking, ``strip_optimizer``, and
what the port refuses."""
import copy
import csv
import pickle
from functools import partial
from pathlib import Path

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.helpers import make_shape_dataset
from yolo_contour_regression_tpu.data import build as jbuild
from yolo_contour_regression_tpu.data import device_augment as jda
from yolo_contour_regression_tpu.engine import trainer as jtrainer
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.nn.tasks import build_model
from yolo_contour_regression_tpu.utils import checkpoint as jckpt
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine import trainer as ttrainer
from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8_SEG
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

NARROW = copy.deepcopy(YOLOV8_SEG)
NARROW.update(nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})
# results.csv: the train losses (relative; the same f32 steps summed in
# other orders, 4 of them at warmup lr) and the val metrics (absolute)
LOSS_RTOL = 1e-3
METRIC_ATOL = 0.01
# the checkpoints' weights: the norm of the difference of the two updates
# from the common init over the norm of JAX's update, for the params (the
# EMA; AdamW moves near-zero gradients by about lr whatever their sign, and
# the two sum them in other orders: 0.026 measured) and the BatchNorm
# statistics (7e-5 measured); each statistics tensor also within
# STATS_RTOL of its largest entry (2.1e-4 measured)
UPDATE_RTOL = {"params": 0.1, "batch_stats": 1e-3}
STATS_RTOL = 1e-3
# the final train state: the EMA's lag behind the live parameters, as the
# norm of the difference of the two lags over the norm of JAX's (0.034
# measured; an EMA ramp of tau 20 in place of 2000 gives 98)
LAG_RTOL = 0.1
IDENTITY_AUG = dict(mosaic=0.0, mixup=0.0, fliplr=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
                    scale=0.0, translate=0.0)
TRAIN = dict(task="segment", model=NARROW, epochs=2, imgsz=64, batch=4, nbs=4, workers=1,
             amp=False, plots=False, verbose=False, seed=0, exist_ok=True, **IDENTITY_AUG)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(root):
    out = {"names": {0: "circle", 1: "rect"}}
    for split in ("train", "val"):
        files = sorted((root / "images" / split).glob("*.jpg"))
        out[split] = ([cv2.imread(str(f)) for f in files],
                      [root / "labels" / split / (f.stem + ".txt") for f in files])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers on the same data and initial weights. JAX's separable
    warp runs in float32 (its default is bfloat16; the port's is float32),
    its trainer one step per dispatch (the port's path); the port's init
    is replaced by JAX's (``PRNGKey(0)``), carried across."""
    tmp = tmp_path_factory.mktemp("trainers")
    yaml = make_shape_dataset(tmp / "ds", n_train=8, n_val=4, imgsz=64, seed=0)
    warp = jda._warp_image_separable
    jda._warp_image_separable = partial(warp, dtype=jnp.float32)
    try:
        jt = jtrainer.SegmentationTrainer(overrides={
            **TRAIN, "data": str(yaml), "steps_per_dispatch": 1, "project": str(tmp / "jax"),
            "name": "t"})
        jm = jt.train()
    finally:
        jda._warp_image_separable = warp
    init = build_model(NARROW, nc=2).init(jax.random.PRNGKey(0), imgsz=64)

    def jax_init(model, generator):
        return tckpt.load_jax_variables(model, _np_tree(init["params"]),
                                        _np_tree(init["batch_stats"]))

    orig = ttrainer.init_weights
    ttrainer.init_weights = jax_init
    try:
        tt = ttrainer.SegmentationTrainer(overrides={**TRAIN, "project": str(tmp / "port"),
                                                     "name": "t"}, device="cpu")
        tm = tt.train(_data(tmp / "ds"))
    finally:
        ttrainer.init_weights = orig
    return {"jax": (jt, jm), "port": (tt, tm), "yaml": yaml, "tmp": tmp, "init": _np_tree(init)}


def _rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


def test_results_csv_matches_jax(runs):
    """The same columns in the same order; the train losses within
    ``LOSS_RTOL``, the val metrics within ``METRIC_ATOL``; both written in
    JAX's ``%.5f`` format."""
    (jt, _), (tt, _) = runs["jax"], runs["port"]
    jr, tr = _rows(jt.csv), _rows(tt.csv)
    assert list(tr[0]) == list(jr[0]) and len(tr) == len(jr) == 2
    for j, t in zip(jr, tr):
        assert t["epoch"] == j["epoch"]
        for k in j:
            if k.startswith("train/"):
                np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=LOSS_RTOL, err_msg=k)
            elif k != "epoch":
                assert abs(float(t[k]) - float(j[k])) <= METRIC_ATOL, k
    assert all(len(v.split(".")[1]) == 5 for v in tr[0].values() if "." in v)


def test_final_metrics_match_jax(runs):
    """The final validation of the stripped best.ckpt: the eight metrics
    and fitness within ``METRIC_ATOL`` of JAX's."""
    (_, jm), (_, tm) = runs["jax"], runs["port"]
    assert list(tm) == list(jm)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= METRIC_ATOL, k


def test_checkpoints_match_jax(runs):
    """The port writes last.ckpt and best.ckpt with JAX's keys, stripped as
    JAX strips them (EMA -> params, no EMA, no optimizer state); the same
    epoch, step and tree leaves; train_args plain Python."""
    (jt, _), (tt, _) = runs["jax"], runs["port"]
    for name in ("best.ckpt", "last.ckpt"):
        j, t = jckpt.load_checkpoint(jt.wdir / name), tckpt.load_checkpoint(tt.wdir / name)
        assert set(t) == set(j) | {"deploy"} and t["deploy"] is None
        assert t["ema_params"] is None and t["opt_state"] is None
        assert (t["epoch"], t["step"]) == (j["epoch"], j["step"])
        jl = jax.tree_util.tree_leaves_with_path(j["params"])
        tl = jax.tree_util.tree_leaves_with_path(t["params"])
        assert [p for p, _ in jl] == [p for p, _ in tl]
        assert all(a.shape == b.shape for (_, a), (_, b) in zip(jl, tl))
        for k, v in t["train_args"].items():
            assert isinstance(v, (type(None), bool, int, float, str, list, dict)), k
        assert t["train_args"]["accumulate"] == j["train_args"]["accumulate"] == 1
        assert t["model_yaml"]["nc"] == 2 and t["names"] == {0: "circle", 1: "rect"}


@pytest.mark.parametrize("name", ["best.ckpt", "last.ckpt"])
def test_checkpoint_weights_match_jax(runs, name):
    """The stripped weights (the EMA) and BatchNorm statistics of the two
    trainers' checkpoints: each update from the common init within
    ``UPDATE_RTOL`` of JAX's (so a missing or wrong last step, or a wrong
    EMA decay, shows), each statistics tensor within ``STATS_RTOL`` of its
    largest entry."""
    (jt, _), (tt, _) = runs["jax"], runs["port"]
    j, t = jckpt.load_checkpoint(jt.wdir / name), tckpt.load_checkpoint(tt.wdir / name)
    for key, rtol in UPDATE_RTOL.items():
        leaves = [jax.tree_util.tree_leaves(tree) for tree in (j[key], t[key], runs["init"][key])]
        assert len({len(x) for x in leaves}) == 1 and leaves[0], key
        diff = norm = 0.0
        for a, b, c in zip(*leaves):
            a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
            diff += np.square(b - a).sum()
            norm += np.square(a - c).sum()
            if key == "batch_stats":
                assert np.abs(b - a).max() <= STATS_RTOL * np.abs(a).max(), key
        assert norm > 0 and (diff / norm) ** 0.5 <= rtol, (key, (diff / norm) ** 0.5)


def _rel(want, got):
    """Norm of ``got - want`` over the norm of ``want``, over lists of leaves."""
    diff = sum(np.square(np.asarray(b, np.float64) - np.asarray(a, np.float64)).sum()
               for a, b in zip(want, got, strict=True))
    return (diff / sum(np.square(np.asarray(a, np.float64)).sum() for a in want)) ** 0.5


def test_final_state_matches_jax(runs):
    """The trainers' final states: the same step count; the live
    parameters' update from the common init within ``UPDATE_RTOL`` of
    JAX's; the EMA's lag behind them within ``LAG_RTOL`` of JAX's; the
    port's stripped last.ckpt holds its final EMA exactly."""
    (jt, _), (tt, _) = runs["jax"], runs["port"]
    js, init = jt.state, runs["init"]["params"]
    live, _ = tckpt.to_jax_variables(tt.state.model.state_dict())
    ema, _ = tckpt.to_jax_variables(tt.state.ema)
    leaves = jax.tree_util.tree_leaves
    assert int(js.step) == tt.state.step == 4

    def minus(x, y):
        return [np.asarray(a, np.float64) - np.asarray(b, np.float64)
                for a, b in zip(leaves(x), leaves(y), strict=True)]

    assert _rel(minus(js.params, init), minus(live, init)) <= UPDATE_RTOL["params"]
    assert _rel(minus(js.ema_params, js.params), minus(ema, live)) <= LAG_RTOL
    last = tckpt.load_checkpoint(tt.wdir / "last.ckpt")["params"]
    for a, b in zip(leaves(last), leaves(ema), strict=True):
        np.testing.assert_array_equal(a, b)


def test_jax_validates_the_port_checkpoint(runs):
    """The JAX package loads the port's stripped best.ckpt, and its
    validator's metrics on it are the port's within ``METRIC_ATOL``."""
    tt, tm = runs["port"]
    jm = JaxYOLO(str(tt.wdir / "best.ckpt")).val(data=str(runs["yaml"]), imgsz=64, batch=4,
                                                 plots=False,
                                                 project=str(runs["tmp"] / "jval"))
    for k in tm:
        assert abs(tm[k] - jm[k]) <= METRIC_ATOL, k


def test_the_facade_adopts_best(runs):
    """``YOLO(best.ckpt)`` in the port holds the checkpoint's stripped
    weights (the EMA) and predicts."""
    (tt, _) = runs["port"]
    ckpt = tckpt.load_checkpoint(tt.wdir / "best.ckpt")
    m = YOLO(tt.wdir / "best.ckpt", device="cpu")
    params, _ = tckpt.to_jax_variables(m.model.state_dict())
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                              jax.tree_util.tree_leaves_with_path(ckpt["params"])):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    assert len(m.predict(np.full((64, 64, 3), 40, np.uint8), imgsz=64)) == 1


@pytest.mark.parametrize("n,batch,nbs,epochs", [(8, 4, 4, 2), (8, 4, 64, 2), (64, 16, 16, 120),
                                                (64, 16, 64, 3), (100, 16, 64, 5), (5, 4, 64, 1),
                                                (1000, 8, 64, 10)])
def test_schedule_matches_jax(n, batch, nbs, epochs):
    """accumulate, steps_per_epoch and iterations as the JAX trainer counts
    them from its loader's length (drop_last)."""
    class DS:
        def __len__(self):
            return n

    micro = max(len(jbuild.DataLoader(DS(), batch, drop_last=True)), 1)
    accumulate = min(max(round(nbs / batch), 1), micro)
    spe = max(micro // accumulate, 1)
    assert ttrainer.schedule(n, batch, nbs, epochs) == (accumulate, spe, spe * epochs)


@pytest.mark.parametrize("patience,fitness", [
    (3, [0.1, 0.2, 0.2, 0.1, 0.1, 0.1, 0.3]),
    (2, [0.0, 0.0, 0.0, 0.0]),
    (0, [0.5, 0.1, 0.1, 0.1, 0.1]),
    (1, [0.3, 0.2, 0.4, 0.4, 0.1]),
])
def test_early_stopping_matches_jax(patience, fitness):
    """The same stop decisions, epoch by epoch."""
    j, t = jtrainer.EarlyStopping(patience), ttrainer.EarlyStopping(patience)
    for epoch, f in enumerate(fitness):
        assert t(epoch, f) == j(epoch, f)
        assert (t.best_epoch, t.best_fitness) == (j.best_epoch, j.best_fitness)


def test_stack_raw_batches_matches_jax():
    """Micro-batches for gradient accumulation: stacked, the instance axes
    padded to the group's largest bucket, as JAX's ``_stack_raw_batches``."""
    rng = np.random.default_rng(0)

    def batches():
        for n in (8, 16, 8):
            yield {"img": rng.integers(0, 255, (2, 8, 8, 3), dtype=np.uint8),
                   "cls": rng.integers(0, 3, (2, n)).astype(np.int32),
                   "bboxes": rng.random((2, n, 4)).astype(np.float32),
                   "segments": rng.random((2, n, 360, 2)).astype(np.float32),
                   "mask_gt": rng.random((2, n)) < 0.5,
                   "content_hw": np.full((2, 2), 8, np.float32),
                   "pad_tl": np.zeros((2, 2), np.float32)}

    items = list(batches())
    ji, jl = jtrainer._stack_raw_batches(iter(copy.deepcopy(items)), 3)
    ti, tl = ttrainer.stack_raw_batches(iter(copy.deepcopy(items)), 3)
    np.testing.assert_array_equal(ti, ji)
    assert sorted(tl) == sorted(jl)
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)


def test_close_mosaic_swaps_the_augmentation(tmp_path, monkeypatch):
    """At epoch ``epochs - close_mosaic`` the step is rebuilt with an
    augmentation of mosaic 0 and mixup 0, as JAX's trainer swaps it; the
    trainer's own args keep theirs. Also: every epoch gets its times, and
    gradient accumulation (nbs 8 at batch 4) trains."""
    made = []
    real = ttrainer.make_augment_fn

    def spy(hyp, imgsz, max_instances):
        made.append((hyp.mosaic, hyp.mixup))
        return real(hyp, imgsz, max_instances)

    monkeypatch.setattr(ttrainer, "make_augment_fn", spy)
    root = tmp_path / "ds"
    make_shape_dataset(root, n_train=8, n_val=2, imgsz=64, seed=1)
    tt = ttrainer.SegmentationTrainer(overrides=dict(
        model=NARROW, epochs=3, close_mosaic=1, imgsz=64, batch=4, nbs=8, workers=2, mixup=0.5,
        val=False, project=str(tmp_path / "runs"), name="t"), device="cpu")
    tt.train(_data(root))
    assert made == [(1.0, 0.5), (0.0, 0.0)]
    assert (tt.args.mosaic, tt.args.mixup, tt.args.accumulate) == (1.0, 0.5, 2)
    assert [t["epoch"] for t in tt.epoch_times] == [0, 1, 2]
    assert all(set(t) == {"epoch", "train_s", "loader_wait_s", "val_s", "save_s"}
               for t in tt.epoch_times)
    assert len(_rows(tt.csv)) == 3 and tt.state.step == 3


def test_strip_optimizer_matches_jax(tmp_path):
    """``strip_optimizer`` gives what JAX's gives for the same file."""
    tree = {"layer0": {"conv": {"kernel": np.ones((3, 3, 3, 4), np.float32)}}}
    ema = {"layer0": {"conv": {"kernel": np.full((3, 3, 3, 4), 2.0, np.float32)}}}
    path = tckpt.save_checkpoint(tmp_path / "a.ckpt", tree, {}, ema, step=3, epoch=1,
                                 best_fitness=np.float64(0.5),
                                 train_args={"imgsz": np.int64(64), "p": Path("x")},
                                 model_yaml=NARROW, names={0: "a"})
    jckpt.strip_optimizer(path, out_path=tmp_path / "j.ckpt")
    tckpt.strip_optimizer(path, out_path=tmp_path / "t.ckpt")
    j = pickle.loads((tmp_path / "j.ckpt").read_bytes())
    t = pickle.loads((tmp_path / "t.ckpt").read_bytes())
    assert set(t) == set(j)
    for k in j:
        if k in ("params", "ema_params", "batch_stats"):
            assert jax.tree_util.tree_all(jax.tree_util.tree_map(
                np.array_equal, t[k], j[k])) if j[k] is not None else t[k] is None
        else:
            assert t[k] == j[k], k
    np.testing.assert_array_equal(t["params"]["layer0"]["conv"]["kernel"], 2.0)
    assert t["train_args"] == {"imgsz": 64, "p": "x"} and type(t["best_fitness"]) is float


def test_trainer_refuses_what_is_not_ported(tmp_path):
    """The host train chain is ported: ``device_augment=false``, ``mosaic9``
    and ``copy_paste`` take it (JAX's ``use_device_augment`` rule), and the
    RT-DETR facade trains on it (one epoch of two images here); another
    task's model still raises ``NotImplementedError`` naming what is
    missing. Resume is ported (``tests/test_torch_port_resume.py``): with
    no checkpoint to resume from it raises ``FileNotFoundError``."""
    for over in (dict(device_augment=False), dict(mosaic9=0.5), dict(copy_paste=0.1), {}):
        t = ttrainer.SegmentationTrainer(overrides={**over, "project": str(tmp_path)},
                                         device="cpu")
        assert t.device_augment == (not over)
    with pytest.raises(NotImplementedError, match="task"):
        ttrainer.SegmentationTrainer(overrides={"task": "detect", "project": str(tmp_path)},
                                     device="cpu")
    with pytest.raises(FileNotFoundError, match="resume"):
        ttrainer.SegmentationTrainer(overrides={"resume": True, "project": str(tmp_path)},
                                     device="cpu")
    rtdetr = YOLO("yolov8n-rtdetr.yaml", device="cpu")
    assert rtdetr.task == "rtdetr" and rtdetr.model is None
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(2)]
    labels = [(np.array([0]), np.array([[0.5, 0.5, 0.4, 0.5]], np.float32),
               np.zeros((1, 360, 2), np.float32))] * 2
    rtdetr.train(data={"train": (images, labels), "val": (images, labels), "names": {0: "a"}},
                 epochs=1, imgsz=64, batch=2, nbs=2, val=False, project=str(tmp_path))
    assert not rtdetr.trainer.device_augment and rtdetr.model is not None
    assert isinstance(rtdetr.trainer, ttrainer.RTDETRTrainer)


def test_a_fresh_facade_has_no_weights_until_trained():
    """``YOLO("yolov8n-seg.yaml")`` names the model and builds nothing: the
    trainer builds and initializes it from ``seed``, so predict and val
    raise until then."""
    m = YOLO("yolov8n-seg.yaml", device="cpu")
    assert m.model is None and m.overrides["model"] == "yolov8n-seg.yaml"
    img = np.full((64, 64, 3), 40, np.uint8)
    with pytest.raises(RuntimeError, match="no weights"):
        m.predict(img, imgsz=64)
    with pytest.raises(RuntimeError, match="no weights"):
        m.val([img], [(np.zeros(0), np.zeros((0, 4)), [])], imgsz=64)
