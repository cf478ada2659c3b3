"""The PyTorch port's classify task against the JAX package on the CPU: the
fork's grayscale transforms (cv2's BGR2GRAY and INTER_LINEAR byte for byte,
the train transform on JAX's draws), the ``Classify`` head (its Dense
carried transposed, ``Dropout(0.0)`` a no-op), the yolov8-cls graph and its
parameters, the floor_classify checkpoint round-tripped, the loss and its
gradient in float32 and float64, ``ClassifyMetrics``' ranks, the committed
floor set (regenerated here and compared), the validator on it (JAX's
metrics exactly), the predictor, the deploy fuse, and a 2-epoch trainer
parity on the host path. Inputs and weights are made from seeds with numpy
and handed to both packages."""
import copy
import json
import random
from pathlib import Path

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.helpers import make_cls_dataset
from tests.test_torch_port_detect import _leaves
from tests.test_torch_port_modules import _carry, _init, _randomize, _x
from tests.test_torch_port_segori_val import recorded_jax_init
from tests.test_torch_port_train import _np
from tests.test_torch_port_trainer import LOSS_RTOL, METRIC_ATOL, _np_tree, _rows
from yolo_contour_regression_tpu.data import augment as jaugment
from yolo_contour_regression_tpu.data.dataset import ClassificationDataset as JaxDataset
from yolo_contour_regression_tpu.engine import trainer as jtrainer
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.nn.modules import head as jhead
from yolo_contour_regression_tpu.nn.tasks import build_model as jbuild_model
from yolo_contour_regression_tpu.utils import checkpoint as jckpt
from yolo_contour_regression_tpu.utils import loss as jloss
from yolo_contour_regression_tpu.utils import metrics as jmetrics
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.data import augment as taugment
from yolo_contour_regression_tpu_torch.data.build import TrainLoader
from yolo_contour_regression_tpu_torch.data.dataset import ClassificationDataset
from yolo_contour_regression_tpu_torch.engine import trainer as ttrainer
from yolo_contour_regression_tpu_torch.engine.validator import ClassificationValidator
from yolo_contour_regression_tpu_torch.nn.modules import head as thead
from yolo_contour_regression_tpu_torch.nn.tasks import (YOLOV8_CLS, ClassificationModel,
                                                        build_model, guess_model_task,
                                                        yaml_model_load)
from yolo_contour_regression_tpu_torch.utils import checkpoint as tckpt
from yolo_contour_regression_tpu_torch.utils import loss as tloss
from yolo_contour_regression_tpu_torch.utils.metrics import ClassifyMetrics

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs" / "floor_classify" / "best.ckpt"
FLOOR_TRAIN = ROOT / "tests" / "data" / "torch_port_floor_classify_train96.npz"
FLOOR_VAL = ROOT / "tests" / "data" / "torch_port_floor_classify_val32.npz"
# probabilities (one sigmoid of f32 logits summed in other orders), the
# train transform on the same draws, the loss and its gradient
PROB_ATOL, TRAIN_TF_ATOL, LOSS_RTOL_CLS = 1e-4, 1e-6, 1e-5
# yolov8n-cls at nc 2, the JAX model's count
YOLOV8N_CLS_PARAMS = 1_440_850
NARROW = copy.deepcopy(YOLOV8_CLS)
NARROW.update(scale="t", scales={"t": [0.33, 0.125, 256]})
NAMES = {0: "circle", 1: "rect"}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def floor_set(path):
    """The committed decoded images and class indices of a floor split."""
    with np.load(path) as z:
        return list(z["images"]), z["labels"]


# --- the transforms ---------------------------------------------------------

def test_gray_is_cv2s_on_every_color():
    """``bgr_to_gray`` equals ``cv2.cvtColor(BGR2GRAY)`` on all 2^24 colors."""
    a = np.arange(1 << 24, dtype=np.int64)
    img = np.stack([a & 255, (a >> 8) & 255, a >> 16], -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(taugment.bgr_to_gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("imgsz", [64, 224, 37])
def test_eval_transform_is_jaxs_byte_for_byte(imgsz):
    """The eval transform on the committed floor images (64x64: a copy at
    64, enlarged at 224, shrunk at 37) and on odd-sized random images:
    equal to JAX's (cv2's), every byte."""
    images = floor_set(FLOOR_VAL)[0][:8]
    rng = np.random.default_rng(imgsz)
    images += [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((50, 70), (81, 33))]
    for img in images:
        got = taugment.classify_transform_eval(img, imgsz)
        want = jaugment.classify_transform_eval(img, imgsz)
        assert got.dtype == want.dtype == np.float32 and got.shape == (imgsz, imgsz, 3)
        assert got.tobytes() == want.tobytes()


def test_train_transform_on_jaxs_draws():
    """The train transform with the same ``random.Random`` and, for the
    noise, numpy's global state seeded alike (JAX's source): equal to JAX's
    within ``TRAIN_TF_ATOL`` (exactly here) over 24 draws, both noise
    branches taken. The port's default noise source is its own generator."""
    images = floor_set(FLOOR_TRAIN)[0][:24]
    np.random.seed(5)
    want = [jaugment.classify_transform_train(img, 64, r) for r in [random.Random(3)]
            for img in images]
    np.random.seed(5)
    got = [taugment.classify_transform_train(img, 64, r, np.random) for r in [random.Random(3)]
           for img in images]
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (64, 64, 3)
        np.testing.assert_allclose(g, w, atol=TRAIN_TF_ATOL)
    r = random.Random(3)
    noisy = sum(r.uniform(0.6, 1.4) > 0 and r.random() < 0.5 for _ in images)
    assert 0 < noisy < len(images)
    ds = ClassificationDataset(images[:2], [0, 1], imgsz=64, augment=True, seed=3)
    assert isinstance(ds.noise, np.random.Generator) and ds[1]["cls"] == 1


# --- the head, the graph and the weights ------------------------------------------

def test_classify_head_matches_jax():
    """``Classify``: Conv 1x1 to 1280 (not width-scaled), the mean over the
    map, ``Dropout(0.0)`` (the same output in train mode), ``linear`` (JAX's
    Dense kernel carried transposed) and the sigmoid: (B, nc)
    probabilities."""
    x = _x(0, (3, 5, 4, 32))
    jmod = jhead.Classify(nc=3)
    jvars = _randomize(_init(jmod, jnp.asarray(x)), 1)
    want = np.asarray(jax.jit(jmod.apply)(jvars, jnp.asarray(x)))
    tmod = _carry(jvars, thead.Classify(3, 32))
    assert tmod.conv.conv.out_channels == 1280 and tmod.linear.weight.shape == (3, 1280)
    np.testing.assert_array_equal(tmod.linear.weight.detach().numpy(),
                                  np.asarray(jvars["params"]["linear"]["kernel"]).T)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tmod(xt)
        tmod.drop.train()
        again = tmod.linear(tmod.drop(tmod.conv(xt).mean((2, 3))))
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_ATOL)
    np.testing.assert_array_equal(torch.sigmoid(again).numpy(), got.numpy())


def test_classify_graph_and_published_config_match_jax():
    """The narrow cls graph at 64 px with numpy-drawn weights: ``predict``'s
    probabilities against JAX ``ClassificationModel.predict``; no strides;
    ``yolov8n-cls.yaml`` is classify at scale n, nc 2, with the JAX model's
    parameter count."""
    jm = jbuild_model(NARROW)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    v = _np(_randomize({n: shapes[n] for n in ("params", "batch_stats")}, 2))
    x = np.random.default_rng(3).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.predict(v, x))(v, jnp.asarray(x)))
    tm = tckpt.load_jax_variables(ClassificationModel(NARROW), v["params"], v["batch_stats"])
    with torch.no_grad():
        got = tm.eval().predict(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tm.strides == () and tm.task == "classify" and got.shape == want.shape == (4, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_ATOL)
    cfg = yaml_model_load("yolov8n-cls.yaml")
    assert guess_model_task(cfg) == "classify" and cfg["scale"] == "n" and cfg["nc"] == 2
    model = build_model(cfg)
    jn = jbuild_model("yolov8n-cls.yaml")
    shapes = jax.eval_shape(lambda: jn.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    assert isinstance(model, ClassificationModel)
    assert model.num_params == n_jax == YOLOV8N_CLS_PARAMS


def test_floor_classify_weights_round_trip_exactly():
    """Every leaf of ``runs/floor_classify/best.ckpt`` (the head's
    ``layer9/conv`` and ``layer9/linear``) maps to exactly one key of the
    port's model and back to the same leaf, unchanged."""
    ckpt = tckpt.load_checkpoint(CKPT)
    params, stats = tckpt.checkpoint_variables(ckpt)
    sd = tckpt.from_jax_variables(params, stats)
    n_leaves = len(list(_leaves(params))) + len(list(_leaves(stats)))
    model = tckpt.load_jax_variables(build_model(ckpt["model_yaml"]), params, stats)
    want = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert len(sd) == n_leaves == len(want) and set(sd) == want
    assert {"model.9.linear.weight", "model.9.conv.conv.weight"} <= want
    back_p, back_s = tckpt.to_jax_variables(model.state_dict())
    for tree, back in ((params, back_p), (stats, back_s)):
        got = dict(_leaves(back))
        assert set(got) == {p for p, _ in _leaves(tree)}
        for p, a in _leaves(tree):
            np.testing.assert_array_equal(got[p], a, err_msg="/".join(p))


# --- the loss and the metrics -----------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_classification_loss_matches_jax(dtype):
    """The loss on sigmoid probabilities (some at the 1e-7 clip, some at 1)
    and its gradient w.r.t. them, in float32 and float64."""
    rng = np.random.default_rng(4)
    p = (1 / (1 + np.exp(-rng.normal(0, 3, (6, 3))))).astype(dtype)
    p[0, 0], p[1, 1] = 1e-9, 1.0
    labels = rng.integers(0, 3, 6).astype(np.int32)
    with jax.enable_x64(dtype == np.float64):
        def jfn(q):
            out = jloss.classification_loss(q, {"cls": jnp.asarray(labels)})
            return out.total, out.items
        (jtotal, jitems), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(p))
        jtotal, jcls, jg = float(jtotal), float(jitems["cls_loss"]), np.asarray(jg)
    tp = torch.from_numpy(p).requires_grad_()
    out = tloss.classification_loss(tp, {"cls": torch.from_numpy(labels)})
    out.total.backward()
    assert out.total.dtype == tp.dtype and set(out.items) == {"cls_loss"}
    np.testing.assert_allclose(out.total.item(), jtotal, rtol=LOSS_RTOL_CLS)
    np.testing.assert_allclose(out.items["cls_loss"].item(), jcls, rtol=LOSS_RTOL_CLS)
    np.testing.assert_allclose(tp.grad.numpy(), jg, rtol=LOSS_RTOL_CLS,
                               atol=LOSS_RTOL_CLS * np.abs(jg).max())


def test_classify_metrics_rank_as_jax():
    """Top-1, top-5 and fitness of ``ClassifyMetrics`` over batches with
    tied probabilities (``argsort(-p)`` ranks the lower class first) equal
    JAX's, and so do the ranks."""
    rng = np.random.default_rng(5)
    got, want = ClassifyMetrics(), jmetrics.ClassifyMetrics()
    for _ in range(3):
        p = np.round(rng.uniform(0, 1, (7, 8)), 1).astype(np.float32)  # many ties
        labels = rng.integers(0, 8, 7)
        got.update(p, labels)
        want.update(p, labels)
        np.testing.assert_array_equal(np.argsort(-p, axis=1)[:, :5], np.argsort(-p, 1)[:, :5])
    assert got.results_dict == want.results_dict and got.fitness == want.fitness
    assert 0 < got.top1 < got.top5 < 1


# --- the floor set, the validator, the predictor, the fuse --------------------------

@pytest.fixture(scope="module")
def floor_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cls_floor")
    make_cls_dataset(root, n_train=48, n_val=16, imgsz=64, seed=0)
    return root


@pytest.mark.parametrize("split,path", [("train", FLOOR_TRAIN), ("val", FLOOR_VAL)])
def test_floor_set_file_is_the_floor_set(floor_dir, split, path):
    """The committed set is ``make_cls_dataset(n_train=48, n_val=16,
    imgsz=64, seed=0)`` (48 and 16 images a class) decoded by cv2, in JAX's
    sample order: the classes' sorted folders, then sorted files."""
    ds = JaxDataset(floor_dir / split, imgsz=64)
    images, labels = floor_set(path)
    assert ds.classes == ["circle", "rect"] and len(images) == len(ds.samples)
    for img, lab, (f, c) in zip(images, labels, ds.samples):
        np.testing.assert_array_equal(img, cv2.imread(f))
        assert lab == c
    with np.load(path) as z:
        assert list(z["names"]) == ["circle", "rect"]


def test_floor_classify_validates_to_jax_metrics_exactly():
    """``runs/floor_classify/best.ckpt`` on the committed 32 val images at
    64: the JAX metrics stored with the set (the JAX validator's on the
    set's files, equal to the checkpoint's ``floor.json`` ``final_val``:
    top-1 0.78125, top-5 1.0) exactly, and the fused model the same."""
    with np.load(FLOOR_VAL) as z:
        stored = {str(k): float(v) for k, v in zip(z["jax_metric_names"], z["jax_metrics"])}
    record = json.loads((CKPT.parent / "floor.json").read_text())
    assert stored == record["final_val"] == {"metrics/accuracy_top1": 0.78125,
                                             "metrics/accuracy_top5": 1.0, "fitness": 0.890625}
    m = YOLO(CKPT, device="cpu")
    assert m.task == "classify" and m.imgsz == 64 and m.names == NAMES
    got = m.val(*floor_set(FLOOR_VAL), imgsz=64, batch=16)
    assert got == stored and isinstance(m.validator, ClassificationValidator)
    assert set(m.validator.speed) == {"preprocess", "eval", "matching"}
    assert m.fuse().val(*floor_set(FLOOR_VAL), imgsz=64, batch=5) == stored


@pytest.fixture(scope="module")
def jax_predict():
    """Seven floor images and an odd-sized random one, and the JAX facade's
    predict of the floor checkpoint on them."""
    images = floor_set(FLOOR_VAL)[0][::5] + [np.random.default_rng(6).integers(
        0, 256, (40, 90, 3), dtype=np.uint8)]
    return images, JaxYOLO(str(CKPT)).predict(images)


def test_predict_matches_jax(jax_predict):
    """``YOLO.predict`` of the floor checkpoint, batch 1 and 3, against the
    JAX facade's: probabilities within ``PROB_ATOL``, the same top-1 and
    top-5; results carry ``probs`` only."""
    images, want = jax_predict
    m = YOLO(CKPT, device="cpu")
    for batch in (1, 3):
        got = m.predict(images, batch=batch)
        for g, w in zip(got, want):
            assert g.boxes is None and g.masks is None and len(g) == 0
            np.testing.assert_allclose(g.probs.data, w.probs.data, atol=PROB_ATOL)
            assert g.probs.top1 == w.probs.top1 and g.probs.top5 == w.probs.top5
            assert g.probs.top1conf == pytest.approx(w.probs.top1conf, abs=PROB_ATOL)


def test_jax_fused_checkpoint_loads_and_predicts(tmp_path, jax_predict):
    """The floor checkpoint fused by the JAX facade and saved (the Conv
    folded, the Dense kept): the port loads it fused, carries it back leaf
    for leaf, and its probabilities equal the JAX model's within
    ``PROB_ATOL`` (fusing moves them by float rounding); the port's own fuse
    keeps them within 1e-3."""
    path = str(tmp_path / "cls_fused.ckpt")
    jf = JaxYOLO(str(CKPT)).fuse()
    jf.save(path)
    ckpt = tckpt.load_checkpoint(path)
    ty = YOLO(path, device="cpu")
    assert ckpt["deploy"] == "fused" and ty.model.fused and ty.task == "classify"
    params, stats = tckpt.to_jax_variables(ty.model.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(ckpt["params"])
    back = dict(jax.tree_util.tree_leaves_with_path(params))
    assert not stats and len(back) == len(leaves)
    for p, a in leaves:
        np.testing.assert_array_equal(back[p], a)
    images, want = jax_predict
    for g, w in zip(ty.predict(images), want):
        np.testing.assert_allclose(g.probs.data, w.probs.data, atol=PROB_ATOL)
    own = YOLO(CKPT, device="cpu").fuse()
    for g, w in zip(own.predict(images), YOLO(CKPT, device="cpu").predict(images)):
        np.testing.assert_allclose(g.probs.data, w.probs.data, atol=1e-3)


# --- the trainer ----------------------------------------------------------------

# the trainers without their EMA validation (the validator is held to JAX's
# on the floor set; JAX's compile of it would add a third of the test's time)
TRAIN = dict(task="classify", model=NARROW, epochs=2, imgsz=32, batch=4, nbs=4, workers=1,
             amp=False, plots=False, verbose=False, seed=0, exist_ok=True, val=False)


class NoiseFromNumpy(ttrainer.ClassificationTrainer):
    """The port's classify trainer drawing its noise from numpy's global
    state, as JAX's transform does."""

    def get_dataset(self, data):
        ds = super().get_dataset(data)
        ds.noise = np.random
        return ds


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both classify trainers on the same 8 train and 4 val images at 32,
    the same initial weights (JAX's ``PRNGKey(0)`` init, carried across) and
    the same draws: the datasets' ``random.Random(0)``, and numpy's global
    state seeded alike before each run."""
    tmp = tmp_path_factory.mktemp("cls_trainers")
    root = make_cls_dataset(tmp / "ds", n_train=4, n_val=2, imgsz=32, seed=1)
    np.random.seed(11)
    with recorded_jax_init() as seen:
        jt = jtrainer.ClassificationTrainer(overrides={
            **TRAIN, "data": str(root), "project": str(tmp / "jax"), "name": "t"})
        jm = jt.train()
    init = seen["v"]

    def jax_init(model, generator):
        return tckpt.load_jax_variables(model, _np_tree(init["params"]),
                                        _np_tree(init["batch_stats"]))

    data = {"names": NAMES}
    for split in ("train", "val"):
        ds = JaxDataset(root / split, imgsz=32)
        data[split] = ([cv2.imread(f) for f, _ in ds.samples], [c for _, c in ds.samples])
    orig = ttrainer.init_weights
    ttrainer.init_weights = jax_init
    np.random.seed(11)
    try:
        tt = NoiseFromNumpy(overrides={**TRAIN, "project": str(tmp / "port"), "name": "t"},
                            device="cpu")
        tm = tt.train(data)
    finally:
        ttrainer.init_weights = orig
    return {"jax": (jt, jm), "port": (tt, tm), "data": data}


def test_trainer_matches_jax(runs):
    """The same ``results.csv`` columns (the loss and the class loss) in
    JAX's order, each within ``LOSS_RTOL``; both checkpoints with JAX's
    epoch, step and tree; the host path (no augmentation in the step);
    ``YOLO(best.ckpt)`` predicts."""
    (jt, jm), (tt, tm) = runs["jax"], runs["port"]
    jr, tr = _rows(jt.csv), _rows(tt.csv)
    assert list(tr[0]) == list(jr[0]) and len(tr) == len(jr) == 2
    assert {"train/cls_loss", "train/loss"} <= set(tr[0])
    for j, t in zip(jr, tr):
        for k in j:
            if k != "epoch":
                np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=LOSS_RTOL, err_msg=k)
    assert tm == jm == {} and not tt.device_augment
    for name in ("best.ckpt", "last.ckpt"):
        j, t = jckpt.load_checkpoint(jt.wdir / name), tckpt.load_checkpoint(tt.wdir / name)
        assert (t["epoch"], t["step"]) == (j["epoch"], j["step"])
        jl = jax.tree_util.tree_leaves_with_path(j["params"])
        tl = jax.tree_util.tree_leaves_with_path(t["params"])
        assert [p for p, _ in jl] == [p for p, _ in tl]
        assert t["train_args"]["task"] == "classify"
    res = YOLO(tt.wdir / "best.ckpt", device="cpu").predict(runs["data"]["val"][0][:2])
    assert res[0].probs.data.shape == (2,)


def test_in_order_loader_reads_in_batch_order():
    """``TrainLoader(..., in_order=True)`` reads samples one batch after
    another whatever the worker count, so the draws follow the batch order:
    4 workers give the batches 1 worker gives."""
    images = floor_set(FLOOR_TRAIN)[0][:16]
    labels = [i % 2 for i in range(16)]
    out = []
    for workers in (1, 4):
        ds = ClassificationDataset(images, labels, imgsz=32, augment=True, seed=2)
        it = iter(TrainLoader(ds, 4, workers=workers, seed=2, in_order=True))
        out.append([next(it) for _ in range(6)])
        it.close()
    for a, b in zip(*out):
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["cls"], b["cls"])


def test_classify_trainer_accumulates_on_the_host_path(tmp_path):
    """nbs 8 at batch 4: two micro-batches an optimizer step, stacked
    without an instance axis (``stack_raw_batches``); 8 images give 1
    optimizer step an epoch; the task's trainer and validator are the
    facade's."""
    images, labels = floor_set(FLOOR_TRAIN)
    data = {"train": (images[::12], labels[::12]), "val": (images[:4], labels[:4]),
            "names": NAMES}
    m = YOLO("yolov8n-cls.yaml", device="cpu")
    m.train(data=data, model=NARROW, epochs=1, imgsz=32, batch=4, nbs=8, workers=2,
            project=str(tmp_path))
    assert isinstance(m.trainer, ttrainer.ClassificationTrainer)
    assert isinstance(m.trainer.validator, ClassificationValidator)
    assert m.trainer.args.accumulate == 2 and m.trainer.state.step == 1
    assert m.task == "classify" and m.ckpt_path.name == "best.ckpt"
