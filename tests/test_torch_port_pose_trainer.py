"""The PyTorch port's pose trainer against the JAX package's on the CPU:
both trainers train the narrow yolov8-pose graph from the same initial
weights for 2 epochs on 8 images of ``make_pose_dataset`` at imgsz 64,
batch 4, with the augmentation reduced to the identity (as
``test_torch_port_trainer.py`` does for the segment task), the data's
``kpt_shape`` [5, 3] overriding the config's 17, and are compared by their
``results.csv``, checkpoints and final metrics. JAX's network runs in
float64 (its loss math in float32, as the port's), as the train-step tests
hold the port to it: at this size the float32 gradients of either side are
far from their float64 values in a few tensors (see
``test_torch_port_pose.py``), and AdamW's first steps move a parameter by
about lr whatever its gradient's size, so JAX's float32 trainer leaves the
float64 trajectory by the second epoch; the port's float32 trainer stays on
it. Then the task dispatch of the trainers and the facade."""
import copy
from functools import partial

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_pose_dataset
from tests.test_torch_port_trainer import IDENTITY_AUG, LOSS_RTOL, METRIC_ATOL, _np_tree, _rows
from tests.torch_port_jax_init import compiled_trainer_init
from yolo_contour_regression_tpu.data import device_augment as jda
from yolo_contour_regression_tpu.engine import trainer as jtrainer
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.utils import checkpoint as jckpt
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine import trainer as ttrainer
from yolo_contour_regression_tpu_torch.engine.validator import PoseValidator
from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8_POSE, PoseModel
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

NARROW = copy.deepcopy(YOLOV8_POSE)
NARROW.update(nc=1, scale="t", scales={"t": [0.33, 0.125, 256]})
KPT_SHAPE, FLIP_IDX = [5, 3], [0, 3, 2, 1, 4]
TRAIN = dict(task="pose", model=NARROW, epochs=2, imgsz=64, batch=4, nbs=4, workers=1,
             amp=False, plots=False, verbose=False, seed=0, exist_ok=True, **IDENTITY_AUG)


def _data(root):
    """The decoded images and label paths of a ``make_pose_dataset`` root,
    and its data yaml's ``kpt_shape`` and ``flip_idx``."""
    out = {"names": {0: "circle"}, "kpt_shape": KPT_SHAPE, "flip_idx": FLIP_IDX}
    for split in ("train", "val"):
        files = sorted((root / "images" / split).glob("*.jpg"))
        out[split] = ([cv2.imread(str(f)) for f in files],
                      [root / "labels" / split / (f.stem + ".txt") for f in files])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both pose trainers on the same data and initial weights, JAX's
    separable warp in float32, its trainer one step per dispatch and its
    network in float64; the port's init replaced by JAX's trainer's
    (``PRNGKey(0)`` on the config with the data's ``kpt_shape``, compiled;
    the float64 build's parameters are float32), carried across."""
    tmp = tmp_path_factory.mktemp("pose_trainers")
    yaml = make_pose_dataset(tmp / "ds", n_train=8, n_val=4, imgsz=64, seed=0)
    warp, build = jda._warp_image_separable, jtrainer.build_model
    jda._warp_image_separable = partial(warp, dtype=jnp.float32)
    jtrainer.build_model = lambda *a, **kw: build(*a, **{**kw, "dtype": jnp.float64})
    try:
        with jax.enable_x64(True), compiled_trainer_init() as seen:
            jt = jtrainer.PoseTrainer(overrides={
                **TRAIN, "data": str(yaml), "steps_per_dispatch": 1,
                "project": str(tmp / "jax"), "name": "t"})
            jm = jt.train()
    finally:
        jda._warp_image_separable, jtrainer.build_model = warp, build
    init = seen["v"]

    def jax_init(model, generator):
        return tckpt.load_jax_variables(model, _np_tree(init["params"]),
                                        _np_tree(init["batch_stats"]))

    orig = ttrainer.init_weights
    ttrainer.init_weights = jax_init
    try:
        tt = ttrainer.PoseTrainer(overrides={**TRAIN, "project": str(tmp / "port"), "name": "t"},
                                  device="cpu")
        tm = tt.train(_data(tmp / "ds"))
    finally:
        ttrainer.init_weights = orig
    return {"jax": (jt, jm), "port": (tt, tm), "yaml": yaml, "tmp": tmp}


def test_results_csv_matches_jax(runs):
    """The same columns (box, cls, dfl, pose and kobj losses, the eight
    metrics and fitness) in the same order; the train losses within
    ``LOSS_RTOL``, the val metrics within ``METRIC_ATOL``."""
    (jt, _), (tt, _) = runs["jax"], runs["port"]
    jr, tr = _rows(jt.csv), _rows(tt.csv)
    assert list(tr[0]) == list(jr[0]) and len(tr) == len(jr) == 2
    assert {"train/pose_loss", "train/kobj_loss", "metrics/mAP50-95(P)"} <= set(tr[0])
    for j, t in zip(jr, tr):
        for k in j:
            if k.startswith("train/"):
                np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=LOSS_RTOL, err_msg=k)
            elif k != "epoch":
                assert abs(float(t[k]) - float(j[k])) <= METRIC_ATOL, k


def test_final_metrics_and_checkpoints_match_jax(runs):
    """The final validation of the stripped best.ckpt within ``METRIC_ATOL``
    of JAX's; both checkpoints with JAX's keys, epoch, step and tree leaves,
    stripped, task pose, the model config's ``kpt_shape`` the data's, and
    ``flip_idx`` in the train args."""
    (jt, jm), (tt, tm) = runs["jax"], runs["port"]
    assert list(tm) == list(jm)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= METRIC_ATOL, k
    assert isinstance(tt.validator, PoseValidator) and tt.model.kpt_shape == (5, 3)
    for name in ("best.ckpt", "last.ckpt"):
        j, t = jckpt.load_checkpoint(jt.wdir / name), tckpt.load_checkpoint(tt.wdir / name)
        assert set(t) == set(j) | {"deploy"} and t["ema_params"] is None
        assert (t["epoch"], t["step"]) == (j["epoch"], j["step"])
        jl = jax.tree_util.tree_leaves_with_path(j["params"])
        tl = jax.tree_util.tree_leaves_with_path(t["params"])
        assert [p for p, _ in jl] == [p for p, _ in tl]
        assert [np.shape(a) for _, a in jl] == [np.shape(a) for _, a in tl]
        assert t["train_args"]["task"] == "pose" and t["model_yaml"]["kpt_shape"] == KPT_SHAPE
        assert t["train_args"]["flip_idx"] == FLIP_IDX


def test_jax_validates_the_port_checkpoint_and_the_facade_adopts_it(runs):
    """The JAX package loads the port's stripped best.ckpt and validates it
    to the port's metrics within ``METRIC_ATOL``; ``YOLO(best.ckpt)`` in the
    port is a pose model, and predicts boxes and keypoints."""
    tt, tm = runs["port"]
    jm = JaxYOLO(str(tt.wdir / "best.ckpt")).val(data=str(runs["yaml"]), imgsz=64, batch=4,
                                                 plots=False, project=str(runs["tmp"] / "jval"))
    for k in tm:
        assert abs(tm[k] - jm[k]) <= METRIC_ATOL, k
    m = YOLO(tt.wdir / "best.ckpt", device="cpu")
    assert m.task == "pose" and isinstance(m.model, PoseModel)
    res = m.predict(np.full((64, 64, 3), 40, np.uint8), imgsz=64, conf=0.0, max_det=5)
    assert res[0].contours is None and res[0].keypoints.shape == (len(res[0].boxes), 5, 3)


def test_the_task_picks_the_pose_trainer(tmp_path):
    """A pose config trains with ``PoseTrainer`` (by default
    ``yolov8n-pose.yaml``); a mismatch raises; a classify task in any
    trainer takes the host path (JAX's ``use_device_augment`` leaves it
    out); the facade takes the task's trainer."""
    over = {"project": str(tmp_path)}
    t = ttrainer.PoseTrainer(overrides=over, device="cpu")
    assert t.args.task == "pose" and t.args.model is None
    assert ttrainer.PoseTrainer.default_model == "yolov8n-pose.yaml"
    with pytest.raises(NotImplementedError, match="task"):
        ttrainer.PoseTrainer(overrides={**over, "model": "yolov8n.yaml"}, device="cpu")
    with pytest.raises(NotImplementedError, match="task"):
        ttrainer.DetectionTrainer(overrides={**over, "model": "yolov8n-pose.yaml"}, device="cpu")
    cls_trainer = type("T", (ttrainer.BaseTrainer,), {"task": "classify",
                                                      "default_model": "yolov8n.yaml"})
    assert not cls_trainer(overrides={**over, "task": "classify"}, device="cpu").device_augment
    m = YOLO("yolov8n-pose.yaml", device="cpu")
    assert m.task == "pose" and m.model is None
