"""The PyTorch port's detect trainer against the JAX package's on the CPU:
both trainers train the narrow yolov8 detect graph from the same initial
weights for 2 epochs on 8 images at imgsz 64, batch 4, with the
augmentation reduced to the identity (as ``test_torch_port_trainer.py``
does for the segment task), and are compared by their ``results.csv``,
checkpoints and final metrics. Then the device augmentation on detect
batches given the draws JAX's key yields (box labels take the box-corner
branch), and the task dispatch of the trainers and the facade."""
import copy
from functools import partial

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_shape_dataset
from tests.test_torch_port_augment import S, _hyp, jax_draws
from tests.test_torch_port_trainer import IDENTITY_AUG, LOSS_RTOL, METRIC_ATOL, _np_tree, _rows
from tests.torch_port_jax_init import compiled_trainer_init
from yolo_contour_regression_tpu.data import device_augment as jda
from yolo_contour_regression_tpu.engine import trainer as jtrainer
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.utils import checkpoint as jckpt
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.data import device_augment as tda
from yolo_contour_regression_tpu_torch.data.augment import collate
from yolo_contour_regression_tpu_torch.data.dataset import TrainDataset
from yolo_contour_regression_tpu_torch.engine import trainer as ttrainer
from yolo_contour_regression_tpu_torch.engine.validator import DetectionValidator
from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8, DetectionModel
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

NARROW = copy.deepcopy(YOLOV8)
NARROW.update(nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})
TRAIN = dict(task="detect", model=NARROW, epochs=2, imgsz=64, batch=4, nbs=4, workers=1,
             amp=False, plots=False, verbose=False, seed=0, exist_ok=True, **IDENTITY_AUG)
# boxes after the augmentation, normalized (the port's float64 affine
# against JAX's float32 one)
LABEL_ATOL = 1e-5


def _data(root, box_labels=False):
    """The decoded images and label paths of a ``make_shape_dataset`` root;
    with ``box_labels`` each polygon label is rewritten as its box (5
    numbers), as a detect dataset holds them."""
    out = {"names": {0: "circle", 1: "rect"}}
    for split in ("train", "val"):
        files = sorted((root / "images" / split).glob("*.jpg"))
        labels = [root / "labels" / split / (f.stem + ".txt") for f in files]
        if box_labels:
            for p in labels:
                lines = []
                for line in p.read_text().splitlines():
                    c, *xy = line.split()
                    pts = np.asarray(xy, np.float64).reshape(-1, 2)
                    lo, hi = pts.min(0), pts.max(0)
                    lines.append(f"{c} " + " ".join(f"{v:.6f}" for v in (*(lo + hi) / 2, *(hi - lo))))
                p.write_text("\n".join(lines))
        out[split] = ([cv2.imread(str(f)) for f in files], labels)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both detect trainers on the same data and initial weights, JAX's
    separable warp in float32, its trainer one step per dispatch; the port's
    init replaced by JAX's (``PRNGKey(0)``), carried across."""
    tmp = tmp_path_factory.mktemp("detect_trainers")
    yaml = make_shape_dataset(tmp / "ds", n_train=8, n_val=4, imgsz=64, seed=0)
    warp = jda._warp_image_separable
    jda._warp_image_separable = partial(warp, dtype=jnp.float32)
    try:
        with compiled_trainer_init() as seen:
            jt = jtrainer.DetectionTrainer(overrides={
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
        tt = ttrainer.DetectionTrainer(overrides={**TRAIN, "project": str(tmp / "port"),
                                                  "name": "t"}, device="cpu")
        tm = tt.train(_data(tmp / "ds"))
    finally:
        ttrainer.init_weights = orig
    return {"jax": (jt, jm), "port": (tt, tm), "yaml": yaml, "tmp": tmp}


def test_results_csv_matches_jax(runs):
    """The same columns (box, cls and dfl losses, the five box metrics) in
    the same order; the train losses within ``LOSS_RTOL``, the val metrics
    within ``METRIC_ATOL``."""
    (jt, _), (tt, _) = runs["jax"], runs["port"]
    jr, tr = _rows(jt.csv), _rows(tt.csv)
    assert list(tr[0]) == list(jr[0]) and len(tr) == len(jr) == 2
    assert {"train/box_loss", "train/cls_loss", "train/dfl_loss"} <= set(tr[0])
    for j, t in zip(jr, tr):
        for k in j:
            if k.startswith("train/"):
                np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=LOSS_RTOL, err_msg=k)
            elif k != "epoch":
                assert abs(float(t[k]) - float(j[k])) <= METRIC_ATOL, k


def test_final_metrics_and_checkpoints_match_jax(runs):
    """The final validation of the stripped best.ckpt within ``METRIC_ATOL``
    of JAX's; both checkpoints with JAX's keys, epoch, step and tree
    leaves, stripped, task detect."""
    (jt, jm), (tt, tm) = runs["jax"], runs["port"]
    assert list(tm) == list(jm)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= METRIC_ATOL, k
    assert isinstance(tt.validator, DetectionValidator)
    for name in ("best.ckpt", "last.ckpt"):
        j, t = jckpt.load_checkpoint(jt.wdir / name), tckpt.load_checkpoint(tt.wdir / name)
        assert set(t) == set(j) | {"deploy"} and t["ema_params"] is None
        assert (t["epoch"], t["step"]) == (j["epoch"], j["step"])
        jl = jax.tree_util.tree_leaves_with_path(j["params"])
        tl = jax.tree_util.tree_leaves_with_path(t["params"])
        assert [p for p, _ in jl] == [p for p, _ in tl]
        assert t["train_args"]["task"] == "detect" and t["model_yaml"]["head"][-1][2] == "Detect"


def test_jax_validates_the_port_checkpoint_and_the_facade_adopts_it(runs):
    """The JAX package loads the port's stripped best.ckpt and validates it
    to the port's metrics within ``METRIC_ATOL``; ``YOLO(best.ckpt)`` in the
    port is a detect model holding its weights, and predicts boxes only."""
    tt, tm = runs["port"]
    jm = JaxYOLO(str(tt.wdir / "best.ckpt")).val(data=str(runs["yaml"]), imgsz=64, batch=4,
                                                 plots=False, project=str(runs["tmp"] / "jval"))
    for k in tm:
        assert abs(tm[k] - jm[k]) <= METRIC_ATOL, k
    m = YOLO(tt.wdir / "best.ckpt", device="cpu")
    assert m.task == "detect" and isinstance(m.model, DetectionModel)
    params, _ = tckpt.to_jax_variables(m.model.state_dict())
    ckpt = tckpt.load_checkpoint(tt.wdir / "best.ckpt")
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                              jax.tree_util.tree_leaves_with_path(ckpt["params"])):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    res = m.predict(np.full((64, 64, 3), 40, np.uint8), imgsz=64, conf=0.0)
    assert res[0].contours is None and res[0].masks is None


@pytest.mark.parametrize("box_labels,hyp_kw", [
    (True, dict(mixup=1.0, fliplr=0.5, flipud=0.5)),
    (True, dict(mosaic=0.0, degrees=10.0, shear=3.0)),
    (False, dict(mixup=1.0, fliplr=0.5, flipud=0.5)),
])
def test_detect_batches_augment_as_jax(tmp_path, box_labels, hyp_kw):
    """Detect batches from ``TrainDataset`` and the raw collate through the
    port's ``apply_augment`` on the draws of JAX's key, against JAX
    ``augment_batch`` on the same batch: ``cls`` and ``mask_gt`` equal,
    boxes and segments within ``LABEL_ATOL``. Box labels carry zero
    segments, so every instance's box comes from the box-corner branch;
    polygon labels are carried as the JAX detect dataset carries them."""
    root = tmp_path / "ds"
    make_shape_dataset(root, n_train=4, n_val=1, imgsz=S, seed=5)
    images, labels = _data(root, box_labels)["train"]
    ds = TrainDataset(images, labels, imgsz=S, max_instances=48)
    batch = collate([ds[i] for i in range(4)])
    has_seg = np.abs(batch["segments"]).sum((-1, -2)) > 0
    assert not has_seg.any() if box_labels else has_seg[batch["mask_gt"]].all()
    hyp = _hyp(**hyp_kw)
    n_out = min(4 * batch["mask_gt"].shape[1], 48)
    key = jax.random.PRNGKey(7)
    warp = jda._warp_image_separable
    jda._warp_image_separable = partial(warp, dtype=jnp.float32)
    try:
        jo = jda.augment_batch(key, {k: jnp.asarray(v) for k, v in batch.items()}, hyp, S, n_out)
    finally:
        jda._warp_image_separable = warp
    to = tda.apply_augment({k: torch.from_numpy(v) for k, v in batch.items()},
                           jax_draws(key, 4, S, hyp), hyp, S, n_out)
    np.testing.assert_array_equal(to["mask_gt"].numpy(), np.asarray(jo["mask_gt"]))
    np.testing.assert_array_equal(to["cls"].numpy(), np.asarray(jo["cls"]))
    for k in ("bboxes", "segments"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=LABEL_ATOL, err_msg=k)
    assert int(to["mask_gt"].sum()) > 0


def test_the_task_picks_the_trainer(tmp_path):
    """The task is the override's, else the model config's head's: a
    detect config trains with ``DetectionTrainer`` (by default
    ``yolov8n.yaml``); a mismatch raises; the facade takes the task's
    trainer."""
    over = {"project": str(tmp_path)}
    assert ttrainer.DetectionTrainer(overrides=over, device="cpu").args.task == "detect"
    assert ttrainer.DetectionTrainer(overrides={**over, "model": "yolov8s.yaml"},
                                     device="cpu").args.model == "yolov8s.yaml"
    with pytest.raises(NotImplementedError, match="task"):
        ttrainer.DetectionTrainer(overrides={**over, "model": "yolov8n-seg.yaml"}, device="cpu")
    with pytest.raises(NotImplementedError, match="task"):
        ttrainer.SegmentationTrainer(overrides={**over, "task": "detect"}, device="cpu")
    m = YOLO("yolov8n.yaml", device="cpu")
    assert m.task == "detect" and m.model is None
