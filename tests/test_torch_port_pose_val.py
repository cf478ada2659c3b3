"""The PyTorch port's pose validator, predictor, deploy fuse and data path
against the JAX package on the CPU. On the pose floor set
(``make_pose_dataset`` at ``runs/floor_pose/floor.json``'s config, decoded
by cv2) with the floor_pose checkpoint: one batch's eval outputs, the eight
metrics end to end, the floor, the keypoint OKS against JAX's, and the
committed copies of the set (what the card run validates and trains on, as
the card's machine decodes no JPEG); the facade's predict against JAX's;
the pose model fused against unfused and against JAX ``fuse_tree``, and a
JAX-fused pose checkpoint. Then pose batches through the device
augmentation on the draws JAX's key yields (keypoints, their visibility
outside the image and ``flip_idx``), the ``collate`` trim of the keypoints,
and ``use_device_augment`` over every task and flag."""
import copy
import json
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import (FLOOR_POSE_TRAIN, FLOOR_POSE_VAL, POSE_CKPT, floor_pose_data,
                        floor_pose_jax_metrics, floor_pose_train_set, floor_pose_val_set,
                        shape_images)
from tests.helpers import make_pose_dataset
from tests.test_torch_port_augment import S, _hyp, jax_draws
from tests.test_torch_port_detect import _leaves
from tests.test_torch_port_pose_trainer import _data
from yolo_contour_regression_tpu.cfg import get_cfg as jax_get_cfg
from yolo_contour_regression_tpu.data import augment as jaug
from yolo_contour_regression_tpu.data import build as jbuild
from yolo_contour_regression_tpu.data import device_augment as jda
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.nn import fuse as jfuse
from yolo_contour_regression_tpu.utils import metrics as jmetrics
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.cfg import get_cfg as port_get_cfg
from yolo_contour_regression_tpu_torch.data import dataset as tdataset
from yolo_contour_regression_tpu_torch.data import device_augment as tda
from yolo_contour_regression_tpu_torch.data.augment import collate
from yolo_contour_regression_tpu_torch.data.build import use_device_augment
from yolo_contour_regression_tpu_torch.data.dataset import TrainDataset
from yolo_contour_regression_tpu_torch.engine.predictor import PosePredictor
from yolo_contour_regression_tpu_torch.engine.validator import PoseValidator
from yolo_contour_regression_tpu_torch.nn import fuse as tfuse
from yolo_contour_regression_tpu_torch.nn.tasks import PoseModel, build_model
from yolo_contour_regression_tpu_torch.utils import metrics as tmetrics
from yolo_contour_regression_tpu_torch.utils.checkpoint import (
    checkpoint_variables, load_checkpoint, load_jax_variables, to_jax_variables)


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
CKPT = ROOT / "runs" / "floor_pose" / "best.ckpt"
FLOOR = json.loads((ROOT / "runs" / "floor_pose" / "floor.json").read_text())
METRIC_KEYS = tuple(f"metrics/{m}({t})" for t in "BP"
                    for m in ("precision", "recall", "mAP50", "mAP50-95")) + ("fitness",)
# the port's validator against the JAX validator, each metric, absolute
METRIC_ATOL = 0.01
# one batch's eval outputs: boxes and keypoints (px), scores and
# visibilities (one sigmoid of f32 logits summed in other orders), box IoUs
BOX_PX, SCORE_ATOL, IOU_ATOL = 0.05, 1e-4, 1e-3
# fused against unfused (tests/test_fuse.py's), and each fused conv against
# JAX fuse_tree (the same f32 algebra, a few ulps)
FUSE_TOL, PARAM_TOL = 1e-3, 1e-5
# boxes, segments and keypoints after the augmentation, normalized (the
# port's float64 affine against JAX's float32 one)
LABEL_ATOL = 1e-5
IMGSZ, BATCH = 96, 4
KPT_SHAPE, FLIP_IDX = (5, 3), (0, 3, 2, 1, 4)


def make_floor_set(root: Path):
    """The pose floor set as the JAX trainer and validator read it (JPEGs
    and label files), made by ``make_pose_dataset`` at ``floor.json``'s
    config; returns the dataset yaml."""
    cfg = FLOOR["config"]
    return make_pose_dataset(root, n_train=cfg["n_train"], n_val=cfg["n_val"],
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
    """Write ``tests/data/torch_port_floor_pose_{train64,val16}.npz`` from a
    fresh floor set under ``root``: the decoded images, the label text, the
    data's kpt_shape and flip_idx, and with the val split the JAX
    validator's metrics."""
    yaml = make_floor_set(root)
    extra = {"kpt_shape": np.array(KPT_SHAPE), "flip_idx": np.array(FLIP_IDX)}
    images, texts = floor_arrays(root, "train")
    np.savez_compressed(FLOOR_POSE_TRAIN, images=images, labels=texts, **extra)
    images, texts = floor_arrays(root, "val")
    want = jax_floor_metrics(yaml, root / "runs")
    np.savez_compressed(FLOOR_POSE_VAL, images=images, labels=texts, **extra,
                        jax_metric_names=np.array(list(want)),
                        jax_metrics=np.array([float(v) for v in want.values()]))


@pytest.fixture(scope="module")
def floor_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("floor_pose")
    return root, make_floor_set(root)


@pytest.fixture(scope="module")
def jax_metrics(floor_dir):
    root, yaml = floor_dir
    return jax_floor_metrics(yaml, root / "runs")


@pytest.fixture(scope="module")
def port():
    return YOLO(CKPT, device="cpu")


@pytest.mark.parametrize("split,n,path", [("train", 64, FLOOR_POSE_TRAIN),
                                          ("val", 16, FLOOR_POSE_VAL)])
def test_floor_set_file_is_the_floor_set(floor_dir, split, n, path):
    """The committed file holds exactly the floor set's images, decoded by
    cv2, and its label files' text: regenerated here and compared byte for
    byte; the kpt_shape and flip_idx are the data yaml's; the parsed
    labels, keypoints included, are ``parse_label_file``'s."""
    root, yaml = floor_dir
    images, texts = floor_arrays(root, split)
    with np.load(path) as z:
        assert z["images"].dtype == np.uint8 and z["images"].shape == (n, 96, 96, 3)
        assert z["images"].tobytes() == images.tobytes()
        assert z["labels"].dtype == texts.dtype and z["labels"].tobytes() == texts.tobytes()
    assert f"kpt_shape: {list(KPT_SHAPE)}" in yaml.read_text()
    assert f"flip_idx: {list(FLIP_IDX)}" in yaml.read_text().replace(",", ", ").replace("  ", " ")
    assert floor_pose_data() == {"kpt_shape": list(KPT_SHAPE), "flip_idx": list(FLIP_IDX)}
    got_images, got_labels = (floor_pose_train_set if split == "train" else floor_pose_val_set)()
    assert len(got_images) == n
    for lab, p in zip(got_labels, split_files(root, split)[1]):
        want = tdataset.parse_label_file(str(p), kpt_shape=KPT_SHAPE)
        assert len(lab) == len(want) == 4 and lab[3].shape[1:] == KPT_SHAPE
        for g, w in zip(lab, want):
            np.testing.assert_array_equal(g, w)


def test_floor_set_file_holds_the_jax_metrics(jax_metrics):
    """The JAX validator's metrics stored with the val set are what it gives
    on the regenerated set now, and meet the floor."""
    stored = floor_pose_jax_metrics()
    assert list(stored) == list(jax_metrics)
    assert set(stored) == set(METRIC_KEYS)
    for k in stored:
        assert stored[k] == pytest.approx(jax_metrics[k], rel=1e-9), k
    for k, n in FLOOR["floor_keys"].items():
        assert stored[k] >= FLOOR["floor"][n], k


def _pose_eval_fn(jy):
    """JAX's pose eval function, as ``PoseValidator.__call__`` builds it
    (its closure), on a validator of the floor set's settings."""
    from yolo_contour_regression_tpu.ops.boxes import box_iou, scale_boxes, scale_coords, xywh2xyxy
    from yolo_contour_regression_tpu.ops.nms import non_max_suppression
    args = jax_get_cfg(overrides={"mode": "val", "imgsz": IMGSZ, "batch": BATCH, "conf": 0.001})
    model = jy.model
    kpt_shape = model.kpt_shape

    def eval_fn(variables, images, gt_bboxes, ori_shape, ratio_pad):
        pred = model.predict(variables, images)
        pred = pred.at[:, :4].set(jnp.transpose(
            xywh2xyxy(jnp.transpose(pred[:, :4], (0, 2, 1))), (0, 2, 1)))
        out = non_max_suppression(pred.astype(jnp.float32), nc=model.nc, conf_thres=args.conf,
                                  iou_thres=args.iou, pre_nms=getattr(args, "pre_nms", 4096),
                                  max_det=args.max_det, multi_label=True)
        boxes_nat = scale_boxes(out["boxes"], ratio_pad, ori_shape)
        gt_nat = scale_boxes(xywh2xyxy(gt_bboxes) * jnp.asarray(
            [images.shape[2], images.shape[1]] * 2, jnp.float32), ratio_pad, ori_shape)
        k = out["extras"].reshape(*out["extras"].shape[:2], kpt_shape[0], kpt_shape[1])
        k = k.at[..., :2].set(scale_coords(k[..., :2], ratio_pad))
        return {**out, "boxes": boxes_nat, "gt_boxes": gt_nat,
                "ious_box": jax.vmap(box_iou)(gt_nat, boxes_nat), "kpts": k}

    return eval_fn, args


def test_eval_batch_matches_jax_eval_fn(port):
    """One batch of 4 floor images through the port's ``eval_batch`` and
    the JAX pose validator's eval function (the same collated batch, the
    same weights): the same detections in the same slots, boxes and
    keypoints within ``BOX_PX``, scores and visibilities within
    ``SCORE_ATOL``, box IoUs within ``IOU_ATOL``, GT boxes equal. The
    pre_nms of both is the port's default (1024), as the facades pass it."""
    images, labels = floor_pose_val_set()
    v = PoseValidator(imgsz=IMGSZ, batch=BATCH)
    v.kpt_shape = KPT_SHAPE
    batch = next(iter(v.loader(images, labels)))
    assert batch["keypoints"].shape[1:] == (batch["mask_gt"].shape[1], *KPT_SHAPE)
    dev = {k: torch.from_numpy(batch[k]) for k in v.eval_keys}
    got = {k: t.numpy() for k, t in v.eval_batch(port.model, dev).items()}
    jy = JaxYOLO(str(CKPT))
    fn, _ = _pose_eval_fn(jy)
    want = jax.jit(fn)(jy.variables, jnp.asarray(batch["img"].astype(np.float32) / 255.0),
                       *(jnp.asarray(batch[k]) for k in ("bboxes", "ori_shape", "ratio_pad")))
    want = {k: np.asarray(x) for k, x in want.items()}
    assert set(got) <= set(want)
    for k in got:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=BOX_PX)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=SCORE_ATOL)
    np.testing.assert_allclose(got["ious_box"], want["ious_box"], atol=IOU_ATOL)
    np.testing.assert_array_equal(got["gt_boxes"], want["gt_boxes"])
    keep = got["valid"]
    np.testing.assert_allclose(got["kpts"][keep][..., :2], want["kpts"][keep][..., :2],
                               atol=BOX_PX)
    np.testing.assert_allclose(got["kpts"][keep][..., 2], want["kpts"][keep][..., 2],
                               atol=SCORE_ATOL)
    assert int(keep.sum()) >= 10


@pytest.mark.parametrize("k", [5, 17])
def test_kpt_iou_matches_jax(k):
    """``kpt_iou`` on random GT and predicted keypoints (some invisible),
    COCO sigmas at 17 and uniform ones otherwise: JAX's values exactly."""
    rng = np.random.default_rng(k)
    gt = rng.uniform(0, 96, (6, k, 3)).astype(np.float32)
    gt[..., 2] = rng.integers(0, 3, (6, k))
    pred = rng.uniform(0, 96, (9, k, 3)).astype(np.float32)
    area = rng.uniform(1, 2000, 6).astype(np.float32)
    from yolo_contour_regression_tpu.utils.loss import OKS_SIGMA
    sigma = np.asarray(OKS_SIGMA) if k == 17 else np.full(k, 1.0 / k)
    np.testing.assert_array_equal(tmetrics.kpt_iou(gt, pred, area, sigma),
                                  jmetrics.kpt_iou(gt, pred, area, sigma))


def test_yolo_val_matches_jax_validator(floor_dir, port, jax_metrics):
    """``YOLO(..., device="cpu").val`` on the floor set's JPEGs, decoded, and
    label files against the JAX validator on the same files: each of the
    eight metrics and fitness within ``METRIC_ATOL``, and the floor met."""
    root, _ = floor_dir
    files, labels = split_files(root, "val")
    got = port.val([cv2.imread(str(f)) for f in files], labels, imgsz=IMGSZ, batch=BATCH)
    assert list(got) == list(jax_metrics)
    gaps = {k: abs(got[k] - jax_metrics[k]) for k in METRIC_KEYS}
    print("port - JAX, per metric:", gaps)
    assert max(gaps.values()) <= METRIC_ATOL, gaps
    for k, n in FLOOR["floor_keys"].items():
        assert got[k] >= FLOOR["floor"][n], k
    assert isinstance(port.validator, PoseValidator)


def test_committed_floor_set_gives_the_stored_metrics(port):
    """The card run's input: the committed decoded set through the port's
    validator gives the stored JAX metrics within ``METRIC_ATOL``; the
    stage marks come in order."""
    marks = []
    v = PoseValidator(imgsz=IMGSZ, batch=BATCH, mark=marks.append)
    got = v(port.model, *floor_pose_val_set())
    want = floor_pose_jax_metrics()
    assert max(abs(got[k] - want[k]) for k in METRIC_KEYS) <= METRIC_ATOL
    assert marks[:3] == ["forward_nms", "scale_box_iou", "end"] and len(marks) == 12


# --- the facade -------------------------------------------------------------

@pytest.fixture(scope="module")
def pose_models():
    return JaxYOLO(str(POSE_CKPT)), YOLO(POSE_CKPT, device="cpu")


def test_yolo_loads_the_pose_checkpoint(pose_models):
    _, ty = pose_models
    ckpt = load_checkpoint(POSE_CKPT)
    assert ty.task == "pose" and isinstance(ty.model, PoseModel)
    assert ty.names == ckpt["names"] and ty.imgsz == 96 and ty.model.kpt_shape == (5, 3)
    assert YOLO("yolov8n-pose.yaml", device="cpu").overrides == {"model": "yolov8n-pose.yaml",
                                                                  "task": "pose"}


def _same_results(got, want):
    n = 0
    for g, w in zip(got, want):
        assert g.masks is None and g.contours is None
        wd = np.asarray(w.boxes.data, np.float32)
        assert g.boxes.data.shape == wd.shape
        np.testing.assert_array_equal(g.boxes.cls, wd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, wd[:, :4], atol=BOX_PX)
        np.testing.assert_allclose(g.boxes.conf, wd[:, 4], atol=SCORE_ATOL)
        wk = np.asarray(w.keypoints, np.float32)
        assert g.keypoints.shape == wk.shape == (len(wd), 5, 3)
        np.testing.assert_allclose(g.keypoints[..., :2], wk[..., :2], atol=BOX_PX)
        np.testing.assert_allclose(g.keypoints[..., 2], wk[..., 2], atol=SCORE_ATOL)
        n += len(g)
    return n


def test_yolo_predict_matches_jax_facade(pose_models):
    """``YOLO(floor_pose).predict`` at imgsz 96 against the JAX facade on
    the floor set's val images: the same detections, boxes and keypoints
    within ``BOX_PX``, scores and visibilities within ``SCORE_ATOL``. (The
    JAX facade raises on an image without detections, so the images are
    ones it finds objects in.)"""
    jy, ty = pose_models
    images = floor_pose_val_set()[0][:8]
    want = jy.predict(images, imgsz=96)
    got = ty.predict(images, imgsz=96)
    assert len(got) == len(want) == len(images)
    assert _same_results(got, want) >= 8


def test_predict_without_detections_gives_empty_keypoints(pose_models):
    """An image with nothing on it: no boxes, and keypoints (0, 5, 3)."""
    _, ty = pose_models
    res = ty.predict(shape_images(1, 72, 120, seed=3)[0] * 0, imgsz=96, conf=0.99)
    assert len(res[0].boxes) == 0 and res[0].keypoints.shape == (0, 5, 3)
    assert isinstance(PosePredictor(), PosePredictor)


# --- the deploy form ----------------------------------------------------------

def test_pose_fuse_equivalence_and_jax_fuse_tree():
    """The floor_pose model fused: its head maps and decode within
    ``FUSE_TOL`` of the unfused model's; every head conv a ``FusedConv``;
    each fused leaf within ``PARAM_TOL`` of JAX ``fuse_tree`` of the same
    checkpoint."""
    ckpt = load_checkpoint(POSE_CKPT)
    params, stats = checkpoint_variables(ckpt)
    model = load_jax_variables(build_model(ckpt["model_yaml"]), params, stats).eval()
    x = torch.from_numpy(np.stack(floor_pose_val_set()[0][:2])).float().div(255.0)
    x = x.flip(-1).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        want_maps, want = model(x), model.predict(x)
    fused = tfuse.fuse_model(copy.deepcopy(model))
    head = fused.model[22]
    assert all(isinstance(m[i], tfuse.FusedConv) for m in (*head.cv4, *head.detect.cv2,
                                                           *head.detect.cv3) for i in (0, 1))
    with torch.no_grad():
        got_maps, got = fused(x), fused.predict(x)
    for g, w in zip(got_maps, want_maps):
        torch.testing.assert_close(g, w, rtol=FUSE_TOL, atol=FUSE_TOL)
    scale = torch.ones_like(want)
    scale[:, :4] = scale[:, 5::3] = scale[:, 6::3] = 96.0
    torch.testing.assert_close(got / scale, want / scale, rtol=FUSE_TOL, atol=FUSE_TOL)
    jtree = jfuse.fuse_tree(params, stats)
    gp, gs = to_jax_variables(fused.state_dict())
    assert not gs
    want_leaves = dict(_leaves(jtree))
    assert set(dict(_leaves(gp))) == set(want_leaves)
    for p, a in _leaves(gp):
        np.testing.assert_allclose(a, want_leaves[p], atol=PARAM_TOL, err_msg="/".join(p))


def test_jax_fused_pose_checkpoint_loads_and_predicts(tmp_path, pose_models):
    """A pose checkpoint fused and saved by the JAX facade loads in the port
    (every leaf used and carried back unchanged) and predicts what JAX's
    fused model predicts, keypoints included; ``YOLO.fuse`` keeps the
    unfused model's detections."""
    path = str(tmp_path / "pose_fused.ckpt")
    JaxYOLO(str(POSE_CKPT)).fuse().save(path)
    ckpt = load_checkpoint(path)
    assert ckpt["deploy"] == "fused"
    ty = YOLO(path, device="cpu")
    assert ty.model.fused and ty.task == "pose"
    params, _ = to_jax_variables(ty.model.state_dict())
    got = dict(_leaves(params))
    assert set(got) == {p for p, _ in _leaves(ckpt["params"])}
    for p, a in _leaves(ckpt["params"]):
        np.testing.assert_array_equal(got[p], a)
    images = floor_pose_val_set()[0][:4]
    assert _same_results(ty.predict(images), JaxYOLO(path).predict(images, imgsz=96)) >= 4
    _, plain = pose_models
    _same_results(YOLO(POSE_CKPT, device="cpu").fuse().predict(images), plain.predict(images))


# --- the augmentation with keypoints -----------------------------------------

def _pose_raw_batch(root, n=4, seed=5):
    make_pose_dataset(root, n_train=n, n_val=1, imgsz=S, seed=seed)
    data = _data(root)
    ds = TrainDataset(*data["train"], imgsz=S, max_instances=48, kpt_shape=KPT_SHAPE)
    return collate([ds[i] for i in range(n)])


POSE_AUG_CASES = {
    "flips_mixup": dict(mixup=1.0, fliplr=0.5, flipud=0.5),
    "affine": dict(mosaic=0.0, degrees=10.0, shear=3.0, scale=0.9, translate=0.3),
    "mosaic_wide": dict(scale=0.9, translate=0.3, fliplr=0.5),
}


@pytest.mark.parametrize("name", sorted(POSE_AUG_CASES))
def test_pose_batches_augment_as_jax(tmp_path, name):
    """Pose batches from ``TrainDataset`` (with ``kpt_shape``) and the raw
    collate through the port's ``apply_augment`` on the draws of JAX's key,
    with ``flip_idx``, against JAX ``augment_batch`` on the same batch:
    ``cls`` and ``mask_gt`` equal, boxes, segments and keypoints within
    ``LABEL_ATOL``, visibilities equal (a keypoint warped out of the image
    loses its visibility: some do here)."""
    batch = _pose_raw_batch(tmp_path / "ds")
    assert batch["keypoints"].shape == (4, 8, 5, 3)
    hyp = _hyp(**POSE_AUG_CASES[name], flip_idx=tuple(FLIP_IDX))
    n_out = min(4 * batch["mask_gt"].shape[1], 48)
    key = jax.random.PRNGKey(sorted(POSE_AUG_CASES).index(name) + 3)
    warp = jda._warp_image_separable
    jda._warp_image_separable = partial(warp, dtype=jnp.float32)
    try:
        jo = jda.augment_batch(key, {k: jnp.asarray(v) for k, v in batch.items()}, hyp, S, n_out)
    finally:
        jda._warp_image_separable = warp
    draws = jax_draws(key, 4, S, hyp)
    to = tda.apply_augment({k: torch.from_numpy(v) for k, v in batch.items()}, draws, hyp, S,
                           n_out)
    assert set(to) == set(jo)
    np.testing.assert_array_equal(to["mask_gt"].numpy(), np.asarray(jo["mask_gt"]))
    np.testing.assert_array_equal(to["cls"].numpy(), np.asarray(jo["cls"]))
    for k in ("bboxes", "segments"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=LABEL_ATOL, err_msg=k)
    tk, jk = to["keypoints"].numpy(), np.asarray(jo["keypoints"])
    assert tk.shape == jk.shape == (4, n_out, 5, 3)
    np.testing.assert_allclose(tk[..., :2], jk[..., :2], atol=LABEL_ATOL)
    np.testing.assert_array_equal(tk[..., 2], jk[..., 2])
    assert int(to["mask_gt"].sum()) > 0
    if name == "mosaic_wide":
        m = to["mask_gt"].numpy()
        assert (tk[m][..., 2] == 0).any() and (tk[m][..., 2] > 0).any()
    if "fliplr" in POSE_AUG_CASES[name]:
        assert draws["fliplr"].any()


def test_fliplr_applies_flip_idx_after_the_x_flip():
    """A flipped image's keypoints: x -> 1 - x, then the ``flip_idx``
    permutation; an image that is not flipped keeps its order."""
    batch = {"img": torch.zeros((2, S, S, 3), dtype=torch.uint8),
             "cls": torch.zeros((2, 1), dtype=torch.int32),
             "bboxes": torch.tensor([[[0.5, 0.5, 0.4, 0.4]]] * 2),
             "segments": torch.zeros((2, 1, 360, 2)), "mask_gt": torch.ones((2, 1), dtype=bool),
             "content_hw": torch.full((2, 2), float(S)), "pad_tl": torch.zeros((2, 2)),
             "keypoints": torch.tensor([[[[0.5, 0.5, 2.0], [0.6, 0.5, 2.0], [0.5, 0.6, 1.0],
                                          [0.4, 0.5, 2.0], [0.5, 0.4, 2.0]]]] * 2)}
    hyp = _hyp(mosaic=0.0, scale=0.0, translate=0.0, fliplr=0.5, flip_idx=tuple(FLIP_IDX))
    draws = tda.draw_augment(np.random.default_rng(0), 2, hyp, S)
    draws["fliplr"] = np.array([True, False])
    out = tda.apply_augment(batch, draws, hyp, S, 1)["keypoints"]
    k = batch["keypoints"][0, 0]
    want = k.clone()
    want[:, 0] = 1.0 - want[:, 0]
    torch.testing.assert_close(out[0, 0], want[list(FLIP_IDX)], atol=1e-6, rtol=0)
    torch.testing.assert_close(out[1, 0], k, atol=1e-6, rtol=0)


def test_collate_trims_keypoints_with_the_instances(tmp_path):
    """``collate`` trims ``keypoints`` to the instance bucket with ``cls``,
    ``bboxes``, ``segments`` and ``mask_gt``, as JAX's ``collate`` does."""
    make_pose_dataset(tmp_path / "ds", n_train=4, n_val=1, imgsz=S, seed=2)
    data = _data(tmp_path / "ds")
    ds = TrainDataset(*data["train"], imgsz=S, max_instances=48, kpt_shape=KPT_SHAPE)
    samples = [ds[i] for i in range(4)]
    assert samples[0]["keypoints"].shape == (48, 5, 3)
    got, want = collate(samples), jaug.collate(samples)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["keypoints"].shape[1] == got["mask_gt"].shape[1] == 8


TASKS = ("detect", "segment", "segment_ori", "pose", "classify")


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("device_augment", [True, False])
@pytest.mark.parametrize("mosaic9", [0.0, 0.5])
@pytest.mark.parametrize("copy_paste", [0.0, 0.1])
def test_use_device_augment_matches_jax_over_tasks(task, device_augment, mosaic9, copy_paste):
    """``use_device_augment`` is JAX's over every task and flag: the device
    path for detect, segment, segment_ori and pose with ``device_augment``
    and neither ``mosaic9`` nor ``copy_paste``; classify never."""
    over = dict(task=task, device_augment=device_augment, mosaic9=mosaic9, copy_paste=copy_paste)
    got = use_device_augment(port_get_cfg(overrides=over))
    assert got == jbuild.use_device_augment(jax_get_cfg(overrides=over))
    assert got == (task != "classify" and device_augment and not mosaic9 and not copy_paste)
    assert use_device_augment(SimpleNamespace(device_augment=True)) == \
        jbuild.use_device_augment(SimpleNamespace(device_augment=True))
