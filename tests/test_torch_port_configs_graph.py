"""The seven configs the port added last (yolov3, yolov5, yolov6,
yolov8-det-rep, yolov8-p2, yolov8-p6, yolov8-pose-p6) as whole graphs
against the JAX package on the CPU, each at its own depth and a narrow
width (``tests/test_torch_port_configs.py:narrow``) with JAX's weights
drawn by numpy: the head maps, the decode, NMS, the fuse against the
unfused model and against JAX's fused tree; the four-level parts (decode,
assigner, detect and pose losses, the validator's eval) at strides 4-32
and 8-64; and checkpoints written by the JAX package's own writer, loaded
by the port's facade. The four-level train step and head priors are in
``tests/test_torch_port_configs_step.py``."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import shape_images
from yolo_contour_regression_tpu.cfg import get_cfg
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_contour_regression_tpu.nn import fuse as jfuse
from yolo_contour_regression_tpu.nn.modules import head as jhead
from yolo_contour_regression_tpu.nn.tasks import build_model as jbuild_model
from yolo_contour_regression_tpu.ops import nms as jnms
from yolo_contour_regression_tpu.utils import loss as jloss
from yolo_contour_regression_tpu.utils import tal as jtal
from yolo_contour_regression_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine.predictor import detect_xyxy
from yolo_contour_regression_tpu_torch.engine.validator import DetectionValidator
from yolo_contour_regression_tpu_torch.nn import fuse as tfuse
from yolo_contour_regression_tpu_torch.nn.modules import head as thead
from yolo_contour_regression_tpu_torch.nn.tasks import build_model
from yolo_contour_regression_tpu_torch.ops import nms as tnms
from yolo_contour_regression_tpu_torch.utils import loss as tloss
from yolo_contour_regression_tpu_torch.utils import tal as ttal
from yolo_contour_regression_tpu_torch.utils.checkpoint import (from_jax_variables,
                                                                load_jax_variables,
                                                                to_jax_variables)

from tests.test_torch_port_configs import CONFIGS, narrow
from tests.test_torch_port_detect import _det_batch
from tests.test_torch_port_modules import _randomize
from tests.test_torch_port_pose import HYP, _pose_batch
from tests.test_torch_port_train import _np, _t


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NAMES = [c[0] for c in CONFIGS]
# heads against JAX's, relative to the largest value (summation order only)
GRAPH_ATOL = 1e-3
# decoded and kept detections: boxes and keypoints in pixels, scores
BOX_PX, SCORE_ATOL = 0.05, 1e-4
# the fused model against the unfused one; its leaves against JAX's fused tree
FUSE_TOL, PARAM_TOL = 1e-3, 1e-5
# four-level losses on the same maps
LOSS_RTOL = 1e-5
ASSIGN_TOL = 1e-5
STRIDES = {"p2": (4, 8, 16, 32), "p6": (8, 16, 32, 64)}


def _imgsz(strides):
    return 128 if max(strides) == 64 else 64


def _jax_narrow(name, seed):
    """The narrow config, JAX's model and its variables drawn by numpy."""
    cfg = narrow(name)
    jm = jbuild_model(cfg)
    imgsz = _imgsz(jm.strides)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, imgsz, imgsz, 3)), train=False))
    v = _np(_randomize({k: shapes[k] for k in ("params", "batch_stats")}, seed))
    return cfg, jm, v, imgsz


def _xyxy(pred):
    """(B, 4 + nc + E, A) xywh -> xyxy, numpy."""
    p = np.array(pred, copy=True)
    xy, wh = p[:, :2].copy(), p[:, 2:4].copy()
    p[:, :2], p[:, 2:4] = xy - wh / 2, xy + wh / 2
    return p


def _same_kept(got, want, n_min=1):
    """NMS outputs: the same slots kept, classes equal, boxes and extras
    (keypoints: pixels, visibility) and scores within their limits."""
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    keep = want["valid"]
    np.testing.assert_array_equal(got["classes"][keep], want["classes"][keep])
    np.testing.assert_allclose(got["boxes"][keep], want["boxes"][keep], atol=BOX_PX)
    np.testing.assert_allclose(got["scores"][keep], want["scores"][keep], atol=SCORE_ATOL)
    if "extras" in want and want["extras"].shape[-1]:
        np.testing.assert_allclose(got["extras"][keep], want["extras"][keep], atol=BOX_PX)
    assert int(keep.sum()) >= n_min


@pytest.mark.parametrize("name", NAMES)
def test_narrow_graph_nms_and_fuse_match_jax(name):
    """Every level's head map (1e-3 of its largest), the decode (boxes and
    keypoints 0.05 px, scores 1e-4), NMS's kept detections; the fused model
    against the unfused one (1e-3) and its leaves against JAX
    ``fuse_variables`` (v6's raw transposed convs pass through both)."""
    cfg, jm, v, imgsz = _jax_narrow(name, 11)
    x = np.random.default_rng(12).uniform(0, 1, (2, imgsz, imgsz, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.raw_forward(v, x))(v, jnp.asarray(x))
    tm = load_jax_variables(build_model(cfg), v["params"], v["batch_stats"]).eval()
    assert tm.strides == tuple(jm.strides) and len(want) == len(tm.strides)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got, pred = tm(xt), tm.predict(xt)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   atol=GRAPH_ATOL * max(1.0, float(np.abs(w).max())))
    jpred = np.asarray(jm.decode(want))
    nc, pred = tm.nc, pred.numpy()
    np.testing.assert_allclose(pred[:, :4], jpred[:, :4], atol=BOX_PX)
    np.testing.assert_allclose(pred[:, 4:4 + nc], jpred[:, 4:4 + nc], atol=SCORE_ATOL)
    if tm.task == "pose":
        kp, jkp = pred[:, 4 + nc:].reshape(2, 17, 3, -1), jpred[:, 4 + nc:].reshape(2, 17, 3, -1)
        np.testing.assert_allclose(kp[:, :, :2], jkp[:, :, :2], atol=BOX_PX)
        np.testing.assert_allclose(kp[:, :, 2], jkp[:, :, 2], atol=SCORE_ATOL)
    kw = dict(nc=nc, conf_thres=0.25, iou_thres=0.7, pre_nms=1024, max_det=300)
    _same_kept(tnms.non_max_suppression(detect_xyxy(torch.from_numpy(pred)), **kw),
               jnms.non_max_suppression(jnp.asarray(_xyxy(jpred)), **kw))

    fused = tfuse.fuse_model(copy.deepcopy(tm))
    with torch.no_grad():
        fgot = fused(xt)
    for g, r in zip(fgot, got):
        torch.testing.assert_close(g, r, rtol=FUSE_TOL,
                                   atol=FUSE_TOL * max(1.0, float(r.abs().max())))
    fvars, _ = jfuse.fuse_variables(jm, v)
    fwant = from_jax_variables(jax.tree_util.tree_map(np.asarray, fvars["params"]), {})
    sd = fused.state_dict()
    assert set(sd) == set(fwant)
    for k, w in fwant.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=PARAM_TOL, err_msg=k)


# --- the four-level parts ------------------------------------------------------

def _level_maps(rng, strides, c, imgsz, nk=0):
    """Random head maps (B 2, NHWC) of ``c`` channels at each stride, their
    box bins falling with the bin (sides of 1-2 cells), keypoints small."""
    feats = []
    for s in strides:
        f = rng.normal(0, 2, (2, imgsz // s, imgsz // s, c))
        f[..., :64] -= np.tile(0.6 * np.arange(16), 4)
        if nk:
            f[..., c - nk:] *= 0.4
        feats.append(f.astype(np.float32))
    return feats


@pytest.mark.parametrize("level", ["p2", "p6"])
def test_four_level_decodes_match_jax(level):
    """``decode_detect`` (B, 4 + nc, A) and ``decode_pose`` (B, A, K, 3) on
    four levels of random maps: anchors row-major level by level."""
    strides, nc, k = STRIDES[level], 3, 17
    imgsz = _imgsz(strides)
    feats = _level_maps(np.random.default_rng(31), strides, 64 + nc + 3 * k, imgsz, 3 * k)
    det = [f[..., :64 + nc] for f in feats]
    want = jhead.decode_detect([jnp.asarray(f) for f in det], strides, nc)
    got = thead.decode_detect([_t(f).permute(0, 3, 1, 2) for f in det], strides, nc)
    assert got.shape[-1] == sum((imgsz // s) ** 2 for s in strides)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BOX_PX)
    hw = [(imgsz // s, imgsz // s) for s in strides]
    kraw = np.concatenate([f[..., 64 + nc:].reshape(2, -1, 3 * k) for f in feats], 1)
    want = jhead.decode_pose(jnp.asarray(kraw), strides, hw, (k, 3))
    got = thead.decode_pose(_t(kraw), strides, hw, (k, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BOX_PX)


@pytest.mark.parametrize("level", ["p2", "p6"])
def test_four_level_assigner_matches_jax(level):
    """The task-aligned assigner over four levels of anchors: fg_mask,
    target indices, labels and boxes equal, scores within 1e-5."""
    strides = STRIDES[level]
    imgsz = _imgsz(strides)
    rng = np.random.default_rng(41)
    anc = np.concatenate([np.stack(np.meshgrid(np.arange(imgsz // s) + 0.5,
                                               np.arange(imgsz // s) + 0.5), -1).reshape(-1, 2) * s
                          for s in strides]).astype(np.float32)
    A, B, N, nc = len(anc), 2, 6, 3
    scores = rng.uniform(0, 1, (B, A, nc)).astype(np.float32)
    half = rng.uniform(2, imgsz / 3, (B, A, 2))
    pred = np.concatenate([anc - half, anc + half], -1).astype(np.float32)
    c = rng.uniform(imgsz * 0.2, imgsz * 0.8, (B, N, 2))
    wh = rng.uniform(imgsz * 0.1, imgsz * 0.7, (B, N, 2))
    gt = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    labels = rng.integers(0, nc, (B, N)).astype(np.int32)
    mask = np.ones((B, N), bool)
    mask[1, 4:] = False
    args = (scores, pred, anc, labels, gt, mask)
    want = jtal.task_aligned_assign(*(jnp.asarray(a) for a in args))
    got = ttal.task_aligned_assign(*(_t(a) for a in args))
    for k in ("fg_mask", "target_gt_idx", "target_labels", "target_bboxes"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores),
                               atol=ASSIGN_TOL)
    assert int(got.fg_mask.sum()) > 10


@pytest.mark.parametrize("level,pose", [("p2", False), ("p6", False), ("p6", True)])
def test_four_level_losses_and_grads_match_jax(level, pose):
    """The detect and pose losses on four levels of random maps: the total,
    its items, the assignment, and the gradient w.r.t. the maps."""
    strides, nc, k = STRIDES[level], 2, 17
    imgsz = _imgsz(strides)
    nk = 3 * k if pose else 0
    _, batch = (_pose_batch(51, 2, 4, k, imgsz) if pose else _det_batch(51, 2, 4, imgsz))
    feats = _level_maps(np.random.default_rng(52), strides, 64 + nc + nk, imgsz, nk)
    jb = {n: jnp.asarray(a) for n, a in batch.items()}

    def jfn(fs):
        out = (jloss.pose_loss(fs, jb, strides, nc, HYP, (k, 3)) if pose
               else jloss.detection_loss(fs, jb, strides, nc, HYP))
        return out.total, out.items

    # compiled once each: eager dispatch took most of this test's time
    (jtotal, jitems), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        [jnp.asarray(f) for f in feats])
    jassign = jax.jit(lambda fs: jloss.detection_loss(fs, jb, strides, nc, HYP,
                                                      return_assign=True)[1])(
        [jnp.asarray(f[..., :64 + nc]) for f in feats])
    tfeats = [_t(f).permute(0, 3, 1, 2).contiguous().requires_grad_() for f in feats]
    tb = {n: _t(a) for n, a in batch.items()}
    out = (tloss.pose_loss(tfeats, tb, strides, nc, HYP, (k, 3)) if pose
           else tloss.detection_loss(tfeats, tb, strides, nc, HYP))
    out.total.backward()
    assign = tloss.detect_targets([f[:, :64 + nc] for f in tfeats], tb, strides, nc).assign
    fg = np.asarray(jassign.fg_mask)
    np.testing.assert_array_equal(assign.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(assign.target_gt_idx.numpy()[fg],
                                  np.asarray(jassign.target_gt_idx)[fg])
    assert int(fg.sum()) > 0
    np.testing.assert_allclose(out.total.item(), float(jtotal), rtol=LOSS_RTOL)
    assert set(out.items) == set(jitems)
    for n in jitems:
        np.testing.assert_allclose(out.items[n].item(), float(jitems[n]), rtol=LOSS_RTOL,
                                   err_msg=n)
    for tf, jg in zip(tfeats, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tf.grad.permute(0, 2, 3, 1).numpy(), jg, rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * np.abs(jg).max())


@pytest.mark.parametrize("name", ["yolov8n-p2.yaml", "yolov8n-p6.yaml"])
def test_four_level_validator_eval_matches_jax(name):
    """One batch of the detect floor set through the port's ``eval_batch``
    and JAX ``_make_eval_fn`` with the same narrow four-level weights: the
    same detections in the same slots, boxes, scores and box IoUs within
    their limits, GT boxes equal."""
    from chip_smoke import floor_detect_val_set

    cfg, jm, v, imgsz = _jax_narrow(name, 61)
    tm = load_jax_variables(build_model(cfg), v["params"], v["batch_stats"]).eval()
    images, labels = floor_detect_val_set()
    val = DetectionValidator(imgsz=imgsz, batch=4, max_det=1000)
    batch = next(iter(val.loader(images[:4], labels[:4])))
    got = val.eval_batch(tm, {k: torch.from_numpy(batch[k]) for k in val.eval_keys})
    got = {k: t.numpy() for k, t in got.items()}
    jv = JaxValidator(get_cfg(overrides={"mode": "val", "imgsz": imgsz, "batch": 4,
                                         "max_det": 1000}))
    fn = jax.jit(jv._make_eval_fn(jm, imgsz))
    want = fn(v, jnp.asarray(batch["img"].astype(np.float32) / 255.0),
              *(jnp.asarray(batch[k]) for k in ("bboxes", "ori_shape", "ratio_pad")))
    want = {k: np.asarray(x) for k, x in want.items()}
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    keep = want["valid"]
    np.testing.assert_array_equal(got["classes"][keep], want["classes"][keep])
    np.testing.assert_allclose(got["boxes"][keep], want["boxes"][keep], atol=BOX_PX)
    np.testing.assert_allclose(got["scores"][keep], want["scores"][keep], atol=SCORE_ATOL)
    np.testing.assert_allclose(got["ious_box"], want["ious_box"], atol=1e-3)
    np.testing.assert_array_equal(got["gt_boxes"], want["gt_boxes"])
    assert int(keep.sum()) >= 20


@pytest.mark.parametrize("name", ["yolov5n.yaml", "yolov6n.yaml", "yolov8n-p6.yaml"])
def test_jax_written_checkpoint_loads_and_predicts(tmp_path, name):
    """A checkpoint of the narrow config written by the JAX package's
    ``save_checkpoint`` loads through ``YOLO(path)`` (every leaf used, every
    parameter set) and predicts JAX's detections: the same classes, boxes
    within 0.05 px, scores within 1e-4."""
    cfg, jm, v, imgsz = _jax_narrow(name, 71)
    path = tmp_path / f"{name[:-5]}.ckpt"
    jsave_checkpoint(path, v["params"], v["batch_stats"], None, None, 0, 0, 0.0,
                     train_args={"task": "detect", "imgsz": imgsz}, model_yaml=cfg,
                     names={0: "circle", 1: "rect"})
    ty = YOLO(path, device="cpu")
    assert ty.task == "detect" and ty.model.strides == tuple(jm.strides)
    params, stats = to_jax_variables(ty.model.state_dict())
    for a, b in ((params, v["params"]), (stats, v["batch_stats"])):
        assert {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(a)} == {
            jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(b)}
    images = shape_images(2, 120, 200, seed=72)
    want, res = JaxYOLO(str(path)).predict(images), ty.predict(images)
    n = 0
    for g, w in zip(res, want):
        wd = np.asarray(w.boxes.data, np.float32)
        assert g.boxes.data.shape == wd.shape
        np.testing.assert_array_equal(g.boxes.cls, wd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, wd[:, :4], atol=BOX_PX)
        np.testing.assert_allclose(g.boxes.conf, wd[:, 4], atol=SCORE_ATOL)
        n += len(g)
    assert n >= 4
