"""The PyTorch port's detect task against the JAX package on the CPU: the
blocks of the detect graph (DFL, Bottleneck, C2f) and its head (Detect,
decode_detect), the yolov8n graph and its weights, the box geometry of the
loss (CIoU, dist2bbox, bbox2dist), the stock task-aligned assigner, the
detect loss and its gradients, NMS on the (B, 4 + nc, A) layout, and the
facade's predict on the floor_detect checkpoint. Inputs and weights are
made from seeds with numpy and handed to both packages."""
import copy
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import shape_images
from yolo_contour_regression_tpu.engine import step as jstep
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.nn.modules import block as jblock
from yolo_contour_regression_tpu.nn.modules import head as jhead
from yolo_contour_regression_tpu.nn.tasks import build_model as jbuild_model
from yolo_contour_regression_tpu.ops import boxes as jboxes
from yolo_contour_regression_tpu.ops import nms as jnms
from yolo_contour_regression_tpu.utils import loss as jloss
from yolo_contour_regression_tpu.utils import tal as jtal
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine import step as tstep
from yolo_contour_regression_tpu_torch.nn.modules import block as tblock
from yolo_contour_regression_tpu_torch.nn.modules import head as thead
from yolo_contour_regression_tpu_torch.nn.tasks import (YOLOV8, DetectionModel, build_model,
                                                        guess_model_task, init_weights,
                                                        yaml_model_load)
from yolo_contour_regression_tpu_torch.ops import boxes as tboxes
from yolo_contour_regression_tpu_torch.ops import nms as tnms
from yolo_contour_regression_tpu_torch.utils import loss as tloss
from yolo_contour_regression_tpu_torch.utils import tal as ttal
from yolo_contour_regression_tpu_torch.utils.checkpoint import (
    checkpoint_variables, from_jax_variables, load_checkpoint, load_jax_variables,
    to_jax_variables)

from tests.test_nms import numpy_greedy_nms
from tests.test_torch_port_modules import _carry, _init, _randomize, _run_pair, _x
from tests.test_torch_port_train import _f64, _np, _t


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

DETECT_CKPT = "runs/floor_detect/best.ckpt"
# modules: f32 convs summed in another order than XLA's (CPU)
MODULE_ATOL = 1e-4
# the whole yolov8n graph at 64 px: 20+ layers of those sums
GRAPH_ATOL = 1e-3
# assigner target scores: f32 on both sides, summed in other orders
ASSIGN_TOL = 1e-5
# the detect loss on the same head maps (relative), its gradient (relative,
# and to 1e-5 of its largest entry)
LOSS_RTOL = 1e-5
# the loss of the network against the JAX network in float64 (relative),
# and each gradient (of its tensor's largest entry): the train-step test's
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 1e-3
# predict on the floor_detect checkpoint against the JAX facade
BOX_PX = 0.05
SCORE_ATOL = 1e-4
# the published yolov8n at nc 80 (tests/test_models.py)
YOLOV8N_PARAMS = 3_157_184

NARROW = copy.deepcopy(YOLOV8)
NARROW.update(nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})


# --- the blocks and the head ------------------------------------------------

def test_dfl_matches():
    x = _x(0, (2, 64, 30))
    want = jblock.DFL(16).apply({}, jnp.asarray(x))
    got = tblock.DFL(16)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODULE_ATOL)


@pytest.mark.parametrize("c1,c2,shortcut", [(16, 16, True), (16, 16, False), (8, 16, True)])
def test_bottleneck_matches(c1, c2, shortcut):
    """The residual only where ``shortcut`` and the widths agree."""
    tmod = tblock.Bottleneck(c1, c2, shortcut, e=1.0)
    assert tmod.add == (shortcut and c1 == c2)
    want, got = _run_pair(jblock.Bottleneck(c2, shortcut, e=1.0), tmod, _x(1, (2, 10, 9, c1)), 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=MODULE_ATOL)


@pytest.mark.parametrize("n,shortcut", [(1, True), (2, False), (3, True)])
def test_c2f_matches(n, shortcut):
    """C2f's split and concatenation keep JAX's channel order; its
    bottlenecks ``m.{i}`` carry JAX's ``m{i}``."""
    tmod = tblock.C2f(24, 32, n, shortcut)
    want, got = _run_pair(jblock.C2f(32, n, shortcut), tmod, _x(3, (2, 9, 11, 24)), 4 + n)
    assert {k.split(".")[1] for k in tmod.state_dict() if k.startswith("m.")} == {
        str(i) for i in range(n)}
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=MODULE_ATOL)


def _head_feats(seed, ch=(16, 32, 64), hw=((16, 12), (8, 6), (4, 3))):
    return [_x(seed + i, (2, h, w, c)) for i, ((h, w), c) in enumerate(zip(hw, ch))]


@pytest.mark.parametrize("nc", [3, 120])
def test_detect_head_and_decode_match(nc):
    """Detect's widths (``c2 = max(16, ch0 // 4, 64)``, ``c3 = max(ch0,
    min(nc, 100))``), its per-level maps, and ``decode_detect``: (B, 4 + nc,
    A), xywh in pixels and sigmoid scores, anchors row-major from NHWC."""
    feats = _head_feats(10)
    jmod = jhead.Detect(nc=nc)
    jfeats = [jnp.asarray(f) for f in feats]
    jvars = _randomize(_init(jmod, jfeats), 11)
    want = jax.jit(jmod.apply)(jvars, jfeats)
    tmod = _carry(jvars, thead.Detect(nc=nc, ch=(16, 32, 64)))
    assert tmod.cv2[0][0].conv.out_channels == 64
    assert tmod.cv3[0][0].conv.out_channels == max(16, min(nc, 100))
    with torch.no_grad():
        got = tmod([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=MODULE_ATOL)
    jdec = jhead.decode_detect(want, (8, 16, 32), nc)
    tdec = thead.decode_detect(got, (8, 16, 32), nc)
    assert tdec.shape == (2, 4 + nc, sum(h * w for h, w in ((16, 12), (8, 6), (4, 3))))
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), atol=MODULE_ATOL * 32)


# --- the graph and its weights ----------------------------------------------

def test_yolov8n_graph_matches_jax():
    """The yolov8n graph (nc 80) at 64 px, JAX's weights and BatchNorm
    statistics drawn with numpy: every level's head map and the decode."""
    jm = jbuild_model(YOLOV8)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    v = _np(_randomize({k: shapes[k] for k in ("params", "batch_stats")}, 21))
    x = np.random.default_rng(22).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.raw_forward(v, x))(v, jnp.asarray(x))
    tm = load_jax_variables(DetectionModel(), v["params"], v["batch_stats"]).eval()
    assert tm.strides == tuple(jm.strides) == (8, 16, 32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        pred = tm.predict(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=GRAPH_ATOL * scale)
    jpred = np.asarray(jm.decode(want))
    np.testing.assert_allclose(pred[:, 4:].numpy(), jpred[:, 4:], atol=GRAPH_ATOL)
    np.testing.assert_allclose(pred[:, :4].numpy(), jpred[:, :4], atol=GRAPH_ATOL * 64)


def test_yolov8n_counts_the_published_parameters():
    """``yolov8n.yaml`` at nc 80: 3,157,184 parameters, the JAX test's count;
    the config is JAX's and its task is detect."""
    cfg = yaml_model_load("yolov8n.yaml")
    assert guess_model_task(cfg) == "detect" and cfg["scale"] == "n"
    model = build_model(cfg)
    assert isinstance(model, DetectionModel) and model.num_params == YOLOV8N_PARAMS
    with pytest.raises(NotImplementedError, match="not ported"):
        model.predict_augmented(torch.zeros(1, 3, 64, 64))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_floor_detect_weights_are_each_used_once():
    """Every leaf of ``runs/floor_detect/best.ckpt`` maps to exactly one key
    of the port's model and back, unchanged."""
    ckpt = load_checkpoint(DETECT_CKPT)
    params, stats = checkpoint_variables(ckpt)
    sd = from_jax_variables(params, stats)
    n_leaves = len(list(_leaves(params))) + len(list(_leaves(stats)))
    model = load_jax_variables(build_model(ckpt["model_yaml"]), params, stats)
    want = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert len(sd) == n_leaves == len(want) and set(sd) == want
    back_p, back_s = to_jax_variables(model.state_dict())
    for tree, back in ((params, back_p), (stats, back_s)):
        got = dict(_leaves(back))
        assert set(got) == {p for p, _ in _leaves(tree)}
        for p, a in _leaves(tree):
            np.testing.assert_array_equal(got[p], a, err_msg="/".join(p))


def test_init_weights_takes_the_detect_priors():
    """Fresh detect model: each class bias ``log(5 / nc / (640 / s)^2)``, the
    box bias left at 0 (only the polar head's ray bias becomes 1)."""
    model = init_weights(DetectionModel(NARROW), torch.Generator().manual_seed(0))
    head = model.model[-1]
    for i, s in enumerate(model.strides):
        torch.testing.assert_close(head.cv3[i][2].bias,
                                   torch.full((2,), np.log(5 / 2 / (640 / s) ** 2)))
        assert torch.equal(head.cv2[i][2].bias, torch.zeros(64))


# --- box geometry -----------------------------------------------------------

def _box_pairs(seed, n=200):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 50, (2, n, 2))
    wh = rng.uniform(0.5, 30, (2, n, 2))
    b = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    b[1, :5] = b[0, :5]  # identical pairs
    b[1, 5:10, :2] = b[0, 5:10, 2:] + 1.0  # disjoint pairs
    b[1, 5:10, 2:] = b[1, 5:10, :2] + 3.0
    return b[0], b[1]


@pytest.mark.parametrize("kind", ["iou", "GIoU", "DIoU", "CIoU"])
@pytest.mark.parametrize("xywh", [False, True])
def test_bbox_iou_matches_jax(kind, xywh):
    """The IoU family elementwise, xyxy and xywh; CIoU's gradient too (its
    ``alpha`` a constant of the gradient on both sides), f32 ``atan``."""
    a, b = _box_pairs(1)
    if xywh:
        a, b = np.asarray(jboxes.xyxy2xywh(a)), np.asarray(jboxes.xyxy2xywh(b))
    flags = {kind: True} if kind != "iou" else {}
    jfn = lambda p, q: jboxes.bbox_iou(p, q, xywh=xywh, **flags)  # noqa: E731
    want = jfn(jnp.asarray(a), jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    got = tboxes.bbox_iou(ta, torch.tensor(b), xywh=xywh, **flags)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    got.sum().backward()
    jg = jax.grad(lambda p: jfn(p, jnp.asarray(b)).sum())(jnp.asarray(a))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg), atol=1e-5)


def test_dist2bbox_and_bbox2dist_match_jax():
    """Both forms of ``dist2bbox``; ``bbox2dist`` clips to ``reg_max -
    0.01``, so the loss's ``reg_max - 1`` = 15 clips at 14.99."""
    rng = np.random.default_rng(2)
    anc = rng.uniform(0, 20, (1, 50, 2)).astype(np.float32)
    dist = rng.uniform(0, 16, (3, 50, 4)).astype(np.float32)
    for xywh in (True, False):
        np.testing.assert_allclose(
            tboxes.dist2bbox(torch.from_numpy(dist), torch.from_numpy(anc), xywh=xywh).numpy(),
            np.asarray(jboxes.dist2bbox(jnp.asarray(dist), jnp.asarray(anc), xywh=xywh)),
            atol=1e-6)
    box = np.concatenate([anc - 30, anc + rng.uniform(-2, 30, (1, 50, 2))], -1).astype(np.float32)
    got = tboxes.bbox2dist(torch.from_numpy(anc), torch.from_numpy(box), 15).numpy()
    np.testing.assert_array_equal(got, np.asarray(jboxes.bbox2dist(jnp.asarray(anc),
                                                                   jnp.asarray(box), 15)))
    assert got.max() == np.float32(14.99) and got.min() == 0.0


# --- the assigner -----------------------------------------------------------

def _assign_scene(name, seed=0):
    """Predicted scores (B, A, nc) and xyxy boxes (B, A, 4) over the anchors
    of a 64 px image, and GT (labels, xyxy boxes, mask) in pixels."""
    rng = np.random.default_rng(seed)
    anc = np.concatenate([np.stack(np.meshgrid(np.arange(64 // s) + 0.5, np.arange(64 // s) + 0.5),
                                   -1).reshape(-1, 2) * s for s in (8, 16, 32)]).astype(np.float32)
    A, B, N, nc = len(anc), 2, 5, 3
    scores = rng.uniform(0, 1, (B, A, nc)).astype(np.float32)
    half = rng.uniform(2, 20, (B, A, 2))
    jit = rng.normal(0, 3, (B, A, 2))
    pred = np.concatenate([anc + jit - half, anc + jit + half], -1).astype(np.float32)
    c = rng.uniform(10, 54, (B, N, 2))
    wh = rng.uniform(8, 40, (B, N, 2))
    gt = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    labels = rng.integers(0, nc, (B, N)).astype(np.int32)
    mask = np.ones((B, N), bool)
    mask[1, 3:] = False
    if name == "ties":  # two identical GTs: each anchor goes to the lower index
        gt[0, 1], labels[0, 1] = gt[0, 0], labels[0, 0]
        pred[0, :, :] = np.round(pred[0] / 4) * 4  # repeated predicted boxes
        scores[0] = np.round(scores[0] * 4) / 4
    if name == "crowded":  # many overlapping GTs, one class
        gt[:, :, :2] = gt[:, :1, :2] + rng.uniform(-3, 3, (B, N, 2))
        gt[:, :, 2:] = gt[:, :1, 2:] + rng.uniform(-3, 3, (B, N, 2))
        labels[:] = 1
    if name == "empty":
        mask[:] = False
    return anc, scores, pred, labels, gt, mask


@pytest.mark.parametrize("name", ["random", "ties", "crowded", "empty"])
def test_task_aligned_assign_matches_jax(name):
    """fg_mask and target_gt_idx equal, labels and boxes equal, target
    scores within ``ASSIGN_TOL``; ties go to the lowest GT index."""
    anc, scores, pred, labels, gt, mask = _assign_scene(name)
    want = jtal.task_aligned_assign(*(jnp.asarray(a) for a in (scores, pred, anc, labels, gt,
                                                                mask)))
    got = ttal.task_aligned_assign(*(_t(a) for a in (scores, pred, anc, labels, gt, mask)))
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.target_gt_idx.numpy(), np.asarray(want.target_gt_idx))
    np.testing.assert_array_equal(got.target_labels.numpy(), np.asarray(want.target_labels))
    np.testing.assert_array_equal(got.target_bboxes.numpy(), np.asarray(want.target_bboxes))
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores),
                               atol=ASSIGN_TOL)
    if name == "ties":
        assert not bool((got.target_gt_idx[0][got.fg_mask[0]] == 1).any())
    if name == "empty":
        assert not bool(got.fg_mask.any())
    else:
        assert int(got.fg_mask.sum()) > 5


# --- the loss ---------------------------------------------------------------

def _det_batch(seed, B, n_pad, imgsz=64):
    """A detect batch (numpy): 1 to 3 GT boxes an image of 30-70% of the
    image (so each has 10 or more in-box anchors at stride 8; the assigner
    takes its top 10 among the in-box anchors only where at least 10 have a
    positive align metric, as JAX's ``_topk_mask`` orders them), and one of
    8% (fewer), classes 0 or 1."""
    rng = np.random.default_rng(seed)
    batch = {"cls": np.zeros((B, n_pad), np.int32), "bboxes": np.zeros((B, n_pad, 4), np.float32),
             "mask_gt": np.zeros((B, n_pad), bool)}
    for i in range(B):
        n = rng.integers(1, min(3, n_pad) + 1)
        wh = rng.uniform(0.3, 0.7, (n, 2))
        wh[-1] = 0.08 if n > 1 else wh[-1]
        xy = rng.uniform(wh / 2, 1 - wh / 2)
        batch["bboxes"][i, :n] = np.concatenate([xy, wh], -1)
        batch["cls"][i, :n] = rng.integers(0, 2, n)
        batch["mask_gt"][i, :n] = True
    images = rng.uniform(0, 1, (B, imgsz, imgsz, 3)).astype(np.float32)
    return images, batch


@pytest.mark.parametrize("seed,n_pad", [(0, 4), (1, 12)])
def test_detection_loss_and_grad_match_jax(seed, n_pad):
    """The loss on random head maps at imgsz 64 (its items and the
    assignment JAX returns with ``return_assign``), and its gradient w.r.t.
    the maps (NHWC for JAX, NCHW for the port)."""
    rng = np.random.default_rng(seed)
    B, nc = 2, 2
    _, batch = _det_batch(seed, B, n_pad)
    feats = []
    for s in (8, 16, 32):
        f = rng.normal(0, 2, (B, 64 // s, 64 // s, 64 + nc))
        # bin logits falling with the bin: sides of 1-2 grid cells
        f[..., :64] -= np.tile(0.6 * np.arange(16), 4)
        feats.append(f.astype(np.float32))
    hyp = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5)

    def jfn(fs):
        out, assign = jloss.detection_loss(fs, {k: jnp.asarray(v) for k, v in batch.items()},
                                           (8, 16, 32), nc, hyp, return_assign=True)
        return out.total, (out.items, assign)

    # compiled once: eager dispatch took most of this test's time
    (jtotal, (jitems, jassign)), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        [jnp.asarray(f) for f in feats])
    tfeats = [_t(f).permute(0, 3, 1, 2).contiguous().requires_grad_() for f in feats]
    out, assign = tloss.detection_loss(tfeats, {k: _t(v) for k, v in batch.items()}, (8, 16, 32),
                                       nc, hyp, return_assign=True)
    out.total.backward()
    np.testing.assert_array_equal(assign.fg_mask.numpy(), np.asarray(jassign.fg_mask))
    assert int(assign.fg_mask.sum()) > 0
    np.testing.assert_allclose(out.total.item(), float(jtotal), rtol=LOSS_RTOL)
    assert set(out.items) == set(jitems) == {"box_loss", "cls_loss", "dfl_loss"}
    for k in jitems:
        np.testing.assert_allclose(out.items[k].item(), float(jitems[k]), rtol=LOSS_RTOL)
    for tf, jg in zip(tfeats, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tf.grad.permute(0, 2, 3, 1).numpy(), jg, rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * np.abs(jg).max())


def test_df_loss_gather_equals_the_one_hot_form():
    """The bin pick by ``gather`` gives JAX's one-hot multiply-reduce, at
    the clip (14.99) and at integer targets."""
    rng = np.random.default_rng(3)
    pred = rng.normal(0, 2, (40, 4, 16)).astype(np.float32)
    target = rng.uniform(0, 14.99, (40, 4)).astype(np.float32)
    target[:4] = np.float32(14.99)
    target[4:8] = np.floor(target[4:8])
    want = jloss._df_loss(jnp.asarray(pred), jnp.asarray(target), 16)
    got = tloss._df_loss(torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_detect_network_loss_and_gradients_match_jax_f64():
    """The narrow detect graph in train mode at imgsz 64, batch 2: the loss
    and every parameter's gradient against the JAX network in float64 (the
    loss math f32 on both sides), at the train-step test's tolerances."""
    jm = jbuild_model(NARROW)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    v = _np(_randomize({k: shapes[k] for k in ("params", "batch_stats")}, 31))
    images, batch = _det_batch(32, 2, 4)
    hyp = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5)
    with jax.enable_x64(True):
        jm64 = jbuild_model(NARROW, dtype=jnp.float64)
        v64 = _f64(v)
        fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm64, hyp), has_aux=True))
        (jl, _), jg = fn(v64["params"], v64["batch_stats"], jnp.asarray(images, jnp.float64),
                         {k: jnp.asarray(a) for k, a in batch.items()})
        jl, jg = float(jl), from_jax_variables(_np(jg), {})
    model = load_jax_variables(DetectionModel(NARROW), v["params"], v["batch_stats"]).train()
    loss, items = tstep.make_loss_fn(model, hyp)(_t(images), {k: _t(a) for k, a in batch.items()})
    loss.backward()
    assert items["box_loss"].item() > 0  # some anchors were assigned
    assert set(items) == {"box_loss", "cls_loss", "dfl_loss"}
    np.testing.assert_allclose(loss.item(), jl, rtol=STEP_LOSS_RTOL)
    grads = dict(model.named_parameters())
    assert set(grads) == set(jg)
    for n, w in jg.items():
        err = float((grads[n].grad - w).abs().max())
        assert err <= STEP_GRAD_TOL * float(w.abs().max()), (n, err)


# --- NMS --------------------------------------------------------------------

def _detect_pred(seed, B=2, A=400, nc=3, E=0):
    """(B, 4 + nc + E, A): xyxy boxes, probabilities (some saturated at 1.0
    and some tied), extras."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(20, 200, (B, A, 2))
    wh = rng.uniform(8, 60, (B, A, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    scores = rng.uniform(0, 1, (B, A, nc)) ** 3
    scores[:, :20] = 1.0
    scores[:, 20:40] = scores[:, 40:60]
    ex = rng.normal(0, 1, (B, A, E))
    return np.concatenate([boxes, scores, ex], -1).transpose(0, 2, 1).astype(np.float32)


@pytest.mark.parametrize("multi_label", [False, True])
@pytest.mark.parametrize("conf,pre_nms,max_det", [(0.25, 1024, 300), (0.001, 64, 30),
                                                  (0.5, 16, 50)])
def test_non_max_suppression_matches_jax(multi_label, conf, pre_nms, max_det):
    """The (B, 4 + nc + E, A) layout, scores gated as probabilities, best
    class and multi-label: every output equal to JAX's."""
    pred = _detect_pred(int(conf * 1000) + pre_nms, E=2)
    kw = dict(nc=3, conf_thres=conf, iou_thres=0.6, pre_nms=pre_nms, max_det=max_det,
              multi_label=multi_label)
    want = jnms.non_max_suppression(jnp.asarray(pred), **kw)
    got = tnms.non_max_suppression(torch.from_numpy(pred), **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert int(got["valid"].sum()) > 0


@pytest.mark.parametrize("trial", range(3))
def test_non_max_suppression_matches_sequential_greedy(trial):
    """Agnostic, one class: the kept set is the sequential greedy one."""
    pred = _detect_pred(50 + trial, B=1, A=64, nc=1)
    pred[0, 4] = np.random.default_rng(trial).uniform(0.3, 1.0, 64)
    out = tnms.non_max_suppression(torch.from_numpy(pred), nc=1, conf_thres=0.0, iou_thres=0.5,
                                   pre_nms=64, max_det=64, agnostic=True)
    boxes, scores = pred[0, :4].T, pred[0, 4]
    want = np.sort(scores[numpy_greedy_nms(boxes, scores, 0.5)])[::-1]
    got = np.sort(out["scores"][0][out["valid"][0]].numpy())[::-1]
    np.testing.assert_allclose(got, want, atol=1e-6)


# --- the facade -------------------------------------------------------------

@pytest.fixture(scope="module")
def detect_models():
    return JaxYOLO(DETECT_CKPT), YOLO(DETECT_CKPT, device="cpu")


def test_yolo_loads_the_detect_checkpoint(detect_models):
    _, ty = detect_models
    ckpt = load_checkpoint(DETECT_CKPT)
    assert ty.task == "detect" and isinstance(ty.model, DetectionModel)
    assert ty.names == ckpt["names"] and ty.imgsz == 96 and not ty.model.training
    assert YOLO("yolov8n.yaml", device="cpu").overrides == {"model": "yolov8n.yaml",
                                                             "task": "detect"}


def _floor_images(n):
    with np.load("tests/data/torch_port_floor_detect_val16.npz") as z:
        return list(z["images"][:n])


def test_yolo_predict_matches_jax_facade(detect_models):
    """``YOLO(floor_detect).predict`` at imgsz 96 against the JAX facade, on
    floor-set images and on wider frames: the same detections, boxes within
    ``BOX_PX``, scores within ``SCORE_ATOL``; no masks, no contours."""
    jy, ty = detect_models
    images = _floor_images(6) + shape_images(2, 72, 120, seed=3)
    want = jy.predict(images, imgsz=96)
    got = ty.predict(images, imgsz=96)
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


def test_detect_model_pickles_its_config():
    """The detect model's config is a plain dict, so a port-trained
    checkpoint's ``model_yaml`` unpickles without the port."""
    model = DetectionModel(NARROW)
    assert pickle.loads(pickle.dumps(model.yaml)) == NARROW
