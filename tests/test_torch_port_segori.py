"""The PyTorch port's segment_ori task (the stock proto-mask segmenter)
against the JAX package on the CPU: ``Proto`` (its nearest 2x upsample),
the ``SegmentProto`` head and its name map, the yolov8-segori graph and
``predict``, the published config's parameters, a fresh JAX tree round
tripped and the init's priors, the GT masks at proto size (the port's plain
even-odd fill against JAX's jnp fill), the proto-mask loss on the same head
maps and its gradients in float32 and float64, its top-64 pick among tied
scores, and the loss and gradients of the network against JAX's in float64.
Inputs and weights are made from seeds with numpy and handed to both
packages."""
import copy
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import circle_contour, rect_contour
from yolo_contour_regression_tpu.engine import step as jstep
from yolo_contour_regression_tpu.nn.modules import block as jblock
from yolo_contour_regression_tpu.nn.modules import head as jhead
from yolo_contour_regression_tpu.nn.tasks import build_model as jbuild_model
from yolo_contour_regression_tpu.ops import raster as jraster
from yolo_contour_regression_tpu.utils import loss as jloss
from yolo_contour_regression_tpu_torch.engine import step as tstep
from yolo_contour_regression_tpu_torch.nn.modules import block as tblock
from yolo_contour_regression_tpu_torch.nn.modules import head as thead
from yolo_contour_regression_tpu_torch.nn.tasks import (YOLOV8_SEGORI, SegmentationOriModel,
                                                        build_model, guess_model_task,
                                                        init_weights, yaml_model_load)
from yolo_contour_regression_tpu_torch.ops.nms import _top
from yolo_contour_regression_tpu_torch.utils import loss as tloss
from yolo_contour_regression_tpu_torch.utils.checkpoint import (from_jax_variables,
                                                                load_jax_variables,
                                                                to_jax_variables)

from tests.test_torch_port_detect import _leaves
from tests.test_torch_port_modules import MODULE_ATOL, _carry, _init, _randomize, _x
from tests.test_torch_port_train import _f64, _np, _t

# the head's maps and the decode (f32 convs summed in other orders)
HEAD_ATOL = 1e-3
# the loss on the same head maps (relative), its gradient (relative, and to
# 1e-5 of its largest entry)
LOSS_RTOL = 1e-5
# the network's loss against JAX's in float64 (relative), each gradient (of
# its tensor's largest entry): the train-step test's
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 1e-3
# yolov8n-segori at nc 2, the JAX model's count
YOLOV8N_SEGORI_PARAMS = 3_918_006
HYP = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5)
STRIDES = (8, 16, 32)
NARROW = copy.deepcopy(YOLOV8_SEGORI)
NARROW["head"][-1][3] = ["nc", 8, 32]  # 8 prototypes of 32 channels
NARROW.update(nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _segori_batch(seed, B, n_pad, imgsz, n=None, size=(0.3, 0.6)):
    """A segment_ori batch (numpy): ``n`` (default 1 to 3) circles or
    rectangles an image, each 30-60% of the image (10 or more in-box anchors
    each, so the stock assigner gives them anchors), with exact 360-point
    contours, classes 0 or 1."""
    rng = np.random.default_rng(seed)
    batch = {"cls": np.zeros((B, n_pad), np.int32), "bboxes": np.zeros((B, n_pad, 4), np.float32),
             "segments": np.zeros((B, n_pad, 360, 2), np.float32),
             "mask_gt": np.zeros((B, n_pad), bool)}
    for i in range(B):
        for j in range(n or rng.integers(1, min(3, n_pad) + 1)):
            r = rng.uniform(*size) * imgsz / 2
            cx, cy = rng.uniform(r, imgsz - r, 2)
            c = rng.integers(2)
            contour = (circle_contour(cx, cy, r) if c == 0
                       else rect_contour(cx - r, cy - r, cx + r, cy + r))
            lo, hi = contour.min(0), contour.max(0)
            batch["cls"][i, j] = c
            batch["bboxes"][i, j] = np.concatenate([(lo + hi) / 2, hi - lo]) / imgsz
            batch["segments"][i, j] = contour / imgsz
            batch["mask_gt"][i, j] = True
    images = rng.uniform(0, 1, (B, imgsz, imgsz, 3)).astype(np.float32)
    return images, batch


def _maps(seed, B, imgsz, nc, nm, scale=2.0):
    """Random head maps (NHWC, numpy): levels (B, H, W, 64 + nc + nm), the
    box bins biased toward small distances as the detect tests draw them,
    and prototypes (B, imgsz / 4, imgsz / 4, nm)."""
    rng = np.random.default_rng(seed)
    levels = []
    for s in STRIDES:
        f = rng.normal(0, scale, (B, imgsz // s, imgsz // s, 64 + nc + nm))
        f[..., :64] -= np.tile(0.6 * np.arange(16), 4)
        levels.append(f.astype(np.float32))
    proto = rng.normal(0, 1, (B, imgsz // 4, imgsz // 4, nm)).astype(np.float32)
    return levels, proto


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2).contiguous()


# --- Proto, the head and the graph --------------------------------------------

def test_proto_matches_jax():
    """Conv 3x3, the nearest 2x upsample (JAX ``_resize2x``, here
    ``F.interpolate(mode="nearest")``), Conv 3x3, Conv 1x1, on a non-square
    map; and the upsample alone, exactly."""
    x = _x(0, (2, 6, 5, 8))
    jmod = jblock.Proto(c_=16, c2=4)
    jvars = _randomize(_init(jmod, jnp.asarray(x)), 1)
    want = jax.jit(jmod.apply)(jvars, jnp.asarray(x))
    tmod = _carry(jvars, tblock.Proto(8, 16, 4))
    with torch.no_grad():
        got = tmod(_nchw(x))
    assert got.shape == (2, 4, 12, 10)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=MODULE_ATOL)
    up = torch.nn.functional.interpolate(_nchw(x), scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(up.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jblock._resize2x(jnp.asarray(x))))


def test_segment_proto_head_matches_jax():
    """SegmentProto's widths (``c4 = max(ch0 // 4, nm)``, the detect
    child's), its JAX child names carried with no rule of their own
    (``detect``, ``proto``, ``cv4.{i}.{j}``), its per-level [detect |
    coefficients] maps and its prototypes."""
    ch, hw = (16, 32, 64), ((8, 6), (4, 3), (2, 2))
    feats = [_x(10 + i, (2, h, w, c)) for i, ((h, w), c) in enumerate(zip(hw, ch))]
    jmod = jhead.SegmentProto(nc=2, nm=8, npr=16)
    jfeats = [jnp.asarray(f) for f in feats]
    jvars = _randomize(_init(jmod, jfeats), 11)
    want_levels, want_proto = jax.jit(jmod.apply)(jvars, jfeats)
    tmod = _carry(jvars, thead.SegmentProto(nc=2, nm=8, npr=16, ch=ch))
    assert tmod.cv4[0][0].conv.out_channels == max(16 // 4, 8)
    assert tmod.detect.cv2[0][0].conv.out_channels == 64
    with torch.no_grad():
        levels, proto = tmod([_nchw(f) for f in feats])
    for g, w in zip(levels, want_levels):
        assert g.shape[1] == 64 + 2 + 8
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=HEAD_ATOL)
    assert proto.shape == (2, 8, 16, 12)
    np.testing.assert_allclose(proto.permute(0, 2, 3, 1).numpy(), np.asarray(want_proto),
                               atol=HEAD_ATOL)


@pytest.fixture(scope="module")
def narrow_graph():
    """The narrow segori graph's JAX model and numpy-drawn variables."""
    jm = jbuild_model(NARROW)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    return jm, _np(_randomize({n: shapes[n] for n in ("params", "batch_stats")}, 20))


def test_segori_graph_and_predict_match_jax(narrow_graph):
    """The narrow graph at 64 px: every level's head map, the prototypes,
    and ``predict``'s ((B, 4 + nc + nm, A), proto) against JAX
    ``SegmentationOriModel.predict`` (JAX's proto NHWC, the port's NCHW)."""
    jm, v = narrow_graph
    x = np.random.default_rng(21).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jlevels, jproto = jax.jit(lambda v, x: jm.raw_forward(v, x))(v, jnp.asarray(x))
    tm = load_jax_variables(SegmentationOriModel(NARROW), v["params"], v["batch_stats"]).eval()
    assert tm.nm == 8 and tm.strides == STRIDES and tm.task == "segment_ori"
    with torch.no_grad():
        (levels, proto), (pred, pproto) = tm(_nchw(x)), tm.predict(_nchw(x))
    for g, w in zip(levels, jlevels):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=HEAD_ATOL * scale)
    np.testing.assert_allclose(proto.permute(0, 2, 3, 1).numpy(), np.asarray(jproto),
                               atol=HEAD_ATOL)
    jpred, jpp = jm.decode((jlevels, jproto))
    jpred = np.asarray(jpred)
    assert pred.shape == jpred.shape == (2, 4 + 2 + 8, 84)
    np.testing.assert_allclose(pred[:, 4:].numpy(), jpred[:, 4:], atol=HEAD_ATOL)
    np.testing.assert_allclose(pred[:, :4].numpy(), jpred[:, :4], atol=HEAD_ATOL * 64)
    np.testing.assert_array_equal(pproto.numpy(), proto.numpy())


def test_yolov8n_segori_is_the_published_config():
    """``yolov8n-segori.yaml``: task segment_ori, scale n, 32 prototypes of
    256 channels (not width-scaled, as JAX's parser leaves them), and the
    JAX model's parameter count at nc 2."""
    cfg = yaml_model_load("yolov8n-segori.yaml")
    assert guess_model_task(cfg) == "segment_ori" and cfg["scale"] == "n"
    model = build_model(cfg, nc=2)
    assert isinstance(model, SegmentationOriModel) and model.nm == 32
    assert model.model[-1].proto.cv1.conv.out_channels == 256
    jm = jbuild_model("yolov8n-segori.yaml", nc=2)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    assert model.num_params == n_jax == YOLOV8N_SEGORI_PARAMS


def test_fresh_jax_tree_round_trips_and_init_priors(narrow_graph):
    """A JAX segori tree (the narrow graph's, every leaf of a fresh init's
    structure) maps to exactly one key of the port's model each and back to
    the same leaf, unchanged; the port's init gives JAX ``init``'s head
    priors (in the ``detect`` child): each class bias ``log(5 / nc / (640 /
    s)^2)``, box and coefficient biases 0."""
    _, v = narrow_graph
    params, stats = v["params"], v["batch_stats"]
    sd = from_jax_variables(params, stats)
    n_leaves = len(list(_leaves(params))) + len(list(_leaves(stats)))
    model = load_jax_variables(SegmentationOriModel(NARROW), params, stats)
    want = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert len(sd) == n_leaves == len(want) and set(sd) == want
    assert {"model.22.proto.cv1.conv.weight", "model.22.cv4.2.2.bias",
            "model.22.detect.cv3.0.2.bias"} <= want
    back_p, back_s = to_jax_variables(model.state_dict())
    for tree, back in ((params, back_p), (stats, back_s)):
        got = dict(_leaves(back))
        assert set(got) == {p for p, _ in _leaves(tree)}
        for p, a in _leaves(tree):
            np.testing.assert_array_equal(got[p], a, err_msg="/".join(p))
    head = init_weights(SegmentationOriModel(NARROW), torch.Generator().manual_seed(0)).model[-1]
    for i, s in enumerate(STRIDES):
        np.testing.assert_allclose(head.detect.cv3[i][2].bias.detach().numpy(),
                                   np.log(5 / 2 / (640 / s) ** 2), rtol=1e-6)
        assert not head.detect.cv2[i][2].bias.any() and not head.cv4[i][2].bias.any()


# --- the GT masks and the loss --------------------------------------------------

@pytest.mark.parametrize("hp,wp", [(16, 16), (40, 24)])
def test_gt_masks_equal_jax_fill(hp, wp):
    """``gt_masks_at`` (the plain even-odd fill here; the CUDA kernel on a
    card) against the JAX loss's masks, ``fill_polygons`` (jnp) of
    ``segments * [wp, hp]`` with ``mask_gt`` broadcast over the 360 points:
    equal, padded instances empty."""
    _, batch = _segori_batch(hp * wp, 2, 4, 64, size=(0.1, 0.9))
    got = tloss.gt_masks_at(_t(batch["segments"]), _t(batch["mask_gt"]), hp, wp).numpy()
    pts = jnp.asarray(batch["segments"]) * jnp.asarray([wp, hp], jnp.float32)
    valid = jnp.broadcast_to(jnp.asarray(batch["mask_gt"])[..., None], pts.shape[:-1])
    want = np.asarray(jax.vmap(lambda p, v: jraster.fill_polygons(p, v, hp, wp))(pts, valid))
    assert got.shape == want.shape == (2, 4, hp, wp) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert got[batch["mask_gt"]].any(axis=(1, 2)).all() and not got[~batch["mask_gt"]].any()


def _loss_pair(levels, proto, batch, dtype=torch.float32):
    """The JAX loss (total, items, gradients w.r.t. the maps) and the
    port's (total, items, the maps with their gradients) on the same maps;
    the port's maps in ``dtype``."""
    jb = {n: jnp.asarray(v) for n, v in batch.items()}
    nm = proto.shape[-1]

    def jfn(ls, p):
        out = jloss.segmentation_ori_loss((ls, p), jb, STRIDES, 2, HYP, nm=nm)
        return out.total, out.items

    (jtotal, jitems), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        [jnp.asarray(f) for f in levels], jnp.asarray(proto))
    tl = [_nchw(f).to(dtype).requires_grad_() for f in levels]
    tp = _nchw(proto).to(dtype).requires_grad_()
    out = tloss.segmentation_ori_loss((tl, tp), {n: _t(v) for n, v in batch.items()}, STRIDES,
                                      2, HYP, nm=nm)
    out.total.backward()
    return (float(jtotal), {k: float(v) for k, v in jitems.items()}, jgrads), (out, tl, tp)


def _check_loss(j, t, rtol):
    (jtotal, jitems, (jgl, jgp)), (out, tl, tp) = j, t
    np.testing.assert_allclose(out.total.item(), jtotal, rtol=rtol)
    assert set(out.items) == set(jitems) == {"box_loss", "cls_loss", "dfl_loss", "mask_loss"}
    for n in jitems:
        np.testing.assert_allclose(out.items[n].item(), jitems[n], rtol=rtol, err_msg=n)
    assert out.items["mask_loss"].item() > 0
    for g, w in [(f.grad, jg) for f, jg in zip(tl, jgl)] + [(tp.grad, jgp)]:
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).double().numpy(), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max())


@pytest.mark.parametrize("seed,n_pad", [(0, 4), (1, 8)])
def test_segori_loss_and_grad_match_jax(seed, n_pad):
    """The proto-mask loss on random head maps at imgsz 64, nm 8: its four
    items (the detect loss's and ``mask_loss``), the shared assignment (the
    same ``fg_mask`` and ``target_gt_idx``), and the gradients w.r.t. the
    maps and the prototypes, in float32; then the port's loss math on the
    same maps held in float64 (its f32 casts keep it f32: the same
    numbers)."""
    images, batch = _segori_batch(seed, 2, n_pad, 64)
    levels, proto = _maps(seed, 2, 64, 2, 8)
    j, t = _loss_pair(levels, proto, batch)
    _check_loss(j, t, LOSS_RTOL)
    jb = {n: jnp.asarray(v) for n, v in batch.items()}
    jassign = jax.jit(lambda fs: jloss.detection_loss(fs, jb, STRIDES, 2, HYP,
                                                      return_assign=True)[1])(
        [jnp.asarray(f[..., :-8]) for f in levels])  # compiled once: eager took most of it
    assign = tloss.detect_targets([f[:, :-8] for f in t[1]], {n: _t(v) for n, v in batch.items()},
                                  STRIDES, 2).assign
    fg = assign.fg_mask.numpy()
    np.testing.assert_array_equal(fg, np.asarray(jassign.fg_mask))
    np.testing.assert_array_equal(assign.target_gt_idx.numpy()[fg],
                                  np.asarray(jassign.target_gt_idx)[fg])
    assert int(fg.sum()) > 0
    _check_loss(j, _loss_pair(levels, proto, batch, torch.float64)[1], LOSS_RTOL)


def _tied_batch(B=2, imgsz=128, side=40):
    """8 GT squares an image, ``side`` px, centred at 8 of the 9 points of
    a 32-px grid: each centre a multiple of 16, so the anchors of each level
    lie symmetrically about it (mirror anchors tie in CIoU), and every GT
    sees the same anchors around it (their scores tie across GTs)."""
    batch = {"cls": np.zeros((B, 8), np.int32), "bboxes": np.zeros((B, 8, 4), np.float32),
             "segments": np.zeros((B, 8, 360, 2), np.float32), "mask_gt": np.ones((B, 8), bool)}
    centers = [(x, y) for y in (32, 64, 96) for x in (32, 64, 96)]
    for i in range(B):
        for j, (cx, cy) in enumerate(centers[i:i + 8]):
            h = side / 2
            contour = rect_contour(cx - h, cy - h, cx + h, cy + h)
            batch["cls"][i, j] = (i + j) % 2
            batch["bboxes"][i, j] = np.array([cx, cy, side, side]) / imgsz
            batch["segments"][i, j] = contour / imgsz
    return batch


def test_top64_pick_breaks_ties_by_lowest_anchor():
    """imgsz 128, 8 GT squares of one size an image (``_tied_batch``): with
    the detect channels all zero every anchor predicts the same box around
    itself, so the scores of foreground anchors tie, and more than 64 are
    foreground; the pick (a stable descending sort, as ``lax.top_k``) keeps
    the lowest anchor indices among the tied. The loss, which depends on the
    pick through the random coefficients, equals JAX's."""
    batch = _tied_batch()
    levels, proto = _maps(8, 2, 128, 2, 8)
    for f in levels:
        f[..., :64 + 2] = 0.0
    j, t = _loss_pair(levels, proto, batch)
    assign = tloss.detect_targets([f[:, :-8].detach() for f in t[1]],
                                  {n: _t(v) for n, v in batch.items()}, STRIDES, 2).assign
    score = assign.target_scores.sum(-1) * assign.fg_mask
    for b in range(2):
        fg = torch.nonzero(assign.fg_mask[b])[:, 0]
        assert len(fg) > 64, len(fg)
        assert torch.unique(score[b, fg]).numel() < len(fg)  # tied scores among them
    vals, idx = _top(score, 64)
    jv, ji = jax.lax.top_k(jnp.asarray(score.numpy()), 64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    _check_loss(j, t, LOSS_RTOL)


# --- the network, JAX in float64 -------------------------------------------------

def test_segori_network_loss_and_gradients_match_jax_f64(narrow_graph):
    """The narrow segori graph in train mode at imgsz 64, batch 2, both
    networks in float64 (the loss math f32 on both sides): the loss, every
    parameter's gradient at the train-step test's tolerances, and the stage
    marks. Then the port's network in float32 against JAX's float64: its
    gradients no further from them than JAX's own float32 gradients (both
    printed), the loss within the step tolerance."""
    jm, v = narrow_graph
    images, batch = _segori_batch(30, 2, 4, 64)
    with jax.enable_x64(True):
        jm64 = jbuild_model(NARROW, dtype=jnp.float64)
        v64 = _f64(v)
        fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm64, HYP), has_aux=True))
        (jl, (jitems, _)), jg = fn(v64["params"], v64["batch_stats"],
                                   jnp.asarray(images, jnp.float64),
                                   {n: jnp.asarray(a) for n, a in batch.items()})
        jl, jg = float(jl), {n: w.double() for n, w in from_jax_variables(_np(jg), {}).items()}
        jmask = float(jitems["mask_loss"])
    tb = {n: _t(a) for n, a in batch.items()}
    model = load_jax_variables(SegmentationOriModel(NARROW), v["params"],
                               v["batch_stats"]).double().train()
    marks = []
    loss, items = tstep.make_loss_fn(model, HYP, mark=marks.append)(_t(images).double(), tb)
    loss.backward()
    assert marks == ["forward", "assigner", "loss"]
    assert items["mask_loss"].item() > 0
    np.testing.assert_allclose(items["mask_loss"].item(), jmask, rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(loss.item(), jl, rtol=STEP_LOSS_RTOL)
    grads = dict(model.named_parameters())
    assert set(grads) == set(jg)
    for n, w in jg.items():
        err = float((grads[n].grad - w).abs().max())
        assert err <= STEP_GRAD_TOL * float(w.abs().max()), (n, err)

    fn32 = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm, HYP), has_aux=True))
    (_, _), jg32 = fn32(v["params"], v["batch_stats"], jnp.asarray(images),
                        {n: jnp.asarray(a) for n, a in batch.items()})
    model = load_jax_variables(SegmentationOriModel(NARROW), v["params"], v["batch_stats"]).train()
    loss32, _ = tstep.make_loss_fn(model, HYP)(_t(images), tb)
    loss32.backward()
    np.testing.assert_allclose(loss32.item(), jl, rtol=STEP_LOSS_RTOL)

    def gap(g):
        return max(float((g[n].double() - w).abs().max() / w.abs().max().clamp_min(1e-30))
                   for n, w in jg.items())

    port_gap = gap({n: p.grad for n, p in model.named_parameters()})
    jax_gap = gap(from_jax_variables(_np(jg32), {}))
    print(f"float32 gradients against JAX's float64, worst of a tensor's largest: "
          f"port {port_gap:.3e}, JAX {jax_gap:.3e}")
    assert port_gap <= max(jax_gap, STEP_GRAD_TOL)
