"""The PyTorch port's pose task against the JAX package on the CPU: the
``Pose`` head and ``decode_pose`` at 5 and 17 keypoints, the yolov8-pose
graph and its weights (the name map of the nested ``detect`` child, the
floor_pose checkpoint round-tripped exactly), the fresh init's priors, the
pose loss on the same head maps and its gradients, and the loss and
gradients of the network against JAX's in float64. Inputs and weights are
made from seeds with numpy and handed to both packages."""
import copy
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import POSE_CKPT
from tests.torch_port_jax_init import compiled_init
from yolo_contour_regression_tpu.engine import step as jstep
from yolo_contour_regression_tpu.nn.modules import head as jhead
from yolo_contour_regression_tpu.nn.tasks import build_model as jbuild_model
from yolo_contour_regression_tpu.utils import loss as jloss
from yolo_contour_regression_tpu_torch.engine import step as tstep
from yolo_contour_regression_tpu_torch.nn.modules import head as thead
from yolo_contour_regression_tpu_torch.nn.tasks import (YOLOV8_POSE, PoseModel, build_model,
                                                        guess_model_task, init_weights,
                                                        yaml_model_load)
from yolo_contour_regression_tpu_torch.utils import loss as tloss
from yolo_contour_regression_tpu_torch.utils.checkpoint import (
    checkpoint_variables, from_jax_variables, load_checkpoint, load_jax_variables,
    to_jax_variables)

from tests.test_torch_port_detect import _det_batch, _leaves
from tests.test_torch_port_modules import _carry, _init, _randomize, _x
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

# the head's maps and the decode (f32 convs summed in other orders)
HEAD_ATOL = 1e-3
# the pose loss on the same head maps (relative), its gradient (relative,
# and to 1e-5 of its largest entry)
LOSS_RTOL = 1e-5
# the loss of the network against the JAX network in float64 (relative),
# and each gradient (of its tensor's largest entry): the train-step test's
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 1e-3
# the published yolov8n-pose at nc 1, K 17: the reference counts 3,295,470
# with DFL's 16 fixed weights, which JAX and the port hold as a constant
YOLOV8N_POSE_PARAMS = 3_295_454
HYP = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5, pose=12.0, kobj=1.0)


def narrow(k):
    cfg = copy.deepcopy(YOLOV8_POSE)
    cfg.update(nc=2, kpt_shape=[k, 3], scale="t", scales={"t": [0.33, 0.125, 256]})
    return cfg


# --- the head and its decode ------------------------------------------------

@pytest.mark.parametrize("k", [5, 17])
def test_pose_head_and_decode_match(k):
    """Pose's widths (``c4 = max(ch0 // 4, nk)``, the detect child's), its
    per-level [detect | keypoints] maps, and ``decode_pose``: xy = (raw * 2
    + anchor - 0.5) * stride, visibility the sigmoid."""
    ch, hw = (16, 32, 64), ((16, 12), (8, 6), (4, 3))
    feats = [_x(40 + i, (2, h, w, c)) for i, ((h, w), c) in enumerate(zip(hw, ch))]
    jmod = jhead.Pose(nc=2, kpt_shape=(k, 3))
    jfeats = [jnp.asarray(f) for f in feats]
    jvars = _randomize(_init(jmod, jfeats), 41)
    want = jax.jit(jmod.apply)(jvars, jfeats)
    tmod = _carry(jvars, thead.Pose(nc=2, kpt_shape=(k, 3), ch=ch))
    assert tmod.cv4[0][0].conv.out_channels == max(16 // 4, 3 * k)
    assert tmod.detect.cv2[0][0].conv.out_channels == 64
    with torch.no_grad():
        got = tmod([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for g, w in zip(got, want):
        assert g.shape[1] == 64 + 2 + 3 * k
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=HEAD_ATOL)
    nk = 3 * k
    jraw = jhead.flatten_levels([w[..., -nk:] for w in want])
    traw = thead.flatten_levels([g[:, -nk:] for g in got])
    jdec = jhead.decode_pose(jraw, (8, 16, 32), hw, (k, 3))
    tdec = thead.decode_pose(traw, (8, 16, 32), hw, (k, 3))
    assert tdec.shape == (2, sum(h * w for h, w in hw), k, 3)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), atol=HEAD_ATOL * 32)


# --- the graph and its weights ----------------------------------------------

@pytest.mark.parametrize("k", [5, 17])
def test_pose_graph_matches_jax(k):
    """The narrow pose graph at 64 px, JAX's weights and BatchNorm
    statistics drawn with numpy: every level's head map and ``predict``'s
    (B, 4 + nc + nk, A) against JAX ``PoseModel.predict``."""
    cfg = narrow(k)
    jm = jbuild_model(cfg)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    v = _np(_randomize({n: shapes[n] for n in ("params", "batch_stats")}, 50 + k))
    x = np.random.default_rng(51).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.raw_forward(v, x))(v, jnp.asarray(x))
    tm = load_jax_variables(PoseModel(cfg), v["params"], v["batch_stats"]).eval()
    assert tm.kpt_shape == tuple(jm.kpt_shape) == (k, 3) and tm.strides == (8, 16, 32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got, pred = tm(xt), tm.predict(xt)
    for g, w in zip(got, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=HEAD_ATOL * scale)
    jpred = np.asarray(jm.decode(want))
    assert pred.shape == jpred.shape == (2, 4 + 2 + 3 * k, 84)
    px = np.ones(jpred.shape[1], bool)
    px[4:6] = False
    px[6 + 2::3] = False  # visibilities
    np.testing.assert_allclose(pred[:, ~px].numpy(), jpred[:, ~px], atol=HEAD_ATOL)
    np.testing.assert_allclose(pred[:, px].numpy(), jpred[:, px], atol=HEAD_ATOL * 64)


def test_yolov8n_pose_is_the_published_config():
    """``yolov8n-pose.yaml``: task pose, nc 1, K 17, scale n, and the JAX
    model's parameter count (``YOLOV8N_POSE_PARAMS``)."""
    cfg = yaml_model_load("yolov8n-pose.yaml")
    assert guess_model_task(cfg) == "pose" and cfg["scale"] == "n"
    model = build_model(cfg)
    assert isinstance(model, PoseModel) and model.kpt_shape == (17, 3) and model.nc == 1
    jm = jbuild_model("yolov8n-pose.yaml", task="pose")
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    assert model.num_params == n_jax == YOLOV8N_POSE_PARAMS


def test_floor_pose_weights_round_trip_exactly():
    """Every leaf of ``runs/floor_pose/best.ckpt`` (the head's
    ``layer22/detect/cv{2,3}_{i}_{j}`` and ``layer22/cv4_{i}_{j}``) maps to
    exactly one key of the port's model (``model.22.detect.cv2...``,
    ``model.22.cv4...``) and back to the same leaf, unchanged; the
    checkpoint's ``kpt_shape`` [5, 3] is the model's."""
    ckpt = load_checkpoint(POSE_CKPT)
    params, stats = checkpoint_variables(ckpt)
    sd = from_jax_variables(params, stats)
    n_leaves = len(list(_leaves(params))) + len(list(_leaves(stats)))
    model = load_jax_variables(build_model(ckpt["model_yaml"]), params, stats)
    assert model.kpt_shape == (5, 3) and ckpt["model_yaml"]["kpt_shape"] == [5, 3]
    want = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert len(sd) == n_leaves == len(want) and set(sd) == want
    assert "model.22.detect.cv2.0.0.conv.weight" in sd and "model.22.cv4.2.2.bias" in sd
    back_p, back_s = to_jax_variables(model.state_dict())
    for tree, back in ((params, back_p), (stats, back_s)):
        got = dict(_leaves(back))
        assert set(got) == {p for p, _ in _leaves(tree)}
        for p, a in _leaves(tree):
            np.testing.assert_array_equal(got[p], a, err_msg="/".join(p))


def test_init_weights_takes_the_pose_priors():
    """A fresh pose model: the class prior on the detect child's ``cv3[i][2]``
    bias, as JAX ``BaseModel.init`` puts it on ``detect/cv3_{i}_2``; the box
    and keypoint biases 0, as JAX's."""
    cfg = narrow(5)
    model = init_weights(PoseModel(cfg), torch.Generator().manual_seed(0))
    jv = compiled_init(jbuild_model(cfg), jax.random.PRNGKey(0), 64)  # this file runs no eager init
    head = jv["params"]["layer22"]
    for i in range(3):
        for tb, jb in ((model.model[22].detect.cv3[i][2].bias, head["detect"][f"cv3_{i}_2"]),
                       (model.model[22].detect.cv2[i][2].bias, head["detect"][f"cv2_{i}_2"]),
                       (model.model[22].cv4[i][2].bias, head[f"cv4_{i}_2"])):
            np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb["bias"]), rtol=1e-6)
    assert float(model.model[22].detect.cv3[0][2].bias[0]) < -5.0


# --- the loss ---------------------------------------------------------------

def _pose_batch(seed, B, n_pad, k, imgsz=64):
    """``_det_batch``'s images and boxes with ``k`` keypoints an instance:
    inside its box, about a fifth not visible (visibility 0), the rest 1 or
    2; the padding's keypoints zero."""
    images, batch = _det_batch(seed, B, n_pad, imgsz)
    rng = np.random.default_rng(seed + 100)
    box = batch["bboxes"]
    u = rng.uniform(-0.5, 0.5, (B, n_pad, k, 2))
    xy = box[:, :, None, :2] + u * box[:, :, None, 2:]
    vis = rng.choice([0.0, 1.0, 2.0], (B, n_pad, k), p=[0.2, 0.3, 0.5])
    kpts = np.concatenate([xy, vis[..., None]], -1).astype(np.float32)
    kpts[~batch["mask_gt"]] = 0.0
    batch["keypoints"] = kpts
    return images, batch


@pytest.mark.parametrize("k,seed,n_pad", [(5, 0, 4), (17, 1, 12)])
def test_pose_loss_and_grad_match_jax(k, seed, n_pad):
    """The pose loss on random head maps at imgsz 64 (its five items, COCO's
    sigmas at K 17 and uniform ones at 5), the shared assignment (the same
    ``fg_mask`` and ``target_gt_idx``), and the gradient w.r.t. the maps
    (NHWC for JAX, NCHW for the port)."""
    rng = np.random.default_rng(seed)
    B, nc, nk = 2, 2, 3 * k
    _, batch = _pose_batch(seed, B, n_pad, k)
    feats = []
    for s in (8, 16, 32):
        f = rng.normal(0, 2, (B, 64 // s, 64 // s, 64 + nc + nk))
        f[..., :64] -= np.tile(0.6 * np.arange(16), 4)
        f[..., 64 + nc:] *= 0.4  # keypoint offsets within a cell or so
        feats.append(f.astype(np.float32))
    jb = {n: jnp.asarray(v) for n, v in batch.items()}

    def jfn(fs):
        out = jloss.pose_loss(fs, jb, (8, 16, 32), nc, HYP, (k, 3))
        return out.total, out.items

    # compiled once each: eager dispatch took most of this test's time
    (jtotal, jitems), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        [jnp.asarray(f) for f in feats])
    jassign = jax.jit(lambda fs: jloss.detection_loss(fs, jb, (8, 16, 32), nc, HYP,
                                                      return_assign=True)[1])(
        [jnp.asarray(f[..., :-nk]) for f in feats])
    tfeats = [_t(f).permute(0, 3, 1, 2).contiguous().requires_grad_() for f in feats]
    tb = {n: _t(v) for n, v in batch.items()}
    out = tloss.pose_loss(tfeats, tb, (8, 16, 32), nc, HYP, (k, 3))
    out.total.backward()
    assign = tloss.detect_targets([f[:, :-nk] for f in tfeats], tb, (8, 16, 32), nc).assign
    np.testing.assert_array_equal(assign.fg_mask.numpy(), np.asarray(jassign.fg_mask))
    fg = assign.fg_mask.numpy()
    np.testing.assert_array_equal(assign.target_gt_idx.numpy()[fg],
                                  np.asarray(jassign.target_gt_idx)[fg])
    assert int(fg.sum()) > 0
    np.testing.assert_allclose(out.total.item(), float(jtotal), rtol=LOSS_RTOL)
    assert set(out.items) == set(jitems) == {"box_loss", "cls_loss", "dfl_loss", "pose_loss",
                                             "kobj_loss"}
    for n in jitems:
        np.testing.assert_allclose(out.items[n].item(), float(jitems[n]), rtol=LOSS_RTOL,
                                   err_msg=n)
    assert out.items["pose_loss"].item() > 0 and out.items["kobj_loss"].item() > 0
    for tf, jg in zip(tfeats, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tf.grad.permute(0, 2, 3, 1).numpy(), jg, rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * np.abs(jg).max())


def test_oks_sigma_is_jaxs():
    np.testing.assert_array_equal(tloss.OKS_SIGMA.numpy(), np.asarray(jloss.OKS_SIGMA))
    assert tloss.OKS_SIGMA.dtype == torch.float32


def _grad_gap(grads, want):
    """The worst gradient difference of any tensor, over its largest entry."""
    return max(float((grads[n].double() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for n, w in want.items())


@pytest.mark.parametrize("k", [5, 17])
def test_pose_network_loss_and_gradients_match_jax_f64(k):
    """The narrow pose graph in train mode at imgsz 64, batch 2, both
    networks in float64 (the loss math f32 on both sides): the loss, every
    parameter's gradient at the train-step test's tolerances, the stage
    marks, and the assignment on the two networks' head maps. Then the
    networks in float32: at batch 2 BatchNorm over 2x2 maps makes these
    gradients ill-conditioned (at K 5 both sides' float32 gradients are tens
    of percent of a tensor's largest entry off their float64 ones), so the
    port's float32 gradients are held to be no further from JAX's float64
    ones than JAX's own float32 gradients are."""
    cfg = narrow(k)
    jm = jbuild_model(cfg)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    v = _np(_randomize({n: shapes[n] for n in ("params", "batch_stats")}, 60 + k))
    images, batch = _pose_batch(61, 2, 4, k)
    nk = 3 * k
    jb = {n: jnp.asarray(a) for n, a in batch.items()}
    with jax.enable_x64(True):
        jm64 = jbuild_model(cfg, dtype=jnp.float64)
        v64 = _f64(v)
        jb64 = {n: jnp.asarray(a) for n, a in batch.items()}
        fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm64, HYP), has_aux=True))
        (jl, _), jg = fn(v64["params"], v64["batch_stats"], jnp.asarray(images, jnp.float64),
                         jb64)
        jl, jg = float(jl), from_jax_variables(_np(jg), {})
        jg = {n: w.double() for n, w in jg.items()}
        def assign(vv, x, b):  # compiled once: eager dispatch took ~20 s of this test
            jout, _ = jm64.raw_forward(vv, x, train=True)
            _, a = jloss.detection_loss([o[..., :-nk] for o in jout], b, (8, 16, 32), 2, HYP,
                                        return_assign=True)
            return a.fg_mask, a.target_gt_idx

        jfg, jidx = (np.asarray(a) for a in jax.jit(assign)(
            v64, jnp.asarray(images, jnp.float64), jb64))
    tb = {n: _t(a) for n, a in batch.items()}
    model = load_jax_variables(PoseModel(cfg), v["params"], v["batch_stats"]).double().train()
    marks = []
    loss, items = tstep.make_loss_fn(model, HYP, mark=marks.append)(_t(images).double(), tb)
    loss.backward()
    assert marks == ["forward", "assigner", "loss"]
    assert set(items) == {"box_loss", "cls_loss", "dfl_loss", "pose_loss", "kobj_loss"}
    assert items["pose_loss"].item() > 0
    np.testing.assert_allclose(loss.item(), jl, rtol=STEP_LOSS_RTOL)
    grads = dict(model.named_parameters())
    assert set(grads) == set(jg)
    for n, w in jg.items():
        err = float((grads[n].grad - w).abs().max())
        assert err <= STEP_GRAD_TOL * float(w.abs().max()), (n, err)
    model = load_jax_variables(PoseModel(cfg), v["params"], v["batch_stats"]).double().train()
    with torch.no_grad():
        feats = model(_t(images).double().permute(0, 3, 1, 2))
    assign = tloss.detect_targets([f[:, :-nk] for f in feats], tb, (8, 16, 32), 2).assign
    np.testing.assert_array_equal(assign.fg_mask.numpy(), jfg)
    np.testing.assert_array_equal(assign.target_gt_idx.numpy()[jfg], jidx[jfg])
    assert int(jfg.sum()) > 0

    fn32 = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm, HYP), has_aux=True))
    (jl32, _), jg32 = fn32(v["params"], v["batch_stats"], jnp.asarray(images), jb)
    model = load_jax_variables(PoseModel(cfg), v["params"], v["batch_stats"]).train()
    loss32, _ = tstep.make_loss_fn(model, HYP)(_t(images), tb)
    loss32.backward()
    np.testing.assert_allclose(loss32.item(), jl, rtol=STEP_LOSS_RTOL)
    port_gap = _grad_gap({n: p.grad for n, p in model.named_parameters()}, jg)
    jax_gap = _grad_gap(from_jax_variables(_np(jg32), {}), jg)
    print(f"K {k}: float32 gradients against JAX's float64, worst of a tensor's largest: "
          f"port {port_gap:.3e}, JAX {jax_gap:.3e}")
    assert port_gap <= max(jax_gap, STEP_GRAD_TOL)
