"""The PyTorch port's train-step slice against the JAX package on the CPU:
BatchNorm's train-mode statistics, the polar assigner (sparse and dense),
the segmentation loss and its gradient, the optimizer groups and schedules,
one full ``make_train_step`` on a narrow yolov8-seg graph, and checkpoints
in the JAX format. Inputs and weights are made from seeds with numpy and
handed to both packages."""
import copy
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import circle_contour, shape_batch, shape_images
from yolo_contour_regression_tpu.cfg import get_cfg
from yolo_contour_regression_tpu.engine import step as jstep
from yolo_contour_regression_tpu.engine.predictor import SegmentationPredictor as JaxPredictor
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.nn.modules import conv as jconv
from yolo_contour_regression_tpu.nn.tasks import build_model
from yolo_contour_regression_tpu.ops import polar as jpolar
from yolo_contour_regression_tpu.utils import loss as jloss
from yolo_contour_regression_tpu.utils import optim as joptim
from yolo_contour_regression_tpu.utils import tal as jtal
from yolo_contour_regression_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine import step as tstep
from yolo_contour_regression_tpu_torch.engine.predictor import SegmentationPredictor
from yolo_contour_regression_tpu_torch.nn.modules import conv as tconv
from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8_SEG, SegmentationModel
from yolo_contour_regression_tpu_torch.utils import loss as tloss
from yolo_contour_regression_tpu_torch.utils import optim as toptim
from yolo_contour_regression_tpu_torch.utils import tal as ttal
from yolo_contour_regression_tpu_torch.utils.checkpoint import (
    CKPT_VERSION, checkpoint_variables, from_jax_variables, load_checkpoint, load_jax_variables,
    save_checkpoint, to_jax_variables)

from tests.test_torch_port_modules import _carry, _randomize
from tests.test_torch_port_slice import CKPT


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# BatchNorm running statistics after one update: O(1) values, a few ulps
BN_TOL = 1e-6
# assigner targets: f32 on both sides, summed in other orders
ASSIGN_TOL = 1e-5
# loss on the same head maps, and its gradient (relative; the gradient also
# to 1e-5 of its largest entry)
LOSS_RTOL = 1e-5
# the full step: loss (relative), each gradient (of its tensor's largest
# entry), and parameters, EMA and BatchNorm statistics after the step
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 1e-3
STEP_STATE_TOL = 1e-5
# AdamW past warmup, first update, lr0 itself: the change of each parameter
# (after minus before) at the entries whose gradient the gradient tolerance
# pins (|g| at least STEP_GRAD_TOL of its tensor's largest), to this share of
# the tensor's largest change there; the other entries within 2 lr0
STEP_DELTA_RTOL = 1e-3
# the optimizer alone, port against optax on the same gradients, both in
# float64 (in float32 one ulp of a BatchNorm scale is some 1e-3 of its
# change): each update's change, to this share of its tensor's largest
# change (the lr and momentum schedules are rounded to float32 on the port's
# side only, some 1e-8)
OPT_DELTA_RTOL = 1e-6
# AdamW's first updates are lr * m / (sqrt(v) + eps), close to lr * sign(g):
# where a gradient entry is smaller than the gradient tolerance above, its
# sign is not pinned by it and the update may take the other sign. Such
# entries, at most this share of a tensor, may differ by up to 2 lr per step
ADAM_SIGN_SHARE = 1e-3
BOX_PX = 0.05

NARROW = copy.deepcopy(YOLOV8_SEG)
NARROW.update(nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- BatchNorm --------------------------------------------------------------

@pytest.mark.parametrize("shape,c2", [((2, 2, 2, 1), 3), ((2, 9, 7, 4), 8)])
def test_batchnorm_train_mode_matches_flax(shape, c2):
    """One train-mode forward of ``Conv``: the output and the running mean
    and variance equal flax's (0.97 * running + 0.03 * batch, with the
    biased batch variance)."""
    x = np.random.default_rng(c2).normal(1.0, 2.0, shape).astype(np.float32)
    jm = jconv.Conv(c2, 3, 1)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jvars = _randomize(dict(shapes), seed=c2)
    y, mut = jm.apply(jvars, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm = _carry(jvars, tconv.Conv(shape[-1], c2, 3, 1)).train()
    ty = tm(_t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y), atol=1e-5)
    bn = mut["batch_stats"]["bn"]
    np.testing.assert_allclose(tm.bn.running_mean.numpy(), np.asarray(bn["mean"]), atol=BN_TOL)
    np.testing.assert_allclose(tm.bn.running_var.numpy(), np.asarray(bn["var"]), atol=BN_TOL)
    # eval mode is torch's own: the running statistics, unchanged by a call
    before = tm.bn.running_var.clone()
    tm.eval()(_t(x).permute(0, 3, 1, 2))
    assert torch.equal(tm.bn.running_var, before)


# --- the assigner -----------------------------------------------------------

def _anchors(imgsz):
    strides = (8, 16, 32)
    pts, st = jpolar.make_anchors([(imgsz // s, imgsz // s) for s in strides], strides)
    return np.asarray(pts * st)


def _single_circle():
    """tests/test_assigner_loss.py:scene: one circle at (16, 16), r 8."""
    B, N, nc = 2, 3, 3
    labels = np.zeros((B, N), np.int32)
    boxes = np.zeros((B, N, 4), np.float32)
    contours = np.zeros((B, N, 360, 2), np.float32)
    mask = np.zeros((B, N), bool)
    labels[0, 0], boxes[0, 0], mask[0, 0] = 1, [8, 8, 24, 24], True
    contours[0, 0] = circle_contour(16, 16, 8)
    return labels, boxes, contours, mask, nc


def _scene(name):
    """(pd_scores, pd_rays, anchors, labels, boxes, contours, mask), cand:
    the scenes of tests/test_assigner_loss.py:55, :93 and :276, and a
    crowded one where the candidate cap binds."""
    rng = np.random.default_rng(0)
    if name in ("single", "dedupe"):
        labels, boxes, contours, mask, nc = _single_circle()
        anc = _anchors(32)
        A = len(anc)
        if name == "single":
            scores = rng.uniform(0.1, 0.9, (2, A, nc)).astype(np.float32)
        else:
            labels[0, 1], boxes[0, 1], mask[0, 1] = 2, [10, 10, 26, 26], True
            contours[0, 1] = circle_contour(18, 18, 8)
            scores = np.full((2, A, nc), 0.5, np.float32)
        rays = np.full((2, A, 36), 8.0, np.float32)
        cand = 16
    else:
        crowded = name == "crowded"
        rng = np.random.default_rng(11 if crowded else 7)
        imgsz, nc = 64, 5
        anc = _anchors(imgsz)
        A = len(anc)
        B, N = (2, 8) if crowded else (3, 6)
        labels = rng.integers(0, nc, (B, N)).astype(np.int32)
        mask = rng.uniform(size=(B, N)) < (0.9 if crowded else 0.7)
        ctr = rng.uniform(16, 48, (B, N, 2))
        rad = rng.uniform(16, 28, (B, N)) if crowded else rng.uniform(6, 20, (B, N))
        boxes = np.concatenate([ctr - rad[..., None], ctr + rad[..., None]], -1).astype(np.float32)
        contours = np.stack([[circle_contour(*ctr[b, n], rad[b, n]) for n in range(N)]
                             for b in range(B)]).astype(np.float32)
        if not crowded:
            mask[2, :] = False  # an all-padding image
            for arr in (labels, boxes, contours):  # GT 1 duplicates GT 0: an exact tie
                arr[0, 1] = arr[0, 0]
            mask[0, 0] = mask[0, 1] = True
        scores = rng.uniform(0, 1, (B, A, nc)).astype(np.float32)
        rays = rng.uniform(1, 20, (B, A, 36)).astype(np.float32)
        cand = 16 if crowded else 32
    return (scores, rays, anc, labels, boxes, contours, mask), cand


@pytest.mark.parametrize("impl", ["sparse", "dense"])
@pytest.mark.parametrize("name", ["single", "dedupe", "ties", "crowded"])
def test_polar_assign_matches_jax(name, impl):
    args, cand = _scene(name)
    j = jtal.polar_task_aligned_assign(*map(jnp.asarray, args), cand=cand, impl=impl)
    t = ttal.polar_task_aligned_assign(*map(_t, args), cand=cand, impl=impl)
    fg = np.asarray(j.fg_mask)
    assert fg.any()
    if name == "crowded":  # the cap binds: more in-box anchors than candidates
        inside = np.asarray(jtal.select_candidates_in_gts(jnp.asarray(args[2]),
                                                          jnp.asarray(args[4])))
        assert (inside & args[6][..., None]).sum(-1).max() > cand
    np.testing.assert_array_equal(t.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(t.target_gt_idx.numpy(), np.asarray(j.target_gt_idx))
    np.testing.assert_array_equal(t.target_labels.numpy(), np.asarray(j.target_labels))
    for field in ("target_rays", "target_scores", "centerness", "target_bboxes"):
        np.testing.assert_allclose(getattr(t, field).numpy(), np.asarray(getattr(j, field)),
                                   rtol=ASSIGN_TOL, atol=ASSIGN_TOL, err_msg=field)


def test_select_candidates_and_cand_caps_match():
    anc = _anchors(64)
    boxes = np.random.default_rng(1).uniform(0, 64, (2, 5, 4)).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2]
    np.testing.assert_array_equal(
        ttal.select_candidates_in_gts(_t(anc), _t(boxes)).numpy(),
        np.asarray(jtal.select_candidates_in_gts(jnp.asarray(anc), jnp.asarray(boxes))))
    for cand in (None, 0, "auto", 16, 128, 10_000):
        for A in (84, 2100, 8400, 33600):
            for n_pad in (None, 4, 8, 12, 48):
                for balance in (True, False):
                    assert (ttal.resolve_cand(cand, A, n_pad, balance)
                            == jtal.resolve_cand(cand, A, n_pad, balance))


# --- the loss ---------------------------------------------------------------

@pytest.mark.parametrize("seed,n_pad,cand", [(0, 4, 128), (1, 12, 128), (2, 4, 16)])
def test_segmentation_loss_and_grad_match_jax(seed, n_pad, cand):
    """The loss on random head maps at imgsz 64, and its gradient w.r.t.
    the maps (NHWC for JAX, NCHW for the port)."""
    rng = np.random.default_rng(seed)
    B, nc = 2, 2
    _, batch = shape_batch(B, 64, n_pad, seed)
    feats = []
    for s in (8, 16, 32):
        f = np.empty((B, 64 // s, 64 // s, 36 + nc), np.float32)
        f[..., :36] = rng.uniform(0.2, 3.0, f[..., :36].shape)
        f[..., 36:] = rng.normal(-2.0, 1.5, f[..., 36:].shape)
        feats.append(f)
    hyp = SimpleNamespace(box=7.5, cls=0.5, cand_balance=True)

    def jfn(fs):
        out = jloss.segmentation_loss(fs, {k: jnp.asarray(v) for k, v in batch.items()},
                                      (8, 16, 32), nc, hyp, cand=cand)
        return out.total, out.items

    # compiled once: eager dispatch took most of this test's time
    (jtotal, jitems), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        [jnp.asarray(f) for f in feats])
    tfeats = [_t(f).permute(0, 3, 1, 2).contiguous().requires_grad_() for f in feats]
    out = tloss.segmentation_loss(tfeats, {k: _t(v) for k, v in batch.items()}, (8, 16, 32), nc,
                                  hyp, cand=cand)
    out.total.backward()
    np.testing.assert_allclose(out.total.item(), float(jtotal), rtol=LOSS_RTOL)
    for k in jitems:
        np.testing.assert_allclose(out.items[k].item(), float(jitems[k]), rtol=LOSS_RTOL)
    for tf, jg in zip(tfeats, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tf.grad.permute(0, 2, 3, 1).numpy(), jg, rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * np.abs(jg).max())


# --- the optimizer ----------------------------------------------------------

def _hyp(optimizer, **kw):
    base = dict(optimizer=optimizer, nc=2, lr0=0.001667, lrf=0.01, momentum=0.9,
                weight_decay=0.0005, warmup_epochs=0.0, warmup_bias_lr=0.0,
                warmup_momentum=0.8, epochs=10, batch=2, nbs=16, accumulate=1,
                box=7.5, cls=0.5, cand_balance=True)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("kw", [dict(warmup_epochs=0.0),
                                dict(warmup_epochs=3.0, warmup_bias_lr=0.1),
                                dict(warmup_epochs=1.0, cos_lr=True, warmup_bias_lr=0.1)])
def test_schedules_match_jax(kw):
    hyp = _hyp("SGD", momentum=0.937, **kw)
    for fn in ("lr_schedule", "bias_lr_schedule", "momentum_schedule"):
        jf, tf = getattr(joptim, fn)(hyp, 40), getattr(toptim, fn)(hyp, 40)
        for step in (0, 1, 2, 39, 40, 99, 100, 101, 119, 120, 399):
            np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6, err_msg=f"{fn}({step})")
    # the JAX ramp takes 1 - exp(x) in f32, so it is good to one ulp of 1.0
    for step in (0, 1, 2, 1000, 10**6):
        assert abs(toptim.ema_decay(step) - float(joptim.ema_decay(step))) <= 2.0**-23


def test_param_groups_match_jax():
    """Every parameter lands in the group of its JAX leaf: BatchNorm biases
    and the head's conv biases are "bias", BatchNorm scales "norm", conv
    kernels "weight"."""
    ckpt = load_checkpoint(CKPT)
    params, _ = checkpoint_variables(ckpt)
    want = {}
    for path, label in jax.tree_util.tree_flatten_with_path(joptim.label_tree(params))[0]:
        keys = tuple(p.key for p in path)
        leaf = params
        for k in keys:
            leaf = leaf[k]
        nested = leaf
        for k in reversed(keys):
            nested = {k: nested}
        (key,) = from_jax_variables(nested, {}).keys()
        want[key] = label
    model = SegmentationModel(ckpt["model_yaml"])
    got = {n: toptim.param_group_label(n) for n, _ in model.named_parameters()}
    assert got == want
    assert {"weight", "bias", "norm"} == set(got.values())


def test_build_optimizer_picks_and_refuses():
    model = SegmentationModel(NARROW)
    hyp = _hyp("auto")
    opt = toptim.build_optimizer(model, hyp, 10, 100)
    assert isinstance(opt.opt, torch.optim.AdamW)
    assert hyp.lr0 == round(0.002 * 5 / (4 + 2), 6) and hyp.warmup_bias_lr == 0.0
    assert isinstance(toptim.build_optimizer(model, _hyp("auto"), 10, 20_000).opt, torch.optim.SGD)
    groups = {g["name"]: g for g in opt.opt.param_groups}
    assert groups["weight"]["weight_decay"] == pytest.approx(0.0005 * 2 / 16)
    assert groups["bias"]["weight_decay"] == groups["norm"]["weight_decay"] == 0.0
    for name in ("Adam", "RMSProp", "NAdam"):  # ported: optax's rules (test_torch_port_optimizers)
        assert isinstance(toptim.build_optimizer(model, _hyp(name), 10, 100).opt,
                          toptim.OptaxRule)
    with pytest.raises(NotImplementedError):
        toptim.build_optimizer(model, _hyp("LAMB"), 10, 100)


def test_clip_matches_optax():
    """Scaled by 10 / ||g|| only when ||g|| >= 10; unchanged below."""
    import optax

    rng = np.random.default_rng(0)
    model = SegmentationModel(NARROW)
    opt = toptim.build_optimizer(model, _hyp("AdamW"), 10, 100)
    for scale in (1e-3, 1.0):
        grads = [rng.normal(0, scale, p.shape).astype(np.float32) for p in opt.params]
        for p, g in zip(opt.params, grads):
            p.grad = _t(g).clone()
        norm = float(opt.clip_grads())
        want, _ = jax.jit(optax.clip_by_global_norm(10.0).update)(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        np.testing.assert_allclose(norm, float(jax.jit(optax.global_norm)(grads)), rtol=1e-5)
        assert (norm >= 10.0) == (scale == 1.0)
        for p, w in zip(opt.params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-9)


# --- the full step ----------------------------------------------------------

def _narrow_variables(jm, seed):
    """The narrow graph's variables drawn with numpy (``_randomize``), the
    ray biases of the head raised by 1 so the first rays are positive."""
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    v = _np(_randomize({k: shapes[k] for k in ("params", "batch_stats")}, seed))
    head = v["params"][f"layer{jm.head_index}"]
    for name in head:
        if name.startswith("cv2_") and name.endswith("_2"):
            head[name]["bias"] = head[name]["bias"] + np.float32(1.0)
    return v


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if np.asarray(a).dtype == np.float32 else a, tree)


@pytest.fixture(scope="module")
def narrow():
    jm = build_model(NARROW)
    v = _narrow_variables(jm, seed=5)
    images, batch = shape_batch(2, 64, 4, seed=6)
    return jm, v, images, batch


@pytest.fixture(scope="module")
def runs(narrow):
    """Two steps of each case on both sides, run once per module."""
    _, v, images, batch = narrow
    cache = {}

    def get(case):
        if case not in cache:
            hyp = _case_hyp(*STEP_CASES[case])
            cache[case] = (hyp, _jax_f64_run(NARROW, v, images, batch, hyp, steps=2),
                           _port_run(v, images, batch, hyp, steps=2))
        return cache[case]

    return get


# the float64 JAX model of NARROW and its compiled loss gradient, by the
# loss's weights (the optimizer's settings never enter the loss): the step
# cases share one trace and compile of it
_JAX_F64_GRAD = {}


def _jax_f64_grad(jm_cfg, hyp):
    key = (id(jm_cfg),) + tuple(getattr(hyp, k, None) for k in (
        "box", "cls", "dfl", "kobj", "pose", "cand_balance"))
    if key not in _JAX_F64_GRAD:
        jm = build_model(jm_cfg, dtype=jnp.float64)
        _JAX_F64_GRAD[key] = jm, jax.jit(jax.value_and_grad(
            jstep.make_loss_fn(jm, hyp, cand=128), has_aux=True))
    return _JAX_F64_GRAD[key]


def _jax_f64_run(jm_cfg, v, images, batch, hyp, steps):
    """The JAX make_train_step with the network in float64 (the loss math
    stays f32 inside segmentation_loss): per step the loss, the gradients
    (torch keys) before the update, and the state after it."""
    out = []
    with jax.enable_x64(True):
        jm, grad_fn = _jax_f64_grad(jm_cfg, hyp)
        v64 = _f64(v)
        tx = joptim.build_optimizer(v64["params"], copy.copy(hyp), 10, 100)
        state = jstep.init_train_state(v64, tx)
        step = jstep.make_train_step(jm, tx, copy.copy(hyp), cand=128, donate=False)
        x = jnp.asarray(images, jnp.float64)
        jb = {k: jnp.asarray(a) for k, a in batch.items()}
        for _ in range(steps):
            (loss, _), g = grad_fn(state.params, state.batch_stats, x, jb)
            state, metrics = step(state, x, jb)
            out.append(dict(
                loss=float(metrics["loss"]), grad_loss=float(loss),
                grads=from_jax_variables(_np(g), {}),
                state=from_jax_variables(_np(state.params), _np(state.batch_stats)),
                ema=from_jax_variables(_np(state.ema_params), {})))
    return out


def _port_run(v, images, batch, hyp, steps):
    model = SegmentationModel(NARROW)
    load_jax_variables(model, v["params"], v["batch_stats"])
    opt = toptim.build_optimizer(model, copy.copy(hyp), 10, 100)
    state = tstep.init_train_state(model, opt, device="cpu")
    step = tstep.make_train_step(model, opt, hyp, cand=128)
    tb = {k: _t(a) for k, a in batch.items()}
    out = []
    for _ in range(steps):
        probe = copy.deepcopy(model).train()
        loss, _ = tstep.make_loss_fn(probe, hyp, cand=128)(_t(images), tb)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in probe.named_parameters()}
        metrics = step(state, _t(images), tb)
        out.append(dict(loss=metrics["loss"].item(), grad_loss=loss.item(), grads=grads,
                        state={k: t.clone() for k, t in model.state_dict().items()},
                        ema={k: t.clone() for k, t in state.ema.items()}))
    return out, state


STEP_CASES = {
    # the seg160 checkpoint's train_args: lr0 0.001667, 3 warmup epochs
    "adamw": ("AdamW", 0.001667, dict(warmup_epochs=3.0, warmup_bias_lr=0.0)),
    "sgd_warmup": ("SGD", 0.01, dict(momentum=0.937, warmup_epochs=1.0, warmup_bias_lr=0.1)),
}


def _case_hyp(optimizer, lr0, kw):
    return _hyp(optimizer, lr0=lr0, **kw)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(runs, case):
    """Two steps of ``make_train_step`` on the narrow graph (scale
    [0.33, 0.125, 256]) at imgsz 64, batch 2, against the JAX
    ``make_train_step``. The JAX network runs in float64: in float32 its
    train-mode gradients at this batch are off by several percent of their
    largest entry (test_jax_f32_gradients_are_the_less_accurate), so float64
    is the reference that can pin the port's. Both cases run inside the
    warmup, so the first update has lr 0 for the weights and norms. AdamW
    takes the seg160 checkpoint's train_args (lr0 0.001667, 3 warmup
    epochs, warmup_bias_lr 0); SGD starts the bias group at warmup_bias_lr
    0.1 and ramps the momentum from 0.8."""
    optimizer = STEP_CASES[case][0]
    hyp, want, (got, state) = runs(case)
    assert state.step == 2
    assert toptim.lr_schedule(hyp, 10)(0) == 0.0
    lrs = [max(toptim.lr_schedule(hyp, 10)(k), toptim.bias_lr_schedule(hyp, 10)(k))
           for k in range(2)]
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=STEP_LOSS_RTOL)
        np.testing.assert_allclose(g["grad_loss"], w["grad_loss"], rtol=STEP_LOSS_RTOL)
        for n, wg in w["grads"].items():
            err = float((g["grads"][n] - wg).abs().max())
            assert err <= STEP_GRAD_TOL * float(wg.abs().max()), (k, n, err)
        for what in ("state", "ema"):
            for n, wt in w[what].items():
                diff = (g[what][n] - wt).abs()
                bad = diff > STEP_STATE_TOL
                if not bad.any():
                    continue
                # only AdamW, only where a gradient entry was below the
                # gradient tolerance at some step so far, and few of them
                assert optimizer == "AdamW", (k, what, n, float(diff.max()))
                tiny = torch.zeros_like(bad)
                for s in range(k + 1):
                    gs = want[s]["grads"][n]
                    tiny |= gs.abs() < STEP_GRAD_TOL * gs.abs().max()
                assert not (bad & ~tiny).any(), (k, what, n, float(diff.max()))
                assert int(bad.sum()) <= ADAM_SIGN_SHARE * bad.numel(), (k, what, n, int(bad.sum()))
                assert float(diff.max()) <= 2 * sum(lrs[: k + 1]), (k, what, n, float(diff.max()))


def test_jax_f32_gradients_are_the_less_accurate(narrow, runs):
    """Why the step test holds the port to the JAX step in float64: at
    imgsz 64, batch 2 (BatchNorm over 8 values per channel at stride 32)
    the JAX network in float32 gives train-mode gradients further from the
    float64 ones than the port's float32 gradients are. Prints both."""
    jm, v, images, batch = narrow
    hyp, want, (got, _) = runs("adamw")
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    (_, _), g32 = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm, hyp, cand=128), has_aux=True))(
        v["params"], v["batch_stats"], jnp.asarray(images), jb)
    jax32 = from_jax_variables(_np(g32), {})
    ref, port = want[0]["grads"], got[0]["grads"]

    def worst(gs):
        return max(float((gs[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30))
                   for n in ref)

    e_jax, e_port = worst(jax32), worst(port)
    print(f"\nlargest gradient error over the largest entry, against the JAX step in float64: "
          f"JAX float32 {e_jax:.3g}, port float32 {e_port:.3g}")
    assert e_port <= STEP_GRAD_TOL < e_jax


ADAMW_LR0 = ("AdamW", 0.001667, dict(warmup_epochs=0.0))


@pytest.fixture(scope="module")
def lr0_run(narrow):
    """One step past warmup on both sides, and the parameters before it."""
    _, v, images, batch = narrow
    hyp = _case_hyp(*ADAMW_LR0)
    before = from_jax_variables(_np(v["params"]), {})
    return (hyp, before, _jax_f64_run(NARROW, v, images, batch, hyp, steps=1)[0],
            _port_run(v, images, batch, hyp, steps=1)[0][0])


def _step_delta_errors(got, want, before, grads):
    """The largest error of a step's change to the parameters (or their
    EMA), at the entries whose gradient is pinned, as a share of the
    tensor's largest change there; and elsewhere, absolute."""
    rel, rest = 0.0, 0.0
    for n, b in before.items():
        g = grads[n]
        pinned = g.abs() >= STEP_GRAD_TOL * g.abs().max()
        dw = want[n] - b
        err = (got[n] - b - dw).abs()
        if pinned.any():
            rel = max(rel, float(err[pinned].max() / dw[pinned].abs().max().clamp_min(1e-30)))
        if not pinned.all():
            rest = max(rest, float(err[~pinned].max()))
    return rel, rest


def test_adamw_step_past_warmup_matches_jax(lr0_run):
    """One ``make_train_step`` with AdamW past warmup (warmup_epochs 0, as
    chip_smoke.py's full-width run trains), so the update takes lr0 itself,
    against the JAX step in float64: the loss and gradients as in
    test_train_step_matches_jax, the change of every parameter and of its
    EMA to STEP_DELTA_RTOL of the tensor's largest change, and the BatchNorm
    statistics to STEP_STATE_TOL. test_update_tolerances_reject_controls
    shows that half the lr fails this. The second update is held on the same
    gradients by test_optimizer_updates_match_optax: in a full step it
    divides m by sqrt(v) where the two steps' gradients nearly cancel, which
    turns their f32 noise into changes of up to 2 lr0."""
    hyp, before, want, got = lr0_run
    lr = toptim.lr_schedule(hyp, 10)(0)
    assert lr == pytest.approx(hyp.lr0, rel=1e-6)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=STEP_LOSS_RTOL)
    for n, wg in want["grads"].items():
        err = float((got["grads"][n] - wg).abs().max())
        assert err <= STEP_GRAD_TOL * float(wg.abs().max()), (n, err)
    for what in ("state", "ema"):
        rel, rest = _step_delta_errors(got[what], want[what], before, want["grads"])
        print(f"\n{what}: change {rel:.3g} of the largest (limit {STEP_DELTA_RTOL}), "
              f"unpinned entries {rest:.3g} (limit {2 * lr:.3g})")
        assert rel <= STEP_DELTA_RTOL and rest <= 2 * lr, (what, rel, rest)
    for n, wt in want["state"].items():
        if n not in before:
            assert float((got["state"][n] - wt).abs().max()) <= STEP_STATE_TOL, n


OPT_CASES = {"AdamW": dict(lr0=0.001667), "SGD": dict(lr0=0.01, momentum=0.937)}
OPT_STEPS = 3


class _AdamWNoBiasCorrection(torch.optim.Optimizer):
    """AdamW with the bias correction left out: a control, never used to train."""

    def __init__(self, groups, betas):
        super().__init__(groups, dict(lr=0.0, betas=betas))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["m"], st["v"] = torch.zeros_like(p), torch.zeros_like(p)
                st["m"].mul_(b1).add_(p.grad, alpha=1 - b1)
                st["v"].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                p.mul_(1 - group["lr"] * group["weight_decay"])
                p.sub_(group["lr"] * st["m"] / (st["v"].sqrt() + 1e-8))


def _opt_hyp(name, **kw):
    """Past warmup, with a weight decay large enough to show in each change
    (lr * wd * |p| some 1e-3 of it)."""
    return _hyp(name, warmup_epochs=0.0, weight_decay=0.05, **{**OPT_CASES[name], **kw})


def _opt_grads(v, seed=21):
    """OPT_STEPS gradient trees shaped like ``v["params"]``, f32, global
    norm about 2 (below the clip)."""
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(lambda a: rng.normal(0, 1e-2, a.shape).astype(np.float32),
                                   v["params"]) for _ in range(OPT_STEPS)]


def _jax_opt_run(v, hyp, grads):
    """optax, as the JAX package builds it, in float64: the parameters
    after each update (torch keys)."""
    import optax

    out = []
    with jax.enable_x64(True):
        params = _f64(v["params"])
        tx = joptim.build_optimizer(params, copy.copy(hyp), 10, 100)
        state = tx.init(params)
        update = jax.jit(lambda g, s, p: tx.update(g, s, p))
        for g in grads:
            upd, state = update(_f64(g), state, params)
            params = optax.apply_updates(params, upd)
            out.append(_torch_f64(params))
    return out


def _torch_f64(tree, prefix=()):
    """A JAX params tree -> torch keys, in float64 (``from_jax_variables``
    takes float32): each leaf's key from ``from_jax_variables`` of that leaf
    alone, kernels HWIO -> OIHW."""
    out = {}
    for k, a in tree.items():
        if isinstance(a, dict):
            out.update(_torch_f64(a, prefix + (k,)))
            continue
        a = np.asarray(a, np.float64)
        nested = {k: a.astype(np.float32)}
        for p in reversed(prefix):
            nested = {p: nested}
        (key,) = from_jax_variables(nested, {}).keys()
        out[key] = torch.from_numpy(a.transpose(3, 2, 0, 1).copy() if a.ndim == 4 else a)
    return out


def _port_opt_run(v, hyp, grads, control=None):
    """The port's optimizer on the same gradients; ``control`` swaps the
    torch optimizer for a wrong one (plain Adam, AdamW without bias
    correction, SGD without nesterov) to show what the tolerance catches."""
    model = SegmentationModel(NARROW)
    load_jax_variables(model, v["params"], v["batch_stats"])
    model.double()
    opt = toptim.build_optimizer(model, copy.copy(hyp), 10, 100)
    groups = [{"params": g["params"], "name": g["name"], "weight_decay": g["weight_decay"]}
              for g in opt.opt.param_groups]
    if control == "plain_adam":
        opt.opt = torch.optim.Adam(groups, lr=0.0, betas=(hyp.momentum, 0.999), eps=1e-8)
    elif control == "no_bias_correction":
        opt.opt = _AdamWNoBiasCorrection(groups, betas=(hyp.momentum, 0.999))
    elif control == "no_nesterov":
        opt.opt = torch.optim.SGD(groups, lr=0.0, momentum=hyp.momentum, nesterov=False)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = []
    for k, g in enumerate(grads):
        tg = _torch_f64(g)
        for n, p in model.named_parameters():
            p.grad = tg[n].clone()
        opt.step(k)
        out.append({n: p.detach().clone() for n, p in model.named_parameters()})
    toptim.ema_update(ema, model, 2000)
    return out, ema, model


def _opt_delta_error(got, want, before) -> float:
    """The largest error of an update's change, as a share of its tensor's
    largest change, over the tensors and the updates."""
    worst = 0.0
    seq_g, seq_w = [before] + got, [before] + want
    for k in range(len(got)):
        for n in before:
            dg, dw = seq_g[k + 1][n] - seq_g[k][n], seq_w[k + 1][n] - seq_w[k][n]
            worst = max(worst, float((dg - dw).abs().max() / dw.abs().max().clamp_min(1e-30)))
    return worst


@pytest.fixture(scope="module")
def opt_ref(narrow):
    _, v, _, _ = narrow
    grads = _opt_grads(v)
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _jax_opt_run(v, _opt_hyp(name), grads)
        return cache[name]

    return v, grads, get


@pytest.mark.parametrize("name", list(OPT_CASES))
def test_optimizer_updates_match_optax(opt_ref, name):
    """OPT_STEPS updates past warmup on the same seeded gradients, the
    port's optimizer against the JAX package's optax chain: every update's
    change to OPT_DELTA_RTOL of its tensor's largest, bias correction,
    momentum, nesterov and the decoupled (AdamW) or coupled (SGD) weight
    decay included; then the EMA at update 2000 (decay 0.63)."""
    v, grads, ref = opt_ref
    got, ema, model = _port_opt_run(v, _opt_hyp(name), grads)
    before = _torch_f64(v["params"])
    err = _opt_delta_error(got, ref(name), before)
    print(f"\n{name}: worst change error {err:.3g} of the tensor's largest (limit {OPT_DELTA_RTOL})")
    assert err <= OPT_DELTA_RTOL
    # the EMA rule on the same parameters: JAX's ema_update (elementwise,
    # so on the torch keys) from the port's
    with jax.enable_x64(True):
        want_ema = joptim.ema_update({n: b.numpy() for n, b in before.items()},
                                     {n: p.detach().numpy() for n, p in model.named_parameters()},
                                     2000)
    want_ema = {n: torch.from_numpy(np.asarray(a)) for n, a in want_ema.items()}
    assert _opt_delta_error([ema], [want_ema], before) <= OPT_DELTA_RTOL


CONTROLS = [("step", "half_lr"), ("AdamW", "half_lr"), ("AdamW", "plain_adam"),
            ("AdamW", "no_bias_correction"), ("SGD", "half_lr"), ("SGD", "no_nesterov")]


@pytest.mark.parametrize("where,control", CONTROLS)
def test_update_tolerances_reject_controls(narrow, lr0_run, opt_ref, where, control):
    """The tolerances above can tell a wrong update: each control (half the
    lr0; plain Adam, whose weight decay enters the gradient; AdamW without
    bias correction; SGD without nesterov) fails the check that the port
    passes, by far. Prints each control's error beside the limit."""
    if where == "step":
        _, v, images, batch = narrow
        hyp, before, want, _ = lr0_run
        lr = ADAMW_LR0[1] / 2
        got = _port_run(v, images, batch, _case_hyp("AdamW", lr, ADAMW_LR0[2]), steps=1)[0][0]
        err, limit = _step_delta_errors(got["state"], want["state"], before, want["grads"])[0], STEP_DELTA_RTOL
    else:
        v, grads, ref = opt_ref
        kw = dict(lr0=OPT_CASES[where]["lr0"] / 2) if control == "half_lr" else {}
        got = _port_opt_run(v, _opt_hyp(where, **kw), grads,
                            control=None if control == "half_lr" else control)[0]
        err = _opt_delta_error(got, ref(where), _torch_f64(v["params"]))
        limit = OPT_DELTA_RTOL
    print(f"\n{where} {control}: change error {err:.3g} of the tensor's largest (limit {limit})")
    assert err > 10 * limit


def test_train_step_accumulates_micro_batches():
    """accumulate=2 over micro-batches (a, b) sums their gradients: the
    step's SGD update equals one from the two gradients summed by hand."""
    torch.manual_seed(0)
    images, batch = shape_batch(4, 64, 3, seed=9)
    hyp = _hyp("SGD", lr0=0.01, momentum=0.9, warmup_epochs=0.0)
    stacked = _t(images).reshape(2, 2, 64, 64, 3)
    sb = {k: _t(a).reshape((2, 2) + a.shape[1:]) for k, a in batch.items()}
    model = SegmentationModel(NARROW)
    ref = copy.deepcopy(model).train()
    opt = toptim.build_optimizer(model, copy.copy(hyp), 10, 100)
    state = tstep.init_train_state(model, opt, device="cpu")
    metrics = tstep.make_train_step(model, opt, hyp, accumulate=2)(state, stacked, sb)
    loss_fn = tstep.make_loss_fn(ref, hyp)
    totals = []
    for i in range(2):
        total, _ = loss_fn(stacked[i], {k: a[i] for k, a in sb.items()})
        total.backward()
        totals.append(total.item())
    np.testing.assert_allclose(metrics["loss"].item(), np.mean(totals), rtol=1e-6)
    ropt = toptim.build_optimizer(ref, copy.copy(hyp), 10, 100)
    ropt.step(0)
    for (n, p), (_, q) in zip(model.named_parameters(), ref.named_parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-7, msg=n)


STAGES = ["forward", "assigner", "gt_rays", "assigner", "loss", "backward"]


@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_step_marks_its_stages(accumulate):
    """``mark`` hears each stage of the step as it starts, the GT-ray
    kernel's wrapper inside the assigner, once per micro-batch, and "end"
    after the EMA; the step's result does not depend on it."""
    images, batch = shape_batch(2 * accumulate, 64, 3, seed=9)
    images, batch = _t(images), {k: _t(a) for k, a in batch.items()}
    if accumulate > 1:
        images = images.reshape((accumulate, 2) + images.shape[1:])
        batch = {k: a.reshape((accumulate, 2) + a.shape[1:]) for k, a in batch.items()}
    hyp = _hyp("SGD", lr0=0.01, warmup_epochs=0.0)
    torch.manual_seed(0)
    model = SegmentationModel(NARROW)
    twin = copy.deepcopy(model)
    out = []
    for m, mark in ((model, None), (twin, [])):
        opt = toptim.build_optimizer(m, copy.copy(hyp), 10, 100)
        state = tstep.init_train_state(m, opt, device="cpu")
        step = tstep.make_train_step(m, opt, hyp, accumulate=accumulate,
                                     mark=None if mark is None else mark.append)
        out.append((step(state, images, batch)["loss"].item(), mark))
    assert out[1][1] == STAGES * accumulate + ["clip_optimizer_ema", "end"]
    assert out[0][0] == out[1][0]
    for (n, p), (_, q) in zip(model.named_parameters(), twin.named_parameters()):
        assert torch.equal(p, q), n


# --- checkpoints ------------------------------------------------------------

def test_to_jax_variables_round_trips_seg160():
    ckpt = load_checkpoint(CKPT)
    params, bstats = checkpoint_variables(ckpt)
    p2, b2 = to_jax_variables(from_jax_variables(params, bstats))
    for want, got in ((params, p2), (bstats, b2)):
        wl = jax.tree_util.tree_flatten_with_path(want)[0]
        gl = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [p for p, _ in wl] == [p for p, _ in gl]
        for (path, w), (_, g) in zip(wl, gl):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            np.testing.assert_array_equal(g, w)


def test_saved_checkpoint_loads_in_jax_and_predicts_the_same(tmp_path):
    """A train step on the seg160 model, saved by the port, loads in the
    JAX package's loader with the JAX keys, and the JAX facade and the
    port's give the same boxes from it."""
    ckpt = load_checkpoint(CKPT)
    model = SegmentationModel(ckpt["model_yaml"])
    load_jax_variables(model, *checkpoint_variables(ckpt))
    hyp = _hyp("AdamW", batch=2, warmup_epochs=0.0, lr0=1e-4)
    opt = toptim.build_optimizer(model, hyp, 10, 100)
    state = tstep.init_train_state(model, opt, device="cpu")
    images, batch = shape_batch(2, 96, 3, seed=2)
    tstep.make_train_step(model, opt, hyp)(state, _t(images), {k: _t(a) for k, a in batch.items()})
    params, bstats = to_jax_variables(model.state_dict())
    ema, _ = to_jax_variables(state.ema)
    path = save_checkpoint(tmp_path / "w" / "last.ckpt", params, bstats, ema, step=state.step,
                           epoch=0, best_fitness=0.0, train_args=ckpt["train_args"],
                           model_yaml=model.yaml, names=ckpt["names"])
    jck = jax_load_checkpoint(str(path))
    assert set(jck) == set(ckpt) | {"deploy"}
    assert jck["opt_state"] is None and jck["step"] == 1 and jck["version"] == CKPT_VERSION
    assert jax.tree_util.tree_structure(jck["params"]) == jax.tree_util.tree_structure(
        ckpt["params"])
    jy, ty = JaxYOLO(str(path)), YOLO(path, device="cpu")
    jpred = JaxPredictor(get_cfg(overrides={"mode": "predict", "conf": 0.25, "imgsz": 160}))
    jeval = jpred._build_eval(jy.model)
    tpred = SegmentationPredictor(imgsz=160)
    n_det = 0
    for img in shape_images(3, 120, 200, seed=8):
        x, _, _ = jpred.preprocess_u8(img, 160)
        jout = {k: np.asarray(a) for k, a in jeval(jy.variables, jnp.asarray(x[None])).items()}
        tout = {k: a.numpy() for k, a in tpred.eval_batch(ty.model, _t(x[None])).items()}
        np.testing.assert_array_equal(tout["valid"], jout["valid"])
        ok = jout["valid"]
        n_det += int(ok.sum())
        np.testing.assert_array_equal(tout["classes"][ok], jout["classes"][ok])
        np.testing.assert_allclose(tout["boxes"][ok], jout["boxes"][ok], atol=BOX_PX)
    assert n_det > 0
