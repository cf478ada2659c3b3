"""The PyTorch port's rtdetr-l (the config JAX's ``RTDETR()`` loads) against
the JAX package on the CPU, at imgsz 64 and nc 3 on seeded random weights:
each of its new modules with carried weights (``DWConv``, ``LightConv``,
``RepC3``, ``HGStem``, ``HGBlock``, ``TransformerEncoderLayer``,
``sincos_2d_position``, ``AIFI``), the whole graph's decoder output and its
32,828,401 parameters (JAX's count), the weights JAX -> port -> JAX, the
deploy fuse against the unfused model and JAX ``fuse_variables``, and the
loss and gradients in float64 on one batch (a narrow rtdetr-l: the same
modules at a fraction of the width and depth, so JAX's float64 gradient
stays quick; JAX's assignment solved in float32 on its own costs, as
``tests/test_torch_port_rtdetr_loss.py`` does it)."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import RTDETR_L_PARAMS as RTDETR_L_PARAMS_80
from chip_smoke import shape_batch
from tests.test_torch_port_modules import _carry, _randomize
from tests.test_torch_port_rtdetr_loss import HYP, _jax_costs
from tests.test_torch_port_train import STEP_GRAD_TOL, STEP_LOSS_RTOL, _f64, _np, _t
from yolo_contour_regression_tpu.engine import step as jstep
from yolo_contour_regression_tpu.models.utils import loss as jloss
from yolo_contour_regression_tpu.models.utils import ops as jops
from yolo_contour_regression_tpu.nn import fuse as jfuse
from yolo_contour_regression_tpu.nn.modules import block as jblock
from yolo_contour_regression_tpu.nn.modules import conv as jconv
from yolo_contour_regression_tpu.nn.modules import transformer as jtr
from yolo_contour_regression_tpu.nn.tasks import build_model as jbuild_model
from yolo_contour_regression_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from yolo_contour_regression_tpu_torch.engine import step as tstep
from yolo_contour_regression_tpu_torch.models.rtdetr import RTDETR
from yolo_contour_regression_tpu_torch.models.utils import loss as tloss
from yolo_contour_regression_tpu_torch.nn.fuse import fuse_model
from yolo_contour_regression_tpu_torch.nn.modules import block as tblock
from yolo_contour_regression_tpu_torch.nn.modules import conv as tconv
from yolo_contour_regression_tpu_torch.nn.modules import transformer as ttr
from yolo_contour_regression_tpu_torch.nn.tasks import (RTDETR_L, RTDETRDetectionModel,
                                                        build_model, init_weights,
                                                        yaml_model_load)
from yolo_contour_regression_tpu_torch.utils.checkpoint import (from_jax_variables,
                                                                load_jax_variables,
                                                                to_jax_variables)

# single modules: f32 sums in other orders than XLA's (relative to the
# output's largest entry: HGBlock sums up to 1,000 channels)
MODULE_RTOL = 1e-5
# the whole graph's decoder output (sigmoid boxes and scores)
GRAPH_ATOL = 1e-4
# fused against unfused, each fused leaf against JAX fuse_variables
FUSE_TOL, PARAM_TOL = 1e-3, 1e-5
RTDETR_L_PARAMS = 32_828_401  # at nc 3, JAX's count
# a gradient that is 0 in exact arithmetic, of the largest gradient of any
# tensor (both sides' are rounding noise there)
ZERO_GRAD_TOL = 1e-9
NC, IMGSZ = 3, 64
# the narrow rtdetr-l of the float64 loss test: every module kind of the
# config (HGStem, HGBlock plain and light, with and without the shortcut,
# DWConv, AIFI, RepC3), 2 blocks of the narrowest widths, the full decoder
NARROW_L = {
    "nc": NC, "scales": {"l": [1.0, 1.0, 1024]},
    "backbone": [
        [-1, 1, "HGStem", [8, 16]],
        [-1, 2, "HGBlock", [8, 32, 3]],
        [-1, 1, "DWConv", [32, 3, 2, 1, False]],
        [-1, 2, "HGBlock", [16, 64, 3]],
        [-1, 1, "DWConv", [64, 3, 2, 1, False]],
        [-1, 2, "HGBlock", [16, 64, 5, True, False]],
        [-1, 2, "HGBlock", [16, 64, 5, True, True]],
        [-1, 2, "HGBlock", [16, 64, 5, True, True]],
        [-1, 1, "DWConv", [64, 3, 2, 1, False]],
        [-1, 2, "HGBlock", [32, 128, 5, True, False]],
    ],
    "head": copy.deepcopy(RTDETR_L["head"]),
}
for _layer in NARROW_L["head"]:
    if _layer[2] in ("Conv", "RepC3"):
        _layer[3][0] = 32
    if _layer[2] == "RepC3":
        _layer[1] = 1
    if _layer[2] == "AIFI":
        _layer[3] = [64, 4]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _pair(jmod, tmod, x, seed, **call):
    """JAX's module on seeded random variables, the port's module carrying
    them, both on ``x`` (NHWC to JAX, NCHW to the port for 4-D inputs)."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), **call))
    jvars = _randomize(dict(shapes), seed)
    want = np.asarray(jmod.apply(jvars, jnp.asarray(x), **call))
    _carry(jvars, tmod)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        if x.ndim == 4:
            got = tmod(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        else:
            got = tmod(xt).numpy()
    return want, got


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=MODULE_RTOL * max(float(np.abs(want).max()), 1.0))


@pytest.mark.parametrize("name", ["dwconv", "dwconv_grouped", "lightconv", "repc3", "repc3_e",
                                  "hgstem", "hgblock", "hgblock_light_shortcut"])
def test_conv_modules_match_jax(name):
    """Each conv block of rtdetr-l on a carried random init (BatchNorm in
    eval form): the depthwise conv (groups gcd(c1, c2)), LightConv, RepC3
    (with and without its ``cv3``), the stem (its one-sided pads and 2x2
    pool) and HGBlock (plain, and light with the shortcut)."""
    x = _x(1, (2, 16, 16, 12))
    jmod, tmod = {
        "dwconv": (jconv.DWConv(12, 3, 2, act=False), tconv.DWConv(12, 12, 3, 2, act=False)),
        "dwconv_grouped": (jconv.DWConv(8, 3, 1), tconv.DWConv(12, 8, 3, 1)),
        "lightconv": (jconv.LightConv(16, 5), tconv.LightConv(12, 16, 5)),
        "repc3": (jblock.RepC3(12, 2), tblock.RepC3(12, 12, 2)),
        "repc3_e": (jblock.RepC3(16, 1, e=0.5), tblock.RepC3(12, 16, 1, e=0.5)),
        "hgstem": (jblock.HGStem(8, 16), tblock.HGStem(12, 8, 16)),
        "hgblock": (jblock.HGBlock(8, 24, 3, 3), tblock.HGBlock(12, 8, 24, 3, 3)),
        "hgblock_light_shortcut": (jblock.HGBlock(8, 12, 5, 2, True, True),
                                   tblock.HGBlock(12, 8, 12, 5, 2, True, True)),
    }[name]
    if name == "hgstem":
        x = _x(1, (2, 17, 19, 12))  # odd sizes: the one-sided pads matter
    want, got = _pair(jmod, tmod, x, seed=2)
    _close(got, want)


def test_encoder_layer_and_positions_match_jax():
    """The encoder layer (flax attention, tanh GELU, LayerNorm eps 1e-6)
    with and without a position table, and the sin-cos table itself."""
    src = _x(3, (2, 12, 32))
    jmod, tmod = jtr.TransformerEncoderLayer(cm=64, num_heads=4), ttr.TransformerEncoderLayer(
        32, 64, 4)
    want, got = _pair(jmod, tmod, src, seed=4)
    _close(got, want)
    pos = _x(5, (1, 12, 32))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(src)))
    jvars = _randomize(dict(shapes), 4)
    want = np.asarray(jmod.apply(jvars, jnp.asarray(src), pos=jnp.asarray(pos)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(src), pos=torch.from_numpy(pos)).numpy()
    _close(got, want)
    for w, h, d in ((4, 3, 32), (5, 5, 256)):
        np.testing.assert_allclose(ttr.sincos_2d_position(w, h, d).numpy(),
                                   np.asarray(jtr.sincos_2d_position(w, h, d)), atol=1e-5)
    with pytest.raises(ValueError, match="multiple of 4"):
        ttr.sincos_2d_position(2, 2, 30)


def test_aifi_matches_jax():
    """AIFI on a non-square map: the row-major tokens and the w-major
    table transposed to them, as JAX's."""
    x = _x(6, (2, 3, 5, 32))
    want, got = _pair(jtr.AIFI(cm=64, num_heads=4), ttr.AIFI(32, 64, 4), x, seed=7)
    _close(got, want)


# --- the whole graph ---------------------------------------------------------

@pytest.fixture(scope="module")
def graph():
    """rtdetr-l at nc 3: JAX's build and seeded random variables (from its
    shapes at imgsz 64), the port's model carrying them."""
    jm = jbuild_model("rtdetr-l.yaml", nc=NC)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), imgsz=IMGSZ))
    v = _np(_randomize({k: shapes[k] for k in ("params", "batch_stats")}, 3))
    tm = load_jax_variables(build_model(yaml_model_load("rtdetr-l.yaml"), nc=NC),
                            v["params"], v["batch_stats"]).eval()
    return jm, v, tm


def test_config_and_parameters_match_jax(graph):
    """The config JAX's ``yaml_model_load`` reads for rtdetr-l (its
    ``yaml_file`` aside); 32,828,401 parameters at nc 3 and 32,986,636 at
    its nc 80, JAX's counts (the latter the card's smoke holds); strides
    (8, 16, 32); the ``RTDETR`` facade's default is rtdetr-l."""
    want = jax_yaml_model_load("rtdetr-l.yaml")
    want.pop("yaml_file")
    assert yaml_model_load("rtdetr-l.yaml") == want
    _, v, tm = graph
    assert isinstance(tm, RTDETRDetectionModel) and tm.strides == (8, 16, 32)
    assert tm.num_params == RTDETR_L_PARAMS == sum(
        a.size for a in jax.tree_util.tree_leaves(v["params"]))
    m = RTDETR(device="cpu")
    assert m.task == "rtdetr" and m.overrides["model"] == "rtdetr-l.yaml" and m.model is None
    # the published config (nc 80): the count the card's smoke holds
    jm = jbuild_model("rtdetr-l.yaml")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), imgsz=IMGSZ))
    assert build_model(yaml_model_load("rtdetr-l.yaml")).num_params == RTDETR_L_PARAMS_80 == sum(
        a.size for a in jax.tree_util.tree_leaves(shapes["params"]))


def test_graph_matches_jax(graph):
    """The eval output (B, 84, 4 + nc) of the whole graph (84 tokens at
    imgsz 64, all of them queries) within ``GRAPH_ATOL``."""
    jm, v, tm = graph
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda vv: jm.predict(vv, jnp.asarray(x)))(v))
    with torch.no_grad():
        got = tm.predict(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 84, 4 + NC)
    np.testing.assert_allclose(got, want, atol=GRAPH_ATOL)


def _flat(tree, prefix=()):
    out = {}
    for k, val in tree.items():
        if isinstance(val, dict):
            if not val:
                out[prefix + (k,)] = None
            out.update(_flat(val, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(val)
    return out


def test_weights_round_trip_to_jax(graph):
    """JAX -> port -> JAX: every leaf back exactly (HGBlock's ``m{j}``,
    DWConv's ``dw``, RepC3's RepConvs, AIFI's attention and LayerNorms, the
    decoder's empty ``detect``); every leaf used once; a fresh port init
    has JAX's leaves by name and shape."""
    _, v, tm = graph
    sd = from_jax_variables(v["params"], v["batch_stats"])
    assert sd["model.1.m.5.conv.weight"].shape == (48, 48, 3, 3)
    assert sd["model.5.m.0.conv2.conv.weight"].shape == (192, 1, 5, 5)
    assert sd["model.2.dw.conv.weight"].shape == (128, 1, 3, 3)
    assert sd["model.11.ma.query.kernel"].shape == (256, 8, 32)
    assert sd["model.16.m.2.conv1.conv.weight"].shape == (256, 256, 3, 3)
    p2, s2 = to_jax_variables(tm.state_dict())
    for want, got in ((v["params"], p2), (v["batch_stats"], s2)):
        fw, fg = _flat(want), _flat(got)
        assert set(fw) == set(fg)
        for k in fw:
            assert (fg[k] is None) if fw[k] is None else np.array_equal(fg[k], fw[k]), k
    fresh = init_weights(build_model(RTDETR_L, nc=NC), torch.Generator().manual_seed(0))
    fp, _ = to_jax_variables(fresh.state_dict())
    assert {k: None if a is None else a.shape for k, a in _flat(fp).items()} == \
        {k: None if a is None else a.shape for k, a in _flat(v["params"]).items()}


def test_fused_matches_unfused_and_jax_fuse(graph):
    """The deploy fuse of rtdetr-l (every Conv, the light and depthwise
    ones, and RepC3's RepConvs folded): eval output against the unfused
    model within ``FUSE_TOL``; each fused leaf against JAX
    ``fuse_variables`` within ``PARAM_TOL``."""
    jm, v, tm = graph
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 3, 96, 96)).astype(np.float32))
    fused = fuse_model(copy.deepcopy(tm))
    assert type(fused.model[1].m[0]).__name__ == "FusedConv"
    assert type(fused.model[16].m[0]).__name__ == "FusedConv"
    with torch.no_grad():
        np.testing.assert_allclose(fused.predict(x).numpy(), tm.predict(x).numpy(), atol=FUSE_TOL)
    jp, _ = jfuse.fuse_variables(jm, {"params": v["params"], "batch_stats": v["batch_stats"]})
    tp, tb = to_jax_variables(fused.state_dict())
    want, got = _flat(jax.tree_util.tree_map(np.asarray, jp["params"])), _flat(tp)
    assert tb == {} and set(want) == set(got)
    for k, w in want.items():
        if w is not None:
            np.testing.assert_allclose(got[k], w, atol=PARAM_TOL, err_msg=str(k))


# --- loss and gradients in float64 -------------------------------------------

def test_narrow_loss_and_gradients_match_jax_f64():
    """The narrow rtdetr-l in train mode at imgsz 64, batch 2, with JAX's
    dn dict of step 0: the same assignment in every layer, the loss and its
    items within ``STEP_LOSS_RTOL``, every gradient within
    ``STEP_GRAD_TOL`` of its tensor's largest entry. The gradients that are
    0 in exact arithmetic are rounding noise on both sides, held below
    ``ZERO_GRAD_TOL`` instead: every attention's key bias (a softmax does
    not see a shift common to its row), and the shifts a train-mode
    BatchNorm takes out again: the BatchNorm biases of the convs without an
    activation (the DWConvs, the input projections) and AIFI's last
    LayerNorm bias, each read only by convs with BatchNorm."""
    jm = jbuild_model(NARROW_L)
    dn0 = {"labels": jnp.zeros((1, 1, 2, 1), jnp.int32), "boxes_logit": jnp.zeros((1, 1, 2, 1, 4))}
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=True,
        head_extra=dn0))
    v = _np(_randomize({k: shapes[k] for k in ("params", "batch_stats")}, 3))
    images, batch = shape_batch(2, IMGSZ, 4, seed=6)
    batch = {k: batch[k] for k in ("cls", "bboxes", "mask_gt")}
    batch["cls"] = batch["cls"] % NC
    n_valid = jnp.asarray(batch["mask_gt"].sum(-1))
    with jax.enable_x64(True):
        jm64 = jbuild_model(NARROW_L, dtype=jnp.float64)
        v64 = _f64(v)
        jb = {k: jnp.asarray(a) for k, a in batch.items()}
        x = jnp.asarray(images, jnp.float64)
        dn = jops.get_cdn_group(jb, NC, jax.random.fold_in(jax.random.PRNGKey(17), 0))
        dn_q = int(np.prod(dn["labels"].shape[1:]))
        outs, _ = jax.jit(lambda vv: jm64.raw_forward(vv, x, train=True, head_extra=dn))(v64)
        costs = _jax_costs(outs, jb, dn_q)
    auction = jax.jit(jloss.hungarian_assign)
    assign = [np.asarray(auction(jnp.asarray(c), n_valid)) for c in costs]
    real = jloss.hungarian_assign
    calls = iter(assign)
    jloss.hungarian_assign = lambda cost, n: jnp.asarray(next(calls))
    try:
        with jax.enable_x64(True):
            fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm64, HYP), has_aux=True))
            (loss, (items, _)), g = fn(v64["params"], v64["batch_stats"], x, jb, 0)
            want_grads = from_jax_variables(_np(g), {})
            dn_np = {k: np.asarray(a) for k, a in dn.items()}
    finally:
        jloss.hungarian_assign = real
    model = load_jax_variables(RTDETRDetectionModel(NARROW_L), v["params"], v["batch_stats"])
    model = model.train().double()
    tdn = {k: _t(a) for k, a in dn_np.items()}
    tb = {k: _t(a) for k, a in batch.items()}
    got, got_items = tstep.make_loss_fn(model, HYP, dn_fn=lambda b, s: tdn)(
        _t(images).double(), tb)
    got.backward()
    with torch.no_grad():
        outs_t = copy.deepcopy(model)(_t(images).double().permute(0, 3, 1, 2), dn=tdn)
    np.testing.assert_array_equal(tloss.rtdetr_assign(outs_t, tb, dn_q).numpy(), np.stack(assign))
    np.testing.assert_allclose(got.item(), float(loss), rtol=STEP_LOSS_RTOL)
    for k, w in items.items():
        np.testing.assert_allclose(got_items[k].item(), float(w), rtol=STEP_LOSS_RTOL, err_msg=k)
    grads = dict(model.named_parameters())
    assert set(grads) == set(want_grads)
    scale = max(float(w.abs().max()) for w in want_grads.values())
    bad = []
    for n, w in want_grads.items():
        gt = grads[n].grad.float()
        if float(w.abs().max()) <= ZERO_GRAD_TOL * scale:
            if float(gt.abs().max()) > ZERO_GRAD_TOL * scale:
                bad.append((n, "nonzero"))
            continue
        if float((gt - w).abs().max()) > STEP_GRAD_TOL * float(w.abs().max()):
            bad.append((n, float((gt - w).abs().max()), float(w.abs().max())))
    assert not bad, bad
