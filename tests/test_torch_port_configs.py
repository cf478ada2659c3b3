"""The configs that end the port's list of the JAX package's model yamls
(yolov3, yolov5, yolov6, yolov8-det-rep, yolov8-p2, yolov8-p6,
yolov8-pose-p6) and the registry modules they and users' configs name,
against the JAX package on the CPU: each module on seeded inputs and
carried weights, each config dict against its yaml, each config's
parameters, running statistics and strides at full width (``jax.eval_shape``),
the weight name map both ways, and the transposed conv's kernel layout."""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from yolo_contour_regression_tpu.nn.modules import block as jblock
from yolo_contour_regression_tpu.nn.modules import conv as jconv
from yolo_contour_regression_tpu.nn.modules import transformer as jtr
from yolo_contour_regression_tpu.nn.tasks import build_model as jbuild_model
from yolo_contour_regression_tpu.nn.tasks import yaml_model_load as jyaml_model_load
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.nn import tasks as ttasks
from yolo_contour_regression_tpu_torch.nn.modules import block as tblock
from yolo_contour_regression_tpu_torch.nn.modules import conv as tconv
from yolo_contour_regression_tpu_torch.nn.modules import transformer as ttr
from yolo_contour_regression_tpu_torch.nn.tasks import (MODEL_CFGS, build_model,
                                                        guess_model_task, yaml_model_load)
from yolo_contour_regression_tpu_torch.utils.checkpoint import (from_jax_variables,
                                                                load_jax_variables,
                                                                to_jax_variables)

from tests.test_torch_port_modules import _carry, _init, _randomize, _x
from tests.test_torch_port_train import _np


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent
MODELS = ROOT / "yolo_contour_regression_tpu" / "cfg" / "models"
# a module's output against JAX's, relative to the largest value
MODULE_RTOL = 1e-5
# each config at full width: (name, strides, nc, parameters), JAX's
CONFIGS = [
    ("yolov3.yaml", (8, 16, 32), 80, 103_754_128),
    ("yolov5n.yaml", (8, 16, 32), 80, 2_654_800),
    ("yolov6n.yaml", (8, 16, 32), 80, 4_500_064),
    ("yolov8n-det-rep.yaml", (8, 16, 32), 1, 658_363),
    ("yolov8n-p2.yaml", (4, 8, 16, 32), 80, 3_354_128),
    ("yolov8n-p6.yaml", (8, 16, 32, 64), 80, 4_984_336),
    ("yolov8n-pose-p6.yaml", (8, 16, 32, 64), 1, 5_182_136),
]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=MODULE_RTOL * np.abs(want).max())


def _pair(jmod, tmod, x_nhwc, seed):
    """The JAX module on NHWC ``x`` and the torch module on its NCHW copy,
    the same numpy-drawn weights carried across; both outputs NHWC."""
    jvars = _randomize(_init(jmod, jnp.asarray(x_nhwc)), seed)
    want = jax.jit(jmod.apply)(jvars, jnp.asarray(x_nhwc))
    _carry(jvars, tmod)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return got.permute(0, 2, 3, 1).numpy(), want


# --- the modules ------------------------------------------------------------

@pytest.mark.parametrize("k,s,p,bn", [(2, 2, 0, True), (2, 2, 0, False), (3, 2, 0, True),
                                      (2, 3, 0, True), (3, 1, 1, False), (3, 2, 1, True),
                                      (2, 2, 2, False)])
def test_conv_transpose_matches(k, s, p, bn):
    """Flax's padding rule (VALID at ``p`` 0 for k above, at and below s;
    ``p`` a side of the dilated input otherwise, past what torch's padding
    can say at ``p`` 2 > k - 1), with a BatchNorm and without (a bias)."""
    got, want = _pair(jconv.ConvTranspose(12, k, s, p, bn=bn, act=bn),
                      tconv.ConvTranspose(8, 12, k, s, p, bn=bn, act=bn),
                      _x(0, (2, 7, 5, 8)), 1)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("k,s", [(1, 1), (3, 2)])
def test_focus_matches(k, s):
    got, want = _pair(jconv.Focus(16, k, s), tconv.Focus(3, 16, k, s), _x(1, (2, 12, 10, 3)), 2)
    _close(got, want)


@pytest.mark.parametrize("k,s", [(1, 1), (3, 2)])
def test_ghost_conv_matches(k, s):
    got, want = _pair(jconv.GhostConv(16, k, s), tconv.GhostConv(8, 16, k, s),
                      _x(2, (2, 12, 10, 8)), 3)
    _close(got, want)


@pytest.mark.parametrize("name", ["channel", "spatial", "cbam"])
def test_attention_matches(name):
    """ChannelAttention, SpatialAttention (k 7) and CBAM (k 3)."""
    jmod, tmod = {"channel": (jconv.ChannelAttention(), tconv.ChannelAttention(8)),
                  "spatial": (jconv.SpatialAttention(7), tconv.SpatialAttention(7)),
                  "cbam": (jconv.CBAM(3), tconv.CBAM(8, 3))}[name]
    got, want = _pair(jmod, tmod, _x(3, (2, 12, 10, 8)), 4)
    _close(got, want)


@pytest.mark.parametrize("name,n,shortcut", [("C3", 1, True), ("C3", 2, False), ("C3x", 2, True),
                                             ("C3Ghost", 2, True), ("C2", 1, True),
                                             ("C2", 3, False)])
def test_csp_blocks_match(name, n, shortcut):
    """C3 (its bottlenecks 1x1 then 3x3), C3x (3x3 twice), C3Ghost and C2;
    the bottlenecks are ``m.{i}``."""
    jmod = getattr(jblock, name)(16, n, shortcut)
    tmod = getattr(tblock, name)(8, 16, n, shortcut)
    assert len(tmod.m) == n
    got, want = _pair(jmod, tmod, _x(4, (2, 12, 10, 8)), 5)
    _close(got, want)


@pytest.mark.parametrize("n", [1, 3])
def test_c1_matches(n):
    got, want = _pair(jblock.C1(16, n), tblock.C1(8, 16, n), _x(5, (2, 12, 10, 8)), 6)
    _close(got, want)


@pytest.mark.parametrize("c1,c2,s", [(16, 16, 1), (8, 16, 1), (8, 16, 2)])
def test_ghost_bottleneck_matches(c1, c2, s):
    """At ``s`` 1 the identity shortcut (or ``sc_pw`` where the widths
    differ), at ``s`` 2 ``dw``, ``sc_dw`` and ``sc_pw``."""
    tmod = tblock.GhostBottleneck(c1, c2, 3, s)
    assert (tmod.dw is not None, tmod.sc_dw is not None) == (s == 2, s == 2)
    got, want = _pair(jblock.GhostBottleneck(c2, 3, s), tmod, _x(6, (2, 12, 10, c1)), 7)
    _close(got, want)


def test_transformer_layer_matches():
    """On tokens (B, L, C): q, k, v, flax's attention, fc1, fc2."""
    x = _x(7, (2, 15, 16))
    jmod = jtr.TransformerLayer(num_heads=4)
    jvars = _randomize(_init(jmod, jnp.asarray(x)), 8)
    want = jax.jit(jmod.apply)(jvars, jnp.asarray(x))
    tmod = _carry(jvars, ttr.TransformerLayer(16, 4))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    _close(got, want)


@pytest.mark.parametrize("c1,layers", [(8, 1), (16, 2)])
def test_transformer_block_matches(c1, layers):
    """With the Conv where the width changes, and without; the position
    term ``tokens + linear(tokens)``."""
    tmod = ttr.TransformerBlock(c1, 16, 4, layers)
    assert (tmod.conv is not None) == (c1 != 16)
    got, want = _pair(jtr.TransformerBlock(16, 4, layers), tmod, _x(8, (2, 6, 5, c1)), 9)
    _close(got, want)


def test_conv_transpose_kernel_carries_flipped_both_ways():
    """An asymmetric flax kernel (kh, kw, in, out) becomes torch's (in, out,
    kh, kw) flipped in both spatial axes, comes back exactly, and gives
    JAX's output: the flip is what makes them agree (a symmetric kernel
    would hide a missing one)."""
    kernel = (np.arange(3 * 3 * 4 * 5, dtype=np.float32).reshape(3, 3, 4, 5) / 180) ** 1.5
    jvars = {"params": {"conv_transpose": {"kernel": kernel, "bias": np.ones(5, np.float32)}}}
    sd = from_jax_variables({"layer0": jvars["params"]}, {})
    w = sd["model.0.conv_transpose.weight"].numpy()
    np.testing.assert_array_equal(w, kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    back, stats = to_jax_variables(sd)
    assert not stats
    np.testing.assert_array_equal(back["layer0"]["conv_transpose"]["kernel"], kernel)
    x = _x(9, (1, 4, 3, 4))
    want = jconv.ConvTranspose(5, 3, 2, 0, bn=False, act=False).apply(jvars, jnp.asarray(x))
    tmod = _carry(jvars, tconv.ConvTranspose(4, 5, 3, 2, 0, bn=False, act=False))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _close(got, want)
    unflipped = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(kernel.transpose(2, 3, 0, 1)),
        torch.ones(5), 2)
    assert np.abs(unflipped.permute(0, 2, 3, 1).numpy() - np.asarray(want)).max() > 0.1


# --- the configs --------------------------------------------------------------

@pytest.mark.parametrize("base", sorted(MODEL_CFGS))
def test_model_cfgs_are_the_yamls(base):
    """Each config dict is ``yaml.safe_load`` of the JAX package's yaml of
    that name (yolov8-seg's dict adds the scale ``SegmentationModel()``
    takes without one)."""
    want = yaml.safe_load((MODELS / f"{base}.yaml").read_text())
    got = copy.deepcopy(MODEL_CFGS[base])
    if base == "yolov8-seg":
        assert got.pop("scale") == "n"
    assert got == want


def _count(tree):
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))


def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name,strides,nc,n_params", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_config_counts_and_strides_equal_jax(name, strides, nc, n_params):
    """``YOLO(name)`` builds; the full-width model has JAX's task, strides
    (which JAX reads off a 256 px trace), parameters and running statistics
    (``jax.eval_shape``), leaf for leaf through the name map."""
    facade = YOLO(name, device="cpu")
    cfg = yaml_model_load(name)
    want_cfg = dict(jyaml_model_load(name))
    want_cfg.pop("yaml_file")
    assert cfg == want_cfg and facade.task == guess_model_task(cfg)
    jm = jbuild_model(name)
    imgsz = 128 if max(strides) == 64 else 64
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, imgsz, imgsz, 3)), train=False))
    model = build_model(cfg)
    assert model.strides == tuple(jm.strides) == strides and model.nc == nc
    assert model.num_params == _count(shapes["params"]) == n_params
    params, stats = to_jax_variables(model.state_dict())
    assert _shapes(params) == _shapes(shapes["params"])
    assert _shapes(stats) == _shapes(shapes["batch_stats"])


def narrow(name):
    """A config at a narrow width (0.125, at most 256 channels) and its own
    depth, nc 2 where it has more than one class: the scaled configs by a
    scale ``t``, yolov3 by its multiples."""
    cfg = yaml_model_load(name)
    if cfg["nc"] > 1:
        cfg["nc"] = 2
    if "scales" in cfg:
        depth = cfg["scales"][cfg["scale"]][0]
        cfg.update(scale="t", scales={"t": [depth, 0.125, 256]})
    else:
        cfg["width_multiple"] = 0.125
    return cfg


@pytest.mark.parametrize("name", [c[0] for c in CONFIGS])
def test_name_map_round_trip_is_exact(name):
    """JAX's variables of the narrow config -> the port (every leaf used,
    every parameter set) -> JAX again, exactly."""
    cfg = narrow(name)
    jm = jbuild_model(cfg)
    imgsz = 128 if max(jm.strides) == 64 else 64
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, imgsz, imgsz, 3)), train=False))
    v = _np(_randomize({k: shapes[k] for k in ("params", "batch_stats")}, 3))
    model = load_jax_variables(build_model(cfg), v["params"], v["batch_stats"])
    params, stats = to_jax_variables(model.state_dict())
    for a, b in ((params, v["params"]), (stats, v["batch_stats"])):
        la = dict(jax.tree_util.tree_leaves_with_path(a))
        lb = dict(jax.tree_util.tree_leaves_with_path(b))
        assert set(la) == set(lb)
        for k in lb:
            np.testing.assert_array_equal(la[k], lb[k])


@pytest.mark.parametrize("spec,strides", [
    ([[-1, 1, "Focus", [16, 3]], [-1, 1, "Conv", [32, 3, 2]]], (4,)),
    ([[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "ConvTranspose", [16]]], (1,)),
    ([[-1, 1, "Conv", [16, 3, 2]], [-1, 2, "Conv", [16, 3, 2]],
      [-1, 1, "nn.ConvTranspose2d", [16, 2, 2, 0]]], (4,)),
    ([[-1, 1, "GhostConv", [16, 3, 2]], [-1, 1, "GhostBottleneck", [16, 3, 2]],
      [-1, 1, "CBAM", [5]], [-1, 1, "TransformerBlock", [16, 2]], [-1, 1, "C3x", [16]],
      [-1, 1, "C1", [16]], [-1, 1, "C3Ghost", [16]]], (4,)),
], ids=["focus", "conv_transpose", "repeated", "ghost_cbam_transformer"])
def test_user_config_strides_and_graph_equal_jax(spec, strides):
    """Users' configs of the new modules: a Focus stem halves before its
    conv, a transposed conv divides the stride (a repeated strided conv
    multiplies it each time); the strides and the heads equal JAX's."""
    cfg = {"nc": 2, "backbone": spec, "head": [[[len(spec) - 1], 1, "Detect", ["nc"]]]}
    jm = jbuild_model(cfg)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    v = _np(_randomize({k: shapes[k] for k in ("params", "batch_stats")}, 5))
    model = load_jax_variables(build_model(cfg), v["params"], v["batch_stats"]).eval()
    assert model.strides == tuple(jm.strides) == strides
    x = np.random.default_rng(6).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jm.raw_forward(v, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=1e-3 * max(1.0, float(np.abs(np.asarray(w)).max())))


def test_init_weights_draws_a_transposed_conv_as_flax():
    """A transposed conv's kernel is drawn with flax's ``fan_in = k * k *
    c_in`` (not torch's ``weight[0].numel()``), a raw one's bias 0; the
    four-level heads take a class prior per stride."""
    model = build_model(yaml_model_load("yolov6n.yaml"), nc=2)
    ttasks.init_weights(model, torch.Generator().manual_seed(0))
    ct = model.model[11].conv_transpose
    ci, co, k, _ = ct.weight.shape
    assert (ci, co, k) == (64, 64, 2) and torch.equal(ct.bias, torch.zeros(co))
    std = float(ct.weight.detach().std())
    assert abs(std - (1 / (k * k * ci)) ** 0.5) < 0.05 * std
    assert float(ct.weight.abs().max()) <= 2 * (1 / (k * k * ci)) ** 0.5 / 0.8796 + 1e-6


def test_batchnormed_conv_transpose_fuses_into_its_kernel():
    """A user config's ``ConvTranspose`` with its BatchNorm (and a Focus
    stem, a GhostBottleneck, a C3) fused by the port: the BN folded into a
    biased transposed kernel, the heads within 1e-3 of the unfused model's.
    JAX's ``fuse_variables`` keeps that pair's raw leaves and drops every
    ``batch_stats``, so its fused model cannot run (the port departs from
    it here)."""
    from yolo_contour_regression_tpu.nn import fuse as jfuse
    from yolo_contour_regression_tpu_torch.nn import fuse as tfuse

    cfg = {"nc": 2, "backbone": [[-1, 1, "Focus", [16, 3]], [-1, 1, "Conv", [32, 3, 2]],
                                 [-1, 1, "ConvTranspose", [16, 2, 2]],
                                 [-1, 1, "GhostBottleneck", [16, 3, 2]], [-1, 1, "C3", [32]]],
           "head": [[[4], 1, "Detect", ["nc"]]]}
    jm = jbuild_model(cfg)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    v = _np(_randomize({k: shapes[k] for k in ("params", "batch_stats")}, 7))
    model = load_jax_variables(build_model(cfg), v["params"], v["batch_stats"]).eval()
    assert model.strides == tuple(jm.strides) == (4,)
    x = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))
    fused = tfuse.fuse_model(copy.deepcopy(model))
    ct = fused.model[2]
    assert ct.bn is None and ct.conv_transpose.bias is not None
    with torch.no_grad():
        ref, got = model(x), fused(x)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3 * max(1.0, float(r.abs().max())))
    fvars, fjm = jfuse.fuse_variables(jm, v)
    assert set(fvars["params"]["layer2"]) == {"conv_transpose", "bn"}
    with pytest.raises(Exception, match="batch_stats"):
        fjm.raw_forward(fvars, jnp.zeros((1, 64, 64, 3)))
