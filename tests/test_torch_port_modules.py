"""The PyTorch port's modules against the JAX package's flax modules at
narrow widths, with the JAX weights carried across by
``from_jax_variables``, on the CPU. Weights, BatchNorm statistics and inputs
are made from a seed with numpy."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yolo_contour_regression_tpu.nn.modules import block as jblock
from yolo_contour_regression_tpu.nn.modules import conv as jconv
from yolo_contour_regression_tpu.nn.modules import head as jhead
from yolo_contour_regression_tpu.nn.tasks import build_model
from yolo_contour_regression_tpu_torch.nn.modules import block as tblock
from yolo_contour_regression_tpu_torch.nn.modules import conv as tconv
from yolo_contour_regression_tpu_torch.nn.modules import head as thead
from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8_SEG, SegmentationModel
from yolo_contour_regression_tpu_torch.utils.checkpoint import (
    from_jax_variables, load_jax_variables)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# f32 convs summed in another order than XLA's (CPU): 1e-4 absolute on O(1)
# activations after a few layers
MODULE_ATOL = 1e-4
# pure f32 elementwise decode: a few ulps of pixel-scale values
DECODE_ATOL = 1e-5


def _randomize(variables, seed):
    """Every leaf drawn from numpy: kernels ~ N(0, 1/fan_in), BN scale in
    [0.5, 1.5], biases and means in [-0.3, 0.3], variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = x.shape
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.uniform(-0.3, 0.3, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _init(jmod, *args):
    """Random variables of a flax module from its shapes alone (no eager
    init pass)."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    return dict(shapes)


def _carry(jvars, module):
    """Load a single flax module's variables into the torch module."""
    sd = from_jax_variables({"layer0": jvars["params"]},
                            {"layer0": jvars.get("batch_stats", {})})
    sd = {k[len("model.0."):]: v for k, v in sd.items()}
    want = {k for k in module.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == want
    module.load_state_dict(sd, strict=False)
    return module.eval()


def _run_pair(jmod, tmod, x_nhwc, seed):
    jvars = _randomize(_init(jmod, jnp.asarray(x_nhwc)), seed)
    want = jax.jit(jmod.apply)(jvars, jnp.asarray(x_nhwc))
    _carry(jvars, tmod)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return want, got


def _x(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("k,s", [(1, 1), (3, 1), (3, 2)])
def test_conv_matches(k, s):
    want, got = _run_pair(jconv.Conv(16, k, s), tconv.Conv(8, 16, k, s), _x(0, (2, 12, 10, 8)), 1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=MODULE_ATOL)


def test_conv2_matches():
    want, got = _run_pair(jconv.Conv2(16), tconv.Conv2(8, 16), _x(1, (2, 12, 10, 8)), 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=MODULE_ATOL)


@pytest.mark.parametrize("c1,c2,s", [(16, 16, 1), (8, 16, 1), (16, 16, 2)])
def test_repconv_matches(c1, c2, s):
    """With the identity BN (c1 == c2, s == 1) and without it."""
    tmod = tconv.RepConv(c1, c2, 3, s)
    assert (tmod.bn is not None) == (c1 == c2 and s == 1)
    want, got = _run_pair(jconv.RepConv(c2, 3, s), tmod, _x(2, (2, 12, 10, c1)), 3)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=MODULE_ATOL)


def test_repblock_matches():
    want, got = _run_pair(jblock.RepBlock(16, 2), tblock.RepBlock(16, 16, 2),
                          _x(3, (2, 10, 10, 16)), 4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=MODULE_ATOL)


def test_sppf_matches():
    want, got = _run_pair(jblock.SPPF(16, 5), tblock.SPPF(32, 16, 5), _x(4, (2, 7, 9, 32)), 5)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=MODULE_ATOL)


def test_polar_segment_matches():
    ch, hw = (16, 32, 64), ((16, 12), (8, 6), (4, 3))
    feats = [_x(10 + i, (2, h, w, c)) for i, ((h, w), c) in enumerate(zip(hw, ch))]
    jmod = jhead.PolarSegment(nc=3)
    jfeats = [jnp.asarray(f) for f in feats]
    jvars = _randomize(_init(jmod, jfeats), 6)
    want = jax.jit(jmod.apply)(jvars, jfeats)
    tmod = _carry(jvars, thead.PolarSegment(nc=3, ch=ch))
    with torch.no_grad():
        got = tmod([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for g, w in zip(got, want):
        assert g.shape[1] == 36 + 3
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=MODULE_ATOL)


def _levels(seed, nc=3, hw=((20, 12), (10, 6), (5, 3))):
    rng = np.random.default_rng(seed)
    return [np.concatenate([rng.uniform(-0.5, 8, (2, h, w, 36)),
                            rng.normal(0, 3, (2, h, w, nc))], -1).astype(np.float32)
            for h, w in hw]


@pytest.mark.parametrize("sigmoid", [True, False])
def test_decode_polar_parts_matches(sigmoid):
    outs = _levels(7)
    want = jhead.decode_polar_parts([jnp.asarray(o) for o in outs], (8, 16, 32), 3,
                                    sigmoid=sigmoid)
    got = thead.decode_polar_parts([torch.from_numpy(o).permute(0, 3, 1, 2) for o in outs],
                                   (8, 16, 32), 3, sigmoid=sigmoid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=DECODE_ATOL)


def test_flatten_levels_is_row_major():
    outs = _levels(8)
    want = jhead.flatten_levels([jnp.asarray(o) for o in outs])
    got = thead.flatten_levels([torch.from_numpy(o).permute(0, 3, 1, 2) for o in outs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_finalize_polar_extras_matches():
    rng = np.random.default_rng(9)
    ex = np.concatenate([rng.uniform(-1, 40, (2, 30, 36)), rng.uniform(0, 320, (2, 30, 2))], -1)
    ex = ex.astype(np.float32)
    ex[0, 0, :4] = [1.0, 0.5, 1.0 + 1e-6, 0.0]
    want = np.asarray(jhead.finalize_polar_extras(jnp.asarray(ex)))
    got = thead.finalize_polar_extras(torch.from_numpy(ex)).numpy()
    np.testing.assert_allclose(got[..., :72], want[..., :72], atol=DECODE_ATOL)
    np.testing.assert_array_equal(got[..., 72:], want[..., 72:])


def test_graph_model_matches_at_64px():
    """yolov8-seg at scale n, nc=3, on 64 px inputs with random weights:
    parse_model, the graph wiring, the weight map and predict_parts
    together."""
    cfg = copy.deepcopy(YOLOV8_SEG)
    cfg["nc"] = 3
    jm = build_model(cfg)
    x = np.random.default_rng(12).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jvars = _randomize(_init(jm.module, jnp.asarray(x)), 11)
    tm = SegmentationModel(cfg)
    load_jax_variables(tm, jvars["params"], jvars["batch_stats"])
    tm.eval()
    assert tm.strides == tuple(jm.strides) == (8, 16, 32)
    assert tm.num_params == sum(int(np.size(p)) for p in jax.tree_util.tree_leaves(jvars["params"]))
    want = jax.jit(jm.raw_forward)(jvars, jnp.asarray(x))
    wparts = jax.jit(lambda v, a: jm.predict_parts(v, a, sigmoid=False))(jvars, jnp.asarray(x))
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = tm(xt)
        gparts = tm.predict_parts(xt, sigmoid=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=MODULE_ATOL)
    for g, w in zip(gparts, wparts):
        # boxes and extras are rays * stride: the 1e-4 head tolerance times 32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=32 * MODULE_ATOL)


@pytest.mark.parametrize("scale", ["s", "m"])
def test_graph_model_matches_at_other_scales(scale):
    """Other published scales build the same graph: at m the depth gain
    repeats each Conv2 twice (``layer{i}_{r}`` in JAX, ``model.{i}.{r}``
    here)."""
    cfg = copy.deepcopy(YOLOV8_SEG)
    cfg.update(nc=3, scale=scale)
    jm = build_model(cfg)
    x = np.random.default_rng(13).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    jvars = _randomize(_init(jm.module, jnp.asarray(x)), 14)
    tm = SegmentationModel(cfg)
    load_jax_variables(tm, jvars["params"], jvars["batch_stats"])
    assert tm.num_params == sum(int(np.size(p)) for p in jax.tree_util.tree_leaves(jvars["params"]))
    assert any(k.startswith("model.12.1.") for k in tm.state_dict()) == (scale == "m")
    want = jax.jit(jm.raw_forward)(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=MODULE_ATOL)
