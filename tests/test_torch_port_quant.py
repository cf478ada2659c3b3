"""The PyTorch port's native int8 (``nn/quant.py``) against the JAX
package's (``nn/quant.py`` and ``deploy_conv``'s int8 branch) on the CPU:
the s8 x s8 -> s32 conv's accumulations over the conv shapes the configs
use, the input quantization's rounding, one deploy conv, the depthwise
skip, calibration, ``quantize_tree``, the int8 model's head, int8
checkpoints both ways, the selective set, and the facade's guards, serving
and ``AutoBackend`` on an int8 handle. The models are yolov8n-seg and
yolov8s-seg at imgsz 64 with weights drawn from a seed with numpy (JAX's
variables carried into the port); calibration batches are uniform images
from a seed."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_port_modules import _randomize
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.nn import fuse as jfuse
from yolo_contour_regression_tpu.nn import quant as jquant
from yolo_contour_regression_tpu.nn.modules import conv as jconv
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.nn import quant as tquant
from yolo_contour_regression_tpu_torch.nn.autobackend import AutoBackend
from yolo_contour_regression_tpu_torch.nn.fuse import FusedConv, fuse_model
from yolo_contour_regression_tpu_torch.nn.modules import conv as tconv
from yolo_contour_regression_tpu_torch.nn.tasks import build_model, yaml_model_load
from yolo_contour_regression_tpu_torch.serve import InferenceServer
from yolo_contour_regression_tpu_torch.utils.checkpoint import (from_jax_variables,
                                                                load_checkpoint,
                                                                load_jax_variables,
                                                                to_jax_variables)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


IMGSZ = 64
# calibration: the port's input absmax against JAX's (the same f32 network,
# its sums in another order), relative
ABSMAX_RTOL = 1e-5
# the int8 model's raw head maps against JAX's, of the head's largest value
HEAD_TOL = 1e-3
# one int8 deploy conv against its float conv (JAX's tests/test_quant.py)
FLOAT_REL = 0.02


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, tree)))


def _same_leaves(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=str(k))


def _calib(seed, n=1, b=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (b, IMGSZ, IMGSZ, 3)).astype(np.float32) for _ in range(n)]


# --- the int8 conv --------------------------------------------------------------

# (cin, cout, k, s, p, d, g, hw): the stem (K = 27), 1x1, 3x3 at strides 1 and 2,
# SPPF's 5x5 pooling neighbours' convs (1x1), a dilated 3x3, a grouped (not
# depthwise) conv, out-channels no multiple of 8 (36 rays, 2 classes), and
# fewer than 17 output rows
CONV_CASES = [(3, 16, 3, 2, 1, 1, 1, 32), (16, 32, 1, 1, 0, 1, 1, 16), (32, 32, 3, 1, 1, 1, 1, 16),
              (32, 64, 3, 2, 1, 1, 1, 16), (64, 36, 3, 1, 1, 1, 1, 8), (64, 2, 1, 1, 0, 1, 1, 8),
              (16, 16, 3, 1, 2, 2, 1, 12), (8, 12, 3, 1, 1, 1, 2, 10), (64, 64, 3, 2, 1, 1, 1, 6)]


@pytest.mark.parametrize("cin,cout,k,s,p,d,g,hw", CONV_CASES)
def test_int8_conv_accumulations_equal_jax(cin, cout, k, s, p, d, g, hw):
    """``int8_conv2d``'s int32 accumulations equal JAX's
    ``lax.conv_general_dilated(..., preferred_element_type=int32)`` on the
    same int8 input and kernel, at every stride, padding, dilation and
    group count, across the full int8 range."""
    rng = np.random.default_rng(cin * 1000 + cout + k + s + d + g)
    x = rng.integers(-127, 128, (2, hw, hw + 2, cin)).astype(np.int8)  # NHWC
    w = rng.integers(-127, 128, (k, k, cin // g, cout)).astype(np.int8)  # HWIO
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), [(p, p), (p, p)], rhs_dilation=(d, d),
        feature_group_count=g, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    got = tquant.int8_conv2d(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                             torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), (s, s), (p, p),
                             (d, d), g)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_input_matches_jax_rounding():
    """``quantize_input`` is JAX's ``clip(round(x / x_scale), -127, 127)``
    as int8: halves round to even (not away from zero), and the clip is at
    -127, not -128."""
    xs = np.float32(0.5)
    x = np.concatenate([np.arange(-70, 70, 0.25, dtype=np.float32),  # every .5 boundary
                        np.array([-1e3, 1e3, -63.75, 63.75, 0.0], np.float32),
                        np.random.default_rng(0).normal(0, 40, 500).astype(np.float32)])
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / xs), -127, 127).astype(jnp.int8))
    got = tquant.quantize_input(torch.from_numpy(x), torch.tensor(xs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() == -127 and got.max() == 127
    assert tquant.quantize_input(torch.tensor([0.25, 0.75, -0.25]), torch.tensor(0.5)).tolist() \
        == [0, 2, 0]


def _jax_deploy(mod, x):
    """A JAX module in deploy mode: its seeded variables and its capture."""
    with jconv.deploy_mode(True):
        variables = mod.init(jax.random.PRNGKey(0), x)
        cal = {}
        with jconv.quant_calibration(cal):
            mod.apply(variables, x)
    return variables, cal


def test_quant_conv_matches_jax_deploy_conv():
    """One deploy Conv (JAX's ``test_quant_conv_matches_f32``): the port's
    calibration of the same weights gives JAX's key ("" at the top level)
    and features, ``quantize_tree`` gives JAX's tree bit for bit, the
    ``QuantConv2d`` built from it gives JAX's int8 output, and that output
    is within 2% of the float conv's."""
    x = jnp.asarray(np.random.default_rng(0).normal(0, 1, (2, 16, 16, 8)).astype(np.float32))
    mod = jconv.Conv(c2=12, k=3, act=False)
    variables, cal = _jax_deploy(mod, x)
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    conv = torch.nn.Conv2d(8, 12, 3, 1, 1, bias=True)
    sd = from_jax_variables({"layer0": params}, {})
    conv.load_state_dict({"weight": sd["model.0.conv.weight"], "bias": sd["model.0.conv.bias"]})
    fused = FusedConv(conv, torch.nn.Identity()).eval()
    xt = torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)
    got_cal = tquant.calibrate(fused, [np.asarray(x)])
    assert list(got_cal) == list(cal) == [""]
    assert {k: v for k, v in got_cal[""].items() if k != "absmax"} == \
        {k: v for k, v in cal[""].items() if k != "absmax"}
    assert got_cal[""]["absmax"] == cal[""]["absmax"]  # the input itself
    want_tree, n_q, n_skip = jquant.quantize_tree(dict(variables["params"]), cal)
    got_tree, *counts = tquant.quantize_tree(params, got_cal)
    assert (n_q, n_skip) == tuple(counts) == (1, 0)
    _same_leaves(got_tree, want_tree)
    q = tquant.QuantConv2d(conv)
    with torch.no_grad():
        q.weight.copy_(torch.from_numpy(got_tree["conv"]["kernel"].transpose(3, 2, 0, 1).copy()))
        q.bias.copy_(torch.from_numpy(got_tree["conv"]["bias"]))
        q.w_scale.copy_(torch.from_numpy(got_tree["conv"]["w_scale"]))
        q.x_scale.copy_(torch.from_numpy(got_tree["conv"]["x_scale"]))
        got, yf = q(xt), conv(xt)
    with jconv.deploy_mode(True), jconv.quant_mode(True):
        want = np.asarray(mod.apply({"params": want_tree}, x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    err = float((got - yf).abs().max() / yf.abs().max())
    assert err < FLOAT_REL, f"int8 conv error {err:.4f}"


def test_quantize_tree_skips_depthwise():
    """A depthwise conv (JAX's ``test_quantize_tree_skips_depthwise``): the
    port's calibration keys it ``dw`` as JAX does, and ``quantize_tree``
    keeps its float kernel: 0 quantized, 1 skipped on both sides."""
    x = jnp.asarray(np.random.default_rng(1).normal(0, 1, (1, 8, 8, 6)).astype(np.float32))
    variables, cal = _jax_deploy(jconv.DWConv(c2=6, k=3), x)
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    dw = tconv.DWConv(6, 6, 3)
    sd = from_jax_variables({"layer0": params}, {})
    fused = fuse_model(torch.nn.Sequential(dw))  # dw's Conv becomes a FusedConv
    fused[0].dw.conv.load_state_dict({"weight": sd["model.0.dw.conv.weight"],
                                      "bias": sd["model.0.dw.conv.bias"]})
    got_cal = tquant.calibrate(fused[0], [np.asarray(x)])
    assert list(got_cal) == list(cal) == ["dw"] and got_cal["dw"]["groups"] == 6
    tree, n_q, n_skip = tquant.quantize_tree(params, got_cal)
    assert (n_q, n_skip) == (0, 1) and tree["dw"]["conv"]["kernel"].dtype == np.float32
    want_tree, *want_counts = jquant.quantize_tree(dict(variables["params"]), cal)
    assert want_counts == [0, 1]
    _same_leaves(tree, want_tree)


# --- yolov8n-seg: calibration, quantize_tree, the int8 head -----------------------


def _jax_model(name: str, seed: int):
    """JAX's model of ``name`` with every variable drawn from a seed with
    numpy (shapes from an abstract init at imgsz 64), and its JAX facade."""
    jy = JaxYOLO(name)
    shapes = jax.eval_shape(lambda: jy.model.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
    jy.variables = jax.tree_util.tree_map(np.asarray, _randomize(dict(shapes), seed))
    return jy


@pytest.fixture(scope="module")
def seg_n():
    """yolov8n-seg: JAX's variables carried into the port and fused there
    (JAX's own fold of them is a few ulps apart:
    ``tests/test_torch_port_onnx.py:test_batchnorm_folds_apart_by_ulps``),
    that fused tree in JAX's deploy model, JAX's calibration and int8 tree
    of it on ``_calib(3)``, and the port's fused model."""
    jy = _jax_model("yolov8n-seg.yaml", seed=2)
    port = build_model(yaml_model_load("yolov8n-seg.yaml"))
    load_jax_variables(port, jy.variables["params"], jy.variables["batch_stats"])
    fuse_model(port)
    fparams, _ = to_jax_variables(port.state_dict())
    jdeploy = jfuse.as_deploy_model(jy.model)
    calib = _calib(3)
    cal = jquant.calibrate(jdeploy, {"params": fparams}, calib)
    qtree, n_q, n_skip = jquant.quantize_tree(fparams, cal)
    return {"jy": jy, "deploy": jdeploy, "fparams": fparams, "calib": calib, "cal": cal,
            "qtree": qtree, "counts": (n_q, n_skip), "port": port.eval()}


def test_calibrate_matches_jax(seg_n):
    """The port's calibration of the same fused weights: JAX's keys in
    JAX's order, the same shape features, the absmax within
    ``ABSMAX_RTOL``."""
    got = tquant.calibrate(seg_n["port"], seg_n["calib"])
    want = seg_n["cal"]
    assert list(got) == list(want) and len(got) == 29
    for k in want:
        assert {f: v for f, v in got[k].items() if f != "absmax"} == \
            {f: v for f, v in want[k].items() if f != "absmax"}, k
        assert got[k]["absmax"] == pytest.approx(want[k]["absmax"], rel=ABSMAX_RTOL), k


def test_quantize_tree_equals_jax(seg_n):
    """``quantize_tree`` on the port's own JAX-form tree of the same fused
    weights (``to_jax_variables``) with JAX's calibration: int8 kernels,
    ``w_scale`` and ``x_scale`` bit for bit, the same counts."""
    params, _ = to_jax_variables(seg_n["port"].state_dict())
    got, *counts = tquant.quantize_tree(params, seg_n["cal"])
    assert tuple(counts) == seg_n["counts"] == (29, 0)
    _same_leaves(got, seg_n["qtree"])


def test_int8_head_matches_jax(seg_n):
    """The port's int8 model built from JAX's int8 tree against JAX's int8
    model on an image: every quantized conv's int8 input within one code
    of JAX's (the count of codes that flipped at a .5 boundary printed),
    and the raw head maps within ``HEAD_TOL`` of the head's largest
    value."""
    port = tquant.as_quantized_model(copy.deepcopy(seg_n["port"]), seg_n["qtree"])
    assert port.quantized and sum(isinstance(m, tquant.QuantConv2d) for m in port.modules()) == 29
    x = np.random.default_rng(4).uniform(0, 1, (1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want_codes, got_codes = [], []
    lax_conv = jax.lax.conv_general_dilated

    def record(lhs, *a, **k):
        if lhs.dtype == jnp.int8:
            want_codes.append(np.asarray(lhs))
        return lax_conv(lhs, *a, **k)

    jax.lax.conv_general_dilated = record  # JAX's apply runs eagerly: each conv's int8 input
    try:
        want = jquant.as_quantized_model(seg_n["deploy"]).raw_forward(
            {"params": seg_n["qtree"]}, jnp.asarray(x))
    finally:
        jax.lax.conv_general_dilated = lax_conv
    hooks = [m.register_forward_pre_hook(
        lambda m, a: got_codes.append(tquant.quantize_input(a[0], m.x_scale).permute(0, 2, 3, 1)
                                      .numpy()))
        for m in port.modules() if isinstance(m, tquant.QuantConv2d)]
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    assert len(got_codes) == len(want_codes) == 29
    diffs = [np.abs(g.astype(np.int32) - w.astype(np.int32)) for g, w in zip(got_codes, want_codes)]
    flipped = sum(int((d > 0).sum()) for d in diffs)
    print(f"int8 input codes flipped at a .5 boundary: {flipped} of "
          f"{sum(d.size for d in diffs)}")
    assert max(int(d.max()) for d in diffs) <= 1
    want = jax.tree_util.tree_leaves(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=0,
                                   atol=HEAD_TOL * scale)


# --- int8 checkpoints both ways ---------------------------------------------------------


def test_int8_checkpoint_from_jax_loads_in_port(seg_n, tmp_path):
    """An int8 checkpoint the JAX facade saves (``deploy == "int8"``: int8
    HWIO kernels, ``w_scale``, ``x_scale``) loads into the port as an int8
    model whose JAX-form leaves are the checkpoint's, bit for bit, and
    which predicts."""
    jy = seg_n["jy"]
    jy.variables, jy.model = {"params": seg_n["qtree"]}, jquant.as_quantized_model(
        seg_n["deploy"])
    path = str(tmp_path / "jax_int8.ckpt")
    jy.save(path)
    ckpt = load_checkpoint(path)
    assert ckpt["deploy"] == "int8"
    port = YOLO(path, device="cpu")
    assert port.model.quantized and port.model.fused
    params, stats = to_jax_variables(port.model.state_dict())
    assert not stats
    _same_leaves(params, ckpt["params"])
    img = (np.random.default_rng(5).uniform(0, 255, (IMGSZ, IMGSZ, 3))).astype(np.uint8)
    assert len(port.predict(img, imgsz=IMGSZ, conf=0.001)) == 1


def test_int8_checkpoint_from_port_loads_in_jax(tmp_path):
    """The port's facade quantizes (fusing on the CPU first) and saves
    ``deploy == "int8"``; the JAX facade loads it as an int8 model
    (``as_quantized_model``) whose variables are the port's leaves bit for
    bit, and the port reloads it to the same leaves."""
    m = YOLO("yolov8n-seg.yaml", device="cpu").quantize(_calib(6))
    assert m.model.quantized
    path = m.save(tmp_path / "port_int8.ckpt")
    want, _ = to_jax_variables(m.model.state_dict())
    jy = JaxYOLO(str(path))
    assert getattr(jy.model, "quantized", False) and jy.ckpt["deploy"] == "int8"
    _same_leaves(jy.variables["params"], want)
    again, _ = to_jax_variables(YOLO(path, device="cpu").model.state_dict())
    _same_leaves(again, want)


def test_selective_quantizes_jax_set():
    """``selective=True`` on yolov8s-seg at 64 (JAX's
    ``test_selective_quantization_quantizes_only_deep_layers``): the port's
    facade gives JAX's ``quantize_tree(..., selective=True)`` of the same
    fold and calibration bit for bit (the calibration's keys and features
    are JAX's: ``test_calibrate_matches_jax``): a mixed tree, every int8
    conv with 128 or more in-channels; and the mixed model predicts."""
    m = YOLO("yolov8s-seg.yaml", device="cpu")
    fused = fuse_model(copy.deepcopy(m._weights()))
    calib = _calib(7, b=1)
    want_tree, n_q, n_skip = jquant.quantize_tree(
        to_jax_variables(fused.state_dict())[0], tquant.calibrate(fused, calib), selective=True)
    m.quantize(calib, selective=True)
    got, _ = to_jax_variables(m.model.state_dict())
    _same_leaves(got, want_tree)
    assert 0 < n_q < n_q + n_skip
    assert all(q.weight.shape[1] * q.groups >= 128 for q in m.model.modules()
               if isinstance(q, tquant.QuantConv2d))
    img = np.random.default_rng(8).integers(0, 255, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
    assert len(m.predict(img, imgsz=IMGSZ, conf=0.001)) == 1


# --- the facade on an int8 handle ---------------------------------------------------------


@pytest.fixture(scope="module")
def int8_handle(tmp_path_factory):
    """The port's yolov8n-seg facade quantized on ``_calib(9)``, and its int8
    checkpoint."""
    m = YOLO("yolov8n-seg.yaml", device="cpu").quantize(_calib(9))
    return m, m.save(tmp_path_factory.mktemp("int8") / "q.ckpt")


def test_guards_on_an_int8_handle(int8_handle):
    """JAX's guards (``test_refuse_requantize_guards``): ``fuse`` and
    ``quantize`` on an int8 handle raise, naming int8, and leave its
    weights as they were; export of it raises; a second ``fuse`` on a fused
    handle is a no-op."""
    m, _ = int8_handle
    before = {k: v.clone() for k, v in m.model.state_dict().items()}
    with pytest.raises(RuntimeError, match="int8"):
        m.fuse()
    with pytest.raises(RuntimeError, match="int8"):
        m.quantize(_calib(10))
    for k, v in m.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(RuntimeError, match="int8"):
        m.export(format="onnx", imgsz=IMGSZ)
    f = YOLO("yolov8n-seg.yaml", device="cpu").fuse()
    model = f.model
    assert f.fuse().model is model


def test_int8_serve_and_autobackend_equal_direct(int8_handle):
    """The int8 handle served by ``InferenceServer`` (not re-fused) gives
    direct predict's detections (JAX's ``test_serve_int8_handle``), and
    ``AutoBackend`` on the int8 checkpoint gives the handle's predict (JAX's
    ``test_int8_ckpt_autobackend_not_refused``): both bit for bit."""
    m, path = int8_handle
    rng = np.random.default_rng(11)
    images = [rng.integers(0, 255, (48, 56, 3), dtype=np.uint8) for _ in range(2)]
    want = m.predict(images, imgsz=IMGSZ, conf=0.001, batch=2)
    with InferenceServer(m, imgsz=IMGSZ, max_batch=2, conf=0.001, device="cpu") as srv:
        assert srv.model is m.model and srv.model.quantized
        got = srv.infer(images)
    for g, w in zip(got, want):
        assert torch.equal(torch.as_tensor(g.boxes.data), torch.as_tensor(w.boxes.data))
    x = torch.from_numpy(rng.uniform(0, 1, (1, 3, IMGSZ, IMGSZ)).astype(np.float32))
    backend = AutoBackend(path, device="cpu")
    with torch.no_grad():
        assert torch.equal(backend(x), m.model.predict(x))
