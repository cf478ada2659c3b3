"""The PyTorch port's deploy form (``nn/fuse.py``) on the CPU, mirroring
``tests/test_fuse.py``: fused against unfused for the polar yolov8-seg graph
(RepConv, RepBlock, Conv2) and the yolov8 detect graph (Conv + BN in C2f
and Detect) with perturbed BatchNorm statistics; each conv form's fused
kernel and bias against JAX ``fuse_tree``; the fused model's parameters;
``fold_input_scale``; and a checkpoint that the JAX facade fused and saved,
loaded by the port and predicting what JAX's fused model predicts."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import CKPT, DETECT_CKPT, floor_detect_val_set, floor_val_set
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.nn import fuse as jfuse
from yolo_contour_regression_tpu.nn.modules import conv as jconv
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine.step import make_loss_fn
from yolo_contour_regression_tpu_torch.nn import fuse as tfuse
from yolo_contour_regression_tpu_torch.nn.modules import conv as tconv
from yolo_contour_regression_tpu_torch.nn.tasks import (YOLOV8, YOLOV8_SEG, DetectionModel,
                                                        SegmentationModel)
from yolo_contour_regression_tpu_torch.utils.checkpoint import (from_jax_variables,
                                                                load_checkpoint,
                                                                to_jax_variables)

from tests.test_torch_port_modules import _carry, _init, _randomize, _x


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# fused against unfused (tests/test_fuse.py's tolerance): BatchNorm folded
# into the kernel changes the f32 rounding
FUSE_TOL = 1e-3
# a fused conv's kernel and bias against JAX's fuse_tree: the same f32
# algebra, a few ulps
PARAM_TOL = 1e-5
# the port's fused model against JAX's, from the same fused checkpoint
BOX_PX, SCORE_ATOL = 0.05, 1e-4


def _perturb_stats(model: torch.nn.Module, seed: int):
    """Non-trivial BatchNorm statistics and affine terms (so the fold is
    tested), drawn with numpy."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)))
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, n).astype(np.float32)))
    return model.eval()


def _image(seed, b=2, hw=64):
    x = np.random.default_rng(seed).normal(0.5, 0.2, (b, 3, hw, hw)).astype(np.float32)
    return torch.from_numpy(x)


CASES = {"yolov8-seg": (SegmentationModel, YOLOV8_SEG), "yolov8": (DetectionModel, YOLOV8)}


def _decode(model, x):
    if model.task == "segment":
        return torch.cat(model.predict_parts(x), -1)
    return model.predict(x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fuse_equivalence(name):
    """The fused model's head maps and decode equal the unfused model's
    within ``FUSE_TOL``; the fused model has no BatchNorm, fewer
    parameters, and only fused convs where Conv, Conv2 and RepConv were."""
    cls, cfg = CASES[name]
    model = _perturb_stats(cls(cfg), seed=1)
    x = _image(2)
    with torch.no_grad():
        want_maps, want = model(x), _decode(model, x)
    n_before = model.num_params
    fused = tfuse.fuse_model(copy.deepcopy(model))
    assert fused.fused and not fused.training
    assert not any(isinstance(m, (torch.nn.BatchNorm2d, tconv.Conv, tconv.Conv2, tconv.RepConv))
                   for m in fused.modules())
    assert not any("running" in k for k in fused.state_dict())
    assert fused.num_params < n_before
    with torch.no_grad():
        got_maps, got = fused(x), _decode(fused, x)
    for g, w in zip(got_maps, want_maps):
        torch.testing.assert_close(g, w, rtol=FUSE_TOL, atol=FUSE_TOL)
    scale = torch.ones_like(want)
    scale[:, :4] = max(1.0, float(want[:, :4].abs().max()))
    torch.testing.assert_close(got / scale, want / scale, rtol=FUSE_TOL, atol=FUSE_TOL)
    assert tfuse.fuse_model(fused) is fused  # a no-op on a fused model


def _jax_pair(jmod, tmod, x_nhwc, seed):
    jvars = _randomize(_init(jmod, jnp.asarray(x_nhwc)), seed)
    _carry(jvars, tmod)
    return jvars


@pytest.mark.parametrize("form,c1,c2,s", [("conv", 8, 16, 2), ("conv2", 16, 16, 1),
                                          ("repconv", 16, 16, 1), ("repconv", 16, 16, 2),
                                          ("repconv", 8, 16, 1)])
def test_fused_conv_matches_jax_fuse_tree(form, c1, c2, s):
    """Each conv form's fused kernel (OIHW here, HWIO in JAX) and bias
    against JAX ``fuse_tree``; RepConv with the identity BN and without it
    (stride 2, or c1 != c2); and the fused module's output against the
    unfused one's."""
    jmod, tmod = {"conv": (jconv.Conv(c2, 3, s), tconv.Conv(c1, c2, 3, s)),
                  "conv2": (jconv.Conv2(c2, 3, s), tconv.Conv2(c1, c2, 3, s)),
                  "repconv": (jconv.RepConv(c2, 3, s), tconv.RepConv(c1, c2, 3, s))}[form]
    x = _x(3, (2, 10, 12, c1))
    jvars = _jax_pair(jmod, tmod, x, 4)
    if form == "repconv":
        assert (tmod.bn is not None) == (c1 == c2 and s == 1)
        assert ("bn_id" in jvars["params"]) == (tmod.bn is not None)
    want = jfuse.fuse_tree(jax.tree_util.tree_map(np.asarray, jvars["params"]),
                           jax.tree_util.tree_map(np.asarray, jvars["batch_stats"]))
    fused = tfuse.fuse_conv(tmod)
    got = from_jax_variables({"layer0": want}, {})
    np.testing.assert_allclose(fused.conv.weight.detach().numpy(),
                               got["model.0.conv.weight"].numpy(), atol=PARAM_TOL)
    np.testing.assert_allclose(fused.conv.bias.detach().numpy(), got["model.0.conv.bias"].numpy(),
                               atol=PARAM_TOL)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        torch.testing.assert_close(fused(xt), tmod(xt), rtol=FUSE_TOL, atol=FUSE_TOL)


def test_fold_input_scale_equivalence_and_refusals():
    """Folding ``/255`` into the stem conv of a fused model gives its
    predictions on the raw image; an unfused model, or a stem that is not
    an image conv, is refused."""
    model = tfuse.fuse_model(_perturb_stats(SegmentationModel(YOLOV8_SEG), seed=5))
    raw = torch.from_numpy(np.random.default_rng(6).integers(0, 255, (1, 3, 64, 64))
                           .astype(np.float32))
    with torch.no_grad():
        want = _decode(model, raw / 255.0)
        got = _decode(tfuse.fold_input_scale(copy.deepcopy(model)), raw)
    scale = max(1.0, float(want[..., :4].abs().max()))
    torch.testing.assert_close(got / scale, want / scale, rtol=FUSE_TOL, atol=FUSE_TOL)
    with pytest.raises(ValueError, match="fused"):
        tfuse.fold_input_scale(SegmentationModel(YOLOV8_SEG))
    odd = tfuse.fuse_model(DetectionModel(YOLOV8))
    odd.model[0].conv = torch.nn.Conv2d(4, 16, 3, bias=True)
    with pytest.raises(ValueError, match="image stem"):
        tfuse.fold_input_scale(odd)


@pytest.fixture(scope="module")
def jax_fused(tmp_path_factory):
    """The floor checkpoints fused by the JAX facade and saved by it
    (``fuse()`` then ``save()``), and JAX's fused handles."""
    tmp = tmp_path_factory.mktemp("fused")
    out = {}
    for name, ckpt in (("seg160", CKPT), ("detect", DETECT_CKPT)):
        path = str(tmp / f"{name}_fused.ckpt")
        JaxYOLO(str(ckpt)).fuse().save(path)
        out[name] = (path, JaxYOLO(path))
    return out


@pytest.mark.parametrize("name,imgsz", [("seg160", 160), ("detect", 96)])
def test_jax_fused_checkpoint_loads_and_predicts(jax_fused, name, imgsz):
    """The port loads ``deploy == "fused"`` checkpoints as JAX saves them (a
    fused params tree, no batch_stats; every leaf used, and carried back
    unchanged), and predicts what JAX's fused model predicts: the same
    detections, boxes within ``BOX_PX``, scores within ``SCORE_ATOL``."""
    path, jy = jax_fused[name]
    ckpt = load_checkpoint(path)
    assert ckpt["deploy"] == "fused" and not ckpt["batch_stats"]
    ty = YOLO(path, device="cpu")
    assert ty.model.fused and ty.task == ("segment" if name == "seg160" else "detect")
    params, stats = to_jax_variables(ty.model.state_dict())
    assert not stats
    leaves = jax.tree_util.tree_leaves_with_path(ckpt["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(got) == len(leaves)
    for p, a in leaves:
        np.testing.assert_array_equal(got[p], a)
    images = (floor_val_set() if name == "seg160" else floor_detect_val_set())[0][:6]
    want, res = jy.predict(images, imgsz=imgsz), ty.predict(images, imgsz=imgsz)
    n = 0
    for g, w in zip(res, want):
        wd = np.asarray(w.boxes.data, np.float32)
        assert g.boxes.data.shape == wd.shape
        np.testing.assert_array_equal(g.boxes.cls, wd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, wd[:, :4], atol=BOX_PX)
        np.testing.assert_allclose(g.boxes.conf, wd[:, 4], atol=SCORE_ATOL)
        n += len(g)
    assert n >= 4


@pytest.mark.parametrize("ckpt", [CKPT, DETECT_CKPT])
def test_yolo_fuse_keeps_the_detections(ckpt):
    """``YOLO(path).fuse()`` in place: the same detections as unfused on the
    floor images, a no-op the second time; a fused model does not train."""
    images = (floor_val_set() if ckpt == CKPT else floor_detect_val_set())[0][:4]
    plain = YOLO(ckpt, device="cpu")
    want = plain.predict(images)
    fused = YOLO(ckpt, device="cpu").fuse()
    model = fused.model
    assert fused.fuse().model is model and model.fused
    for g, w in zip(fused.predict(images), want):
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, atol=BOX_PX)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, atol=SCORE_ATOL)
    with pytest.raises(ValueError, match="inference-only"):
        make_loss_fn(model, None)


def test_int8_checkpoints_still_raise(tmp_path):
    """A checkpoint marked ``deploy == "int8"`` whose tree holds no int8
    kernel (here the training-form detect tree) raises, naming int8; real
    int8 checkpoints load (``tests/test_torch_port_quant.py``)."""
    ckpt = load_checkpoint(DETECT_CKPT)
    ckpt["deploy"] = "int8"
    import pickle
    path = tmp_path / "int8.ckpt"
    path.write_bytes(pickle.dumps(ckpt))
    with pytest.raises(ValueError, match="int8"):
        YOLO(path, device="cpu")
