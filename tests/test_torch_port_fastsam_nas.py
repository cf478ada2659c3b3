"""FastSAM and YOLO-NAS in the PyTorch port against the JAX package, on the
CPU: the polar predictor's lazy masks (``boxes``, ``retina_masks``) and
FastSAM's agnostic predict on the seg160 checkpoint, the four prompts on
those results and on JAX's hand-built ones, the even-odd fill of results
without masks; YOLO-NAS's blocks, a narrow graph in float32 and its detect
loss and gradients in float64, its config and parameter counts at every
scale, the name map, the fuse and the facade."""
import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import CKPT, shape_images
from yolo_contour_regression_tpu.engine import step as jstep
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.engine.results import Results as JaxResults
from yolo_contour_regression_tpu.models.fastsam import FastSAM as JaxFastSAM
from yolo_contour_regression_tpu.models.fastsam import FastSAMPrompt as JaxPrompt
from yolo_contour_regression_tpu.nn import fuse as jfuse
from yolo_contour_regression_tpu.nn.modules import block as jblock
from yolo_contour_regression_tpu.nn.tasks import build_model as jbuild_model
from yolo_contour_regression_tpu.nn.tasks import yaml_model_load as jyaml_model_load
from yolo_contour_regression_tpu_torch import NAS, YOLO, FastSAM, FastSAMPrompt
from yolo_contour_regression_tpu_torch.engine import step as tstep
from yolo_contour_regression_tpu_torch.engine.results import Results
from yolo_contour_regression_tpu_torch.nn import fuse as tfuse
from yolo_contour_regression_tpu_torch.nn.modules import block as tblock
from yolo_contour_regression_tpu_torch.nn.tasks import (YOLO_NAS, DetectionModel, build_model,
                                                        guess_model_task, yaml_model_load)
from yolo_contour_regression_tpu_torch.ops import raster
from yolo_contour_regression_tpu_torch.utils.checkpoint import (from_jax_variables,
                                                                load_jax_variables,
                                                                to_jax_variables)

from tests.test_torch_port_detect import (GRAPH_ATOL, MODULE_ATOL, STEP_GRAD_TOL, STEP_LOSS_RTOL,
                                          _det_batch)
from tests.test_torch_port_modules import _randomize, _run_pair, _x
from tests.test_torch_port_train import _f64, _np, _t

PX_ATOL, SCORE_ATOL = 0.05, 1e-4
FUSE_TOL, PARAM_TOL = 1e-3, 1e-5

# yolo_nas cut narrow for the graph parities (the full width's JAX compile
# is slow: its own tests are heavy); the full width is held by counts
NARROW_NAS = copy.deepcopy(YOLO_NAS)
NARROW_NAS.update(nc=2, scale="t", scales={"t": [0.33, 0.25, 256]})


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seg():
    images = shape_images(3, 120, 200, seed=5) + shape_images(1, 160, 96, seed=6)
    return JaxYOLO(str(CKPT)), YOLO(CKPT, device="cpu"), images


def _same_results(tres, jres):
    assert [len(r) for r in tres] == [len(r) for r in jres]
    for t, j in zip(tres, jres):
        np.testing.assert_array_equal(t.boxes.cls, j.boxes.cls)
        np.testing.assert_allclose(t.boxes.conf, j.boxes.conf, atol=SCORE_ATOL)
        np.testing.assert_allclose(t.boxes.xyxy, j.boxes.xyxy, atol=PX_ATOL)
        np.testing.assert_allclose(t.contours.points, j.contours.points, atol=PX_ATOL)


@pytest.mark.parametrize("kw", [{}, {"boxes": False}, {"boxes": False, "retina_masks": True}],
                         ids=["default", "no_boxes", "no_boxes_retina"])
def test_lazy_masks_follow_jax(seg, kw):
    """The polar results fill their masks lazily where JAX's do (``boxes``
    or ``retina_masks``); with ``boxes=False`` alone ``masks`` is None, as
    JAX's."""
    jy, ty, images = seg
    jres, tres = jy.predict(images, **kw), ty.predict(images, **kw)
    _same_results(tres, jres)
    for t, j in zip(tres, jres):
        assert (t.masks is None) == (j.masks is None)
        if j.masks is not None:
            np.testing.assert_array_equal(t.masks.data, j.masks.data)
    assert all((r.masks is None) == (kw == {"boxes": False}) for r in tres)


@pytest.fixture(scope="module")
def fastsam(seg):
    _, _, images = seg
    jf, tf = JaxFastSAM(str(CKPT)), FastSAM(CKPT, device="cpu")
    return jf, tf, images


def test_fastsam_predict_equals_jax(fastsam):
    """FastSAM on the seg160 checkpoint: agnostic NMS at conf 0.4 by
    default, the same detections, contours and masks."""
    jf, tf, images = fastsam
    assert tf.task == "segment"
    jres, tres = jf.predict(images), tf.predict(images)
    _same_results(tres, jres)
    assert sum(len(r) for r in tres) > 0
    assert all(r.boxes.conf.min() >= 0.4 for r in tres if len(r))
    for t, j in zip(tres, jres):
        np.testing.assert_array_equal(t.masks.data, j.masks.data)


def _prompts(p, boxes):
    """Every prompt: boxes around the first detection and a small one; a
    foreground point at the first detection's centre, one on no mask, a
    background point at the last detection's centre; that background point
    first. (A background point on no mask makes JAX's ``point_prompt``
    raise, so none is given here.)"""
    first, last = boxes[0], boxes[-1]
    c0 = [(first[0] + first[2]) / 2, (first[1] + first[3]) / 2]
    c1 = [(last[0] + last[2]) / 2, (last[1] + last[3]) / 2]
    return {"everything": p.everything_prompt(),
            "box": p.box_prompt(first[:4] + np.array([-4, -4, 4, 4])),
            "box_small": p.box_prompt([3, 3, 13, 13]),
            "points": p.point_prompt([c0, [0, 0], c1], [1, 1, 0]),
            "bg_first": p.point_prompt([c1, c0], [0, 1])}


@pytest.mark.parametrize("boxes", [True, False], ids=["masks", "contours_only"])
def test_prompts_on_predicted_results_equal_jax(fastsam, boxes):
    """The prompts on FastSAM's results: from their masks (the cv2-rule
    fill, at the default ``boxes=True``), and from contours alone
    (``boxes=False``: ``_masks`` fills them by the even-odd rule, JAX's jnp
    fill)."""
    jf, tf, images = fastsam
    before = raster.fill_polygons.launches
    for img in images:
        jres, tres = jf.predict(img, boxes=boxes), tf.predict(img, boxes=boxes)
        jp, tp = JaxPrompt(img, jres), FastSAMPrompt(img, tres)
        assert (tres[0].masks is None) == (not boxes)
        np.testing.assert_array_equal(tp._masks(), jp._masks())
        if not len(tres[0]):
            continue
        got, want = _prompts(tp, tres[0].boxes.data), _prompts(jp, tres[0].boxes.data)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        with pytest.raises(ImportError):
            tp.text_prompt("a dog")
        with pytest.raises(NotImplementedError, match="plotting"):
            tp.plot()
    assert raster.fill_polygons.launches == before  # the CPU takes the plain version


def test_prompts_on_hand_built_results_equal_jax():
    """``tests/test_families.py``'s hand-built results (masks given)."""
    img = np.zeros((32, 32, 3), np.uint8)
    masks = np.zeros((2, 32, 32), bool)
    masks[0, 4:12, 4:12] = True
    masks[1, 20:30, 20:30] = True
    boxes = np.array([[4, 4, 12, 12, 0.9, 0], [20, 20, 30, 30, 0.8, 0]])
    jp = JaxPrompt(img, [JaxResults(img, "x.jpg", {0: "obj"}, boxes=boxes, masks=masks)])
    tp = FastSAMPrompt(img, [Results(img, "x.jpg", {0: "obj"}, boxes=boxes, masks=masks,
                                     device="cpu")])
    for name, args in (("everything_prompt", ()), ("box_prompt", ([3, 3, 13, 13],)),
                       ("point_prompt", ([[25, 25]], [1])),
                       ("point_prompt", ([[25, 25], [5, 5]], [1, 0]))):
        np.testing.assert_array_equal(getattr(tp, name)(*args), getattr(jp, name)(*args))
    np.testing.assert_array_equal(tp.box_prompt([3, 3, 13, 13])[0], masks[0])
    # a background point on no mask changes nothing (JAX's raises)
    np.testing.assert_array_equal(tp.point_prompt([[25, 25], [1, 1]], [1, 0])[0], masks[1])
    empty = FastSAMPrompt(img, [Results(img, "x.jpg", {0: "obj"}, boxes=np.zeros((0, 6)),
                                        device="cpu")])
    assert empty.box_prompt([0, 0, 5, 5]).shape == (0, 32, 32)


# --- YOLO-NAS ------------------------------------------------------------------

@pytest.mark.parametrize("c1,k", [(16, (5, 9, 13)), (12, (3, 5))])
def test_spp_matches(c1, k):
    want, got = _run_pair(jblock.SPP(24, k), tblock.SPP(c1, 24, k), _x(0, (2, 15, 13, c1)), 1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=MODULE_ATOL)


@pytest.mark.parametrize("c1,c2,shortcut", [(16, 16, True), (16, 16, False), (8, 16, True)])
def test_nas_bottleneck_matches(c1, c2, shortcut):
    """Two RepConvs; the identity added only where ``shortcut`` and the
    widths agree."""
    tmod = tblock.NASBottleneck(c1, c2, shortcut)
    assert tmod.add == (shortcut and c1 == c2)
    want, got = _run_pair(jblock.NASBottleneck(c2, shortcut), tmod, _x(2, (2, 9, 10, c1)), 3)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=MODULE_ATOL)


@pytest.mark.parametrize("n,shortcut", [(1, True), (3, False)])
def test_nascsp_matches(n, shortcut):
    """NASCSP's bottlenecks ``m.{i}`` carry JAX's ``m{i}``."""
    tmod = tblock.NASCSP(24, 32, n, shortcut)
    want, got = _run_pair(jblock.NASCSP(32, n, shortcut), tmod, _x(4, (2, 9, 11, 24)), 5)
    assert {k.split(".")[1] for k in tmod.state_dict() if k.startswith("m.")} == {
        str(i) for i in range(n)}
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=MODULE_ATOL)


def _jax_nas(cfg, imgsz=64, seed=21):
    jm = jbuild_model(cfg)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, imgsz, imgsz, 3)), train=False))
    return jm, _np(_randomize({k: shapes[k] for k in ("params", "batch_stats")}, seed))


def test_narrow_nas_graph_matches_jax():
    """The narrow graph at 64 px, JAX's weights drawn with numpy: every
    level's head map and the decode."""
    jm, v = _jax_nas(NARROW_NAS)
    x = np.random.default_rng(22).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.raw_forward(v, x))(v, jnp.asarray(x))
    tm = load_jax_variables(DetectionModel(NARROW_NAS), v["params"], v["batch_stats"]).eval()
    assert tm.strides == tuple(jm.strides) == (8, 16, 32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got, pred = tm(xt), tm.predict(xt)
    for g, w in zip(got, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=GRAPH_ATOL * scale)
    jpred = np.asarray(jm.decode(want))
    np.testing.assert_allclose(pred[:, 4:].numpy(), jpred[:, 4:], atol=GRAPH_ATOL)
    np.testing.assert_allclose(pred[:, :4].numpy(), jpred[:, :4], atol=GRAPH_ATOL * 64)


def test_narrow_nas_loss_and_gradients_match_jax_f64():
    """The narrow graph in train mode at imgsz 64, batch 2, both networks in
    float64 (in float32 the port's first-layer gradient leaves JAX's
    float64 one by 1.0e-3 of its largest: eight RepConv stages of float32
    sums): the detect loss and every parameter's gradient (loss 1e-4
    relative, gradients 1e-3 of each tensor's largest)."""
    jm, v = _jax_nas(NARROW_NAS, seed=31)
    images, batch = _det_batch(32, 2, 4)
    hyp = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5)
    with jax.enable_x64(True):
        jm64 = jbuild_model(NARROW_NAS, dtype=jnp.float64)
        v64 = _f64(v)
        fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm64, hyp), has_aux=True))
        (jl, _), jg = fn(v64["params"], v64["batch_stats"], jnp.asarray(images, jnp.float64),
                         {k: jnp.asarray(a) for k, a in batch.items()})
        jl, jg = float(jl), from_jax_variables(_np(jg), {})
    model = load_jax_variables(DetectionModel(NARROW_NAS), v["params"], v["batch_stats"])
    model = model.double().train()
    loss, items = tstep.make_loss_fn(model, hyp)(_t(images).double(),
                                                 {k: _t(a) for k, a in batch.items()})
    loss.backward()
    assert items["box_loss"].item() > 0
    np.testing.assert_allclose(loss.item(), jl, rtol=STEP_LOSS_RTOL)
    grads = dict(model.named_parameters())
    assert set(grads) == set(jg)
    for n, w in jg.items():
        err = float((grads[n].grad - w.double()).abs().max())
        assert err <= STEP_GRAD_TOL * float(w.abs().max()), (n, err)


def _count(tree):
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("scale", "sml")
def test_yolo_nas_config_and_counts_equal_jax(scale):
    """``yaml_model_load("yolo_nas_{s,m,l}")`` is JAX's config (its yaml
    file's path aside), the task detect; the full-width model at nc 2 has
    JAX's parameters and running statistics (``jax.eval_shape``), leaf by
    leaf through the name map."""
    name = f"yolo_nas_{scale}.yaml"
    want = dict(jyaml_model_load(name))
    want.pop("yaml_file")
    cfg = yaml_model_load(name)
    assert cfg == want and cfg["scale"] == scale and guess_model_task(cfg) == "detect"
    jm = jbuild_model(name, nc=2)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    model = build_model(cfg, nc=2)
    assert model.num_params == _count(shapes["params"])
    params, stats = to_jax_variables(model.state_dict())
    for got, want in ((params, shapes["params"]), (stats, shapes["batch_stats"])):
        flat = {jax.tree_util.keystr(p): tuple(x.shape)
                for p, x in jax.tree_util.tree_leaves_with_path(want)}
        assert {jax.tree_util.keystr(p): x.shape
                for p, x in jax.tree_util.tree_leaves_with_path(got)} == flat
    print(name, "parameters", model.num_params)


def test_nas_name_map_round_trip_and_fuse_equal_jax():
    """JAX's narrow NAS variables -> the port -> JAX again, exactly; the
    fused model's kernels and biases against JAX ``fuse_variables`` (the
    NASBottlenecks' RepConvs folded), and its heads against the unfused
    model's."""
    jm, v = _jax_nas(NARROW_NAS, seed=41)
    model = load_jax_variables(DetectionModel(NARROW_NAS), v["params"], v["batch_stats"]).eval()
    params, stats = to_jax_variables(model.state_dict())
    for a, b in ((params, v["params"]), (stats, v["batch_stats"])):
        la = dict(jax.tree_util.tree_leaves_with_path(a))
        lb = dict(jax.tree_util.tree_leaves_with_path(b))
        assert set(la) == set(lb)
        for k in lb:
            np.testing.assert_array_equal(la[k], lb[k])
    fvars, _ = jfuse.fuse_variables(jm, v)
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, fvars["params"]), {})
    x = torch.from_numpy(np.random.default_rng(42).uniform(0, 1, (2, 3, 64, 64))
                         .astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        fused = tfuse.fuse_model(copy.deepcopy(model))
        got = fused(x)
    sd = fused.state_dict()
    assert set(sd) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=PARAM_TOL, err_msg=k)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=FUSE_TOL, atol=FUSE_TOL)


def test_nas_facade():
    """``NAS`` names, a config and the detect task; a ``.pt`` raises as
    JAX's; a fresh yolo_nas_s (nc 2) predicts on the CPU."""
    from chip_smoke import fresh_nas

    model = NAS("yolo_nas_s", device="cpu")
    assert model.task == "detect" and model.overrides["model"] == "yolo_nas_s.yaml"
    assert NAS("yolo_nas_m.yaml", device="cpu").task == "detect"
    with pytest.raises(NotImplementedError, match="convert"):
        NAS("yolo_nas_s.pt")
    nas = fresh_nas(device="cpu")
    res = nas.predict(shape_images(1, 48, 64, seed=1), imgsz=64, conf=0.001)
    assert len(res) == 1 and res[0].boxes.data.shape[1] == 6
