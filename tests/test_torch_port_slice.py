"""The PyTorch port's predict slice against the JAX predictor on the
committed yolov8n-seg checkpoint (``runs/floor_seg160/best.ckpt``, scale n
at full width, nc=2), on the CPU, and the weight map's coverage of it."""
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import shape_images
from yolo_contour_regression_tpu.cfg import get_cfg
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.engine.predictor import (
    SegmentationPredictor as JaxPredictor)
from yolo_contour_regression_tpu.ops.nms import non_max_suppression_parts as jnms
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine.predictor import SegmentationPredictor
from yolo_contour_regression_tpu_torch.nn.tasks import SegmentationModel
from yolo_contour_regression_tpu_torch.ops.polar import VALID_RAY_THRESH
from yolo_contour_regression_tpu_torch.utils.checkpoint import (
    checkpoint_variables, from_jax_variables, load_checkpoint, load_jax_variables)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

CKPT = Path(__file__).resolve().parent.parent / "runs" / "floor_seg160" / "best.ckpt"
IMGSZ = 160
# f32 on both sides; conv sums in other orders (XLA CPU vs oneDNN)
HEAD_ATOL = 1e-3
PX_ATOL = 0.05  # boxes and contour points, px
SCORE_ATOL = 1e-4
RAY_GATE = 1e-4  # a ray this close to VALID_RAY_THRESH may flip its flag


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_weights_cover_checkpoint_exactly_once():
    """Every JAX parameter and batch stat of the checkpoint maps to one
    port key, every port parameter and running stat is set from it, and the
    port has the checkpoint's 4,271,698 parameters."""
    ckpt = load_checkpoint(CKPT)
    params, bstats = checkpoint_variables(ckpt)
    sd = from_jax_variables(params, bstats)
    assert len(sd) == len(_leaves(params)) + len(_leaves(bstats))
    model = SegmentationModel(ckpt["model_yaml"])
    want = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == want
    assert model.num_params == sum(np.size(p) for p in _leaves(params)) == 4_271_698
    load_jax_variables(model, params, bstats)
    got = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    # HWIO -> OIHW and the RepConv renames
    np.testing.assert_array_equal(
        got["model.0.conv1.conv.weight"].numpy(),
        params["layer0"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got["model.2.cv1.bn.running_var"].numpy(),
                                  bstats["layer2"]["cv1"]["bn_id"]["var"])
    np.testing.assert_array_equal(got["model.22.cv3.1.2.bias"].numpy(),
                                  params["layer22"]["cv3_1_2"]["bias"])


@pytest.fixture(scope="module")
def models():
    jy = JaxYOLO(str(CKPT))
    ty = YOLO(CKPT, device="cpu")
    return jy, ty


def test_slice_matches_jax_predictor(models):
    """Same letterboxed uint8 input into both predictors: head outputs,
    detections, classes, scores, boxes, contours and ray flags agree."""
    jy, ty = models
    jpred = JaxPredictor(get_cfg(overrides={"mode": "predict", "conf": 0.25, "imgsz": IMGSZ}))
    jeval = jpred._build_eval(jy.model)
    kw = dict(conf_thres=0.25, iou_thres=0.7, pre_nms=1024, max_det=300)
    jrays_fn = jax.jit(lambda v, x: jnms(*jy.model.predict_parts(v, x, sigmoid=False),
                                         scores_are_logits=True, **kw))
    tpred = SegmentationPredictor(imgsz=IMGSZ)
    images = shape_images(3, 120, 200, seed=3) + shape_images(2, 160, 96, seed=4)
    n_total = 0
    for i, img in enumerate(images):
        x, gain, pad = jpred.preprocess_u8(img, IMGSZ)
        xf = x[None].astype(np.float32) / 255.0
        # head outputs
        jh = jax.jit(jy.model.raw_forward)(jy.variables, jnp.asarray(xf))
        with torch.no_grad():
            th = ty.model(torch.from_numpy(xf).permute(0, 3, 1, 2))
        for t, j in zip(th, jh):
            np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(j),
                                       atol=HEAD_ATOL)
        # detections after NMS and postprocess
        jout = {k: np.asarray(v) for k, v in jeval(jy.variables, jnp.asarray(x[None])).items()}
        jres = jpred.postprocess(jout, 0, img, f"a{i}", gain, pad, jy.names)
        tout = tpred.eval_batch(ty.model, torch.from_numpy(x[None]))
        tout = {k: v.numpy() for k, v in tout.items()}
        tres = tpred.postprocess(tout, 0, img, f"a{i}", gain, pad, ty.names, "cpu")
        assert len(tres) == len(jres)
        n_total += len(tres)
        np.testing.assert_array_equal(tres.boxes.cls, jres.boxes.cls)
        np.testing.assert_allclose(tres.boxes.conf, jres.boxes.conf, atol=SCORE_ATOL)
        np.testing.assert_allclose(tres.boxes.xyxy, jres.boxes.xyxy, atol=PX_ATOL)
        np.testing.assert_allclose(tres.contours.points, jres.contours.points, atol=PX_ATOL)
        jrays = np.asarray(jrays_fn(jy.variables, jnp.asarray(xf))["extras"])[0, :len(jres), :36]
        near = np.abs(jrays - VALID_RAY_THRESH) <= RAY_GATE
        np.testing.assert_array_equal(tres.contours.valid[~near], jres.contours.valid[~near])
    assert n_total >= len(images)  # every image has its shapes found


def test_yolo_predict_end_to_end_cpu(models):
    """The port's own letterbox and batching: the same detections as the JAX
    facade, boxes within the slice's 0.05 px, and the same masks pixel for
    pixel (both letterboxes resize as cv2 does, and the port's facade fills
    by the JAX facade's cv2.fillPoly rule)."""
    jy, ty = models
    images = shape_images(3, 120, 200, seed=5)
    tres = ty.predict(images, batch=2)  # imgsz 160 from the checkpoint's train args
    jres = jy.predict(images)
    assert [len(r) for r in tres] == [len(r) for r in jres]
    for t, j in zip(tres, jres):
        np.testing.assert_array_equal(t.boxes.cls, j.boxes.cls)
        np.testing.assert_allclose(t.boxes.xyxy, j.boxes.xyxy, atol=PX_ATOL)
        tm, jm = t.masks.data, j.masks.data
        assert tm.shape == jm.shape == (len(t),) + images[0].shape[:2]
        np.testing.assert_array_equal(tm, jm)
