"""SAM's predictor and everything mode in the PyTorch port against the JAX
package, on the CPU: ``set_image`` and ``predict`` with points, a box and
a mask prompt (sam_b at full width, img_size 64, JAX's variables carried
over), ``amg.py``'s functions, ``remove_small_regions`` against JAX's
(which calls cv2) and the 8-connected labelling against cv2 itself,
``generate`` on a torch copy of JAX's stub decoder (exactly equal at crop
layers 0 and 1 with the small-region cleanup) and on sam_b, the
antialiased shrink, and the ``SAM`` facade."""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_sam_generate import HQ, OBJECTS, S
from tests.test_sam_generate import StubSam as JaxStub
from tests.test_torch_port_cuda import STUB_OBJECTS, STUB_S, StubSam
from tests.test_torch_port_sam import close, randomized, state_from_jax
from yolo_contour_regression_tpu.models.sam import Predictor as JaxPredictor
from yolo_contour_regression_tpu.models.sam import Sam as JaxSam
from yolo_contour_regression_tpu.models.sam import amg as jamg
from yolo_contour_regression_tpu_torch import SAM
from yolo_contour_regression_tpu_torch.models.sam import Predictor, Sam
from yolo_contour_regression_tpu_torch.models.sam import amg

IOU_ATOL = SCORE_ATOL = 1e-4
LOGIT_RTOL = 1e-3
THRESH_BAND = 1e-4  # a pixel whose logit lies this close to 0 may flip


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("crop_n_layers", [0, 1])
def test_generate_on_the_stub_exact(crop_n_layers):
    """Masks, scores and boxes exactly JAX's, with the small-region cleanup
    on (a planted island and a hole in the image make no difference to the
    stub: it answers from the prompt point alone)."""
    assert (STUB_S, STUB_OBJECTS, StubSam.img_size) == (S, OBJECTS, S) and HQ == S // 4
    img = np.full((S, S, 3), 127, np.uint8)
    kw = dict(crop_n_layers=crop_n_layers, points_stride=16, points_batch_size=24,
              conf_thres=0.5, min_mask_region_area=20)
    want = JaxPredictor(JaxStub()).generate(img, **kw)
    got = Predictor(StubSam()).generate(img, **kw)
    assert len(got[0]) >= len(OBJECTS)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def sam_b():
    """sam_b at full width at img_size 64, random variables of JAX's shapes
    carried over (``tests/test_torch_port_sam.py:randomized``)."""
    js = JaxSam("sam_b", img_size=64)
    rng = np.random.default_rng(11)
    js.variables = randomized(jax.eval_shape(js.init, jax.random.PRNGKey(0)), rng, noise=0.05)
    port = Sam("sam_b", img_size=64, seed=None)
    port.load_state_dict(state_from_jax(port, js.variables))
    return JaxPredictor(js), Predictor(port, device="cpu")


def _frame_logits(low, h, w, s=64):
    """JAX's full-resolution logits of low-res ones (cv2, as its predict)."""
    r = min(s / h, s / w)
    return np.stack([cv2.resize(cv2.resize(m, (s, s))[:round(h * r), :round(w * r)], (w, h))
                     for m in low])


def test_set_image_and_predict(sam_b):
    """The resized RGB input byte-equal to cv2's (before normalizing); then
    points, a box, and a point with the previous call's low-res logits as
    the mask prompt: low-res logits within 1e-3 of their largest, IoU
    1e-4, masks equal except pixels at the threshold (counted)."""
    jp, tp = sam_b
    img = np.random.default_rng(12).integers(0, 256, (48, 56, 3), dtype=np.uint8)
    jp.set_image(img)
    tp.set_image(img)
    r = min(64 / 48, 64 / 56)
    want_u8 = cv2.cvtColor(cv2.resize(img, (round(56 * r), round(48 * r))), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(tp.input_u8, want_u8)
    close(tp._emb.permute(0, 2, 3, 1), jp._emb, 1e-4)
    flips = {}
    prev = None
    cases = {"point": dict(point_coords=[[28, 24]], point_labels=[1]),
             "box": dict(box=[5, 5, 40, 40]),
             "points_bg": dict(point_coords=[[28, 24], [5, 40]], point_labels=[1, 0])}
    for name, kw in cases.items():
        wm, wi, wl = jp.predict(**kw, return_logits=True)
        gm, gi, gl = tp.predict(**kw, return_logits=True)
        close(gl, wl, LOGIT_RTOL)
        np.testing.assert_allclose(gi, wi, atol=IOU_ATOL)
        diff = gm != wm
        assert not (diff & (np.abs(_frame_logits(wl, 48, 56)) > THRESH_BAND)).any(), name
        flips[name] = int(diff.sum())
        prev = wl[int(np.argmax(wi))]
    wm, wi, wl = jp.predict(point_coords=[[28, 24]], point_labels=[1], mask_input=prev,
                            return_logits=True)
    gm, gi, gl = tp.predict(point_coords=[[28, 24]], point_labels=[1], mask_input=prev,
                            return_logits=True)
    close(gl, wl, LOGIT_RTOL)
    np.testing.assert_allclose(gi, wi, atol=IOU_ATOL)
    assert not ((gm != wm) & (np.abs(_frame_logits(wl, 48, 56)) > THRESH_BAND)).any()
    flips["mask_input"] = int((gm != wm).sum())
    print("mask pixels at the threshold that differ:", flips)


def test_generate_on_sam_b(sam_b):
    """Everything mode on sam_b at 64 with thresholds that keep masks: the
    same kept masks (pixels at the threshold counted), boxes and scores."""
    jp, tp = sam_b
    img = np.random.default_rng(13).integers(0, 256, (48, 56, 3), dtype=np.uint8)
    kw = dict(points_stride=4, points_batch_size=8, conf_thres=-1e9,
              stability_score_thresh=-1.0, iou_thres=1.0)
    wm, ws, wb = jp.generate(img, **kw)
    gm, gs, gb = tp.generate(img, **kw)
    assert len(wm) > 1 and gm.shape == wm.shape
    np.testing.assert_allclose(gs, ws, atol=SCORE_ATOL)
    np.testing.assert_array_equal(gb, wb)
    print("kept", len(gm), "masks; differing pixels", int((gm != wm).sum()))
    assert (gm != wm).mean() < 1e-3


def test_amg_helpers_equal_jax():
    rng = np.random.default_rng(14)
    for n in (1, 4, 16, 32):
        np.testing.assert_array_equal(amg.point_grid(n), jamg.point_grid(n))
    for args in ((32, 1, 1), (16, 2, 2)):
        for a, b in zip(amg.build_all_layer_point_grids(*args),
                        jamg.build_all_layer_point_grids(*args)):
            np.testing.assert_array_equal(a, b)
    for hw, n in (((480, 640), 1), ((100, 200), 2), ((64, 64), 1)):
        assert amg.generate_crop_boxes(hw, n) == jamg.generate_crop_boxes(hw, n)
    logits = rng.normal(0, 2, (6, 3, 16, 16)).astype(np.float32)
    # the port's score is float32 on the device, as JAX's device filter in
    # ``generate``: JAX's float64 host score rounded to float32 (exact:
    # the rounding of a quotient of integers through float64 is innocuous)
    np.testing.assert_array_equal(
        amg.stability_score(torch.from_numpy(logits), 0.0, 0.95).numpy(),
        jamg.stability_score(logits, 0.0, 0.95).astype(np.float32))
    masks = rng.random((12, 13, 17)) > 0.85
    masks[3] = False
    np.testing.assert_array_equal(amg.batched_mask_to_box(masks), jamg.batched_mask_to_box(masks))
    boxes = rng.uniform(0, 100, (40, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    np.testing.assert_array_equal(
        amg.is_box_near_crop_edge(boxes, [10, 10, 90, 90], [0, 0, 200, 200], 15.0),
        jamg.is_box_near_crop_edge(boxes, [10, 10, 90, 90], [0, 0, 200, 200], 15.0))
    scores = np.round(rng.random(40), 1).astype(np.float32)  # ties break as numpy's argsort
    for thr in (0.3, 0.7):
        np.testing.assert_array_equal(amg.nms_boxes(boxes, scores, thr),
                                      jamg.nms_boxes(boxes, scores, thr))


def _random_masks(rng, n=24, h=37, w=45):
    """Blobs of several sizes with holes and specks, and two masks full and
    empty."""
    out = []
    for i in range(n):
        m = rng.random((h, w)) < rng.uniform(0.3, 0.7)
        m = cv2.dilate(m.astype(np.uint8), np.ones((3, 3), np.uint8),
                       iterations=int(rng.integers(0, 3))).astype(bool)
        out.append(m)
    out.append(np.ones((h, w), bool))
    out.append(np.zeros((h, w), bool))
    return out


def test_labelling_equals_cv2():
    """8-connected components, labels in cv2's order, areas cv2's."""
    for m in _random_masks(np.random.default_rng(15)):
        n, labels, areas = amg.label_components(m)
        cn, clabels, stats, _ = cv2.connectedComponentsWithStats(m.astype(np.uint8), 8)
        assert n == cn
        np.testing.assert_array_equal(labels, clabels)
        np.testing.assert_array_equal(areas, stats[:, -1])


@pytest.mark.parametrize("mode", ["holes", "islands"])
def test_remove_small_regions_equals_jax(mode):
    for m in _random_masks(np.random.default_rng(16)):
        for thr in (1, 3, 10, 50, 5000):
            got = amg.remove_small_regions(m, thr, mode)
            want = jamg.remove_small_regions(m, thr, mode)
            assert got[1] == want[1]
            np.testing.assert_array_equal(got[0], want[0])


def test_predictor_remove_small_regions_equals_jax():
    masks = np.stack(_random_masks(np.random.default_rng(17), n=10))
    got = Predictor.remove_small_regions(masks, 12)
    want = JaxPredictor.remove_small_regions(masks, 12)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("size", [(5, 7), (40, 50), (100, 30), (16, 16), (200, 150)],
                         ids=["shrink_both", "grow_both", "one_down", "same", "grow"])
def test_antialiased_resize_equals_jax(size):
    """``jax.image.resize(..., "bilinear")`` antialiases where it shrinks:
    a crop smaller than the 16x16 low-res grid in one or both axes."""
    x = np.random.default_rng(18).normal(0, 3, (3, 16, 16)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, *size), "bilinear"))
    got = amg.resize_bilinear(torch.from_numpy(x), *size).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert ((got > 0) != (want > 0)).sum() == 0


def test_predictor_defaults_to_the_card():
    """``Predictor`` moves a module model to ``device``, the card unless the
    caller asks for the CPU (here, with no card, the move raises: nothing
    falls back to the CPU); a stub that is no module keeps its device."""
    model = Sam("sam_b", img_size=64, seed=None)
    assert Predictor(model, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            Predictor(model)
    assert Predictor(StubSam()).device.type == "cpu"


def test_sam_facade():
    """``SAM`` on the CPU: prompts give three masks of the frame and their
    IoU; no prompt runs everything mode; ``generate`` gives boxes; ``info``
    counts the parameters; a file path is refused (decoding is not
    ported)."""
    sam = SAM("sam_b", img_size=64, device="cpu")
    img = np.full((48, 56, 3), 128, np.uint8)
    masks, iou = sam.predict(img, points=[[28, 24]], labels=[1])
    assert masks.shape == (3, 48, 56) and iou.shape == (3,)
    masks, iou = sam.predict(img, bboxes=[5, 5, 40, 40])
    assert masks.shape == (3, 48, 56)
    kw = dict(points_stride=4, conf_thres=-1e9, stability_score_thresh=-1.0)
    m, s = sam.predict(img, **kw)
    m2, s2, b2 = sam.generate(img, **kw)
    assert m.shape[1:] == (48, 56) and len(m) == len(s) == len(b2)
    np.testing.assert_array_equal(m, m2)
    assert sam.info()["parameters"] == sam.model.num_params
    with pytest.raises(TypeError, match="decoding"):
        sam.predict("image.jpg", points=[[1, 1]], labels=[1])
