"""The port's int8 seg160 model on the CPU against JAX's int8 record of the
same checkpoint, calibration and val set
(``tests/data/torch_port_int8_seg160.npz``, written by
``tests/torch_port_int8_record.py``; ``chip_smoke.py``'s int8 phase reads
it too): the calibration, the quantize counts, the int8 kernels and scales
against JAX's quantize of JAX's own fold, the int8 head on two frames, and
the validator's metrics on the floor set."""
import copy
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from chip_smoke import CKPT, INT8_IMGSZ, floor_val_set, int8_calib_batches, int8_record
from yolo_contour_regression_tpu.nn import fuse as jfuse
from yolo_contour_regression_tpu.nn import quant as jquant
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.nn import quant as tquant
from yolo_contour_regression_tpu_torch.nn.fuse import fuse_model
from yolo_contour_regression_tpu_torch.utils.checkpoint import (checkpoint_variables,
                                                                load_checkpoint,
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


ROOT = Path(__file__).resolve().parent.parent
FLOOR = json.loads((ROOT / "runs" / "floor_seg160" / "floor.json").read_text())
# calibration absmax and the scales against JAX's: the same f32 network and
# fold, their sums in other orders, relative
SCALE_RTOL = 1e-5
# the int8 head, of the head's largest value: with JAX's int8 tree the port
# computes JAX's int8 network (its float glue in another order); with its
# own, an x_scale or w_scale a few ulps off JAX's now and then rounds an
# input code to the other side of a .5 boundary, which moves the maps after
# it by about one code's worth
HEAD_TOL_JAX_TREE, HEAD_TOL_OWN = 1e-3, 5e-3
METRIC_ATOL = 0.01  # the int8 validator's metrics against JAX's record


@pytest.fixture(scope="module")
def run():
    """JAX's record, the calibration batches, the port's calibration of its
    CPU fold, the port's int8 facade (``quantize`` on the CPU), and JAX's
    int8 tree of its own fold with the record's calibration."""
    rec, calib = int8_record(), int8_calib_batches()
    handle = YOLO(CKPT, device="cpu")
    cal = tquant.calibrate(fuse_model(copy.deepcopy(handle.model)), calib)
    handle.quantize(calib)
    params, stats = checkpoint_variables(load_checkpoint(CKPT))
    jax_tree, *_ = jquant.quantize_tree(jfuse.fuse_tree(params, stats), rec["cal"])
    return {"rec": rec, "calib": calib, "cal": cal, "handle": handle,
            "jax_tree": jax.tree_util.tree_map(np.asarray, jax_tree)}


def test_record_is_jax_int8_of_seg160(run):
    """The record: its writer, JAX's counts (29 convs quantized, none
    skipped), and JAX's int8 metrics meeting the seg160 floor."""
    rec = run["rec"]
    assert rec["written_by"] == "tests/torch_port_int8_record.py"
    assert (rec["n_quantized"], rec["n_skipped"]) == (29, 0)
    assert rec["metrics"]["metrics/mAP50-95(M)"] >= FLOOR["floor"]["mask_mAP50-95"]
    assert rec["metrics"]["metrics/mAP50-95(B)"] >= FLOOR["floor"]["box_mAP50-95"]


def test_calibration_matches_record(run):
    """The port's calibration of the seg160 model: JAX's keys in JAX's
    order, its shape features, the absmax within ``SCALE_RTOL``; the port
    quantizes JAX's count."""
    got, want = run["cal"], run["rec"]["cal"]
    assert list(got) == list(want)
    for k in want:
        assert {f: v for f, v in got[k].items() if f != "absmax"} == \
            {f: v for f, v in want[k].items() if f != "absmax"}, k
        assert got[k]["absmax"] == pytest.approx(want[k]["absmax"], rel=SCALE_RTOL), k
    n_q = sum(isinstance(m, tquant.QuantConv2d) for m in run["handle"].model.modules())
    assert n_q == run["rec"]["n_quantized"]


def test_int8_kernels_match_jax_quantize(run):
    """The port's int8 kernels equal JAX's quantize of JAX's own fold (with
    the record's calibration) code for code, and its ``w_scale`` and
    ``x_scale`` are within ``SCALE_RTOL`` (the two folds and calibrations
    are a few ulps apart; the count of scales apart is printed)."""
    got, _ = to_jax_variables(run["handle"].model.state_dict())
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    want = dict(jax.tree_util.tree_leaves_with_path(run["jax_tree"]))
    assert got.keys() == want.keys()
    apart = 0
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        if w.dtype == np.int8:
            np.testing.assert_array_equal(got[k], w, err_msg=str(k))
        elif "scale" in str(k[-1]):
            np.testing.assert_allclose(got[k], w, rtol=SCALE_RTOL, err_msg=str(k))
            apart += int((got[k] != w).sum())
    print(f"w_scale and x_scale values apart from JAX's: {apart}")


def test_int8_heads_match_record(run):
    """The int8 head on the record's two frames: the port with JAX's int8
    tree within ``HEAD_TOL_JAX_TREE`` of the head's largest value, the
    port's own int8 model within ``HEAD_TOL_OWN``."""
    rec = run["rec"]
    x = torch.from_numpy(run["calib"][0][:rec["head_frames"]]).permute(0, 3, 1, 2).contiguous()
    jax_in_port = tquant.as_quantized_model(fuse_model(YOLO(CKPT, device="cpu").model),
                                            run["jax_tree"])
    scale = max(float(np.abs(h).max()) for h in rec["heads"])
    for model, tol in ((jax_in_port, HEAD_TOL_JAX_TREE), (run["handle"].model, HEAD_TOL_OWN)):
        with torch.no_grad():
            heads = model(x)
        assert len(heads) == len(rec["heads"])
        for g, w in zip(heads, rec["heads"]):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                       atol=tol * scale)


def test_int8_metrics_match_record(run):
    """``val`` of the port's int8 model on the floor set at 160, batch 4:
    each metric within ``METRIC_ATOL`` of JAX's int8 record, and the floor
    met where the record meets it."""
    images, labels = floor_val_set()
    got = run["handle"].val(images, labels, imgsz=INT8_IMGSZ, batch=4)
    want = run["rec"]["metrics"]
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])
    for key, floor in (("metrics/mAP50-95(M)", "mask_mAP50-95"),
                       ("metrics/mAP50-95(B)", "box_mAP50-95")):
        if want[key] >= FLOOR["floor"][floor]:
            assert got[key] >= FLOOR["floor"][floor], key
