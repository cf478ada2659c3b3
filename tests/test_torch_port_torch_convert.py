"""The port's Ultralytics ``.pt`` converter (``utils/torch_convert.py``)
against the JAX package's on the CPU: ``convert_state_dict`` on synthetic
state dicts with the reference's names (``tests/test_torch_convert.py``'s
inverse naming, every learnable tensor of each config) onto the same target
weights gives the state dict of ``from_jax_variables`` of JAX's result, key
for key and bit for bit, and JAX's report; the port's own state dict, which
carries the reference's names, comes back whole; the tolerant unpickler
reads a ``.pt`` whose classes cannot be imported; ``convert_torch_checkpoint``
writes a checkpoint that both packages load, with the converted weights;
SAM's official names load through ``convert_sam_state_dict``."""
import copy

import numpy as np
import pytest

import jax
import torch

from chip_smoke import ultralytics_pt
from tests.test_torch_convert import _inverse_name
from tests.test_torch_port_onnx import narrow
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.utils import torch_convert as jconvert
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.nn.tasks import build_model, init_weights
from yolo_contour_regression_tpu_torch.utils import torch_convert as tconvert
from yolo_contour_regression_tpu_torch.utils.checkpoint import (from_jax_variables,
                                                                to_jax_variables)

CONFIGS = {"segment": ("yolov8n-seg.yaml", 3), "detect": ("yolov8n.yaml", 2),
           "pose": ("yolov8n-pose.yaml", None), "segment_ori": ("yolov8n-segori.yaml", 3),
           "classify": ("yolov8n-cls.yaml", 2), "yolov6": ("yolov6n.yaml", 2)}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads beside the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def synthetic_state(variables, seed: int = 0):
    """A reference-named state dict of random arrays, one per leaf of the
    JAX-form ``variables`` (``tests/test_torch_convert.py``'s inverse
    naming: RepConv's branches nested, OIHW kernels, (out, in) Linear)."""
    rng = np.random.default_rng(seed)
    state = {}
    rep = {"conv1": ["conv1", "conv"], "bn1": ["conv1", "bn"], "conv2": ["conv2", "conv"],
           "bn2": ["conv2", "bn"], "bn_id": ["bn"]}

    def emit(tree, coll, path=()):
        for k, val in tree.items():
            if isinstance(val, dict):
                emit(val, coll, path + (k,))
                continue
            toks = _inverse_name(path)
            leaf = {("params", "kernel"): "weight", ("params", "scale"): "weight",
                    ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
                    ("batch_stats", "var"): "running_var"}[(coll, k)]
            if toks and toks[-1] in rep and path[-2:] != ("proto",):
                toks = toks[:-1] + rep[toks[-1]]
            arr = rng.normal(size=np.asarray(val).shape).astype(np.float32)
            if k == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            state["model." + ".".join(toks + [leaf])] = arr

    emit(variables["params"], "params")
    emit(variables["batch_stats"], "batch_stats")
    return state


def seeded_model(name: str, nc, seed: int = 0):
    return init_weights(build_model(narrow(name, nc)), torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_convert_state_dict_equals_jax(case):
    """Onto the same target weights, the port's state dict is
    ``from_jax_variables`` of JAX's converted variables, key for key and
    bit for bit, and the reports are JAX's."""
    model = seeded_model(*CONFIGS[case])
    params, stats = to_jax_variables(model.state_dict())
    state = synthetic_state({"params": params, "batch_stats": stats}, seed=1)
    got, report = tconvert.convert_state_dict(state, model)
    jvars, jreport = jconvert.convert_state_dict(
        state, {"params": copy.deepcopy(params), "batch_stats": copy.deepcopy(stats)})
    assert report == jreport
    assert report["converted"] > 0
    want = from_jax_variables(jvars["params"], jvars["batch_stats"])
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", ["segment", "detect", "pose"])
def test_the_ports_own_names_round_trip(case):
    """The port's state dict (the reference's names) converted onto a model
    of other weights gives it back: every tensor placed, none missed."""
    src = seeded_model(*CONFIGS[case], seed=3)
    state = {k: v.numpy() for k, v in src.state_dict().items()}
    got, report = tconvert.convert_state_dict(state, seeded_model(*CONFIGS[case], seed=4))
    assert not report["missed"] and not report["unmatched_target"], report
    want = src.state_dict()
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def test_tolerant_unpickler_and_end_to_end(tmp_path):
    """A ``.pt`` holding modules of a class that cannot be imported loads
    through stubs (``load_torch_checkpoint``, ``extract_state_dict``: the
    reference's names); ``convert_torch_checkpoint`` writes a checkpoint
    that the port's ``YOLO`` and JAX's load, with every converted weight in
    place (JAX's reads the same leaves)."""
    src = seeded_model("yolov8n-seg.yaml", 3, seed=5)
    pt = ultralytics_pt(src.state_dict(), tmp_path / "last.pt")
    ckpt = tconvert.load_torch_checkpoint(pt)
    assert ckpt["epoch"] == 7 and type(ckpt["model"]).__name__ == "Node"
    state = tconvert.extract_state_dict(ckpt)
    assert state.keys() == {k for k in src.state_dict()}
    assert all(np.array_equal(state[k], v.numpy()) for k, v in src.state_dict().items())
    out, report = tconvert.convert_torch_checkpoint(pt, src.yaml, out_path=str(tmp_path / "m.ckpt"))
    assert not report["missed"] and not report["unmatched_target"]
    y = YOLO(out, device="cpu")
    assert y.model.nc == 3
    for k, v in y.model.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
    jy = JaxYOLO(out)
    assert jy.model.nc == 3
    params, _ = to_jax_variables(src.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(jy.variables["params"]))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)


def test_convert_sam_state_dict_loads_official_names():
    """SAM's official state dict loads by name (the port's SAM carries the
    official keys), MobileSAM's classifier head skipped; a missing tensor
    raises when strict."""
    from yolo_contour_regression_tpu_torch.models.sam.model import SAM

    src = SAM("mobile_sam", img_size=64, device="cpu").model
    dst = SAM("mobile_sam", img_size=64, device="cpu").model
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.5)
    state = {k: v.clone() for k, v in src.state_dict().items()}
    state["image_encoder.head.weight"] = torch.zeros(3, 3)
    _, report = tconvert.convert_sam_state_dict(state, dst)
    assert report["skipped"] == ["image_encoder.head.weight"] and not report["missed"]
    for k, v in dst.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
    state.pop("mask_decoder.iou_token.weight")
    with pytest.raises(RuntimeError, match="iou_token"):
        tconvert.convert_sam_state_dict(state, dst)
