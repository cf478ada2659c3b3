"""The port's ``AutoBackend`` (``nn/autobackend.py``) on the CPU: a
``.ckpt`` (fused), a ``.yaml`` (the facade's lazy weights), a ``.pt``
(Ultralytics-style, converted to a ``.ckpt`` beside it) and a ``.pt2``
(the exporter's) each give the facade's predict of the same weights bit for
bit; the ``.pt`` and the ``.ckpt`` of the same weights give equal outputs;
``.onnx`` raises naming onnxruntime and ``cv2.dnn`` (JAX's two consumers),
as do JAX's artifacts and the TensorFlow ones; an unknown suffix is a
``ValueError``."""
from pathlib import Path

import numpy as np
import pytest

import torch

from chip_smoke import ultralytics_pt
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.nn.autobackend import AutoBackend
from yolo_contour_regression_tpu_torch.nn.fuse import fuse_model

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs" / "floor_seg160" / "best.ckpt"
DETECT_CKPT = ROOT / "runs" / "floor_detect" / "best.ckpt"
IMGSZ = 64


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads beside the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def image(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random((1, 3, IMGSZ, IMGSZ), np.float32)


def fused_predict(model, x):
    with torch.no_grad():
        return fuse_model(model).predict(torch.from_numpy(x))


@pytest.mark.parametrize("ckpt", [CKPT, DETECT_CKPT])
def test_ckpt_is_the_fused_predict(ckpt):
    b = AutoBackend(ckpt, device="cpu")
    assert b.fmt == "ckpt" and b.names == YOLO(ckpt, device="cpu").names
    x = image()
    assert torch.equal(b(x), fused_predict(YOLO(ckpt, device="cpu").model, x))


def test_yaml_is_the_fresh_facade():
    """A config runs unfused, on the weights a fresh facade draws."""
    b = AutoBackend("yolov8n-seg.yaml", device="cpu")
    m = YOLO("yolov8n-seg.yaml", device="cpu")
    x = image(1)
    with torch.no_grad():
        want = m._weights().predict(torch.from_numpy(x))
    assert b.fmt == "yaml" and torch.equal(b(x), want)


def test_pt_and_ckpt_of_the_same_weights(tmp_path):
    """An Ultralytics-style ``.pt`` of seeded weights (``ultralytics_pt``:
    classes that cannot be imported) is converted to a ``.ckpt`` beside it
    and gives the outputs of the facade's ``.ckpt`` of the same weights."""
    m = YOLO("yolov8n-seg.yaml", device="cpu")
    ckpt = m.save(tmp_path / "seeded.ckpt")
    pt = ultralytics_pt(m.model.state_dict(), tmp_path / "seeded_ultralytics.pt")
    b_pt, b_ckpt = AutoBackend(pt, device="cpu"), AutoBackend(ckpt, device="cpu")
    assert (tmp_path / "seeded_ultralytics.ckpt").exists()
    x = image(2)
    assert torch.equal(b_pt(x), b_ckpt(x))


@pytest.fixture(scope="module")
def detect_pt2(tmp_path_factory):
    """The detect checkpoint's facade and its ``.pt2`` exported on the CPU."""
    m = YOLO(DETECT_CKPT, device="cpu")
    return m, m.export(imgsz=IMGSZ, project=str(tmp_path_factory.mktemp("pt2")))


def test_pt2_is_the_fused_predict(detect_pt2):
    """The exporter's ``.pt2`` on the device in its sidecar; the names from
    the sidecar."""
    m, path = detect_pt2
    b = AutoBackend(path, device="cpu")
    assert b.fmt == "pt2" and b.device == torch.device("cpu")
    assert {int(k): v for k, v in b.names.items()} == m.names
    x = image(3)
    assert torch.equal(b(x), fused_predict(m.model, x))


def test_pt2_refuses_another_device(detect_pt2):
    """A ``.pt2`` exported on the CPU and asked for on the card raises,
    naming both devices, where it would otherwise run on the CPU."""
    with pytest.raises(ValueError, match="exported for cpu.*asked for cuda"):
        AutoBackend(detect_pt2[1], device="cuda")


@pytest.mark.parametrize("suffix,needle", [(".onnx", "onnxruntime.*cv2.dnn"),
                                           (".stablehlo", "JAX package"),
                                           (".tflite", "tensorflow"), (".pb", "tensorflow"),
                                           ("_saved_model", "tensorflow")])
def test_formats_the_port_does_not_run(tmp_path, suffix, needle):
    path = tmp_path / f"m{suffix}"
    path.write_bytes(b"")
    with pytest.raises(NotImplementedError, match=needle):
        AutoBackend(path, device="cpu")


def test_onnx_export_is_refused_by_name(tmp_path):
    """The port's own ONNX file: refused, pointing at onnxruntime and
    cv2.dnn."""
    path = YOLO(DETECT_CKPT, device="cpu").export(format="onnx", imgsz=IMGSZ,
                                                  project=str(tmp_path))
    with pytest.raises(NotImplementedError, match="onnxruntime"):
        AutoBackend(path, device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        AutoBackend(tmp_path / "m.engine", device="cpu")
