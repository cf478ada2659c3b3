"""The port's exporter (``engine/exporter.py``), the facade's ``export`` and
``yolo export`` against the JAX package's on the CPU: on a fused
checkpoint, ``YOLO(path).export(format="onnx")`` writes JAX's facade's file
but for the metadata's ``description`` (the sidecar too); the
CLI writes the facade's file; the ``pt2`` artifact (a ``torch.export``
program) reloads equal to the fused predict bit for bit for every task, a
fresh config's lazy weights included, and the facade's model stays
unfused; ``nms=True`` raises for ``pt2`` and is dropped with a warning for
``onnx``; every other format raises with its recipe; ``dump_prediction``
writes JAX's bytes; and a fresh facade predicts, validates, fuses, saves
and exports without ``train``."""
import json
import logging
from pathlib import Path

import numpy as np
import pytest

import torch

from chip_smoke import floor_val_set, shape_images
from yolo_contour_regression_tpu.engine import exporter as jexporter
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.cfg import entrypoint
from yolo_contour_regression_tpu_torch.engine import exporter as texporter
from yolo_contour_regression_tpu_torch.nn.fuse import fuse_model

ROOT = Path(__file__).resolve().parent.parent
CKPTS = {"seg160": ROOT / "runs" / "floor_seg160" / "best.ckpt",
         "detect": ROOT / "runs" / "floor_detect" / "best.ckpt",
         "pose": ROOT / "runs" / "floor_pose" / "best.ckpt",
         "segment_ori": ROOT / "tests" / "data" / "torch_port_segori_narrow64.ckpt",
         "classify": ROOT / "runs" / "floor_classify" / "best.ckpt",
         "rtdetr": ROOT / "runs" / "floor_rtdetr" / "best.ckpt"}
IMGSZ = 64


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads beside the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _varint(buf: bytes, i: int):
    out = shift = 0
    while True:
        b = buf[i]
        out |= (b & 0x7F) << shift
        i += 1
        if b < 0x80:
            return out, i
        shift += 7


def proto_fields(buf: bytes) -> list:
    """The top-level fields of a protobuf message: (number, payload)."""
    out, i = [], 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _varint(buf, i)
        elif wire == 2:
            n, i = _varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"wire type {wire}")
        out.append((num, v))
    return out


def onnx_parts(buf: bytes):
    """A ModelProto -> (its fields but the metadata, the metadata as a dict)."""
    fields = proto_fields(buf)
    meta = {}
    for num, payload in fields:
        if num == 14:
            kv = dict(proto_fields(payload))
            meta[kv[1].decode()] = kv[2].decode()
    return [f for f in fields if f[0] != 14], meta


@pytest.mark.parametrize("name", ["seg160", "detect"])
def test_facade_onnx_equals_jax_but_the_description(tmp_path, name):
    """``YOLO(path).export(format="onnx")`` against JAX's facade on the same
    fused checkpoint (``deploy == "fused"``, which both exporters take as
    it is; the port's facade fused and saved it): every field of the file
    equal, and every metadata entry but ``description`` (the graph's own
    keys and the exporter's); the sidecar's keys and values too."""
    path = YOLO(CKPTS[name], device="cpu").fuse().save(tmp_path / f"{name}_fused.ckpt")
    got = YOLO(path, device="cpu").export(format="onnx", imgsz=IMGSZ, project=str(tmp_path / "t"))
    want = JaxYOLO(str(path)).export(format="onnx", imgsz=IMGSZ, project=str(tmp_path / "j"))
    assert Path(got).name == Path(want).name == f"{name}_fused.onnx"
    (gf, gm), (wf, wm) = (onnx_parts(Path(p).read_bytes()) for p in (got, want))
    assert gf == wf
    assert gm.keys() == wm.keys() and "description" in gm
    assert {k: v for k, v in gm.items() if k != "description"} == \
        {k: v for k, v in wm.items() if k != "description"}
    task = "segment" if name == "seg160" else "detect"
    assert json.loads(gm["description"]) == f"{name}_fused ({task}) PyTorch export"
    sg, sw = (json.loads(Path(p).with_suffix(".metadata.json").read_text()) for p in (got, want))
    assert sg.pop("description") != sw.pop("description") and sg == sw


def test_cli_export_writes_the_facade_file(tmp_path):
    """``yolo export model=... format=onnx imgsz=64`` writes the file that
    ``YOLO(...).export(format="onnx", imgsz=64)`` writes."""
    ckpt = CKPTS["seg160"]
    want = YOLO(ckpt, device="cpu").export(format="onnx", imgsz=IMGSZ, project=str(tmp_path / "f"))
    assert entrypoint(["export", f"model={ckpt}", "format=onnx", f"imgsz={IMGSZ}", "device=cpu",
                       f"project={tmp_path / 'c'}"]) == 0
    got = tmp_path / "c" / "best.onnx"
    assert got.read_bytes() == Path(want).read_bytes()


@pytest.mark.parametrize("name", ["yolov8n-seg.yaml", "detect", "segment_ori", "classify",
                                  "rtdetr"])
def test_pt2_reloads_equal_to_the_fused_predict(tmp_path, name):
    """The default format: a ``.pt2`` that ``load_pt2`` runs bit for bit as
    the fused predict (a fresh config's lazy weights, and the detect,
    segment_ori (two outputs), classify and RT-DETR (its cached anchors and
    positions) checkpoints); the facade's own model is not fused; the
    sidecar names the layout and the device."""
    m = YOLO(CKPTS.get(name, name), device="cpu")
    path = m.export(imgsz=IMGSZ, project=str(tmp_path))
    assert path.endswith(".pt2") and not m.model.fused
    meta = json.loads(Path(path).with_suffix(".metadata.json").read_text())
    assert meta["device"] == "cpu" and meta["layout"].startswith("NCHW")
    x = torch.from_numpy(np.random.default_rng(0).random((1, 3, IMGSZ, IMGSZ), np.float32))
    got = texporter.load_pt2(path)(x)
    with torch.no_grad():
        want = fuse_model(m.model).predict(x)
    got, want = (v if isinstance(v, (tuple, list)) else (v,) for v in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_nms_options(tmp_path, caplog):
    """``nms=True``: ``pt2`` raises naming its ROADMAP item (the port's NMS
    ends on a host test); ``onnx`` writes the graph without NMS and
    warns, as JAX's."""
    m = YOLO(CKPTS["detect"], device="cpu")
    with pytest.raises(NotImplementedError, match="3.4b"):
        m.export(format="pt2", nms=True, imgsz=IMGSZ, project=str(tmp_path))
    with caplog.at_level(logging.WARNING):
        path = m.export(format="onnx", nms=True, imgsz=IMGSZ, project=str(tmp_path))
    assert "ignoring nms=True" in caplog.text and Path(path).exists()


@pytest.mark.parametrize("fmt,needle", [
    ("engine", "trtexec"), ("coreml", "coremltools"), ("paddle", "x2paddle"),
    ("ncnn", "onnx2ncnn"), ("torchscript", "pt2"), ("stablehlo", "pt2"), ("tfjs", "tensorflowjs"),
    ("openvino", "ovc"), ("saved_model", "onnx2tf"), ("tflite", "onnx2tf"),
    ("pb", "convert_variables_to_constants_v2"), ("edgetpu", "edgetpu_compiler")])
def test_formats_raise_with_their_recipe(fmt, needle):
    """Each format the port does not write raises with its offline recipe
    (JAX's text where JAX has one); JAX's own recipes stand in the table
    unchanged but ``torchscript``'s."""
    m = YOLO("yolov8n-seg.yaml", device="cpu")
    with pytest.raises(NotImplementedError, match=needle):
        m.export(format=fmt, imgsz=IMGSZ)
    if fmt in jexporter.OFFLINE_RECIPES and fmt != "torchscript":
        assert texporter.OFFLINE_RECIPES[fmt] == jexporter.OFFLINE_RECIPES[fmt]


def test_unknown_format_and_quantized_handle():
    m = YOLO("yolov8n-seg.yaml", device="cpu")
    with pytest.raises(ValueError, match="not in"):
        m.export(format="not_a_format", imgsz=IMGSZ)
    m.model.quantized = True
    with pytest.raises(RuntimeError, match="int8"):
        m.export(format="onnx", imgsz=IMGSZ)


def test_dump_prediction_equals_jax(tmp_path):
    """The C++ example's prediction file: the port's bytes are JAX's for the
    fused seg160 predict (a tensor) and for a numpy array."""
    m = YOLO(CKPTS["seg160"], device="cpu").fuse()
    x = torch.from_numpy(np.random.default_rng(1).random((1, 3, IMGSZ, IMGSZ), np.float32))
    with torch.no_grad():
        pred = m.model.predict(x)
    for i, p in enumerate((pred, pred[0].numpy())):
        got = texporter.dump_prediction(p, m.model.nc, IMGSZ, IMGSZ, str(tmp_path / f"t{i}.bin"),
                                        conf=0.3, iou=0.6)
        want = jexporter.dump_prediction(np.asarray(pred), m.model.nc, IMGSZ, IMGSZ,
                                         str(tmp_path / f"j{i}.bin"), conf=0.3, iou=0.6)
        assert Path(got).read_bytes() == Path(want).read_bytes()


def test_a_fresh_facade_runs_every_entry_without_train(tmp_path):
    """``YOLO("yolov8n-seg.yaml")`` builds nothing until used; then
    ``names``, ``predict``, ``val``, ``fuse``, ``save`` and ``export`` run on
    the weights drawn at first use (JAX's facade: ``_ensure_variables``),
    which equal ``reset_weights``' draws; the saved checkpoint reloads with
    the same weights."""
    m = YOLO("yolov8n-seg.yaml", device="cpu")
    assert m.model is None
    assert m.names == {i: f"class{i}" for i in range(10)} and m.model is not None
    want = {k: v.clone() for k, v in m.model.state_dict().items()}
    m.reset_weights()
    for k, v in m.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    images, labels = floor_val_set()
    assert len(m.predict(shape_images(1, 64, 80, seed=0), imgsz=IMGSZ, conf=0.001)) == 1
    metrics = m.val(images[:2], labels[:2], imgsz=IMGSZ, batch=2)
    assert "metrics/mAP50-95(M)" in metrics
    saved = YOLO(m.fuse().save(tmp_path / "fresh.ckpt"), device="cpu")
    assert saved.model.fused
    for k, v in saved.model.state_dict().items():
        assert torch.equal(v, m.model.state_dict()[k]), k
    assert Path(YOLO("yolov8n-seg.yaml", device="cpu").export(
        format="onnx", imgsz=IMGSZ, project=str(tmp_path))).exists()
