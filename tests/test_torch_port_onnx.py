"""The port's ONNX writer (``onnx/``) against the JAX package's on the CPU.

For each head the JAX ONNX tests cover (polar segment, detect, pose,
segment_ori, classify, yolov6's ``ConvTranspose`` neck, and RT-DETR with
its HGNetV2 blocks and deformable decoder), a narrow model at imgsz 64 with
seeded weights and BatchNorm statistics is fused by the port, and its file
is held byte for byte to JAX's ``export_onnx`` of the same fused weights
(``to_jax_variables``) and model config; the port's numpy executor gives
JAX's executor's arrays bit for bit on that graph, and the port's fused
predict within the JAX test's tolerance. Also: how far the two BatchNorm
folds (the port's ``fuse_model``, JAX's ``fuse_variables``) leave the fused
weights apart, in ulps; the committed SHA-256 of JAX's export of the fused
seg160 checkpoint at 640, which the port's facade writes too (the smoke
holds the card's facade's export to it); the executor's scipy-free
``Erf``; the unsupported-head message; an unfused model refused."""
import copy
import hashlib
import json
import math
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from yolo_contour_regression_tpu.nn.fuse import fuse_variables
from yolo_contour_regression_tpu.nn.tasks import build_model as jbuild_model
from yolo_contour_regression_tpu.onnx import builder as jbuilder
from yolo_contour_regression_tpu.onnx.export import export_onnx as jexport_onnx
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine import exporter as texporter
from yolo_contour_regression_tpu_torch.nn.fuse import fuse_model
from yolo_contour_regression_tpu_torch.nn.tasks import (RTDETR_L, build_model, init_weights,
                                                        yaml_model_load)
from yolo_contour_regression_tpu_torch.onnx import builder as tbuilder
from yolo_contour_regression_tpu_torch.onnx.export import export_onnx
from yolo_contour_regression_tpu_torch.utils.checkpoint import to_jax_variables

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs" / "floor_seg160" / "best.ckpt"
# JAX's export of the port-fused seg160 checkpoint at 640 with the port's exporter
# metadata (``record_seg160_sha``)
SEG160_SHA = ROOT / "tests" / "data" / "torch_port_onnx_seg160_640.sha256"
IMGSZ = 64
# the executor against the fused predict: the JAX ONNX tests' tolerances (numpy's im2col
# sums against torch's conv; RT-DETR's through its six decoder layers)
EXEC_ATOL, EXEC_RTOL, RTDETR_ATOL = 2e-3, 1e-2, 5e-3
# the two folds of a BatchNorm into its conv: the same float32 algebra in another order
# of operations (JAX's divide and XLA's fusion), a few ulps; the largest gaps are on
# RepConv's three summed branches
FOLD_ULPS = 64


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads beside the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def narrow_rtdetr():
    """rtdetr-l cut to the narrowest widths (every block kind, two blocks a
    stage), its decoder whole; AIFI with JAX's emitter's 8 heads."""
    cfg = {"nc": 3, "scales": {"l": [1.0, 1.0, 1024]},
           "backbone": [[-1, 1, "HGStem", [8, 16]], [-1, 2, "HGBlock", [8, 32, 3]],
                        [-1, 1, "DWConv", [32, 3, 2, 1, False]], [-1, 2, "HGBlock", [16, 64, 3]],
                        [-1, 1, "DWConv", [64, 3, 2, 1, False]],
                        [-1, 2, "HGBlock", [16, 64, 5, True, False]],
                        [-1, 2, "HGBlock", [16, 64, 5, True, True]],
                        [-1, 2, "HGBlock", [16, 64, 5, True, True]],
                        [-1, 1, "DWConv", [64, 3, 2, 1, False]],
                        [-1, 2, "HGBlock", [32, 128, 5, True, False]]],
           "head": copy.deepcopy(RTDETR_L["head"])}
    for layer in cfg["head"]:
        if layer[2] in ("Conv", "RepC3"):
            layer[3][0] = 32
        if layer[2] == "RepC3":
            layer[1] = 1
        if layer[2] == "AIFI":
            layer[3] = [64, 8]
    return cfg


def narrow(name: str, nc=None):
    """A config of ``yaml_model_load(name)`` at the narrowest widths."""
    cfg = copy.deepcopy(yaml_model_load(name))
    if nc:
        cfg["nc"] = nc
    if "scales" in cfg:
        cfg.update(scale="t", scales={"t": [0.33, 0.125, 256]})
    else:
        cfg.update(width_multiple=0.125, depth_multiple=0.33)
    return cfg


HEADS = {"segment": ("yolov8n-seg.yaml", 3), "detect": ("yolov8n.yaml", 2),
         "pose": ("yolov8n-pose.yaml", None), "segment_ori": ("yolov8n-segori.yaml", 3),
         "classify": ("yolov8n-cls.yaml", 2), "yolov6": ("yolov6n.yaml", 2), "rtdetr": None}


def seeded(cfg, seed: int = 0):
    """The port's model of ``cfg`` with ``init_weights`` draws and seeded
    BatchNorm statistics and affine terms (so the fold is not the
    identity), in eval mode."""
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)))
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, n).astype(np.float32)))
    return model.eval()


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Per head: (the unfused and fused port models, the config, the port's
    and JAX's files' bytes, both builders, the output list)."""
    tmp = tmp_path_factory.mktemp("onnx")
    out = {}
    for head, spec in HEADS.items():
        cfg = narrow_rtdetr() if spec is None else narrow(*spec)
        model = seeded(cfg)
        fused = fuse_model(copy.deepcopy(model))
        g, outs = export_onnx(fused, str(tmp / f"{head}.onnx"), imgsz=IMGSZ)
        jm = jbuild_model(cfg)
        jm.names = dict(fused.names)
        params, _ = to_jax_variables(fused.state_dict())
        jg, jouts = jexport_onnx(jm, {"params": params}, str(tmp / f"{head}_jax.onnx"),
                                 imgsz=IMGSZ)
        assert jouts == outs
        out[head] = dict(model=model, fused=fused, cfg=cfg, g=g, jg=jg, outs=outs,
                         got=(tmp / f"{head}.onnx").read_bytes(),
                         want=(tmp / f"{head}_jax.onnx").read_bytes())
    return out


@pytest.mark.parametrize("head", sorted(HEADS))
def test_onnx_bytes_equal_jax(exports, head):
    """The port's file equals JAX's byte for byte (graph, initializers in
    their order and names, the graph's metadata)."""
    e = exports[head]
    assert len(e["got"]) == len(e["want"]) and e["got"] == e["want"]
    assert len(e["g"].nodes) == len(e["jg"].nodes)


@pytest.mark.parametrize("head", sorted(HEADS))
def test_executor_equals_jax_and_predict(exports, head):
    """The port's numpy executor gives JAX's executor's outputs bit for bit
    on the exported graph, and the port's fused predict within the JAX ONNX
    tests' tolerance (the proto-mask head's prototypes as the second
    output)."""
    e = exports[head]
    x = np.random.default_rng(0).random((1, 3, IMGSZ, IMGSZ), np.float32)
    got, jgot = e["g"].run({"images": x}), e["jg"].run({"images": x})
    for name, _ in e["outs"]:
        np.testing.assert_array_equal(got[name], jgot[name])
    if head == "yolov6":
        # JAX's emitter writes flax's ConvTranspose kernel to ONNX unflipped (its
        # onnx/export.py:454), where ONNX's (torch's) is flax's flipped: the file keeps
        # JAX's bytes, and its graph with the kernels flipped is the one held to predict
        print("yolov6 as exported, max gap to predict:", float(np.abs(
            got[e["outs"][0][0]] - e["fused"].predict(torch.from_numpy(x)).detach().numpy()
        ).max()))
        got = flipped_transposed_kernels(e).run({"images": x})
    with torch.no_grad():
        ref = e["fused"].predict(torch.from_numpy(x))
    refs = ref if isinstance(ref, tuple) else (ref,)
    assert len(refs) == len(e["outs"])
    atol = RTDETR_ATOL if head == "rtdetr" else EXEC_ATOL
    for (name, shape), r in zip(e["outs"], refs):
        assert list(got[name].shape) == shape == list(r.shape)
        np.testing.assert_allclose(got[name], r.numpy(), atol=atol, rtol=EXEC_RTOL)


def flipped_transposed_kernels(e):
    """JAX's graph of ``e``'s fused weights with each ConvTranspose kernel
    flipped in its two spatial axes."""
    params, _ = to_jax_variables(e["fused"].state_dict())
    flipped = 0
    for layer in params.values():
        if "conv_transpose" in layer:
            layer["conv_transpose"]["kernel"] = layer["conv_transpose"]["kernel"][::-1, ::-1].copy()
            flipped += 1
    assert flipped
    jm = jbuild_model(e["cfg"])
    jm.names = dict(e["fused"].names)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        g, _ = jexport_onnx(jm, {"params": params}, str(Path(d) / "flipped.onnx"), imgsz=IMGSZ)
    return g


def ulp_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise distance of two float32 arrays in units in the last place."""
    ia, ib = (np.asarray(v, np.float32).view(np.int32).astype(np.int64) for v in (a, b))
    ia, ib = (np.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
    return np.abs(ia - ib)


def fold_gap(model, cfg) -> dict:
    """The port's fold of ``model`` against JAX's ``fuse_variables`` of the
    same unfused weights: fused leaves (the ONNX file's initializers of
    weights), how many differ, their values that differ, and the largest gap
    in ulps."""
    params, stats = to_jax_variables(model.state_dict())
    fv, _ = fuse_variables(jbuild_model(cfg), {"params": params, "batch_stats": stats})
    want = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                                           fv["params"])))
    got = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_variables(fuse_model(copy.deepcopy(model)).state_dict())[0]))
    assert got.keys() == want.keys()
    gaps = [ulp_gap(got[k], want[k]) for k in got]
    return {"leaves": len(gaps), "leaves_apart": sum(int(g.max() > 0) for g in gaps),
            "values": sum(g.size for g in gaps), "values_apart": sum(int((g > 0).sum())
                                                                     for g in gaps),
            "max_ulps": max(int(g.max()) for g in gaps)}


@pytest.mark.parametrize("case", ["detect", "seg160"])
def test_batchnorm_folds_apart_by_ulps(exports, case):
    """The two folds' fused weights from the same unfused weights (the
    narrow seeded models, and the committed seg160 checkpoint): equal
    leaves, each value within ``FOLD_ULPS``; the count apart is printed
    (the ONNX byte gate feeds both writers the port's fold)."""
    if case == "seg160":
        model = YOLO(CKPT, device="cpu").model
        cfg = model.yaml
    else:
        model, cfg = exports[case]["model"], exports[case]["cfg"]
    gap = fold_gap(model, cfg)
    print(case, gap)
    assert gap["max_ulps"] <= FOLD_ULPS, gap


def seg160_export(d, imgsz: int = 640):
    """The port's facade's ONNX export of the seg160 checkpoint
    (``YOLO(ckpt).export(format="onnx")``, fused on the CPU) and JAX's
    ``export_onnx`` of the same fused weights, names and exporter metadata
    -> (the port's bytes, JAX's bytes)."""
    path = YOLO(CKPT, device="cpu").export(format="onnx", imgsz=imgsz, project=str(d))
    fused = fuse_model(YOLO(CKPT, device="cpu").model)
    jm = jbuild_model(fused.yaml)
    jm.names = dict(fused.names)
    meta = texporter.export_metadata(fused, CKPT.stem, imgsz, 1, False)
    jpath = Path(d) / "seg160_jax.onnx"
    jexport_onnx(jm, {"params": to_jax_variables(fused.state_dict())[0]}, str(jpath),
                 imgsz=imgsz, metadata={k: json.dumps(v, default=str) for k, v in meta.items()})
    return Path(path).read_bytes(), jpath.read_bytes()


def record_seg160_sha(path=SEG160_SHA):
    """Rewrite the committed SHA-256 of JAX's export (``seg160_export``)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        _, want = seg160_export(d)
    Path(path).write_text(hashlib.sha256(want).hexdigest() + "\n")


def test_committed_seg160_sha_is_current(tmp_path):
    """JAX's export of the port-fused seg160 checkpoint at 640 has the
    committed SHA-256, and the port's facade writes the same bytes."""
    got, want = seg160_export(tmp_path)
    assert got == want
    assert hashlib.sha256(want).hexdigest() == SEG160_SHA.read_text().strip()


def test_executor_erf_without_scipy():
    """The port's executor's ``Erf`` (the standard library's double
    precision, rounded to float32) against JAX's (scipy's)."""
    x = np.linspace(-4, 4, 2001, dtype=np.float32).reshape(1, -1)
    outs = []
    for mod in (tbuilder, jbuilder):
        g = mod.GraphBuilder()
        g.add_input("x", list(x.shape))
        g.add_output(g.node("Erf", ["x"]), list(x.shape))
        outs.append(next(iter(g.run({"x": x}).values())))
    assert outs[0].dtype == np.float32
    np.testing.assert_array_equal(outs[0], np.float32([math.erf(float(v)) for v in x[0]])[None])
    assert int(ulp_gap(outs[0], outs[1]).max()) <= 1


def test_unsupported_head_and_unfused_model(tmp_path):
    """A head without an emitter raises pointing at the pt2 format (as JAX's
    at stablehlo); an unfused model is refused."""
    from types import SimpleNamespace

    fake = SimpleNamespace(head_spec=SimpleNamespace(name="NotAHead"))
    with pytest.raises(NotImplementedError, match="pt2"):
        export_onnx(fake, str(tmp_path / "m.onnx"), imgsz=IMGSZ)
    with pytest.raises(ValueError, match="fused"):
        export_onnx(build_model(narrow("yolov8n.yaml", 2)), str(tmp_path / "m.onnx"),
                    imgsz=IMGSZ)
