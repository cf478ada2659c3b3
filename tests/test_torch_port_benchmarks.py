"""The PyTorch port's ``utils/benchmarks.py``, ``utils/autobatch.py``,
``utils/torch_utils.py`` and ``models/yolo/`` against the JAX package's
counterparts on the CPU: the ``benchmark()`` table's rows and statuses (and
``yolo benchmark``), ``profile_models``, the AutoBatch fit on the same byte
counts, the seeding, ramp, unwrapping, FLOP count, timing and trace
utilities, and the task re-exports. Weights are drawn from seeds; the
timings themselves are the host's and are not compared."""
import ast
import json
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import CKPT, floor_val_set
from tests.test_torch_port_modules import _randomize
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.utils import autobatch as jautobatch
from yolo_contour_regression_tpu.utils import benchmarks as jbenchmarks
from yolo_contour_regression_tpu.utils import jax_utils
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.cfg import entrypoint
from yolo_contour_regression_tpu_torch.nn.tasks import build_model, yaml_model_load
from yolo_contour_regression_tpu_torch.utils import autobatch, benchmarks, torch_utils


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


IMGSZ, BATCH = 64, 2
# the pt2 artifact against the fused predict (JAX's stablehlo limit)
CONSISTENCY_TOL = 1e-3
# the pt2 artifact's validated mAP against the fused model's: the artifact's
# scores are gated as probabilities, the model's as logits
PT2_MAP_ATOL = 0.01
# the keys of each row kind, as JAX writes them (utils/benchmarks.py)
TIMED_KEYS = {"format", "imgsz", "batch", "status", "latency_ms_per_batch", "imgs_per_sec"}
ARTIFACT_KEYS = {"format", "imgsz", "batch", "status", "cold_latency_ms", "latency_ms_per_img",
                 "consistency_maxabs"}


@pytest.fixture(scope="module")
def port_rows(tmp_path_factory):
    """The port's table for the seg160 checkpoint at 64, batch 2, every
    format, validated on four floor frames (decoded images and labels; a
    dataset yaml works the same)."""
    images, labels = floor_val_set()
    return benchmarks.benchmark(YOLO(CKPT, device="cpu"), data=(images[:4], labels[:4]),
                                imgsz=IMGSZ, batch=BATCH,
                                project=str(tmp_path_factory.mktemp("bench")), verbose=False)


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    """JAX's table for its yolov8n-seg (variables drawn from a seed) at 64,
    batch 2, the rows the JAX package runs without TensorFlow or
    onnxruntime (native, fused, int8), its timing loop stubbed: its rows and
    statuses are compared, not its times."""
    jy = JaxYOLO("yolov8n-seg.yaml")
    shapes = jax.eval_shape(lambda: jy.model.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
    jy.variables = jax.tree_util.tree_map(np.asarray, _randomize(dict(shapes), 1))
    loop = jbenchmarks._device_loop_throughput
    jbenchmarks._device_loop_throughput = lambda *a: {"latency_ms_per_batch": 1.0,
                                                      "imgs_per_sec": 2.0}
    try:
        return jbenchmarks.benchmark(jy, imgsz=IMGSZ, batch=BATCH,
                                     formats=["native", "fused", "int8"],
                                     project=str(tmp_path_factory.mktemp("jbench")),
                                     verbose=False)
    finally:
        jbenchmarks._device_loop_throughput = loop


def test_benchmark_rows_match_jax(port_rows, jax_rows):
    """One row a format in the port's order (JAX's, ``pt2`` where JAX has
    ``stablehlo``); native, fused and int8 carry JAX's keys (and, validated,
    ``mAP50-95``) and JAX's "ok"; the times are positive."""
    assert [r["format"] for r in port_rows] == list(benchmarks.FORMATS)
    by = {r["format"]: r for r in port_rows}
    for want in jax_rows:
        got = by[want["format"]]
        assert want["status"] == "ok" and set(want) == TIMED_KEYS, want
        assert got["status"] == "ok" and set(got) == set(want) | {"mAP50-95"}, got
        assert 0 <= got["mAP50-95"] <= 1
        assert got["imgsz"] == IMGSZ and got["batch"] == BATCH
        assert got["imgs_per_sec"] > 0 and got["latency_ms_per_batch"] > 0


def test_benchmark_artifact_rows(port_rows):
    """``pt2`` (JAX's ``stablehlo``): reloaded by ``AutoBackend``, JAX's
    artifact keys, within ``CONSISTENCY_TOL`` of the fused predict, and its
    validated ``mAP50-95`` (masks) within ``PT2_MAP_ATOL`` of the fused
    model's. The formats the port writes or runs no runtime for fail in
    ``status`` with the port's own message, and the table goes on: ONNX is
    written and refused by ``AutoBackend`` (no onnxruntime), TensorFlow's
    formats by the exporter with their recipes."""
    by = {r["format"]: r for r in port_rows}
    pt2 = by["pt2"]
    assert pt2["status"] == "ok" and set(pt2) == ARTIFACT_KEYS | {"mAP50-95"}, pt2
    assert pt2["consistency_maxabs"] < CONSISTENCY_TOL
    assert abs(pt2["mAP50-95"] - by["fused"]["mAP50-95"]) <= PT2_MAP_ATOL
    assert by["onnx"]["status"].startswith("fail: NotImplementedError") and \
        "onnxruntime" in by["onnx"]["status"]
    for fmt in ("saved_model", "tflite", "pb"):
        assert by[fmt]["status"].startswith("fail: NotImplementedError") and \
            "Offline recipe" in by[fmt]["status"], by[fmt]


def test_benchmark_of_an_int8_handle(tmp_path):
    """An int8 handle (JAX's rule): its fused and int8 rows time the handle
    itself, and its export rows fail with the exporter's int8 refusal."""
    rng = np.random.default_rng(3)
    m = YOLO("yolov8n-seg.yaml", device="cpu").quantize(
        [rng.uniform(0, 1, (1, IMGSZ, IMGSZ, 3)).astype(np.float32)])
    rows = benchmarks.benchmark(m, imgsz=IMGSZ, batch=BATCH, formats=["int8", "pt2"],
                                project=str(tmp_path), verbose=False)
    assert rows[0]["status"] == "ok" and "int8" in rows[1]["status"], rows


def test_yolo_benchmark_cli(capsys, tmp_path):
    """``yolo benchmark`` runs ``YOLO.benchmark`` with its keys and prints
    a row a format."""
    argv = ["segment", "benchmark", "model=yolov8n-seg.yaml", f"imgsz={IMGSZ}", "batch=1",
            "formats=[native,tflite]", "device=cpu", f"project={tmp_path}", "verbose=false"]
    assert entrypoint(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()[-2:]
    rows = [ast.literal_eval(line) for line in lines]  # the CLI prints each row's repr
    assert [r["format"] for r in rows] == ["native", "tflite"]
    assert rows[0]["status"] == "ok" and rows[1]["status"].startswith("fail")


def test_profile_models():
    """``profile_models``: JAX's row keys, the unfused parameter count in
    millions, a positive latency; and the sigma clip drops an outlier as
    JAX's three rounds do."""
    rows = benchmarks.profile_models(["yolov8n-seg.yaml"], imgsz=IMGSZ, num_timed_runs=4,
                                     verbose=False, device="cpu")
    assert set(rows[0]) == {"model", "params_M", "latency_ms", "latency_std_ms", "imgsz"}
    n = build_model(yaml_model_load("yolov8n-seg.yaml")).num_params
    assert rows[0]["params_M"] == round(n / 1e6, 2) and rows[0]["latency_ms"] > 0
    ts = np.array([10.0, 10.2, 9.9, 10.1, 10.0, 10.1, 9.8, 10.3, 55.0])
    kept = benchmarks._sigma_clip(ts)
    assert 55.0 not in kept and len(kept) == 8


# --- AutoBatch ----------------------------------------------------------------


@pytest.mark.parametrize("total,b2,b4,fraction", [
    (80 * 2**30, 300e6, 520e6, 0.6), (16 * 2**30, 1.2e9, 2.3e9, 0.6),
    (80 * 2**30, 2e9, 2e9, 0.6),     # no growth with the batch: the 1-byte floor
    (8 * 2**30, 7e9, 9e9, 0.6),      # the fixed part over the budget
    (80 * 2**30, 500e6, 400e6, 0.9), (24 * 2**30, 64e6, 96e6, 0.3)])
def test_autobatch_fit_matches_jax(total, b2, b4, fraction):
    """``fit_batch_size`` gives JAX's ``check_train_batch_size`` batch on
    the same byte counts (JAX's device memory and memory analysis fed the
    numbers)."""
    dm, est = jautobatch.device_memory_bytes, jautobatch.estimate_activation_bytes
    jautobatch.device_memory_bytes = lambda: total
    jautobatch.estimate_activation_bytes = lambda m, imgsz, b: {2: b2, 4: b4}[b]
    try:
        want = jautobatch.check_train_batch_size(type("M", (), {"variables": {}})(), 640,
                                                 fraction)
    finally:
        jautobatch.device_memory_bytes, jautobatch.estimate_activation_bytes = dm, est
    got = autobatch.fit_batch_size(total, b2, b4, fraction)
    assert got["batch"] == want and got["budget"] == total * fraction


def test_autobatch_refuses_the_cpu():
    """A model on the CPU has no card memory to fit: a clear error."""
    with pytest.raises(ValueError, match="card"):
        autobatch.check_train_batch_size(YOLO("yolov8n-seg.yaml", device="cpu"), 64)


# --- torch_utils ----------------------------------------------------------------


def test_seeds_ramp_and_unwrap():
    """``init_seeds`` seeds the global generators and returns a seeded
    ``torch.Generator``; ``one_cycle`` is JAX's ramp; ``de_parallel``
    unwraps a ``DataParallel``."""
    g = torch_utils.init_seeds(7)
    a = (np.random.rand(), torch.rand(1, generator=g).item(), torch.rand(1).item())
    g = torch_utils.init_seeds(7)
    assert a == (np.random.rand(), torch.rand(1, generator=g).item(), torch.rand(1).item())
    f, jf = torch_utils.one_cycle(1.0, 0.01, 50), jax_utils.one_cycle(1.0, 0.01, 50)
    assert all(f(x) == jf(x) for x in range(51))
    lin = torch.nn.Linear(2, 2)
    assert torch_utils.de_parallel(torch.nn.DataParallel(lin)) is lin
    assert torch_utils.de_parallel(lin) is lin


def _conv_linear_macs(model, x) -> int:
    """Multiply-adds of every conv and linear of one forward, from their
    shapes (``forward`` hooks)."""
    macs = []

    def hook(m, _, out):
        if isinstance(m, torch.nn.Conv2d):
            macs.append(out.numel() * (m.in_channels // m.groups) * math.prod(m.kernel_size))
        else:
            macs.append(out.numel() * m.in_features)

    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model(x)
    for h in hs:
        h.remove()
    return sum(macs)


@pytest.mark.parametrize("name", ["yolov8n-seg.yaml", "yolov8n-cls.yaml"])
def test_model_flops_are_twice_the_macs(name):
    """``model_info``'s FLOPs (``FlopCounterMode``) are 2 x the convs' and
    linears' multiply-adds computed from the shapes, and its layers and
    parameters are the model's. JAX's XLA cost analysis of the same config
    is printed beside it for yolov8n-seg: it counts elementwise work too,
    so it differs in kind and is not held to the port's."""
    model = build_model(yaml_model_load(name)).eval()
    info = torch_utils.model_info(model, imgsz=IMGSZ, verbose=False)
    flops = torch_utils.model_flops(model, torch.zeros(1, 3, IMGSZ, IMGSZ))
    assert flops == 2 * _conv_linear_macs(model, torch.zeros(1, 3, IMGSZ, IMGSZ))
    assert info == {"layers": len(model.specs), "parameters": model.num_params,
                    "GFLOPs": round(flops / 1e9, 2)}
    if name == "yolov8n-seg.yaml":
        jm = JaxYOLO(name).model
        shapes = jax.eval_shape(lambda: jm.module.init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
        jflops = jax_utils.model_flops(lambda v, x: jm.raw_forward(v, x), shapes,
                                       jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), jnp.float32))
        print(f"{name} at {IMGSZ}: FlopCounterMode {flops / 1e9:.4f} GFLOPs, JAX's XLA cost "
              f"analysis {jflops / 1e9:.4f} GFLOPs (not compared)")


def test_profile_and_trace(tmp_path):
    """``profile`` gives ms a call of each named function; ``trace`` writes
    a Chrome trace of what ran inside it."""
    x = torch.randn(64, 64)
    ms = torch_utils.profile({"matmul": lambda a: a @ a, "relu": torch.relu}, x, n=3)
    assert set(ms) == {"matmul", "relu"} and all(v > 0 for v in ms.values())
    with torch_utils.trace(tmp_path / "prof"):
        (x @ x).sum()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_models_yolo_reexports():
    """``models/yolo`` (JAX's 34 lines): the facade, its task map, and each
    task package's predictor, trainer and validator under JAX's names."""
    from yolo_contour_regression_tpu.models import yolo as jyolo
    from yolo_contour_regression_tpu_torch.engine import model as tmodel
    from yolo_contour_regression_tpu_torch.models import yolo

    assert yolo.YOLO is tmodel.YOLO and yolo.TASK_MAP is tmodel.TASK_MAP
    assert yolo.model.YOLO is YOLO
    for task in ("classify", "detect", "pose", "segment"):
        got, want = getattr(yolo, task), getattr(jyolo, task)
        assert got.__all__ == want.__all__
        for name in got.__all__:
            assert isinstance(getattr(got, name), type), (task, name)
    assert yolo.segment.SegmentationValidator is tmodel.TASK_MAP["segment"]["validator"]
