"""The PyTorch port imports nothing that a CUDA machine with only torch,
numpy and the standard library lacks: in a fresh interpreter that refuses
jax, flax, optax, cv2, PIL, yaml, torchvision, triton, onnx, onnxruntime,
tensorflow, tf2onnx, openvino, thop and the JAX package, every module of the port
(the CLI's ``__main__``, the callbacks, tuner, checks and settings, the
``onnx/`` writer, the exporter and ``AutoBackend`` among them) and
``chip_smoke`` import, the CPU predict runs
on the committed seg160 checkpoint, the CPU validator runs on two images
of the floor set with it, one CPU train step runs on it, and
``YOLO("yolov8n-seg.yaml").train`` runs one epoch on the CPU on four of the
floor set's train images at imgsz 64 (amp, the augmentation, the loader's
threads, checkpoints); then the detect task: the floor_detect checkpoint
predicts and validates, fused and unfused, and ``YOLO("yolov8n.yaml")
.train`` runs one epoch on four of the detect floor set's images; then the
classify task (the floor_classify checkpoint validates to JAX's top-1 on
the committed set, and ``YOLO("yolov8n-cls.yaml").train`` runs one epoch
on the host path), the segment_ori task (the narrow checkpoint of the
CPU tests predicts masks) and RT-DETR (the floor_rtdetr checkpoint predicts
and validates, and one CPU train step with contrastive denoising runs on
it); then SAM at img_size 64 (prompted predict and everything mode),
FastSAM on the seg160 checkpoint with a box prompt (from its masks, and
from contours alone), and one predict of a fresh yolo_nas_s behind
``NAS``; then the serving path: a committed JPEG and PNG decoded by
``data/imcodec.py`` (byte-equal to their committed cv2 decodes), served by
``InferenceServer`` on the seg160 checkpoint, and two synthetic captures
through ``LoadStreams``; then the lifecycle: the CLI's ``version`` and
``cfg``, a callback, a mid-run checkpoint with optax's state (read without
optax) and a resume from it; then tracking: the trackers, the contour
finder, the annotator and the converter are among the modules, and
``YOLO.track`` runs BOT-SORT (its sparse-flow GMC) and ByteTrack on three
panning frames with ``Masks.xy`` read; then the seg160 checkpoint is
exported to ONNX; then the seg160 checkpoint is quantized to int8, saved,
reloaded, benchmarked (its int8 row) and predicts (``nn/quant.py``,
``utils/benchmarks.py``, ``utils/autobatch.py``, ``utils/torch_utils.py`` and
``models/yolo`` are among the modules; ``thop`` is refused too); and scipy
and cv2 were never imported."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "cv2", "PIL", "yaml", "torchvision", "triton",
           "onnx", "onnxruntime", "tensorflow", "tf2onnx", "openvino", "thop",
           "yolo_contour_regression_tpu")

SCRIPT = r"""
import importlib, importlib.abc, importlib.machinery, os, pkgutil, sys
BLOCKED = set(sys.argv[1].split(","))

class Refuse(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    # a blocked name has a spec without origin, whose import fails: an import raises,
    # and a probe by importlib.util.find_spec (torch's dynamo probes onnx and tensorflow
    # that way when it is first imported) learns nothing of where it lies
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            return importlib.machinery.ModuleSpec(name, self)
        return None

    def create_module(self, spec):
        raise ModuleNotFoundError(f"blocked: {spec.name}", name=spec.name)

    def exec_module(self, module):
        pass

for name in list(sys.modules):  # anything a site hook imported already
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())

import numpy as np
import torch
torch.set_num_threads(2)  # beside the suite's parallel workers
import yolo_contour_regression_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke

model = pkg.YOLO("runs/floor_seg160/best.ckpt", device="cpu")
res = model.predict(chip_smoke.shape_images(2, 120, 200, seed=0), imgsz=160)
assert sum(len(r) for r in res) > 0
assert all(r.masks.data.shape[1:] == (120, 200) for r in res)
images, labels = chip_smoke.floor_val_set()
val = model.val(images[:2], labels[:2], imgsz=160, batch=2)
assert 0.0 < val["metrics/mAP50-95(M)"] <= 1.0 and 0.0 < val["metrics/mAP50-95(B)"] <= 1.0, val
import torch
from types import SimpleNamespace
from yolo_contour_regression_tpu_torch.engine.step import init_train_state, make_train_step
from yolo_contour_regression_tpu_torch.ops import gt_rays
from yolo_contour_regression_tpu_torch.utils import loss, optim, tal
from yolo_contour_regression_tpu_torch.utils import checkpoint as ckpt_module
hyp = SimpleNamespace(optimizer="AdamW", nc=2, lr0=0.001667, lrf=0.01, momentum=0.9,
                      weight_decay=0.0005, warmup_epochs=0.0, warmup_bias_lr=0.0, epochs=1,
                      batch=2, nbs=16, box=7.5, cls=0.5)
net = model.model
opt = optim.build_optimizer(net, hyp, 1, 1)
state = init_train_state(net, opt, device="cpu")
images, batch = chip_smoke.shape_batch(2, 64, 3, seed=0)
metrics = make_train_step(net, opt, hyp)(
    state, torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in batch.items()})
assert state.step == 1 and torch.isfinite(metrics["loss"]), metrics
import tempfile
train_images, train_labels = chip_smoke.floor_train_set()
with tempfile.TemporaryDirectory() as d:
    fresh = pkg.YOLO("yolov8n-seg.yaml", device="cpu")
    fresh.train(data={"train": (train_images[:4], train_labels[:4]), "val": ([], []),
                      "names": {0: "circle", 1: "rect"}},
                epochs=1, imgsz=64, batch=2, nbs=2, workers=1, val=False, project=d)
    trained = fresh.trainer.state.step
    assert trained == 2 and fresh.ckpt_path.name == "best.ckpt", (trained, fresh.ckpt_path)
det = pkg.YOLO("runs/floor_detect/best.ckpt", device="cpu")
det_images, det_labels = chip_smoke.floor_detect_val_set()
n_det = sum(len(r) for r in det.predict(det_images[:4]))
det_val = det.val(det_images[:4], det_labels[:4], imgsz=96, batch=2)
fused_val = det.fuse().val(det_images[:4], det_labels[:4], imgsz=96, batch=2)
assert n_det > 0 and det.model.fused, n_det
assert abs(det_val["metrics/mAP50-95(B)"] - fused_val["metrics/mAP50-95(B)"]) < 0.01
assert sum(len(r) for r in pkg.YOLO("runs/floor_seg160/best.ckpt", device="cpu").fuse().predict(
    chip_smoke.shape_images(1, 120, 200, seed=0), imgsz=160)) > 0
det_train = chip_smoke.floor_detect_train_set()
with tempfile.TemporaryDirectory() as d:
    fresh = pkg.YOLO("yolov8n.yaml", device="cpu")
    fresh.train(data={"train": (det_train[0][:4], det_train[1][:4]), "val": ([], []),
                      "names": {0: "circle", 1: "rect"}},
                epochs=1, imgsz=64, batch=2, nbs=2, workers=1, val=False, project=d)
    assert fresh.task == "detect" and fresh.trainer.state.step == 2
cls = pkg.YOLO("runs/floor_classify/best.ckpt", device="cpu")
with np.load("tests/data/torch_port_floor_classify_val32.npz") as z:
    cls_images, cls_labels = list(z["images"]), z["labels"]
cls_val = cls.val(cls_images, cls_labels, imgsz=64, batch=16)
assert cls_val["metrics/accuracy_top1"] == 0.78125, cls_val
with tempfile.TemporaryDirectory() as d:
    fresh = pkg.YOLO("yolov8n-cls.yaml", device="cpu")
    fresh.train(data={"train": (cls_images[::4], cls_labels[::4]),
                      "val": (cls_images[:4], cls_labels[:4]), "names": {0: "circle", 1: "rect"}},
                epochs=1, imgsz=32, batch=4, nbs=4, workers=1, project=d)
    assert fresh.task == "classify" and fresh.trainer.state.step == 2
so = pkg.YOLO("tests/data/torch_port_segori_narrow64.ckpt", device="cpu")
so_res = so.predict(chip_smoke.shape_val_set(4, 48, 64, 41)[0], conf=0.001)
assert sum(len(r) for r in so_res) > 0
assert all(r.masks.data.shape[1:] == (48, 64) for r in so_res if len(r))
rt = pkg.YOLO("runs/floor_rtdetr/best.ckpt", device="cpu")
rt_images, rt_labels = chip_smoke.floor_rtdetr_val_set()
assert sum(len(r) for r in rt.predict(rt_images[:2])) > 0
rt_val = rt.val(rt_images[:2], rt_labels[:2], imgsz=192, batch=2)
assert 0.0 < rt_val["metrics/mAP50-95(B)"] <= 1.0, rt_val
rt_opt = optim.build_optimizer(rt.model, hyp, 1, 1)
rt_state = init_train_state(rt.model, rt_opt, device="cpu")
rt_images, rt_batch = chip_smoke.shape_batch(2, 64, 3, seed=0)
rt_metrics = make_train_step(rt.model, rt_opt, hyp)(
    rt_state, torch.from_numpy(rt_images), {k: torch.from_numpy(v) for k, v in rt_batch.items()})
assert "dn_cls_loss" in rt_metrics and torch.isfinite(rt_metrics["loss"]), rt_metrics
sam = pkg.SAM("sam_b", img_size=64, device="cpu")
sam_img = np.full((48, 56, 3), 128, np.uint8)
sam_masks, sam_iou = sam.predict(sam_img, points=[[28, 24]], labels=[1])
assert sam_masks.shape == (3, 48, 56) and sam_iou.shape == (3,)
gen = sam.generate(sam_img, points_stride=4, conf_thres=-1e9, stability_score_thresh=-1.0,
                   min_mask_region_area=4)
assert len(gen[0]) > 0 and gen[0].shape[1:] == (48, 56), gen[0].shape
fs_img = chip_smoke.shape_images(1, 120, 200, seed=0)[0]
fs = pkg.FastSAM("runs/floor_seg160/best.ckpt", device="cpu")
for boxes in (True, False):
    fs_res = fs.predict(fs_img, boxes=boxes)
    assert len(fs_res[0]) and (fs_res[0].masks is None) == (not boxes)
    sel = pkg.FastSAMPrompt(fs_img, fs_res).box_prompt(fs_res[0].boxes.xyxy[0])
    assert sel.shape == (1, 120, 200) and sel.any()
nas = chip_smoke.fresh_nas(device="cpu")
assert len(nas.predict(chip_smoke.shape_images(1, 48, 64, seed=1), imgsz=64, conf=0.001)) == 1
from yolo_contour_regression_tpu_torch.data.imcodec import imread
from yolo_contour_regression_tpu_torch.data.streams import LoadStreams
from yolo_contour_regression_tpu_torch.serve import InferenceServer
with np.load("tests/data/" + chip_smoke.SERVE_DECODES) as z:
    posted = [imread("tests/data/" + name) for name in chip_smoke.SERVE_FIXTURES[::3]]
    assert all((a == z[n]).all() for a, n in zip(posted, chip_smoke.SERVE_FIXTURES[::3]))
with InferenceServer("runs/floor_seg160/best.ckpt", imgsz=160, max_batch=2,
                     device="cpu") as srv:
    served = srv.infer(posted, timeout=120)
assert sum(len(r) for r in served) > 0 and srv.stats()["requests"] == 2

frames = chip_smoke.shape_images(4, 48, 64, seed=2)
streamed = pkg.YOLO("runs/floor_seg160/best.ckpt", device="cpu").predict(
    LoadStreams(["a", "b"], buffer=True, open_fn=lambda s: chip_smoke.SyntheticCapture(
        frames[:2] if s == "a" else frames[2:])), imgsz=64)
assert [r.path for r in streamed] == ["a#frame0", "b#frame0", "a#frame1", "b#frame1"]
from yolo_contour_regression_tpu_torch.cfg import entrypoint, parse_key_value_args
from yolo_contour_regression_tpu_torch.utils import callbacks, checks, settings, tuner
lifecycle = {f"yolo_contour_regression_tpu_torch.{m}" for m in (
    "utils.callbacks", "utils.tuner", "utils.checks", "utils.settings", "__main__")}
assert lifecycle <= set(mods), sorted(lifecycle - set(mods))
assert entrypoint(["version"]) == 0 and entrypoint(["cfg"]) == 0
assert parse_key_value_args(["imgsz=[640, 480]", "amp=off"]) == {"imgsz": [640, 480], "amp": False}
assert checks.check_yolo(verbose=False)["torch"] == torch.__version__
assert set(tuner.Tuner(seed=0)._mutate({"lr0": 0.01})) >= {"lr0"}
with tempfile.TemporaryDirectory() as d:
    assert settings.SettingsManager(d + "/settings.json")["runs_dir"] == "runs"
    events = []
    cb = pkg.YOLO("yolov8n-seg.yaml", device="cpu")
    cb.add_callback("on_model_save", lambda t: events.append(t.epoch))
    split = {"train": (train_images[:4], train_labels[:4]), "val": ([], []),
             "names": {0: "circle", 1: "rect"}}
    cb.train(data=split, epochs=2, save_period=1, imgsz=64, batch=2, nbs=2, workers=1,
             val=False, project=d, name="a")
    mid = cb.trainer.wdir / "epoch1.ckpt"
    assert events == [0, 1] and type(ckpt_module.load_checkpoint(mid)["opt_state"][1]).__name__ \
        == "PartitionState"
    resumed = pkg.YOLO(mid, device="cpu")
    resumed.train(data=split, resume=True, epochs=2, project=d, name="b")
    assert resumed.trainer.start_epoch == 1 and resumed.trainer.state.step == 4
tracking = {f"yolo_contour_regression_tpu_torch.{m}" for m in (
    "trackers", "trackers.basetrack", "trackers.bot_sort", "trackers.byte_tracker",
    "trackers.track", "trackers.utils.kalman_filter", "trackers.utils.lsa",
    "trackers.utils.matching", "ops.contours", "data.annotator", "data.converter")}
assert tracking <= set(mods), sorted(tracking - set(mods))
pan = chip_smoke.track_frames(3, 96, 128, seed=1)
n_tracked = 0
for name in ("botsort", "bytetrack"):
    tracked = model.track(pan, imgsz=64, tracker=name)
    assert all(r.track_ids.shape == (len(r),) for r in tracked)
    n_tracked += sum(len(c) for r in tracked for c in r.masks.xy)
exporting = {f"yolo_contour_regression_tpu_torch.{m}" for m in (
    "onnx", "onnx.builder", "onnx.export", "onnx.proto", "onnx.rtdetr", "engine.exporter",
    "nn.autobackend", "utils.torch_convert")}
assert exporting <= set(mods), sorted(exporting - set(mods))
import tempfile
with tempfile.TemporaryDirectory() as d:
    onnx_path = model.export(format="onnx", imgsz=64, project=d)
    exported = os.path.getsize(onnx_path)
int8_mods = {f"yolo_contour_regression_tpu_torch.{m}" for m in (
    "nn.quant", "utils.benchmarks", "utils.autobatch", "utils.torch_utils", "models.yolo",
    "models.yolo.model", "models.yolo.segment")}
assert int8_mods <= set(mods), sorted(int8_mods - set(mods))
calib = [np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)]
q = pkg.YOLO("runs/floor_seg160/best.ckpt", device="cpu").quantize(calib)
with tempfile.TemporaryDirectory() as d:
    q_back = pkg.YOLO(q.save(d + "/q.ckpt"), device="cpu")
    rows = q_back.benchmark(imgsz=64, batch=1, formats=["int8"], project=d, verbose=False)
n_int8 = sum(len(r) for r in q_back.predict(chip_smoke.shape_images(1, 120, 200, seed=0),
                                            imgsz=160))
assert q_back.model.quantized and rows[0]["status"] == "ok" and n_int8 > 0, (rows, n_int8)
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
assert not [n for n in sys.modules if n.split(".")[0] == "scipy"]
print("imported", len(mods), "modules;", sum(len(r) for r in res), "detections;",
      "val mask mAP50-95", val["metrics/mAP50-95(M)"], ";", "train step loss",
      float(metrics["loss"]), ";", "YOLO.train steps", trained, "; detect", n_det, "detections",
      "; SAM everything mode", len(gen[0]), "masks; served", len(served), "images;",
      "tracked contour points", n_tracked, "; onnx bytes", exported, "; int8 detections",
      n_int8)
"""


def test_port_imports_and_predicts_without_jax_cv2_yaml_triton():
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, ",".join(BLOCKED)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "detections" in res.stdout and "train step loss" in res.stdout
    assert "val mask mAP50-95" in res.stdout and "YOLO.train steps 2" in res.stdout
    assert "; detect" in res.stdout and "; SAM everything mode" in res.stdout
    assert "; served 2 images" in res.stdout and "tracked contour points" in res.stdout
    assert "; onnx bytes" in res.stdout and "; int8 detections" in res.stdout
    n_mods = int(res.stdout.split("imported ")[1].split()[0])
    assert n_mods >= 20  # ops, nn, utils, engine, data modules of the port
