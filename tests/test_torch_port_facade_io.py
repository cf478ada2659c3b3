"""The facade's lifecycle against the JAX package on the CPU: ``save`` of a
fused (and an unfused) port model, which JAX's ``YOLO(path)`` loads and
predicts from as the port does; ``info`` equal to JAX's dict; ``load``,
``reset_weights``, ``to``, the callbacks kept for the next trainer and
``train(resume=True)`` from a checkpoint; ``strip_optimizer(half=True)``
against JAX's; and the asynchronous saver: its files leaf-equal to a
synchronous save of the same state (the snapshot taken at ``submit``, not
when the worker writes), and a failed write raised at the next ``submit``
or ``wait``."""
import copy
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from chip_smoke import floor_val_set
from tests.helpers import make_shape_dataset
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.utils import checkpoint as jckpt
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine import trainer as ttrainer
from yolo_contour_regression_tpu_torch.engine.step import init_train_state, make_train_step
from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8_SEG, build_model, init_weights
from yolo_contour_regression_tpu_torch.utils import checkpoint as tckpt
from yolo_contour_regression_tpu_torch.utils import optim as toptim

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs" / "floor_seg160" / "best.ckpt"
BOX_PX, SCORE_ATOL = 0.05, 1e-4
NARROW = copy.deepcopy(YOLOV8_SEG)
NARROW.update(nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads beside the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same_detections(got, want, exact=False):
    n = 0
    for g, w in zip(got, want, strict=True):
        wd = np.asarray(w.boxes.data, np.float32)
        assert np.asarray(g.boxes.data).shape == wd.shape
        np.testing.assert_array_equal(g.boxes.cls, wd[:, 5])
        if exact:
            np.testing.assert_array_equal(g.boxes.data, w.boxes.data)
            np.testing.assert_array_equal(g.contours.points, w.contours.points)
        else:
            np.testing.assert_allclose(g.boxes.xyxy, wd[:, :4], atol=BOX_PX)
            np.testing.assert_allclose(g.boxes.conf, wd[:, 4], atol=SCORE_ATOL)
        n += len(g)
    assert n >= 4


@pytest.mark.parametrize("fuse", [True, False])
def test_save_is_loaded_by_jax(tmp_path, fuse):
    """``YOLO(ckpt).fuse().save(p)`` (and ``save`` unfused): JAX's
    ``YOLO(p)`` loads it and predicts the port's detections (boxes within
    ``BOX_PX``, scores within ``SCORE_ATOL``); the port's ``YOLO(p)``
    predicts the saved model's bit for bit; the file is JAX's ``save``
    format (deploy marker, step 0, epoch -1, no EMA, no optimizer state)."""
    images = floor_val_set()[0][:6]
    m = YOLO(CKPT, device="cpu")
    if fuse:
        m.fuse()
    path = m.save(tmp_path / "m.ckpt")
    ckpt = tckpt.load_checkpoint(path)
    assert ckpt["deploy"] == ("fused" if fuse else None)
    assert (ckpt["step"], ckpt["epoch"], ckpt["ema_params"], ckpt["opt_state"]) == (0, -1, None,
                                                                                   None)
    assert ckpt["train_args"]["task"] == "segment" and ckpt["names"] == m.names
    want = m.predict(images, imgsz=160)
    _same_detections(JaxYOLO(str(path)).predict(images, imgsz=160), want)
    back = YOLO(path, device="cpu")
    assert back.model.fused == fuse
    _same_detections(back.predict(images, imgsz=160), want, exact=True)


@pytest.mark.parametrize("model", ["yolov8n-seg.yaml", "yolov8n-pose.yaml", "yolov8n-cls.yaml",
                                   str(CKPT)])
def test_info_matches_jax(model):
    """``info()`` and ``info(detailed=True)``: JAX's dict, row for row."""
    j, t = JaxYOLO(model), YOLO(model, device="cpu")
    assert t.info() == j.info()
    jd, td = j.info(detailed=True), t.info(detailed=True)
    assert td.keys() == jd.keys()
    for a, b in zip(td["layers_detail"], jd["layers_detail"], strict=True):
        assert a == b, (a, b)


def test_load_reset_and_to(tmp_path):
    """``load`` reads another checkpoint into the facade; ``reset_weights``
    draws the trainer's seed-0 init; ``to`` moves the model; ``device`` is
    the facade's."""
    m = YOLO(CKPT, device="cpu")
    sd = {k: v.clone() for k, v in m.model.state_dict().items()}
    m.reset_weights()
    fresh = init_weights(build_model(tckpt.load_checkpoint(CKPT)["model_yaml"]),
                         torch.Generator().manual_seed(0))
    for k, v in fresh.state_dict().items():
        assert torch.equal(m.model.state_dict()[k], v), k
    assert m.load(CKPT) is m
    for k, v in sd.items():
        assert torch.equal(m.model.state_dict()[k], v), k
    assert m.to("cpu") is m and m.device == torch.device("cpu")
    assert next(m.model.parameters()).device == torch.device("cpu")


def test_callbacks_and_resume_through_the_facade(tmp_path):
    """Callbacks added to the facade fire in its next trainer
    (``clear_callback`` and ``reset_callbacks`` drop them);
    ``YOLO(epoch1.ckpt).train(resume=True)`` goes on from that checkpoint
    at its epoch and step (``epochs`` is the call's, as in JAX: a resume
    does not restore it); training a checkpoint without ``resume`` raises
    as before."""
    yaml = make_shape_dataset(tmp_path / "ds", n_train=8, n_val=2, imgsz=64, seed=0)
    seen = []
    m = YOLO("yolov8n-seg.yaml", device="cpu")
    m.add_callback("on_train_start", lambda t: seen.append(("start", t.epoch)))
    m.add_callback("on_model_save", lambda t: seen.append(("save", t.epoch)))
    m.add_callback("on_train_end", lambda t: seen.append(("end", t.epoch)))
    m.clear_callback("on_train_start")
    kw = dict(model=NARROW, epochs=2, imgsz=64, batch=4, nbs=4, workers=1, save_period=1,
              project=str(tmp_path), name="a", plots=False)
    m.train(data=str(yaml), **kw)
    assert seen == [("save", 0), ("save", 1), ("end", 1)]
    mid = m.trainer.wdir / "epoch1.ckpt"
    r = YOLO(mid, device="cpu")
    with pytest.raises(NotImplementedError, match="resume"):
        r.train(data=str(yaml))
    r.reset_callbacks()
    r.train(resume=True, epochs=2, project=str(tmp_path), name="b")  # epochs is not restored
    assert r.trainer.start_epoch == 1 and r.trainer.state.step == 4
    assert [t["epoch"] for t in r.trainer.epoch_times] == [1]


def test_strip_optimizer_half_matches_jax(tmp_path):
    """``strip_optimizer(half=True)`` gives JAX's file: the EMA as float16
    params, float16 statistics, no EMA and no optimizer state; the facade
    loads it (cast back to float32)."""
    src = tmp_path / "a.ckpt"
    m = YOLO(CKPT, device="cpu")
    params, stats = tckpt.to_jax_variables(m.model.state_dict())
    tckpt.save_checkpoint(src, params, stats, params, step=3, epoch=1, best_fitness=0.5,
                          train_args={"task": "segment", "imgsz": 160},
                          model_yaml=tckpt.load_checkpoint(CKPT)["model_yaml"], names=m.names)
    jckpt.strip_optimizer(src, out_path=str(tmp_path / "j.ckpt"), half=True)
    tckpt.strip_optimizer(src, out_path=tmp_path / "t.ckpt", half=True)
    j, t = jckpt.load_checkpoint(tmp_path / "j.ckpt"), tckpt.load_checkpoint(tmp_path / "t.ckpt")
    assert set(t) == set(j) and t["opt_state"] is None and t["ema_params"] is None
    for key in ("params", "batch_stats"):
        jl, tl = jax.tree_util.tree_leaves(j[key]), jax.tree_util.tree_leaves(t[key])
        assert len(jl) == len(tl) and all(x.dtype == np.float16 for x in tl)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(a, b)
    images = floor_val_set()[0][:4]
    _same_detections(YOLO(tmp_path / "t.ckpt", device="cpu").predict(images, imgsz=160),
                     JaxYOLO(str(tmp_path / "j.ckpt")).predict(images, imgsz=160))


def _state():
    """A narrow model's train state after one AdamW step."""
    model = init_weights(build_model(NARROW, nc=2), torch.Generator().manual_seed(0))
    from types import SimpleNamespace
    hyp = SimpleNamespace(optimizer="AdamW", nc=2, lr0=0.01, lrf=0.01, momentum=0.9,
                          weight_decay=5e-4, warmup_epochs=0.0, warmup_bias_lr=0.0, epochs=1,
                          batch=2, nbs=2, box=7.5, cls=0.5, dfl=1.5)
    opt = toptim.build_optimizer(model, hyp, 1, 1)
    state = init_train_state(model, opt, device="cpu")
    from chip_smoke import shape_batch
    images, batch = shape_batch(2, 64, 3, seed=0)
    step = make_train_step(model, opt, hyp)
    args = (torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in batch.items()})
    step(state, *args)
    return state, step, args


def _meta(state):
    return dict(step=state.step, epoch=0, best_fitness=0.25, train_args={"task": "segment"},
                model_yaml=NARROW, names={0: "a", 1: "b"})


def _build_args(state):
    return toptim.optimizer_spec(state.optimizer, state.step), _meta(state)


def _same_checkpoint(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "date":
            continue
        la, ta = jax.tree_util.tree_flatten(a[k])
        lb, tb = jax.tree_util.tree_flatten(b[k])
        assert str(ta) == str(tb), k
        for x, y in zip(la, lb, strict=True):
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_async_save_equals_a_synchronous_save(tmp_path):
    """The saver's files (two paths from one snapshot, written by its
    writer process) equal, leaf for leaf, a synchronous save of the state
    at ``submit``: the state stepped again at once does not reach them."""
    state, step, args = _state()
    sync = ttrainer.train_checkpoint(ttrainer.checkpoint_tensors(state), *_build_args(state))
    tckpt.write_checkpoint(tmp_path / "sync.ckpt", sync)
    saver = tckpt.AsyncCheckpointSaver()
    try:
        saver.submit([tmp_path / "last.ckpt", tmp_path / "best.ckpt"],
                     ttrainer.checkpoint_tensors(state), ttrainer.train_checkpoint,
                     *_build_args(state))
        step(state, *args)
        saver.wait()
        assert len(saver.write_s) == 1 and saver._writer.proc.poll() is None
    finally:
        saver.close()
    assert saver._shm is None
    want = tckpt.load_checkpoint(tmp_path / "sync.ckpt")
    for name in ("last.ckpt", "best.ckpt"):
        _same_checkpoint(tckpt.load_checkpoint(tmp_path / name), want)
    assert not list(tmp_path.glob("*.tmp"))


def test_async_save_failure_raises(tmp_path):
    """A failed write (a path under a file) raises at the next ``wait`` and
    at the next ``submit``, naming the async save; the checkpoint it would
    have replaced stays."""
    state, _, _ = _state()
    tensors = ttrainer.checkpoint_tensors(state)
    build = (ttrainer.train_checkpoint, *_build_args(state))
    (tmp_path / "file").write_text("not a directory")
    saver = tckpt.AsyncCheckpointSaver()
    try:
        saver.submit([tmp_path / "last.ckpt"], tensors, *build)
        saver.wait()
        before = (tmp_path / "last.ckpt").read_bytes()
        saver.submit([tmp_path / "file" / "last.ckpt"], tensors, *build)
        with pytest.raises(RuntimeError, match="async checkpoint save failed") as e:
            saver.wait()
        assert isinstance(e.value.__cause__, OSError)
        saver.submit([tmp_path / "file" / "last.ckpt"], tensors, *build)
        with pytest.raises(RuntimeError, match="async checkpoint save failed"):
            saver.submit([tmp_path / "last.ckpt"], tensors, *build)
        saver.wait()  # the refused submit started nothing
    finally:
        saver.close()
    assert (tmp_path / "last.ckpt").read_bytes() == before


@pytest.mark.parametrize("extra", [{}, {"project": Path("runs/x"), "fitness": np.float64(0.5)}])
def test_writer_reads_back_and_falls_back(tmp_path, extra):
    """``write_checkpoint`` pickles a checkpoint that ``pickle.load`` (JAX's
    reader) and the port's reader read back leaf for leaf, with any value a
    JAX checkpoint's ``train_args`` may hold (a ``Path``, a numpy scalar)
    read back the same."""
    state, _, _ = _state()
    meta = _meta(state)
    meta["train_args"] = {**meta["train_args"], "flip_idx": (0, 2, 1), "big": 1 << 40,
                          "neg": -3, "text": "é" * 300, "none": None}
    ckpt = ttrainer.train_checkpoint(ttrainer.checkpoint_tensors(state),
                                     toptim.optimizer_spec(state.optimizer, state.step), meta)
    ckpt["train_args"].update(extra)
    tckpt.write_checkpoint(tmp_path / "a.ckpt", ckpt)
    for got in (jckpt.load_checkpoint(tmp_path / "a.ckpt"), tckpt.load_checkpoint(tmp_path / "a.ckpt")):
        for k in ckpt:
            if k in ("train_args", "names", "model_yaml", "date", "version", "deploy"):
                assert got[k] == ckpt[k], k
            elif k != "opt_state":
                _same_checkpoint({k: got[k]}, {k: ckpt[k]})
