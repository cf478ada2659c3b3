"""Resume against the JAX package on the CPU, both ways: the narrow
yolov8-seg trained by both trainers from the same initial weights (2
epochs on 8 images at imgsz 64, batch 4, the augmentation at the identity,
``save_period=1``), then resumed from the mid-run ``epoch1.ckpt`` of each:
the port resumed from JAX's checkpoint against JAX resumed from it, and JAX
resumed from the port's against JAX resumed from its own. The port's
mid-run checkpoints carry the optimizer state in optax's form (the repair of
the port's ``opt_state: None``), a resume restores the saved state exactly,
its first step on the batch the uninterrupted run took there gives that
run's state bit for bit, a cut run's ``results.csv`` carries on, and the
callbacks fire in JAX's order."""
import copy
import csv
import shutil
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.helpers import make_shape_dataset
from tests.torch_port_jax_init import compiled_init, compiled_trainer_init
from yolo_contour_regression_tpu.data import device_augment as jda
from yolo_contour_regression_tpu.engine import trainer as jtrainer
from yolo_contour_regression_tpu.nn.tasks import build_model
from yolo_contour_regression_tpu.utils import checkpoint as jckpt
from yolo_contour_regression_tpu_torch.engine import trainer as ttrainer
from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8_SEG
from yolo_contour_regression_tpu_torch.utils import DEFAULT_CALLBACK_EVENTS
from yolo_contour_regression_tpu_torch.utils import checkpoint as tckpt
from yolo_contour_regression_tpu_torch.utils import optim as toptim


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads beside the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NARROW = copy.deepcopy(YOLOV8_SEG)
NARROW.update(nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})
IDENTITY_AUG = dict(mosaic=0.0, mixup=0.0, fliplr=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
                    scale=0.0, translate=0.0)
# steps_per_dispatch 1 is JAX's path that the port takes; it goes into both
# checkpoints' train_args, which a resume restores
TRAIN = dict(task="segment", model=NARROW, epochs=2, imgsz=64, batch=4, nbs=4, workers=1,
             amp=False, plots=False, verbose=False, seed=0, exist_ok=True, save_period=1,
             steps_per_dispatch=1, **IDENTITY_AUG)
STEPS_PER_EPOCH = 2
# the resumed runs, as the 2-epoch trainers are held (test_torch_port_trainer.py):
# train losses relative, val metrics absolute
LOSS_RTOL = 1e-3
METRIC_ATOL = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


class Recorder:
    """Every callback event, in order, with the trainer's epoch."""

    def __init__(self):
        self.events = []

    def attach(self, trainer):
        for e in DEFAULT_CALLBACK_EVENTS:
            trainer.callbacks.setdefault(e, []).append(
                lambda t, e=e: self.events.append((e, t.epoch)))
        return self


def _state_copy(state):
    """Weights and BatchNorm statistics, EMA, moments and step of a port
    train state, cloned."""
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()
                      if not k.endswith("num_batches_tracked")},
            "ema": {k: v.clone() for k, v in state.ema.items()},
            "opt": {k: v.clone() for k, v in
                    toptim.moment_tensors(state.optimizer, state.model).items()},
            "step": state.step}


def _assert_states_equal(a, b):
    assert a["step"] == b["step"]
    for part in ("model", "ema", "opt"):
        assert sorted(a[part]) == sorted(b[part]), part
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


class CaptureTrainer(ttrainer.SegmentationTrainer):
    """The port's trainer that keeps, at optimizer step ``at`` (0-based, as
    the run counts them), the state before the step, the batch and the state
    after; with ``feed`` it steps on that batch in place of the loader's."""

    at, feed = 0, None

    def train_step(self, step_fn, state, images, batch):
        if state.step != self.at:
            return step_fn(state, images, batch)
        if self.feed is not None:
            images, batch = self.feed
        self.before = _state_copy(state)
        self.best_before = self.best_fitness
        self.batch = (images.clone(), {k: v.clone() for k, v in batch.items()})
        out = step_fn(state, images, batch)
        self.after = _state_copy(state)
        return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted runs of both trainers, and the resumed ones."""
    tmp = tmp_path_factory.mktemp("resume")
    yaml = make_shape_dataset(tmp / "ds", n_train=8, n_val=4, imgsz=64, seed=0)
    init = compiled_init(build_model(NARROW, nc=2), jax.random.PRNGKey(0), 64)

    def jax_init(model, generator):
        return tckpt.load_jax_variables(model, _np_tree(init["params"]),
                                        _np_tree(init["batch_stats"]))

    warp = jda._warp_image_separable
    jda._warp_image_separable = partial(warp, dtype=jnp.float32)
    orig = ttrainer.init_weights
    ttrainer.init_weights = jax_init
    out = {"tmp": tmp}
    try:
        def jax_run(name, **over):
            t = jtrainer.SegmentationTrainer(overrides={
                **TRAIN, "data": str(yaml), "project": str(tmp / "jax"), "name": name, **over})
            rec = Recorder().attach(t)
            with compiled_trainer_init():  # the init above, compiled once in the process
                return t, t.train(), rec

        def port_run(name, cls=ttrainer.SegmentationTrainer, **over):
            t = cls(overrides={**TRAIN, "project": str(tmp / "port"), "name": name, **over},
                    device="cpu")
            rec = Recorder().attach(t)
            return t, t.train(str(yaml)), rec

        out["jax"] = jax_run("full")
        CaptureTrainer.at = STEPS_PER_EPOCH  # the first step of the second epoch
        out["port"] = port_run("full", cls=CaptureTrainer)
        jmid = out["jax"][0].wdir / "epoch1.ckpt"
        pmid = out["port"][0].wdir / "epoch1.ckpt"
        out["jax_from_jax"] = jax_run("from_jax", resume=str(jmid))
        out["jax_from_port"] = jax_run("from_port", resume=str(pmid))
        out["port_from_jax"] = port_run("from_jax", resume=str(jmid))
        # a run cut after its first epoch: last.ckpt is the epoch-1 checkpoint and
        # results.csv holds one row; resume=True goes on in the same directory
        cut = tmp / "port" / "cut"
        shutil.copytree(out["port"][0].save_dir, cut)
        shutil.copyfile(cut / "weights" / "epoch1.ckpt", cut / "weights" / "last.ckpt")
        lines = (cut / "results.csv").read_text().splitlines(keepends=True)
        (cut / "results.csv").write_text("".join(lines[:2]))
        CaptureTrainer.feed = out["port"][0].batch
        out["port_cut"] = port_run("cut", cls=CaptureTrainer, resume=True)
    finally:
        jda._warp_image_separable = warp
        ttrainer.init_weights = orig
        CaptureTrainer.feed = None
    out["pmid"], out["jmid"] = pmid, jmid
    return out


def test_port_midrun_checkpoint_has_opt_state(runs):
    """The repair of the cross-package fault: the port's mid-run checkpoint
    holds the optimizer state (it held ``opt_state: None``, so JAX resumed
    it with fresh moments, a fresh EMA and step 0), with the structure of
    JAX's own mid-run checkpoint, its counts the step."""
    p, j = tckpt.load_checkpoint(runs["pmid"]), jckpt.load_checkpoint(runs["jmid"])
    assert p["opt_state"] is not None and p["step"] == j["step"] == STEPS_PER_EPOCH
    jp = jckpt.load_checkpoint(runs["pmid"])  # as JAX reads it: optax's own classes
    assert (jax.tree_util.tree_structure(jp["opt_state"])
            == jax.tree_util.tree_structure(j["opt_state"]))
    counts = [int(x) for path, x in jax.tree_util.tree_leaves_with_path(jp["opt_state"])
              if jax.tree_util.keystr(path).endswith(".count")]
    assert counts and set(counts) == {STEPS_PER_EPOCH}


def test_jax_restores_the_port_state(runs):
    """JAX resumed from the port's mid-run checkpoint holds, before it
    steps, the port's moments and EMA and its step (a JAX trainer run to
    ``epochs`` = the checkpoint's epoch + 1 restores and stops)."""
    p = jckpt.load_checkpoint(runs["pmid"])
    t = jtrainer.SegmentationTrainer(overrides={
        **TRAIN, "resume": str(runs["pmid"]), "epochs": 1, "project": str(runs["tmp"] / "jr"),
        "name": "r"})
    t.train()
    assert int(t.state.step) == p["step"]
    for a, b in zip(jax.tree_util.tree_leaves(t.state.opt_state),
                    jax.tree_util.tree_leaves(p["opt_state"]), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(t.state.ema_params),
                    jax.tree_util.tree_leaves(p["ema_params"]), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _compare_runs(got, want):
    (gt, gm, _), (wt, wm, _) = got, want
    gr, wr = _rows(gt.csv), _rows(wt.csv)
    assert list(gr[0]) == list(wr[0]) and len(gr) == len(wr) == 1
    assert gr[0]["epoch"] == wr[0]["epoch"] == "1"
    for k in wr[0]:
        if k.startswith("train/"):
            np.testing.assert_allclose(float(gr[0][k]), float(wr[0][k]), rtol=LOSS_RTOL,
                                       err_msg=k)
        elif k != "epoch":
            assert abs(float(gr[0][k]) - float(wr[0][k])) <= METRIC_ATOL, k
    assert list(gm) == list(wm)
    for k in wm:
        assert abs(gm[k] - wm[k]) <= METRIC_ATOL, k


def test_port_resumed_from_jax_matches_jax(runs):
    """The port resumed from JAX's mid-run checkpoint against JAX resumed
    from it: the resumed epoch's results.csv row and the final metrics
    (losses within ``LOSS_RTOL``, metrics within ``METRIC_ATOL``)."""
    _compare_runs(runs["port_from_jax"], runs["jax_from_jax"])


def test_jax_resumed_from_port_matches_jax(runs):
    """JAX resumed from the port's mid-run checkpoint against JAX resumed
    from its own: the same limits."""
    _compare_runs(runs["jax_from_port"], runs["jax_from_jax"])


def test_resume_restores_the_saved_state(runs):
    """The cut run resumed: before its first step the trainer holds the
    checkpoint's weights, BatchNorm statistics, EMA, moments and step bit
    for bit (the state the uninterrupted run had there), and its
    ``start_epoch`` and ``best_fitness`` are the checkpoint's."""
    t = runs["port_cut"][0]
    ckpt = tckpt.load_checkpoint(runs["pmid"])
    _assert_states_equal(t.before, runs["port"][0].before)
    assert t.start_epoch == ckpt["epoch"] + 1 == 1
    assert t.best_before == ckpt["best_fitness"] == runs["port"][0].best_before


def test_first_resumed_step_is_bit_exact(runs):
    """Fed the batch the uninterrupted run took at that step, the resumed
    trainer's first step gives that run's weights, EMA and moments bit for
    bit."""
    a, b = runs["port_cut"][0], runs["port"][0]
    for k in b.batch[1]:
        assert torch.equal(a.batch[1][k], b.batch[1][k])
    _assert_states_equal(a.after, b.after)


def test_cut_run_results_csv_carries_on(runs):
    """resume=True in the cut run's directory: results.csv keeps its first
    row and gets the resumed epoch's after it; the final checkpoints are
    stripped as at the end of any run."""
    t = runs["port_cut"][0]
    rows = _rows(t.csv)
    first = _rows(runs["port"][0].csv)[0]
    assert [r["epoch"] for r in rows] == ["0", "1"] and rows[0] == first
    assert t.save_dir == runs["tmp"] / "port" / "cut"
    assert tckpt.load_checkpoint(t.wdir / "last.ckpt")["opt_state"] is None


def test_callbacks_fire_in_jax_order(runs):
    """The same events in the same order, epoch for epoch, on the 2-epoch
    runs (and on the resumed ones, from the resumed epoch)."""
    for port, jax_ in (("port", "jax"), ("port_from_jax", "jax_from_jax")):
        got, want = runs[port][2].events, runs[jax_][2].events
        assert got == want, (port, got, want)
    assert [e for e, _ in runs["port"][2].events] == [
        "on_train_start", "on_train_epoch_start", "on_fit_epoch_end", "on_model_save",
        "on_train_epoch_start", "on_fit_epoch_end", "on_model_save", "on_train_end"]


def test_a_failing_callback_is_logged(tmp_path, caplog):
    """A callback that raises is logged and the run goes on, as in JAX."""
    from yolo_contour_regression_tpu_torch.utils.callbacks import run_callbacks

    class T:
        callbacks = {"on_train_start": [lambda t: 1 / 0, lambda t: seen.append(1)]}

    seen = []
    run_callbacks(T(), "on_train_start")
    assert seen == [1] and "on_train_start failed" in caplog.text


def test_resume_keeps_the_host_chain(tmp_path, monkeypatch):
    """A run on the host train chain (``copy_paste`` > 0), cut after its
    first epoch and resumed through ``YOLO(last.ckpt).train(resume=True)``
    with its overrides not repeated (but ``epochs``, which a resume keeps
    from the call, as JAX's does), goes on with the host chain: the
    augmentation is chosen from the arguments the resume restored, as JAX
    builds its dataset from them. The resumed loader starts its
    ``random.Random(seed)`` again (JAX's quirk), so the resumed run's first
    batch is the one the uninterrupted run took first."""
    from yolo_contour_regression_tpu_torch import YOLO

    yaml = make_shape_dataset(tmp_path / "ds", n_train=8, n_val=4, imgsz=64, seed=0)
    taken = []
    step = ttrainer.BaseTrainer.train_step

    def record(self, step_fn, state, images, batch):
        taken.append((self.device_augment, images.clone(),
                       {k: v.clone() for k, v in batch.items()}))
        return step(self, step_fn, state, images, batch)

    monkeypatch.setattr(ttrainer.BaseTrainer, "train_step", record)
    full = ttrainer.SegmentationTrainer(overrides={
        **TRAIN, "copy_paste": 0.1, "project": str(tmp_path), "name": "full"}, device="cpu")
    full.train(str(yaml))
    assert not full.device_augment and len(taken) == 2 * STEPS_PER_EPOCH
    first = taken[0]
    cut = tmp_path / "cut"
    shutil.copytree(full.save_dir, cut)
    shutil.copyfile(cut / "weights" / "epoch1.ckpt", cut / "weights" / "last.ckpt")
    taken.clear()
    model = YOLO(str(cut / "weights" / "last.ckpt"), device="cpu")
    model.train(resume=True, epochs=2, project=str(tmp_path), name="cut")  # its directory
    assert model.trainer.args.copy_paste == 0.1 and not model.trainer.device_augment
    assert model.trainer.save_dir == cut
    assert len(taken) == STEPS_PER_EPOCH and not taken[0][0]
    assert taken[0][1].dtype == first[1].dtype and torch.equal(taken[0][1], first[1])
    assert sorted(taken[0][2]) == sorted(first[2])
    for k in first[2]:
        assert torch.equal(taken[0][2][k], first[2][k]), k
