"""The port's data parallelism (``parallel/mesh.py``) on the CPU: the
trainer's mesh against JAX's ``build_train_mesh``; one train step on two
gloo ranks against one process on the concatenated batch, in float64, for
the six task losses (segment, detect, pose, segment_ori, classify and
RT-DETR: the global BatchNorm statistics, loss normalizers, CDN draws and
gradient); the polar loss and gradient on two ranks against JAX's step on a
2-device mesh; the ranks' states bit-identical after 3 steps; the launcher
when a rank fails; ``tp > 1`` refused; the rank-sharded loader.

The ranks are spawned processes that import ``tests/torch_port_ranks.py``
(no JAX) and meet through a file store; they run the caller's two torch
threads."""
import copy
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import pose_batch, shape_batch, shape_images
from tests import torch_port_ranks as ranks
from tests.test_torch_port_train import NARROW as SEG_NARROW
from tests.test_torch_port_train import _f64, _hyp, _narrow_variables
from yolo_contour_regression_tpu.engine import step as jstep
from yolo_contour_regression_tpu.nn.tasks import build_model as jbuild_model
from yolo_contour_regression_tpu.parallel import mesh as jmesh
from yolo_contour_regression_tpu.utils import loss as jloss
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch import parallel
from yolo_contour_regression_tpu_torch.cfg import get_cfg
from yolo_contour_regression_tpu_torch.data.build import TrainLoader
from yolo_contour_regression_tpu_torch.data.dataset import TrainDataset
from yolo_contour_regression_tpu_torch.engine.trainer import pad_instances
from yolo_contour_regression_tpu_torch.models.utils.ops import cdn_generator, get_cdn_group
from yolo_contour_regression_tpu_torch.nn.tasks import (YOLOV8, YOLOV8_CLS, YOLOV8_POSE,
                                                        YOLOV8_RTDETR, YOLOV8_SEG, YOLOV8_SEGORI,
                                                        build_model, init_weights)
from yolo_contour_regression_tpu_torch.utils.checkpoint import (from_jax_variables,
                                                                load_jax_variables)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs (the spawned ranks take the
    caller's count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# W = 2 against W = 1, both in float64 (the loss math too, ``loss_dtype``):
# the loss relative, each gradient of its tensor's largest entry, the
# BatchNorm running statistics absolute (O(1) values)
W_LOSS_RTOL = 1e-10
W_GRAD_TOL = 1e-9
W_STATS_ATOL = 1e-12
# a gradient whose largest entry is below this share of the model's largest
# is rounding noise (a zero gradient); it must stay that small
NOISE = 1e-12
# the polar step against JAX's float64 network (the train-step tests')
JAX_LOSS_RTOL = 1e-4
JAX_GRAD_TOL = 1e-3
STEPS = 3
TASKS = ("segment", "detect", "pose", "segment_ori", "classify", "rtdetr")
KPT = [5, 3]


def _narrow(task):
    base = {"segment": YOLOV8_SEG, "detect": YOLOV8, "pose": YOLOV8_POSE,
            "segment_ori": YOLOV8_SEGORI, "classify": YOLOV8_CLS, "rtdetr": YOLOV8_RTDETR}[task]
    cfg = copy.deepcopy(base)
    cfg.update(nc=1 if task == "pose" else 2, scale="t", scales={"t": [0.33, 0.125, 256]})
    if task == "pose":
        cfg["kpt_shape"] = KPT
    if task == "segment_ori":
        cfg["head"][-1][3] = ["nc", 8, 32]  # 8 prototypes of 32 channels
    return cfg


def _job(task, seed):
    """One task's float64 step job: a fresh narrow model, a batch of 4 at
    imgsz 64 (classify: 32), AdamW past warmup."""
    cfg = _narrow(task)
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(seed))
    if task == "classify":
        images = np.stack(shape_images(4, 32, 32, seed)).astype(np.float32) / 255.0
        batch = {"cls": np.array([0, 1, 1, 0], np.int32)}
    else:
        images, batch = shape_batch(4, 64, 4, seed=seed)
        if task == "pose":
            batch = pose_batch(batch, KPT[0])
    hyp = vars(get_cfg(None, {"optimizer": "AdamW", "lr0": 0.001, "warmup_epochs": 0.0,
                              "warmup_bias_lr": 0.0, "batch": 4, "nbs": 4}))
    hyp.update(nc=cfg["nc"], loss_dtype=torch.float64)
    return dict(kind="step", task=task, cfg=cfg, state=model.state_dict(), dtype=torch.float64,
                hyp=hyp, images=images, batch=batch, steps=STEPS)


def _polar_job():
    """The polar loss job on the JAX-seeded narrow graph, float32."""
    jm = jbuild_model(SEG_NARROW)
    v = _narrow_variables(jm, seed=5)
    images, batch = shape_batch(4, 64, 4, seed=6)
    model = load_jax_variables(build_model(SEG_NARROW), v["params"], v["batch_stats"])
    return dict(kind="polar_loss", cfg=SEG_NARROW, state=model.state_dict(),
                dtype=torch.float32, hyp=vars(_hyp("AdamW")), images=images, batch=batch,
                variables=v)


@pytest.fixture(scope="module")
def runs():
    """Every job once on two gloo ranks (one launch, in a thread) and,
    meanwhile, the step jobs on this process."""
    jobs = [_job(task, seed) for seed, task in enumerate(TASKS, 11)] + [_polar_job()]
    with ThreadPoolExecutor(1) as ex:
        two = ex.submit(parallel.launch, ranks.run_jobs, ["cpu", "cpu"], args=(jobs,),
                        timeout_s=300)
        ref = ranks.run_jobs(0, torch.device("cpu"), jobs[:-1])
        return {"jobs": jobs, "one": ref, "two": two.result()}


def _gap(got, want):
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.double().abs().max()), 1e-300)


@pytest.mark.parametrize("task", TASKS)
def test_two_ranks_equal_one_process_f64(runs, task):
    """The first step on 2 ranks (each on its 2 rows of the batch of 4)
    against one process on all 4: the loss and every loss item within
    1e-10 relative, every gradient (summed over the ranks, clipped by the
    global norm) within 1e-9 of its tensor's largest entry, the BatchNorm
    running statistics within 1e-12, and the update counters equal. Both
    ranks report the same global loss."""
    i = TASKS.index(task)
    one, r0, r1 = runs["one"][i], runs["two"][0][i], runs["two"][1][i]
    want = one["metrics"][0]
    assert set(r0["metrics"][0]) == set(want)
    for k, w in want.items():
        assert r0["metrics"][0][k] == r1["metrics"][0][k], k
        np.testing.assert_allclose(r0["metrics"][0][k], w, rtol=W_LOSS_RTOL, err_msg=k)
    assert want["loss"] > 0
    assert set(r0["grads"]) == set(one["grads"])
    top = max(float(w.abs().max()) for w in one["grads"].values())
    for n, w in one["grads"].items():
        # RT-DETR's self-attention key biases have a zero gradient (a
        # softmax ignores a shift): both sides hold rounding noise there
        if float(w.abs().max()) > NOISE * top:
            assert _gap(r0["grads"][n], w) <= W_GRAD_TOL, n
        else:
            assert float(r0["grads"][n].abs().max()) <= NOISE * top, n
    n_stats = 0
    for n, w in one["buffers"].items():
        if n.endswith(("running_mean", "running_var")):
            n_stats += 1
            assert float((r0["buffers"][n] - w).abs().max()) <= W_STATS_ATOL, n
        else:
            assert torch.equal(r0["buffers"][n], w), n
    assert n_stats > 0


@pytest.mark.parametrize("task", TASKS)
def test_ranks_bit_identical_after_three_steps(runs, task):
    """After 3 steps the two ranks hold bit-identical parameters, BatchNorm
    statistics and EMA: every rank applied the same summed gradient."""
    i = TASKS.index(task)
    r0, r1 = runs["two"][0][i], runs["two"][1][i]
    assert len(r0["metrics"]) == STEPS
    for what in ("state", "ema"):
        assert set(r0[what]) == set(r1[what])
        for n, t in r0[what].items():
            assert torch.equal(t, r1[what][n]), (what, n)
    # the parameters moved
    init = runs["jobs"][i]["state"]
    assert any(not torch.equal(r0["state"][n].float(), init[n].float()) for n in init
               if init[n].is_floating_point())


def test_polar_two_ranks_match_jax_two_device_mesh(runs, monkeypatch):
    """The polar loss and gradient on 2 ranks (float32, each on 2 of the 4
    images) against JAX's ``make_loss_fn`` under ``jax.jit`` with the batch
    sharded over a 2-device CPU mesh and the parameters replicated, JAX's
    network in float64 as the train-step tests take it: the loss within
    1e-4 relative, each gradient within 1e-3 of its tensor's largest, and
    the same assignment (JAX's on its head maps)."""
    job = runs["jobs"][-1]
    got = [runs["two"][0][-1], runs["two"][1][-1]]
    hyp = _hyp("AdamW")
    captured = {}
    orig = jloss.polar_task_aligned_assign

    def keep(*a, **kw):
        captured["assign"] = orig(*a, **kw)
        return captured["assign"]

    with jax.enable_x64(True):
        jm64 = jbuild_model(SEG_NARROW, dtype=jnp.float64)
        v64 = _f64(job["variables"])
        mesh = jmesh.create_mesh(jax.devices()[:2])
        assert mesh.shape == {"batch": 2}
        x = jmesh.shard_batch(mesh, jnp.asarray(job["images"], jnp.float64))
        jb = jmesh.shard_batch(mesh, {k: jnp.asarray(a) for k, a in job["batch"].items()})
        params = jmesh.replicate_tree(mesh, v64["params"])
        stats = jmesh.replicate_tree(mesh, v64["batch_stats"])
        fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm64, hyp, cand=128), has_aux=True))
        (jl, (jitems, _)), jg = fn(params, stats, x, jb)
        jl, jg = float(jl), from_jax_variables(jax.tree_util.tree_map(np.asarray, jg), {})
        monkeypatch.setattr(jloss, "polar_task_aligned_assign", keep)

        def assign_fn(v, x, b):
            jout, _ = jm64.raw_forward(v, x, train=True)
            jloss.segmentation_loss(jout, b, jm64.strides, 2, hyp, cand=128)
            return captured["assign"].fg_mask, captured["assign"].target_gt_idx

        jfg, jidx = map(np.asarray, jax.jit(assign_fn)(v64, x, jb))
    assert got[0]["loss"] == got[1]["loss"]
    np.testing.assert_allclose(got[0]["loss"], jl, rtol=JAX_LOSS_RTOL)
    for k, v in jitems.items():
        np.testing.assert_allclose(got[0]["items"][k], float(v), rtol=JAX_LOSS_RTOL, err_msg=k)
    assert set(got[0]["grads"]) == set(jg)
    for n, w in jg.items():
        assert torch.equal(got[0]["grads"][n], got[1]["grads"][n]), n
        assert _gap(got[0]["grads"][n], w) <= JAX_GRAD_TOL, n
    fg = np.concatenate([g["fg_mask"] for g in got])
    idx = np.concatenate([g["target_gt_idx"] for g in got])
    np.testing.assert_array_equal(fg, jfg)
    np.testing.assert_array_equal(idx[fg], jidx[jfg])
    assert int(fg.sum()) > 0


def test_a_failing_rank_fails_the_launch():
    """Rank 1 raises while rank 0 waits in an all-reduce: the launcher
    raises ``RankFailed`` with rank 1's traceback, well inside the group's
    timeout, and leaves no rank running."""
    t0 = time.perf_counter()
    with pytest.raises(parallel.RankFailed, match="rank 1 fails on purpose"):
        parallel.launch(ranks.failing_rank, ["cpu", "cpu"], args=(1,), timeout_s=60)
    assert time.perf_counter() - t0 < 60
    import multiprocessing

    assert not [p for p in multiprocessing.active_children() if p.name.startswith("rank")]


@pytest.mark.parametrize("n_dev", range(1, 9))
def test_build_train_mesh_matches_jax(n_dev):
    """The trainer's mesh over 1-8 devices and batches 1-16 at tp 1: the
    same device count and axes as JAX's (the largest count that divides
    the batch), the first devices of the list."""
    jdevs = jax.devices()[:n_dev]
    tdevs = [f"cpu:{i}" for i in range(n_dev)]
    for batch in range(1, 17):
        jm = jmesh.build_train_mesh(jdevs, batch, tp=1)
        tm = parallel.build_train_mesh(tdevs, batch, tp=1)
        assert tm.shape == dict(jm.shape), (n_dev, batch)
        assert tm.size == jm.devices.size
        assert [str(d) for d in tm.devices] == tdevs[:tm.size]


def test_tp_is_refused():
    """A model axis is not ported: ``build_train_mesh(tp=2)``, a mesh with a
    ``model`` axis, and ``YOLO.train(tp=2)`` raise ``NotImplementedError``
    naming the ROADMAP item; ``tp=1`` trains as before."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 2.1"):
        parallel.build_train_mesh(["cpu", "cpu"], 4, tp=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2.1"):
        parallel.create_mesh(["cpu", "cpu"], axes={"batch": 1, "model": 2})
    images, batch = shape_batch(2, 32, 2, seed=3)
    u8 = [(im * 255).astype(np.uint8) for im in images]
    labels = [(batch["cls"][i][batch["mask_gt"][i]], batch["bboxes"][i][batch["mask_gt"][i]],
               batch["segments"][i][batch["mask_gt"][i]]) for i in range(2)]
    data = {"train": (u8, labels), "val": (u8, labels), "names": {0: "circle", 1: "rect"}}
    kw = dict(epochs=1, imgsz=32, batch=2, nbs=2, workers=1, val=False, save=False)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2.1"):
        YOLO("yolov8n-seg.yaml", device="cpu").train(data, tp=2, **kw)
    m = YOLO("yolov8n-seg.yaml", device="cpu")
    m.train(data, tp=1, **kw)
    assert m.trainer.state.step == 1


def test_loader_ranks_split_each_global_batch():
    """``TrainLoader(rank, world)``: over the host chain (draws made in read
    order), the two ranks' rows of each global batch are the one-rank
    loader's batch, byte for byte: the draws advance for the whole global
    batch on every rank."""
    images, batch = shape_batch(8, 48, 4, seed=4)
    u8 = [(im * 255).astype(np.uint8) for im in images]
    labels = [(batch["cls"][i][batch["mask_gt"][i]], batch["bboxes"][i][batch["mask_gt"][i]],
               batch["segments"][i][batch["mask_gt"][i]]) for i in range(8)]
    hyp = get_cfg(None, {"mixup": 0.5})

    def first_batches(rank, world, n=2):
        ds = TrainDataset(u8, labels, imgsz=48, device_augment=False, hyp=hyp, seed=5)
        it = iter(TrainLoader(ds, 4, workers=1, seed=5, in_order=True, rank=rank, world=world))
        try:
            return [next(it) for _ in range(n)]
        finally:
            it.close()

    one = first_batches(0, 1)
    two = [first_batches(r, 2) for r in range(2)]
    for k, b in enumerate(one):
        n = b["mask_gt"].shape[1]  # the trainer widens each rank's pad to the global one
        halves = [pad_instances(dict(two[r][k]), n) for r in range(2)]
        for key in b:
            np.testing.assert_array_equal(np.concatenate([h[key] for h in halves]), b[key],
                                          err_msg=key)
    with pytest.raises(ValueError, match="does not split"):
        TrainLoader(TrainDataset(u8, labels, imgsz=48, hyp=hyp), 3, rank=0, world=2)


def test_cdn_draws_are_the_global_batch_rows():
    """RT-DETR's CDN groups on a rank (``shard=(r, 2)``) are rows of the
    groups drawn for the global batch, as JAX draws them on the global
    array."""
    _, batch = shape_batch(4, 64, 3, seed=8)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    whole = get_cdn_group(tb, 2, cdn_generator(5))
    for r in range(2):
        part = get_cdn_group({k: v[2 * r:2 * r + 2] for k, v in tb.items()}, 2, cdn_generator(5),
                             shard=(r, 2))
        for k, v in whole.items():
            assert torch.equal(part[k], v[2 * r:2 * r + 2]), (r, k)


def test_placement_helpers():
    """``shard_batch`` and ``shard_microbatches`` take contiguous rows;
    ``replicate`` makes a copy a device; ``resolve_devices`` reads a list,
    and ``"cuda"`` needs a card."""
    x = {"a": np.arange(12).reshape(6, 2), "b": torch.arange(6)}
    parts = parallel.shard_batch(x, 3)
    assert [p["b"].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    np.testing.assert_array_equal(parts[1]["a"], x["a"][2:4])
    stacked = np.arange(2 * 4).reshape(2, 4)
    np.testing.assert_array_equal(parallel.shard_microbatches(stacked, 1, 2), stacked[:, 2:])
    with pytest.raises(ValueError):
        parallel.shard_batch(np.zeros((5, 1)), 2)
    m = torch.nn.Linear(2, 2)
    copies = parallel.replicate(m, ["cpu", "cpu"])
    assert len(copies) == 2 and copies[0] is not copies[1] and copies[0].weight is not m.weight
    assert torch.equal(copies[1].weight, m.weight)
    assert parallel.resolve_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert parallel.world_size() == 1 and parallel.rank() == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.resolve_devices("cuda")
