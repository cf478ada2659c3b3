"""The port's seg trainer on two gloo ranks (CPU) against the JAX
package's trainer at the same global batch, which the suite's 8 host
devices make a 2-device mesh: both train the narrow yolov8-seg graph from
JAX's initial weights for 2 epochs on the 8 images of a ``make_shape_dataset``
yaml at imgsz 64, batch 2, with the augmentation reduced to the identity
(so JAX's per-shard augmentation and the port's per-rank draws agree), and
read the splits from disk. The results.csv rows and the final metrics
agree; rank 0 alone writes the run's files. And two processes started with
``torchrun``'s environment join one group."""
import copy
import csv
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests import torch_port_ranks as ranks
from tests.helpers import make_shape_dataset
from tests.torch_port_jax_init import compiled_init, compiled_trainer_init
from yolo_contour_regression_tpu.data import device_augment as jda
from yolo_contour_regression_tpu.engine import trainer as jtrainer
from yolo_contour_regression_tpu.nn.tasks import build_model
from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8_SEG


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs (the spawned ranks take the
    caller's count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NARROW = copy.deepcopy(YOLOV8_SEG)
NARROW.update(nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})
# PERF.md section 2's trainer tolerance: the val metrics (absolute) and
# the train losses of results.csv (relative)
METRIC_ATOL = 1e-3
LOSS_RTOL = 1e-3
IDENTITY_AUG = dict(mosaic=0.0, mixup=0.0, fliplr=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
                    scale=0.0, translate=0.0)
TRAIN = dict(task="segment", model=NARROW, epochs=2, imgsz=64, batch=2, nbs=2, workers=1,
             amp=False, plots=False, verbose=False, seed=0, exist_ok=True, **IDENTITY_AUG)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's trainer (its separable warp in float32, one step a dispatch)
    and the port's on ranks over ``["cpu", "cpu"]``, JAX's init carried to
    every rank through ``jax_init.npz`` in the port's project directory."""
    tmp = tmp_path_factory.mktemp("ddp")
    yaml = make_shape_dataset(tmp / "ds", n_train=8, n_val=4, imgsz=64, seed=0)
    init = compiled_init(build_model(NARROW, nc=2), jax.random.PRNGKey(0), 64)
    (tmp / "port").mkdir()
    ranks.save_tree(tmp / "port" / "jax_init.npz",
                    jax.tree_util.tree_map(np.asarray, init["params"]),
                    jax.tree_util.tree_map(np.asarray, init["batch_stats"]))
    tt = ranks.JaxInitSegmentationTrainer(
        overrides={**TRAIN, "project": str(tmp / "port"), "name": "t"}, device=["cpu", "cpu"])
    warp = jda._warp_image_separable
    jda._warp_image_separable = partial(warp, dtype=jnp.float32)
    try:
        with ThreadPoolExecutor(1) as ex:  # the ranks train while JAX does
            port = ex.submit(tt.train, str(yaml))
            with compiled_trainer_init():
                jt = jtrainer.SegmentationTrainer(overrides={
                    **TRAIN, "data": str(yaml), "steps_per_dispatch": 1,
                    "project": str(tmp / "jax"), "name": "t"})
                jm = jt.train()
            tm = port.result()
    finally:
        jda._warp_image_separable = warp
    return {"jax": (jt, jm), "port": (tt, tm), "tmp": tmp}


def _rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


def test_jax_trains_on_a_two_device_mesh():
    """The JAX run this test holds the port to is data-parallel: batch 2 on
    the suite's host devices builds a 2-device mesh."""
    from yolo_contour_regression_tpu.parallel.mesh import build_train_mesh

    assert len(jax.devices()) >= 2
    assert build_train_mesh(jax.devices(), 2).shape == {"batch": 2}


def test_two_rank_metrics_match_jax(runs):
    """The final validation of the stripped best.ckpt (rank 0's): the eight
    metrics and fitness within 1e-3 of JAX's."""
    (_, jm), (_, tm) = runs["jax"], runs["port"]
    assert list(tm) == list(jm)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= METRIC_ATOL, (k, tm[k], jm[k])


def test_two_rank_results_csv_matches_jax(runs):
    """One row an epoch (rank 0 alone appends): the train losses (the
    global batch's) within 1e-3 relative, the val metrics within 1e-3."""
    (jt, _), (tt, _) = runs["jax"], runs["port"]
    jr, tr = _rows(jt.csv), _rows(tt.csv)
    assert list(tr[0]) == list(jr[0]) and len(tr) == len(jr) == 2
    for j, t in zip(jr, tr):
        for k in j:
            if k.startswith("train/"):
                np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=LOSS_RTOL, err_msg=k)
            elif k != "epoch":
                assert abs(float(t[k]) - float(j[k])) <= METRIC_ATOL, k


def test_only_rank_zero_writes(runs):
    """The ranks share the caller's save_dir; rank 0 wrote results.csv and
    the two checkpoints, nothing else is there, and the caller holds rank
    0's epoch times."""
    (_, _), (tt, _) = runs["jax"], runs["port"]
    tmp = runs["tmp"] / "port"
    assert sorted(p.name for p in tmp.iterdir()) == ["jax_init.npz", "t"]
    assert sorted(p.name for p in (tmp / "t").iterdir()) == ["results.csv", "weights"]
    assert sorted(p.name for p in tt.wdir.iterdir()) == ["best.ckpt", "last.ckpt"]
    assert len(tt.epoch_times) == 2 and all(t["train_s"] > 0 for t in tt.epoch_times)


TORCHRUN_RANK = """
import torch
from yolo_contour_regression_tpu_torch import parallel
torch.set_num_threads(1)
assert parallel.initialize_distributed(timeout_s=60)
t = torch.tensor([float(parallel.rank() + 1)])
torch.distributed.all_reduce(t)
print(parallel.rank(), parallel.world_size(), float(t.item()))
torch.distributed.destroy_process_group()
"""


def test_initialize_distributed_joins_a_torchrun_group(tmp_path):
    """Two processes started with the environment ``torchrun`` gives its
    workers (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT`` on localhost) join one gloo group through
    ``initialize_distributed`` and all-reduce across it."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = str(Path(__file__).resolve().parent.parent)
    procs = []
    for r in range(2):
        env = {**os.environ, "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "GLOO_SOCKET_IFNAME": "lo", "PYTHONPATH": root,
               "CUDA_VISIBLE_DEVICES": ""}  # gloo, also on a machine with cards
        procs.append(subprocess.Popen([sys.executable, "-c", TORCHRUN_RANK], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                      cwd=tmp_path))
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert sorted(o.split() for o, _ in outs) == [["0", "2", "3.0"], ["1", "2", "3.0"]]
