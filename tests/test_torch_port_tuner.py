"""The port's evolutionary ``Tuner`` against the JAX package's on the CPU:
for the same seed and the same history it draws the same mutations, and
over a run with the same fitnesses (a failed training scoring 0) it trains
the same hyperparameters; a real tune of a narrow yolov8-seg runs through
the facade."""
import copy

import numpy as np
import pytest
import torch

from tests.helpers import make_shape_dataset
from yolo_contour_regression_tpu.engine import model as jmodel
from yolo_contour_regression_tpu.utils import tuner as jtuner
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.engine import model as tmodel
from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8_SEG
from yolo_contour_regression_tpu_torch.utils import tuner as ttuner


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads beside the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_space_is_jax():
    assert ttuner.SPACE == jtuner.SPACE


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_mutations_match_jax(seed):
    """Ten successive mutations of evolving parents, and of a parent
    missing some keys, with the default and other rates: the same
    hyperparameters as JAX's, float for float."""
    j, t = jtuner.Tuner(seed=seed), ttuner.Tuner(seed=seed)
    parent = {k: (lo + hi) / 2 for k, (lo, hi, _) in jtuner.SPACE.items()}
    for i in range(10):
        kw = {} if i % 3 else dict(mutation=0.3, sigma=0.5)
        jp, tp = j._mutate(parent, **kw), t._mutate(parent, **kw)
        assert tp == jp
        parent = jp
    sparse = {"lr0": 0.02, "box": 0.1}
    assert t._mutate(sparse) == j._mutate(sparse)


class _Stub:
    """A ``YOLO`` whose ``train`` returns the next fitness of a list (or
    raises for None) and records its keyword arguments."""

    fits, calls = [], []

    def __init__(self, model, *a, **k):
        self.model = model

    def train(self, **kw):
        _Stub.calls.append(kw)
        fit = _Stub.fits[len(_Stub.calls) - 1]
        if fit is None:
            raise RuntimeError("diverged")
        return {"fitness": fit}


def test_search_matches_jax(monkeypatch):
    """Six iterations with the same fitnesses (one training failing): the
    same hyperparameters trained, the same history, the same best."""
    fits = [0.1, 0.3, None, 0.2, 0.5, 0.4]
    out = {}
    for name, mod, tun in (("jax", jmodel, jtuner), ("port", tmodel, ttuner)):
        monkeypatch.setattr(mod, "YOLO", _Stub)
        _Stub.fits, _Stub.calls = fits, []
        tuner = tun.Tuner("yolov8n-seg.yaml", seed=3)
        best = tuner("data.yaml", iterations=6, epochs=2, imgsz=64)
        out[name] = (best, tuner.history, _Stub.calls)
    assert out["port"] == out["jax"]
    assert [f for f, _ in out["port"][1]] == [0.1, 0.3, 0.0, 0.2, 0.5, 0.4]


def test_facade_tune_runs(tmp_path):
    """``YOLO("yolov8n-seg.yaml").tune(data, iterations=2, epochs=1)`` on a
    narrow model: two trainings (the middle of the space, then a
    mutation), the best of them returned."""
    yaml = make_shape_dataset(tmp_path / "ds", n_train=4, n_val=2, imgsz=64, seed=0)
    narrow = copy.deepcopy(YOLOV8_SEG)
    narrow.update(nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})
    m = YOLO("yolov8n-seg.yaml", device="cpu")
    hyp, fit = m.tune(str(yaml), iterations=2, epochs=1, model=narrow, imgsz=64, batch=2,
                      nbs=2, workers=1, project=str(tmp_path / "runs"))
    assert set(hyp) == set(ttuner.SPACE) and np.isfinite(fit) and fit >= 0.0
    assert len(list((tmp_path / "runs").glob("segment_train*"))) == 2
