"""The port's ``linear_sum_assignment`` (``trackers/utils/lsa.py``, no
scipy) against scipy's on seeded matrices: square and rectangular in both
orientations, matrices gated as ``linear_assignment`` gates them (every
cost above the gate set to gate + 1e-4, so ties everywhere), integer
matrices full of ties, +inf entries, and the infeasible and invalid
matrices scipy refuses. The row and column arrays must be equal exactly;
``linear_assignment`` equals the JAX package's."""
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment as scipy_lsa

from yolo_contour_regression_tpu.trackers.utils import matching as jmatching
from yolo_contour_regression_tpu_torch.trackers.utils import matching
from yolo_contour_regression_tpu_torch.trackers.utils.lsa import linear_sum_assignment

SHAPES = [(1, 1), (5, 5), (12, 12), (3, 9), (9, 3), (1, 7), (7, 1), (30, 40), (40, 30)]


def _matrices(kind, shape, seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        if kind == "uniform":
            yield rng.random(shape)
        elif kind == "gated":
            c = (1.0 - rng.random(shape) * rng.random(shape)).astype(np.float32)
            t = rng.choice([0.5, 0.7, 0.8])
            yield np.where(c > t, t + 1e-4, c)
        elif kind == "integer":
            yield rng.integers(0, 3, shape).astype(np.float64)
        elif kind == "constant":
            yield np.full(shape, rng.integers(0, 2), np.float64)
        else:  # some +inf entries, every row still assignable
            c = rng.integers(0, 5, shape).astype(np.float64)
            c[rng.random(shape) < 0.3] = np.inf
            if shape[0] <= shape[1]:
                c[np.arange(shape[0]), rng.permutation(shape[1])[:shape[0]]] = 1.0
            else:
                c[rng.permutation(shape[0])[:shape[1]], np.arange(shape[1])] = 1.0
            yield c


@pytest.mark.parametrize("kind", ["uniform", "gated", "integer", "constant", "inf"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_equals_scipy(kind, shape):
    for i, c in enumerate(_matrices(kind, shape, seed=shape[0] * 100 + shape[1])):
        want = scipy_lsa(c)
        got = linear_sum_assignment(c)
        for g, w in zip(got, want):
            assert g.dtype == np.int64 and w.dtype == np.int64
            np.testing.assert_array_equal(g, w, err_msg=f"{kind} {shape} #{i}")


def test_empty_infeasible_and_invalid_like_scipy():
    for shape in ((0, 0), (0, 4), (3, 0)):
        got, want = linear_sum_assignment(np.zeros(shape)), scipy_lsa(np.zeros(shape))
        assert [a.shape for a in got] == [a.shape for a in want] == [(0,), (0,)]
    inf = np.array([[np.inf, 1.0], [np.inf, 2.0]])
    for c, message in ((inf, "infeasible"), (np.array([[np.nan, 1.0]]), "invalid"),
                       (np.array([[-np.inf, 1.0]]), "invalid")):
        with pytest.raises(ValueError, match=message):
            scipy_lsa(c)
        with pytest.raises(ValueError, match=message):
            linear_sum_assignment(c)
    with pytest.raises(ValueError):
        linear_sum_assignment(np.zeros(3))


@pytest.mark.parametrize("thresh", [0.5, 0.7, 0.8])
def test_linear_assignment_equals_jax(thresh):
    rng = np.random.default_rng(int(thresh * 10))
    for _ in range(40):
        n, m = rng.integers(0, 9, 2)
        c = (1.0 - rng.random((n, m)) * rng.random((n, m))).astype(np.float32)
        got, want = matching.linear_assignment(c, thresh), jmatching.linear_assignment(c, thresh)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
