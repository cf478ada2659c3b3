"""The port's trackers (``trackers/``, host numpy, no scipy or cv2) against
the JAX package's on the CPU:

- the Kalman filters (``KalmanFilterXYAH``, ``KalmanFilterXYWH``):
  initiate, predict, project, update, multi_predict and the gating
  distance equal to JAX's (the same float64 operations: to the last bit);
- ``BYTETracker`` and ``BOTSORT`` (``gmc_method="none"``) on the scenarios
  of JAX's ``tests/test_trackers.py`` and on seeded sequences with births,
  deaths, occlusions, low-score rescues, crowds and several classes: every
  frame's output equal exactly, ids included;
- ``BOTSORT`` with ``sparseOptFlow`` on seeded panning frames
  (``chip_smoke.track_frames``): given the JAX GMC's warps (replayed into
  the port's tracker) and with the port's own GMC, on the
  ``SPARSE_FLOW_SEEDS`` sequences, every frame's output equal exactly."""
import numpy as np
import pytest

from chip_smoke import track_frames
from yolo_contour_regression_tpu.trackers import BOTSORT as JaxBOTSORT
from yolo_contour_regression_tpu.trackers import BYTETracker as JaxBYTETracker
from yolo_contour_regression_tpu.trackers.utils import kalman_filter as jkf
from yolo_contour_regression_tpu_torch.trackers import BOTSORT, BYTETracker
from yolo_contour_regression_tpu_torch.trackers.utils import kalman_filter as kf


@pytest.mark.parametrize("name", ["KalmanFilterXYAH", "KalmanFilterXYWH"])
def test_kalman_filters_equal_jax(name):
    rng = np.random.default_rng(len(name))
    got, want = getattr(kf, name)(), getattr(jkf, name)()
    for _ in range(20):
        z = np.concatenate([rng.uniform(0, 600, 2), rng.uniform(0.3, 200, 2)]).astype(np.float32)
        (gm, gc), (wm, wc) = got.initiate(z), want.initiate(z)
        for _ in range(4):
            (gm, gc), (wm, wc) = got.predict(gm, gc), want.predict(wm, wc)
            np.testing.assert_array_equal(gm, wm)
            np.testing.assert_array_equal(gc, wc)
            z = (z + rng.normal(0, 2, 4)).astype(np.float32)
            z[2:] = np.abs(z[2:]) + 0.1
            for a, b in zip(got.project(gm, gc), want.project(wm, wc)):
                np.testing.assert_array_equal(a, b)
            (gm, gc), (wm, wc) = got.update(gm, gc, z), want.update(wm, wc, z)
            np.testing.assert_array_equal(gm, wm)
            np.testing.assert_array_equal(gc, wc)
        zs = (z + rng.normal(0, 5, (6, 4))).astype(np.float32)
        for only in (False, True):
            np.testing.assert_array_equal(got.gating_distance(gm, gc, zs, only),
                                          want.gating_distance(wm, wc, zs, only))
        means, covs = np.stack([gm, gm * 1.01]), np.stack([gc, gc])
        for a, b in zip(got.multi_predict(means, covs), want.multi_predict(means, covs)):
            np.testing.assert_array_equal(a, b)


def moving_box(t, speed=5.0):
    x = 50 + speed * t
    return np.array([[x, 50, x + 40, 100]], np.float32)


def jax_scenarios():
    """The frames of JAX's tests/test_trackers.py scenarios: (boxes, scores,
    classes) a frame, and the tracker's keywords."""
    empty = (np.zeros((0, 4), np.float32), np.zeros(0), np.zeros(0))
    one = [(moving_box(t), np.array([0.9]), np.array([0])) for t in range(10)]
    two = [(np.concatenate([moving_box(t), moving_box(t) + 200]), np.array([0.9, 0.8]),
            np.array([0, 1])) for t in range(8)]
    rescue = one[:5] + [(moving_box(5), np.array([0.3]), np.array([0]))]
    occlusion = one[:5] + [empty] * 3 + [(moving_box(8), np.array([0.9]), np.array([0]))]
    kw = {"new_track_thresh": 0.5}
    return {"identity": (one, kw), "two_objects": (two, kw),
            "low_score_rescue": (rescue, {**kw, "track_low_thresh": 0.1}),
            "occlusion": (occlusion, {**kw, "track_buffer": 30})}


def seeded_sequence(seed, n=40, objects=8, h=480, w=640, pan=False):
    """Boxes of ``objects`` moving objects over ``n`` frames: each born and
    dying at a seeded frame, hidden for seeded gaps (occlusions), scores
    drifting through the low band (0.1-0.5: BYTE's second stage) and
    below 0.1, jittered, two classes, some crossing; with ``pan`` the whole
    scene shifts by a seeded camera motion."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, n // 2, objects)
    end = np.minimum(start + rng.integers(5, n, objects), n)
    pos = rng.uniform([0, 0], [w - 80, h - 80], (objects, 2))
    vel = rng.uniform(-8, 8, (objects, 2))
    size = rng.uniform(20, 90, (objects, 2))
    cls = rng.integers(0, 2, objects)
    cam = np.cumsum(rng.integers(-3, 4, (n, 2)), 0) if pan else np.zeros((n, 2))
    frames = []
    for t in range(n):
        live = [i for i in range(objects) if start[i] <= t < end[i]
                and not (t % 11 in (4, 5) and i % 3 == 0)]
        boxes, scores = [], []
        for i in live:
            xy = pos[i] + vel[i] * (t - start[i]) - cam[t] + rng.normal(0, 1.5, 2)
            boxes.append(np.concatenate([xy, xy + size[i]]))
            s = 0.9 - 0.5 * abs(np.sin(0.3 * t + i)) + rng.normal(0, 0.05)
            scores.append(float(np.clip(s, 0.01, 0.99)))
        frames.append((np.asarray(boxes, np.float32).reshape(-1, 4),
                       np.asarray(scores, np.float32), cls[live].astype(np.float32)))
    return frames


def run(tracker, frames, images=None):
    out = []
    for t, (b, s, c) in enumerate(frames):
        kw = {} if images is None else {"frame": images[t]}
        out.append(tracker.update(b.copy(), s.copy(), c.copy(), **kw))
    return out


def assert_same(got, want):
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w, err_msg=f"frame {t}")


@pytest.mark.parametrize("scenario", ["identity", "two_objects", "low_score_rescue",
                                      "occlusion"])
@pytest.mark.parametrize("kind", ["bytetrack", "botsort_none"])
def test_jax_scenarios_equal(kind, scenario):
    frames, kw = jax_scenarios()[scenario]
    if kind == "bytetrack":
        got, want = run(BYTETracker(**kw), frames), run(JaxBYTETracker(**kw), frames)
    else:
        got = run(BOTSORT(gmc_method="none", **kw), frames)
        want = run(JaxBOTSORT(gmc_method="none", **kw), frames)
    assert_same(got, want)
    assert any(len(o) for o in got)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["bytetrack", "botsort_none"])
def test_seeded_sequences_equal(kind, seed):
    frames = seeded_sequence(seed, pan=seed % 2 == 1)
    kw = dict(track_buffer=[30, 5, 10, 60][seed], match_thresh=[0.8, 0.7, 0.9, 0.8][seed],
              fuse_score_flag=seed != 2)
    if kind == "bytetrack":
        got, want = run(BYTETracker(**kw), frames), run(JaxBYTETracker(**kw), frames)
    else:
        got = run(BOTSORT(gmc_method="none", **kw), frames)
        want = run(JaxBOTSORT(gmc_method="none", **kw), frames)
    assert_same(got, want)
    ids = {int(i) for o in got for i in o[:, 4]}
    assert len(ids) >= 5, ids


@pytest.fixture(scope="module")
def panning():
    """12 panning 480x640 frames and a seeded box sequence over them."""
    return track_frames(12, seed=3), seeded_sequence(7, n=12, objects=6, pan=True)


def test_botsort_sparse_flow_given_jax_warps_equals_jax(panning):
    images, frames = panning
    want_tracker = JaxBOTSORT()
    warps = []
    orig = want_tracker.gmc.apply

    def record(frame):
        warps.append(orig(frame))
        return warps[-1]

    want_tracker.gmc.apply = record
    want = run(want_tracker, frames, images)
    got_tracker = BOTSORT()
    replay = iter(warps)
    got_tracker.gmc.apply = lambda frame: next(replay)
    assert_same(run(got_tracker, frames, images), want)
    assert np.abs(np.stack(warps)[:, :, 2]).max() > 1.0  # the camera moved


def _sparse_flow_equal(images, frames):
    assert_same(run(BOTSORT(), frames, images), run(JaxBOTSORT(), frames, images))


def test_botsort_sparse_flow_equals_jax(panning):
    _sparse_flow_equal(*panning)


# (frames seed, boxes seed) of the sparse-flow sequences, the port's GMC
# against JAX's: ``panning``'s first
SPARSE_FLOW_SEEDS = [(3, 7), (1, 2), (8, 13), (9, 23)]


@pytest.mark.parametrize("seeds", SPARSE_FLOW_SEEDS[1:])
def test_botsort_sparse_flow_other_sequences_equal_jax(seeds):
    _sparse_flow_equal(track_frames(12, seed=seeds[0]),
                       seeded_sequence(seeds[1], n=12, objects=6, pan=True))
