"""``YOLO.track`` of the port on the CPU against the JAX package's, on the
seg160 checkpoint over the seeded 480x640 panning sequence of
``chip_smoke.track_frames`` (births, a death, an occlusion), for BOT-SORT
(sparseOptFlow) and ByteTrack: the same detections and track ids on every
frame, boxes within ``BOX_ATOL``, BOT-SORT's warps within the GMC limits;
``Masks.xy`` of every tracked result equal to the JAX result's, point for
point. One CPU model tracks the sequence once per tracker for all cases.
The committed JAX record the smoke holds the card to
(``tests/data/torch_port_track_jax.npz``) is regenerated here and compared,
so it cannot go stale; ``make_track_record`` rewrites it. The ``yolo
segment track`` CLI gives ``YOLO.track``'s ids and contours."""
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (CKPT, TRACK_IMGSZ, TRACK_RECORD, TRACK_WARP_ATOL, TRACKER_NAMES,
                        load_track_record, png_bytes, timed, track_frames, track_gaps,
                        track_record, track_run)
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.trackers import bot_sort as jax_bot_sort
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.cfg import entrypoint
from yolo_contour_regression_tpu_torch.engine import model as model_mod

BOX_ATOL = 0.05  # px


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_track_runs(frames) -> dict:
    """JAX's ``YOLO.track`` on ``frames`` for each tracker: per frame the
    ids and boxes, BOT-SORT's warps (its ``GMC.apply`` recorded), and the
    results themselves."""
    model = JaxYOLO(str(CKPT))
    runs = {}
    for name in TRACKER_NAMES:
        warps = []
        with timed(jax_bot_sort.GMC, "apply", [], warps):
            res = model.track(frames, imgsz=TRACK_IMGSZ, tracker=name)
        runs[name] = {"ids": [np.asarray(r.track_ids, np.int64) for r in res],
                      "boxes": [r.boxes.xyxy.copy() for r in res],
                      "warps": np.asarray(warps, np.float32).reshape(-1, 2, 3), "results": res}
    return runs


def make_track_record(path: Path = TRACK_RECORD):
    """Write the JAX record of the smoke's track phase (run where the JAX
    package and cv2 are installed)."""
    np.savez_compressed(path, **track_record(jax_track_runs(track_frames())))


@pytest.fixture(scope="module")
def frames():
    return track_frames()


@pytest.fixture(scope="module")
def jax_runs(frames):
    return jax_track_runs(frames)


@pytest.fixture(scope="module")
def port_runs(frames):
    """The port's ``track_run`` on the CPU for each tracker, one model."""
    model = YOLO(CKPT, device="cpu")
    return {name: track_run(model, name, frames) for name in TRACKER_NAMES}


def _ok(gaps, box_atol=BOX_ATOL):
    return (not gaps["id_frames"] and not gaps.get("xy_frames") and gaps["box"] <= box_atol
            and gaps["warp"][0] <= TRACK_WARP_ATOL[0] and gaps["warp"][1] <= TRACK_WARP_ATOL[1])


@pytest.mark.parametrize("tracker", TRACKER_NAMES)
def test_track_equals_jax(tracker, frames, jax_runs, port_runs):
    want, got = jax_runs[tracker], port_runs[tracker]
    want = {**want, "xy": [r.masks.xy for r in want["results"]]}
    gaps = track_gaps(got, want)
    print(f"{tracker}: {gaps}")
    assert _ok(gaps), gaps
    ids = {int(i) for f in got["ids"] for i in f}
    assert len(got["ids"]) == len(frames) and len(ids - {-1}) >= 3, ids
    assert (len(got["warps"]) > 0) == (tracker == "botsort")
    assert all(len(xy) == len(i) for xy, i in zip(got["xy"], got["ids"])) and got["points"]


def test_committed_record_is_current(jax_runs):
    committed = load_track_record()
    for name in TRACKER_NAMES:
        gaps = track_gaps(committed[name], jax_runs[name])
        assert _ok(gaps), (name, gaps)


def test_cli_track(tmp_path, monkeypatch, frames, port_runs):
    """``yolo segment track model=... source=<folder> tracker=...`` runs
    ``YOLO.track`` with the tracker named and prints nothing (as JAX's
    CLI); its list of results gives the ids and contours the streamed
    ``YOLO.track`` gave on the same frames."""
    for i, f in enumerate(frames[:5]):
        (tmp_path / f"{i:03d}.png").write_bytes(png_bytes(f))
    seen = []
    track = model_mod.YOLO.track

    def spy(self, *args, **kwargs):
        seen.append((kwargs.get("tracker"), track(self, *args, **kwargs)))
        return seen[-1][1]

    monkeypatch.setattr(model_mod.YOLO, "track", spy)
    rc = entrypoint(["segment", "track", f"model={CKPT}", f"source={tmp_path}",
                     f"imgsz={TRACK_IMGSZ}", "device=cpu", "tracker=bytetrack.yaml"])
    monkeypatch.setattr(model_mod.YOLO, "track", track)
    assert rc == 0 and len(seen) == 1 and seen[0][0] == "bytetrack.yaml"
    res, want = seen[0][1], port_runs["bytetrack"]
    assert isinstance(res, list)
    assert [Path(r.path).name for r in res] == [f"{i:03d}.png" for i in range(5)]
    for t, r in enumerate(res):
        assert r.track_ids.shape == (len(r),)
        np.testing.assert_array_equal(r.track_ids, want["ids"][t])
        assert len(r.masks.xy) == len(want["xy"][t])
        for a, b in zip(r.masks.xy, want["xy"][t]):
            np.testing.assert_array_equal(a, b)
