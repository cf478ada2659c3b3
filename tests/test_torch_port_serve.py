"""The port's dynamic-batching server (``serve/``) on the CPU: its buckets
equal JAX's, its results the port's predictor's on the same weights (every
task, and NAS and FastSAM handles) and JAX's ``InferenceServer``'s on the
same checkpoints (segment, detect, pose, classify), and it keeps JAX's
contract (coalescing, bucket padding, close, drain and restart, a bad
request or a failed batch kept to itself, stats); ``mesh=`` takes only a
``parallel.Mesh`` without a model axis; the
HTTP front end and ``YOLO.serve`` answer as JAX's do. IMGSZ 64."""
import json
import threading
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import (CLS_CKPT, DETECT_CKPT, FLOOR_CLS_VAL, POSE_CKPT, RTDETR_CKPT,
                        floor_cls_set, floor_detect_val_set, floor_pose_val_set, fresh_nas,
                        http_json, shape_images)
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.serve import InferenceServer as JaxServer
from yolo_contour_regression_tpu.serve.server import _default_buckets as jax_buckets
from yolo_contour_regression_tpu_torch import YOLO, FastSAM
from yolo_contour_regression_tpu_torch.engine.model import TASK_MAP
from yolo_contour_regression_tpu_torch.serve import InferenceServer
from yolo_contour_regression_tpu_torch.serve.http_api import serve_http
from yolo_contour_regression_tpu_torch.serve.server import _default_buckets

ROOT = Path(__file__).resolve().parent.parent
SEG_CKPT = ROOT / "runs" / "floor_seg160" / "best.ckpt"
SEGORI_CKPT = ROOT / "tests" / "data" / "torch_port_segori_narrow64.ckpt"
IMGSZ = 64
PX_ATOL = 0.05  # boxes, contours and keypoints, px (f32 both sides, other sum orders)
SCORE_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _seg_images(n, seed=0):
    return shape_images(n, 72, 96, seed)


CASES = {  # task -> (checkpoint, images, conf)
    "segment": (SEG_CKPT, lambda: _seg_images(3, 1), 0.25),
    "detect": (DETECT_CKPT, lambda: floor_detect_val_set()[0][:3], 0.25),
    # images with a detection each: JAX's pose postprocess raises on none
    "pose": (POSE_CKPT, lambda: [floor_pose_val_set()[0][i] for i in (0, 1, 3)], 0.25),
    "classify": (CLS_CKPT, lambda: floor_cls_set(FLOOR_CLS_VAL)[0][:3], None),
    "segment_ori": (SEGORI_CKPT, lambda: shape_images(3, 48, 64, 41), 0.001),
    "rtdetr": (RTDETR_CKPT, lambda: floor_detect_val_set()[0][:3], 0.25),
}


@pytest.fixture(scope="module")
def seg():
    return YOLO(SEG_CKPT, device="cpu")


def _same(got, want, px=PX_ATOL, exact_masks=True):
    """Two lists of Results hold the same detections (in order)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        if g.probs is not None or w.probs is not None:
            assert g.probs.top1 == w.probs.top1
            np.testing.assert_allclose(g.probs.data, w.probs.data, atol=SCORE_ATOL)
            continue
        if not len(g):
            continue
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, atol=SCORE_ATOL)
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, atol=px)
        if w.contours is not None:
            np.testing.assert_allclose(g.contours.points, w.contours.points, atol=px)
            np.testing.assert_array_equal(g.contours.valid, w.contours.valid)
        if w.keypoints is not None:
            np.testing.assert_allclose(g.keypoints[..., :2], w.keypoints[..., :2], atol=px)
            np.testing.assert_allclose(g.keypoints[..., 2], w.keypoints[..., 2], atol=SCORE_ATOL)
        if exact_masks and w.masks is not None:
            np.testing.assert_array_equal(g.masks.data, w.masks.data)


@pytest.mark.parametrize("max_batch", [1, 2, 3, 5, 8, 20, 32])
def test_default_buckets_equal_jax(max_batch):
    assert _default_buckets(max_batch) == jax_buckets(max_batch)


def test_capacity_buckets_equal_jax(seg):
    """The capacity bucket is added to the given or default buckets and the
    set sorted, as JAX's server does."""
    jax_handle = JaxYOLO(str(SEG_CKPT))
    for max_batch, buckets in ((8, None), (5, None), (20, [4]), (8, [8]), (6, [1, 3]),
                               (32, [2, 16])):
        port = InferenceServer(seg, imgsz=IMGSZ, max_batch=max_batch, buckets=buckets)
        jax = JaxServer(jax_handle, imgsz=IMGSZ, max_batch=max_batch, buckets=buckets)
        assert port.buckets == jax.buckets, (max_batch, buckets)


@pytest.mark.parametrize("task", list(CASES))
def test_server_equals_port_predictor(task):
    """Served results (coalesced, padded to bucket 4, fused) equal the
    port's predictor on the same fused weights, masks pixel for pixel."""
    ckpt, images, conf = CASES[task]
    handle = YOLO(ckpt, device="cpu")
    imgs = images()
    kw = {} if conf is None else {"conf": conf}
    with InferenceServer(handle, imgsz=IMGSZ, max_batch=4, max_delay_ms=200.0, **kw) as srv:
        got = srv.infer(imgs, timeout=300.0)
    assert handle.model.fused and handle.task == task
    want = handle.predict(imgs, imgsz=IMGSZ, **kw)
    _same(got, want)
    if task in ("segment", "detect", "pose", "segment_ori", "rtdetr"):
        assert sum(len(r) for r in got) > 0, task


@pytest.mark.parametrize("kind", ["nas", "fastsam"])
def test_server_takes_nas_and_fastsam_handles(kind):
    """NAS (the detect task) and FastSAM (the polar segment task) serve
    through their handles with their task's predictor."""
    handle = fresh_nas(device="cpu") if kind == "nas" else FastSAM(SEG_CKPT, device="cpu")
    imgs = _seg_images(2, 3)
    conf = 0.001 if kind == "nas" else 0.25
    with InferenceServer(handle, imgsz=IMGSZ, max_batch=2, max_delay_ms=200.0,
                         conf=conf) as srv:
        got = srv.infer(imgs, timeout=300.0)
    want = YOLO.predict(handle, imgs, imgsz=IMGSZ, conf=conf)
    _same(got, want)
    assert sum(len(r) for r in got) > 0


@pytest.mark.parametrize("task", ["segment", "detect", "pose", "classify"])
def test_server_equals_jax_server(task):
    """The port's server against JAX's ``InferenceServer`` on the same
    checkpoint, both fused: the same counts and classes, boxes, contours
    and keypoints within 0.05 px, scores within 1e-4, masks equal."""
    ckpt, images, conf = CASES[task]
    imgs = images()
    kw = {} if conf is None else {"conf": conf}
    with InferenceServer(YOLO(ckpt, device="cpu"), imgsz=IMGSZ, max_batch=4,
                         max_delay_ms=200.0, **kw) as srv:
        got = srv.infer(imgs, timeout=300.0)
    with JaxServer(JaxYOLO(str(ckpt)), imgsz=IMGSZ, max_batch=4, buckets=[4],
                   max_delay_ms=200.0, **kw) as jsrv:
        want = jsrv.infer(imgs, timeout=300.0)
    _same(got, want)
    if task != "classify":
        assert sum(len(r) for r in got) > 0


def test_coalesces_and_pads(seg):
    """Concurrent submits share batches (batches < requests) and, with the
    single bucket 8, every formed batch pads to 8."""
    srv = InferenceServer(seg, imgsz=IMGSZ, max_batch=8, max_delay_ms=500.0,
                          buckets=[8]).start()
    try:
        srv.warmup([8])
        assert set(srv.warmup_ms) == {8}
        futs = []
        threads = [threading.Thread(target=lambda im=im: futs.append(srv.submit(im)))
                   for im in _seg_images(6, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for f in list(futs):
            f.result(timeout=300.0)
        s = srv.stats()
        assert s["requests"] == 6
        assert s["batches"] < 6, s
        assert max(int(k) for k in s["batch_hist"]) > 1
        assert s["padded_rows"] >= 2
        for key in ("latency_ms_p50", "latency_ms_p95", "latency_ms_p99", "throughput_rps",
                    "mean_batch", "queue_depth", "last_error", "dispatch_ms", "complete_ms",
                    "overlap_ms"):
            assert key in s, key
        assert s["buckets"] == [8] and s["queue_depth"] == 0 and s["last_error"] is None
        assert s["latency_ms_p50"] <= s["latency_ms_p95"] <= s["latency_ms_p99"]
    finally:
        srv.close()


def test_close_drain_and_restart(seg):
    srv = InferenceServer(seg, imgsz=IMGSZ, max_batch=2, max_delay_ms=1.0).start()
    fut = srv.submit(_seg_images(1)[0])
    srv.close()  # drains: the pending request completes
    assert fut.result(timeout=300.0) is not None
    with pytest.raises(RuntimeError):
        srv.submit(_seg_images(1)[0])
    srv.start()  # a live dispatcher again, not one stopped by the old flag
    assert srv.submit(_seg_images(1)[0]).result(timeout=300.0) is not None
    srv.close()


def test_close_without_drain_fails_queued(seg):
    """close(drain=False) fails the queued requests with RuntimeError; the
    batch already on the device completes."""
    srv = InferenceServer(seg, imgsz=IMGSZ, max_batch=1, max_delay_ms=1.0).start()
    gate, started = threading.Event(), threading.Event()
    real = srv._predictor.eval_batch

    def held(model, x):
        started.set()
        gate.wait(60.0)
        return real(model, x)

    srv._predictor.eval_batch = held
    futs = [srv.submit(im) for im in _seg_images(4, 5)]
    assert started.wait(60.0)  # the first request is on the device, three are queued
    closer = threading.Thread(target=srv.close, kwargs={"drain": False})
    closer.start()
    for f in futs[1:]:
        with pytest.raises(RuntimeError, match="server closed"):
            f.result(timeout=60.0)
    gate.set()
    closer.join(60.0)
    assert futs[0].result(timeout=60.0) is not None and srv._thread is None


def test_bad_request_isolated(seg):
    """A malformed image fails only its own future."""
    srv = InferenceServer(seg, imgsz=IMGSZ, max_batch=4, max_delay_ms=150.0).start()
    try:
        srv.warmup([2])
        good = _seg_images(2, 7)
        futs = [srv.submit(good[0]), srv.submit(np.zeros((0, 0, 3), np.uint8)),
                srv.submit(good[1])]
        assert futs[0].result(timeout=300.0) is not None
        assert futs[2].result(timeout=300.0) is not None
        with pytest.raises(Exception):
            futs[1].result(timeout=300.0)
        assert srv.submit(good[0]).result(timeout=300.0) is not None
        assert srv.stats()["last_error"] is None
    finally:
        srv.close()


def test_failed_batch_fails_its_batch_and_serving_goes_on(seg):
    srv = InferenceServer(seg, imgsz=IMGSZ, max_batch=2, max_delay_ms=50.0).start()
    real = srv._predictor.eval_batch
    calls = []

    def once(model, x):
        calls.append(x.shape[0])
        if len(calls) == 1:
            raise RuntimeError("device lost")
        return real(model, x)

    srv._predictor.eval_batch = once
    try:
        with pytest.raises(RuntimeError, match="device lost"):
            srv.submit(_seg_images(1)[0]).result(timeout=300.0)
        assert "device lost" in srv.stats()["last_error"]
        assert srv.submit(_seg_images(1)[0]).result(timeout=300.0) is not None
        assert srv.stats()["last_error"] is None
    finally:
        srv.close()


def test_warmup_runs_each_bucket_at_the_input_dtype():
    """Classify warms with its float32 transform, the others with uint8."""
    cls = InferenceServer(YOLO(CLS_CKPT, device="cpu"), imgsz=IMGSZ, max_batch=4)
    seen = []
    real = cls._predictor.eval_batch
    cls._predictor.eval_batch = lambda m, x: seen.append((x.shape[0], x.dtype)) or real(m, x)
    cls.warmup()
    assert seen == [(1, torch.float32), (2, torch.float32), (4, torch.float32)]
    assert sorted(cls.warmup_ms) == [1, 2, 4]


def test_mesh_raises(seg):
    """``mesh=`` takes a ``parallel.Mesh`` (multi-device serving,
    ``tests/test_torch_port_serve_mesh.py``): another object raises, and so
    does a mesh with a model axis (tensor parallelism is not ported)."""
    from yolo_contour_regression_tpu_torch.parallel import create_mesh

    with pytest.raises(TypeError, match="parallel.Mesh"):
        InferenceServer(seg, imgsz=IMGSZ, mesh=object())
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        InferenceServer(seg, imgsz=IMGSZ, mesh=create_mesh(["cpu", "cpu"],
                                                           axes={"batch": 1, "model": 2}))


def test_device_default_is_cuda():
    """A checkpoint path loads on the card unless the caller asks for the
    CPU; here, without one, that fails rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        InferenceServer(str(SEG_CKPT), imgsz=IMGSZ)
    srv = InferenceServer(str(SEG_CKPT), imgsz=IMGSZ, device="cpu")
    assert srv.device.type == "cpu" and set(TASK_MAP) >= {srv.handle.task}


def _rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["name"], g["class"]) == (w["name"], w["class"])
        assert abs(g["confidence"] - w["confidence"]) <= SCORE_ATOL
        for k in ("x1", "y1", "x2", "y2"):
            assert abs(g["box"][k] - w["box"][k]) <= PX_ATOL
        if "segments" in w:
            for a in "xy":
                np.testing.assert_allclose(g["segments"][a], w["segments"][a], atol=PX_ATOL)


def test_http_endpoints(seg):
    httpd = serve_http(seg, host="127.0.0.1", port=0, imgsz=IMGSZ, max_batch=2,
                       max_delay_ms=5.0, warmup_buckets=(), conf=0.25)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        img = _seg_images(1, 4)[0]
        for ext in (".jpg", ".png"):
            buf = cv2.imencode(ext, img)[1]
            code, payload = http_json(port, "/predict", buf.tobytes())
            assert code == 200 and "speed_ms" in payload, payload
            want = seg.predict(cv2.imdecode(buf, cv2.IMREAD_COLOR), imgsz=IMGSZ)[0]
            assert len(payload["results"]) == len(want) > 0
            _rows_close(payload["results"], json.loads(want.tojson()))
        code, stats = http_json(port, "/stats")
        assert code == 200 and stats["requests"] == 2 and stats["queue_depth"] == 0
        assert http_json(port, "/healthz") == (200, {"ok": True})
        assert http_json(port, "/nope")[0] == 404
        assert http_json(port, "/nope", b"x")[0] == 404
        code, payload = http_json(port, "/predict", b"")
        assert code == 400 and "empty body" in payload["error"]
        code, payload = http_json(port, "/predict", b"GIF89a....")
        assert code == 400 and "GIF" in payload["error"]
        code, payload = http_json(port, "/predict", cv2.imencode(".jpg", img)[1].tobytes()[:200])
        assert code == 400 and "truncated JPEG" in payload["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.engine.close()
    assert not httpd.engine._thread


def test_serve_http_closes_when_warmup_fails(seg, monkeypatch):
    """The port is bound before the warm-up; a failing warm-up closes the
    socket and the dispatcher before it raises."""
    from yolo_contour_regression_tpu_torch.serve import http_api, server

    made = []
    real_init = server.InferenceServer.__init__

    def spy(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)

    def boom(self, buckets=None):
        raise RuntimeError("warm-up failed")

    monkeypatch.setattr(server.InferenceServer, "__init__", spy)
    monkeypatch.setattr(server.InferenceServer, "warmup", boom)
    monkeypatch.setattr(http_api.InferenceServer, "warmup", boom)
    with pytest.raises(RuntimeError, match="warm-up failed"):
        serve_http(seg, port=0, imgsz=IMGSZ, max_batch=2)
    assert made and made[0]._thread is None


def test_yolo_serve_background(seg):
    httpd = seg.serve(port=0, imgsz=IMGSZ, max_batch=2, max_delay_ms=5.0, background=True,
                      warmup_buckets=(), conf=0.25)
    try:
        port = httpd.server_address[1]
        assert http_json(port, "/healthz") == (200, {"ok": True})
        code, payload = http_json(port, "/predict",
                              cv2.imencode(".png", _seg_images(1, 8)[0])[1].tobytes())
        assert code == 200 and isinstance(payload["results"], list)
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.engine.close()
