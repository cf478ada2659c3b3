"""The port's multi-device serving (``InferenceServer(mesh=...)``) on the
CPU, over a mesh of two CPU devices: the weights replicated, each batch
split into two equal shards, one a replica. Served results equal direct
predict and a one-device server at equal per-shard shapes, exactly; the
buckets are JAX's for mesh sizes 1-4; warm-up and close run every shard."""
import numpy as np
import pytest
import torch

import jax

from chip_smoke import CLS_CKPT, FLOOR_CLS_VAL, floor_cls_set, shape_images
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.parallel import create_mesh as jax_create_mesh
from yolo_contour_regression_tpu.serve import InferenceServer as JaxServer
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.parallel import create_mesh
from yolo_contour_regression_tpu_torch.serve import InferenceServer

from tests.test_torch_port_serve import SEG_CKPT


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


IMGSZ = 64
MESH2 = create_mesh(["cpu", "cpu"])


def _same_exactly(got, want):
    """Two lists of Results hold the same detections, bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        if w.probs is not None:
            np.testing.assert_array_equal(g.probs.data, w.probs.data)
            continue
        for a, b in ((g.boxes.xyxy, w.boxes.xyxy), (g.boxes.conf, w.boxes.conf),
                     (g.boxes.cls, w.boxes.cls)):
            np.testing.assert_array_equal(a, b)
        if w.contours is not None:
            np.testing.assert_array_equal(g.contours.points, w.contours.points)
        if w.masks is not None and len(w):
            np.testing.assert_array_equal(g.masks.data, w.masks.data)


def _served(handle, images, mesh, max_batch, conf):
    """All of ``images`` in one formed batch (a long coalescing window)."""
    kw = {} if conf is None else {"conf": conf}
    with InferenceServer(handle, imgsz=IMGSZ, max_batch=max_batch, buckets=[max_batch],
                         max_delay_ms=2000.0, mesh=mesh, **kw) as srv:
        got = srv.infer(images, timeout=300.0)
        stats = srv.stats()
    return got, stats, srv


@pytest.mark.parametrize("task", ["segment", "classify"])
def test_two_replicas_equal_direct_predict_and_one_device(task):
    """8 requests on a 2-device mesh (bucket 8: two shards of 4) against
    direct predict at batch 4 and a one-device server at bucket 4: the
    same detections, scores, contours and masks (segment) or probabilities
    (classify), bit for bit, in request order."""
    if task == "segment":
        ckpt, images, conf = SEG_CKPT, shape_images(8, 72, 96, 5), 0.25
    else:
        ckpt, images, conf = CLS_CKPT, floor_cls_set(FLOOR_CLS_VAL)[0][:8], None
    handle = YOLO(ckpt, device="cpu")
    got, stats, srv = _served(handle, images, MESH2, 8, conf)
    assert stats["batch_hist"] == {8: 1} and stats["padded_rows"] == 0
    assert len(srv.replicas) == 2 and srv.replicas[0] is not srv.replicas[1]
    assert all(m.fused for m in srv.replicas) and srv.devices == list(MESH2.devices)
    kw = {} if conf is None else {"conf": conf}
    want = handle.predict(images, imgsz=IMGSZ, batch=4, **kw)
    _same_exactly(got, want)
    one, _, _ = _served(handle, images[:4], None, 4, conf)
    _same_exactly(got[:4], one)
    if task == "segment":
        assert sum(len(r) for r in got) > 0 and all(r.masks is not None for r in got if len(r))


def test_short_batch_pads_the_last_shard():
    """3 requests on the 2-device mesh fill bucket 4: shard 0 holds rows
    0-1, shard 1 row 2 and a padded row; each result equals direct predict
    at batch 2."""
    handle = YOLO(SEG_CKPT, device="cpu")
    images = shape_images(4, 72, 96, 9)[:3]
    got, stats, _ = _served(handle, images, MESH2, 4, 0.25)
    assert stats["batch_hist"] == {3: 1} and stats["padded_rows"] == 1
    want = handle.predict(images[:2], imgsz=IMGSZ, batch=2) + handle.predict(
        [images[2], np.zeros_like(images[2])], imgsz=IMGSZ, batch=2)[:1]
    _same_exactly(got, want)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_mesh_buckets_equal_jax(n_dev):
    """Buckets rounded up to multiples of the mesh size, ``max_batch`` at
    least that size: the port's equal JAX's for meshes of 1-4 devices."""
    jax_handle = JaxYOLO(str(SEG_CKPT))
    handle = YOLO(SEG_CKPT, device="cpu")
    mesh = create_mesh(["cpu"] * n_dev)
    jmesh = jax_create_mesh(jax.devices()[:n_dev])
    for max_batch, buckets in ((8, None), (5, None), (1, None), (3, [1, 2]), (20, [4, 6]),
                               (32, None)):
        port = InferenceServer(handle, imgsz=IMGSZ, max_batch=max_batch, buckets=buckets,
                               mesh=mesh)
        want = JaxServer(jax_handle, imgsz=IMGSZ, max_batch=max_batch, buckets=buckets,
                         mesh=jmesh)
        assert port.buckets == want.buckets, (n_dev, max_batch, buckets)
        assert port.max_batch == want.max_batch
        assert all(b % n_dev == 0 for b in port.buckets)


def test_warmup_splits_each_bucket_over_the_replicas():
    """Warm-up evaluates every bucket as the dispatcher does: each replica
    one equal shard."""
    srv = InferenceServer(YOLO(SEG_CKPT, device="cpu"), imgsz=IMGSZ, max_batch=4, mesh=MESH2)
    seen = []
    real = srv._predictor.eval_batch
    srv._predictor.eval_batch = lambda m, x: seen.append(
        (srv.replicas.index(m), x.shape[0])) or real(m, x)
    srv.warmup()
    assert srv.buckets == [2, 4] and sorted(srv.warmup_ms) == [2, 4]
    assert sorted(seen) == [(0, 1), (0, 2), (1, 1), (1, 2)]
