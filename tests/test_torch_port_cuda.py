"""The port's CUDA kernels on a card, against their plain PyTorch versions.
They skip where there is no card; on one, run

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda
"""
import copy

import numpy as np
import pytest
import torch

from chip_smoke import (kernels_of_one_call, ray_contours, ray_inputs, ray_mismatches,
                        ray_scenes)
from yolo_contour_regression_tpu_torch.ops import gt_rays, raster

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    return torch.device("cuda")


def _polygons(seed, n, v, h, w):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 2 * np.pi, (n, v)), axis=1)
    r = rng.uniform(1, 0.45 * max(h, w), (n, v))
    c = rng.uniform(0.1, 0.9, (n, 1, 2)) * np.array([w, h])
    pts = (np.stack([np.cos(t), np.sin(t)], -1) * r[..., None] + c).astype(np.float32)
    valid = rng.uniform(size=(n, v)) > 0.2
    valid[0] = False
    pts[1, :, 1] = np.round(pts[1, :, 1])
    return torch.from_numpy(pts), torch.from_numpy(valid)


@pytest.mark.parametrize("n,v,h,w", [(7, 36, 61, 83), (300, 36, 480, 640), (3, 5, 1, 1000)])
def test_raster_kernel_equals_plain(cuda, n, v, h, w):
    pts, valid = _polygons(n + v, n, v, h, w)
    before = raster.fill_polygons.launches
    got = raster.fill_polygons(pts.to(cuda), valid.to(cuda), h, w)
    torch.cuda.synchronize()
    assert raster.fill_polygons.launches == before + 1
    want = raster.fill_polygons_plain(pts.to(cuda), valid.to(cuda), h, w)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), raster.fill_polygons_plain(pts, valid, h, w))


FILLS = {"even_odd": (raster.fill_polygons, raster.fill_polygons_plain),
         "cv2": (raster.fill_polygons_cv2, raster.fill_polygons_cv2_plain)}


def _fill_case(name):
    """(points, valid, H, W) of one edge case of the scanline kernels."""
    if name == "w_not_16":  # rows not 16-byte aligned: byte head and tail
        return (*_polygons(11, 7, 36, 61, 83), 61, 83)
    if name == "h1":
        return (*_polygons(12, 3, 5, 1, 1000), 1, 1000)
    if name == "v1":
        return (*_polygons(13, 5, 1, 40, 50), 40, 50)
    if name == "all_invalid":
        pts, valid = _polygons(14, 4, 12, 32, 48)
        return pts, torch.zeros_like(valid), 32, 48
    if name == "off_image":  # each polygon wholly off one side, or around the image
        pts, valid = _polygons(15, 5, 36, 40, 64)
        pts = pts - pts.mean(1, keepdim=True) + torch.tensor([32.0, 20.0])
        shifts = torch.tensor([[-100.0, 0], [200, 0], [0, -90], [0, 150], [0, 0]])
        pts = pts + shifts[:, None]
        pts[4] = (pts[4] - torch.tensor([32.0, 20.0])) * 40 + torch.tensor([32.0, 20.0])
        return pts.contiguous(), torch.ones_like(valid), 40, 64
    if name == "n_and_h_ragged":  # N odd, H not a multiple of the 32-row tile
        return (*_polygons(16, 37, 36, 45, 96), 45, 96)
    if name == "v_max":  # the most vertices the kernels take: above 48 KB of shared memory
        return (*_polygons(17, 3, raster.MAX_VERTICES, 64, 80), 64, 80)
    if name == "main_path":  # the predict path's masks
        from chip_smoke import raster_inputs
        pts, valid = raster_inputs(device="cpu")
        return pts, valid, 480, 640
    raise KeyError(name)


@pytest.mark.parametrize("entry", sorted(FILLS))
@pytest.mark.parametrize("case", ["w_not_16", "h1", "v1", "all_invalid", "off_image",
                                  "n_and_h_ragged", "v_max", "main_path"])
def test_fill_kernels_equal_plain_on_edge_cases(cuda, entry, case):
    """Each entry, one launch, against its plain version on the card and on
    the CPU: 0 differing pixels."""
    fast, plain = FILLS[entry]
    pts, valid, h, w = _fill_case(case)
    before = fast.launches
    got = fast(pts.to(cuda), valid.to(cuda), h, w)
    torch.cuda.synchronize()
    assert fast.launches == before + 1
    assert torch.equal(got, plain(pts.to(cuda), valid.to(cuda), h, w))
    assert torch.equal(got.cpu(), plain(pts, valid, h, w))
    if case in ("all_invalid", "off_image"):
        assert not got[:4].any()


def test_raster_kernel_rejects_what_it_cannot_take(cuda):
    pts, valid = _polygons(0, 4, 12, 32, 32)
    pts, valid = pts.to(cuda), valid.to(cuda)
    big = torch.zeros((1, raster.MAX_VERTICES + 1, 2), device=cuda)
    for fill in (raster.fill_polygons, raster.fill_polygons_cv2):
        before = fill.launches
        with pytest.raises(TypeError):
            fill(pts.double(), valid, 32, 32)
        with pytest.raises(ValueError):
            fill(pts, valid.int(), 32, 32)
        with pytest.raises(ValueError):
            fill(pts.transpose(0, 1), valid.t(), 32, 32)
        with pytest.raises(ValueError):
            fill(pts, valid.cpu(), 32, 32)
        with pytest.raises(ValueError):
            fill(big, torch.ones(big.shape[:2], dtype=torch.bool, device=cuda), 32, 32)
        assert fill.launches == before
        assert fill(pts[:0], valid[:0], 32, 32).shape == (0, 32, 32)


# The plain version on the CPU takes PyTorch's vectorized CPU sqrt, which is
# not correctly rounded (about 0.6% of f32 values come out 1 ulp off), so
# against it a ray may also differ by a few ulps of its distance
CPU_SQRT_RTOL = 1e-6


def _assert_same_rays(got, want, contours, rows, centers, rtol=0.0):
    """Equal rays (within ``rtol``); a difference beyond that only where one
    rounding of atan2 may pick another point, at the 3-degree gate or a
    4th/5th-nearest tie (printed)."""
    got, want = got.cpu().reshape(-1, 36).numpy(), want.cpu().reshape(-1, 36).numpy()
    diffs = ray_mismatches(got, want, contours, rows, centers, rtol=rtol)
    for d in diffs:
        print(f"pair {d[0]} ray {d[1]}: {d[2]:.6f} vs {d[3]:.6f}, at a gate or tie: {d[4]}")
    assert all(d[4] for d in diffs)


def _rows_case(R, K):
    if R == "scenes":  # each hard case's contour as a row of 8 candidates
        contours, centers = ray_scenes()
        valid = np.ones(centers.shape[:2], bool)
        valid[2, 5] = False
        return contours, centers, valid
    contours, centers, valid = ray_inputs(R, K, seed=R + K)
    if R > 2:
        valid[1] = False
        valid[2] = np.arange(K) % 3 == 1
    return contours, centers, valid


def _pairs_case(P):
    if P == "scenes":  # each hard case's contour with each of its 8 centers
        contours, centers = ray_scenes()
        k = centers.shape[1]
        return (np.ascontiguousarray(np.repeat(contours, k, 0)),
                np.ascontiguousarray(centers.reshape(-1, 2)))
    contours, c, r = ray_contours(P, seed=P)
    centers = (c + np.random.default_rng(P).uniform(-1.5, 1.5, (P, 2)) * r[:, None])
    return contours, centers.astype(np.float32)


@pytest.mark.parametrize("R,K", [(128, 128), (768, 48), (5, 1), (7, 13), (3, 9), (1, 300),
                                 ("scenes", 8)])
def test_gt_rays_rows_kernel_equals_plain(cuda, R, K):
    """The main path's shapes (640, batch 16: R 128 x K 128 and R 768 x K 48),
    K = 1, R * K not a multiple of the 8-pair block, all-invalid rows (the
    last row of ``ray_inputs``, and row 1 here), a non-prefix pattern, and
    the search's hard cases (``chip_smoke.ray_scenes``)."""
    contours, centers, valid = _rows_case(R, K)
    c, x, v = (torch.from_numpy(a).to(cuda) for a in (contours, centers, valid))
    before = gt_rays.gt_rays_rows_fast.launches
    got = gt_rays.gt_rays_rows_fast(c, x, v)
    torch.cuda.synchronize()
    assert gt_rays.gt_rays_rows_fast.launches == before + 1
    want = gt_rays.gt_rays_rows_plain(c, x, v)
    assert (got[~v] == np.float32(1e-6)).all()
    rows = np.nonzero(valid)[0]
    _assert_same_rays(got[v], want[v], contours, rows, centers[valid])
    # and the plain version on the CPU, whose atan2 is another implementation
    cpu = gt_rays.gt_rays_rows_plain(*(torch.from_numpy(a) for a in (contours, centers, valid)))
    _assert_same_rays(got[v], cpu[torch.from_numpy(valid)], contours, rows, centers[valid],
                      rtol=CPU_SQRT_RTOL)


@pytest.mark.parametrize("P", [16384, 21, 1, "scenes"])
def test_gt_rays_pairs_kernel_equals_plain(cuda, P):
    contours, centers = _pairs_case(P)
    P = len(centers)
    ct, xt = torch.from_numpy(contours).to(cuda), torch.from_numpy(centers).to(cuda)
    before = gt_rays.gt_rays_fast.launches
    got = gt_rays.gt_rays_fast(ct, xt)
    torch.cuda.synchronize()
    assert gt_rays.gt_rays_fast.launches == before + 1
    _assert_same_rays(got, gt_rays.gt_rays_pairs_plain(ct, xt), contours, np.arange(P), centers)


def test_gt_rays_kernels_reject_what_they_cannot_take(cuda):
    contours, centers, valid = ray_inputs(4, 8, seed=0)
    c, x, v = (torch.from_numpy(a).to(cuda) for a in (contours, centers, valid))
    before = (gt_rays.gt_rays_rows_fast.launches, gt_rays.gt_rays_fast.launches)
    with pytest.raises(TypeError):
        gt_rays.gt_rays_rows_fast(c.double(), x, v)
    with pytest.raises(TypeError):
        gt_rays.gt_rays_rows_fast(c, x.half(), v)
    with pytest.raises(ValueError):
        gt_rays.gt_rays_rows_fast(c, x, v.int())
    with pytest.raises(ValueError):
        gt_rays.gt_rays_rows_fast(c[:, :359].contiguous(), x, v)
    with pytest.raises(ValueError):
        gt_rays.gt_rays_rows_fast(c, x, v.cpu())
    with pytest.raises(ValueError):
        gt_rays.gt_rays_rows_fast(c, x.transpose(0, 1).contiguous().transpose(0, 1), v)
    with pytest.raises(TypeError):
        gt_rays.gt_rays_fast(c.double(), x[:, 0].contiguous())
    with pytest.raises(ValueError):
        gt_rays.gt_rays_fast(c, x[:, 0])  # not contiguous
    with pytest.raises(ValueError):
        gt_rays.gt_rays_fast(c, x[:3, 0].contiguous())
    misaligned = torch.empty(c.numel() + 1, device=cuda)[1:].view(c.shape)  # float2 loads
    misaligned.copy_(c)
    with pytest.raises(ValueError):
        gt_rays.gt_rays_rows_fast(misaligned, x, v)
    with pytest.raises(ValueError):
        gt_rays.gt_rays_fast(misaligned, x[:, 0].contiguous())
    assert before == (gt_rays.gt_rays_rows_fast.launches, gt_rays.gt_rays_fast.launches)
    # empty inputs launch nothing and give empty outputs
    assert gt_rays.gt_rays_rows_fast(c[:0], x[:0], v[:0]).shape == (0, 8, 36)
    assert gt_rays.gt_rays_fast(c[:0], x[:0, 0].contiguous()).shape == (0, 36)


@pytest.mark.parametrize("entry", ["rows", "pairs"])
def test_gt_rays_one_device_kernel_per_call(cuda, entry):
    """One call of each wrapper launches one device kernel (``torch.profiler``,
    read by ``kernels_of_one_call``: a profile that drops a kernel's record
    is taken again), at the main path's R 128 x K 128 and at P 16,384."""
    if entry == "rows":
        c, x, v = (torch.from_numpy(a).to(cuda) for a in ray_inputs(128, 128, seed=128))
        call = lambda: gt_rays.gt_rays_rows_fast(c, x, v)  # noqa: E731
    else:
        c, x = (torch.from_numpy(a).to(cuda) for a in _pairs_case(16384))
        call = lambda: gt_rays.gt_rays_fast(c, x)  # noqa: E731
    call()
    kernels = kernels_of_one_call(f"gt_rays_{entry}", call, 1)
    assert isinstance(kernels, list) and len(kernels) == 1, kernels
    assert "gt_rays_kernel" in kernels[0][0]


def test_train_state_defaults_to_the_card(cuda):
    """``init_train_state`` without ``device`` moves the model and its EMA
    to the card, and the step takes CPU inputs there, GT-ray kernel
    included."""
    from chip_smoke import shape_batch
    from types import SimpleNamespace
    from yolo_contour_regression_tpu_torch.engine.step import init_train_state, make_train_step
    from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8_SEG, SegmentationModel
    from yolo_contour_regression_tpu_torch.utils import optim

    cfg = dict(YOLOV8_SEG, nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})
    model = SegmentationModel(cfg)
    hyp = SimpleNamespace(optimizer="AdamW", nc=2, lr0=0.001667, lrf=0.01, momentum=0.9,
                          weight_decay=0.0005, warmup_epochs=0.0, warmup_bias_lr=0.0,
                          epochs=1, batch=2, nbs=16, box=7.5, cls=0.5)
    opt = optim.build_optimizer(model, hyp, 1, 1)
    state = init_train_state(model, opt)
    assert state.device.type == "cuda"
    assert all(p.is_cuda for p in model.parameters()) and all(e.is_cuda for e in state.ema.values())
    images, batch = shape_batch(2, 64, 3, seed=0)
    before = gt_rays.gt_rays_rows_fast.launches
    metrics = make_train_step(model, opt, hyp)(
        state, torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert metrics["loss"].is_cuda and torch.isfinite(metrics["loss"])
    assert gt_rays.gt_rays_rows_fast.launches == before + 1


def _iou_sets(seed, n, m, grid):
    """GT-like 360-gons and prediction-like 36-gons on a grid x grid mask
    grid, some partly off it, with invalid runs; the first GT and the first
    prediction have no valid vertex."""
    ga, va = _polygons(seed, n, 360, grid, grid)
    pb, vb = _polygons(seed + 1, m, 36, grid, grid)
    vb[1, :10] = False
    return ga, va, pb, vb


@pytest.mark.parametrize("grid,n,m", [(160, 8, 300), (640, 32, 300), (160, 0, 300), (640, 5, 0),
                                      (37, 3, 11), (40, 1, 1), (33, 17, 17)])
def test_polygon_mask_iou_kernel_equals_plain(cuda, grid, n, m):
    """``polygon_mask_iou`` on the card (two fill launches and a product of
    the masks in float32 row blocks) equals its plain version on the card
    and on the CPU: 0 differing IoUs, also with all-invalid sets, empty sets
    and a grid whose size is not a multiple of 8."""
    ga, va, pb, vb = _iou_sets(grid + n + m, max(n, 2), max(m, 2), grid)
    ga, va, pb, vb = ga[:n], va[:n], pb[:m], vb[:m]
    before = raster.fill_polygons.launches
    got = raster.polygon_mask_iou(ga.to(cuda), va.to(cuda), pb.to(cuda), vb.to(cuda), grid, grid)
    torch.cuda.synchronize()
    assert raster.fill_polygons.launches == before + (n > 0) + (m > 0)
    want = raster.polygon_mask_iou_plain(ga.to(cuda), va.to(cuda), pb.to(cuda), vb.to(cuda), grid,
                                         grid)
    assert got.shape == (n, m) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), raster.polygon_mask_iou_plain(ga, va, pb, vb, grid, grid))
    if n > 1 and m > 1:  # the first of each set has no valid vertex
        assert bool((got[0] == 0).all()) and bool((got[:, 0] == 0).all()) and bool(got.any())


def test_multilabel_nms_card_equals_cpu(cuda):
    """Multi-label NMS on logits, the val protocol (conf 0.001, pre_nms 1024,
    max_det 300), at imgsz 640's 8,400 anchors and 2 classes: the card keeps
    the detections the CPU keeps, boxes and extras exactly, scores within
    1e-6."""
    from yolo_contour_regression_tpu_torch.ops.nms import non_max_suppression_parts

    rng = np.random.default_rng(0)
    B, A, nc = 2, 8400, 2
    xy = rng.uniform(0, 600, (B, A, 2))
    wh = rng.uniform(4, 80, (B, A, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))
    logits = torch.from_numpy(rng.normal(-6, 2, (B, A, nc)).astype(np.float32))
    logits[0, :7, 1] = logits[0, :7, 0]  # ties across classes
    extras = torch.from_numpy(rng.uniform(0, 50, (B, A, 38)).astype(np.float32))
    kw = dict(conf_thres=0.001, iou_thres=0.7, pre_nms=1024, max_det=300, multi_label=True,
              scores_are_logits=True)
    got = non_max_suppression_parts(boxes.to(cuda), logits.to(cuda), extras.to(cuda), **kw)
    want = non_max_suppression_parts(boxes, logits, extras, **kw)
    assert torch.equal(got["valid"].cpu(), want["valid"]) and bool(want["valid"].any())
    for k in ("boxes", "classes", "extras"):
        assert torch.equal(got[k].cpu(), want[k]), k
    torch.testing.assert_close(got["scores"].cpu(), want["scores"], atol=1e-6, rtol=0)


def test_yolo_val_defaults_to_the_card(cuda):
    """``YOLO(ckpt).val`` with no device runs on the card: the model is
    there, and the mask IoU launches the even-odd fill kernel."""
    from pathlib import Path

    from chip_smoke import floor_val_set
    from yolo_contour_regression_tpu_torch import YOLO

    ckpt = Path(__file__).resolve().parent.parent / "runs" / "floor_seg160" / "best.ckpt"
    model = YOLO(ckpt)
    assert all(p.is_cuda for p in model.model.parameters())
    images, labels = floor_val_set()
    before = raster.fill_polygons.launches
    res = model.val(images[:4], labels[:4], imgsz=160, batch=2)
    assert raster.fill_polygons.launches == before + 8
    assert 0.0 <= res["metrics/mAP50-95(M)"] <= 1.0 and 0.0 <= res["metrics/mAP50-95(B)"] <= 1.0


def test_apply_augment_card_equals_cpu(cuda):
    """The batch augmentation on the card, given the same draws, equals the
    CPU's: images within 1e-3 levels (the same float32 steps in other
    kernels), boxes and contours within 1e-6, ``cls`` and ``mask_gt``
    exactly."""
    from types import SimpleNamespace

    from chip_smoke import shape_batch
    from yolo_contour_regression_tpu_torch.data import device_augment as tda

    images, batch = shape_batch(8, 160, 8, seed=5)
    raw = {k: torch.from_numpy(v) for k, v in batch.items()}
    raw["img"] = torch.from_numpy((images[..., ::-1] * 255).round().astype(np.uint8))
    raw["content_hw"] = torch.full((8, 2), 160.0)
    raw["pad_tl"] = torch.zeros((8, 2))
    for hyp in (SimpleNamespace(mosaic=1.0, mixup=0.5, degrees=0.0, translate=0.1, scale=0.5,
                                shear=0.0, perspective=0.0, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4,
                                fliplr=0.5, flipud=0.5),
                SimpleNamespace(mosaic=0.5, mixup=0.0, degrees=10.0, translate=0.1, scale=0.5,
                                shear=2.0, perspective=1e-4, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
                                fliplr=0.5, flipud=0.0)):
        draws = tda.draw_augment(np.random.default_rng(1), 8, hyp, 160)
        want = tda.apply_augment(raw, draws, hyp, 160, 32)
        got = tda.apply_augment({k: v.to(cuda) for k, v in raw.items()}, draws, hyp, 160, 32)
        assert got["img"].is_cuda
        torch.testing.assert_close(got["img"].cpu() * 255, want["img"] * 255, atol=1e-3, rtol=0)
        for k in ("bboxes", "segments"):
            torch.testing.assert_close(got[k].cpu(), want[k], atol=1e-6, rtol=0)
        for k in ("cls", "mask_gt"):
            assert torch.equal(got[k].cpu(), want[k]), k


def test_yolo_train_defaults_to_the_card_and_launches_the_kernels(cuda, tmp_path):
    """``YOLO("yolov8n-seg.yaml").train`` with no device trains on the card:
    the model, its EMA and the adopted best.ckpt are there, each step
    launches the GT-ray kernel and each validation the even-odd fill."""
    from chip_smoke import floor_train_set, floor_val_set
    from yolo_contour_regression_tpu_torch import YOLO

    train, val = floor_train_set(), floor_val_set()
    model = YOLO("yolov8n-seg.yaml")
    assert model.device.type == "cuda" and model.model is None
    rays, fills = gt_rays.gt_rays_rows_fast.launches, raster.fill_polygons.launches
    res = model.train(data={"train": (train[0][:8], train[1][:8]),
                            "val": (val[0][:4], val[1][:4]), "names": {0: "circle", 1: "rect"}},
                      epochs=2, imgsz=160, batch=4, nbs=4, workers=2, project=str(tmp_path))
    state = model.trainer.state
    assert state.device.type == "cuda" and all(e.is_cuda for e in state.ema.values())
    assert all(p.is_cuda for p in model.model.parameters())
    assert gt_rays.gt_rays_rows_fast.launches == rays + state.step == rays + 4
    # two fills an image: 4 images in each epoch's validation and the final one
    assert raster.fill_polygons.launches == fills + 2 * 4 * 3
    assert 0.0 <= res["metrics/mAP50-95(M)"] <= 1.0


@pytest.fixture
def full_f32():
    """TF32 off for convolutions and matmuls, as ``chip_smoke.py`` runs, so
    the card computes in float32 like the CPU it is held to."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_detect_predict_card_equals_cpu(cuda, full_f32):
    """``YOLO(runs/floor_detect/best.ckpt)`` defaults to the card; its head
    maps and predict outputs equal the CPU port's on the floor images:
    heads within 1e-3, the same detections, boxes within 0.05 px, scores
    within 1e-4 (``chip_smoke.card_vs_cpu_predict``)."""
    from chip_smoke import DETECT_CKPT, card_vs_cpu_predict, floor_detect_val_set
    from yolo_contour_regression_tpu_torch import YOLO

    model = YOLO(DETECT_CKPT)
    assert model.task == "detect" and all(p.is_cuda for p in model.model.parameters())
    card_vs_cpu_predict(model, YOLO(DETECT_CKPT, device="cpu"), floor_detect_val_set()[0][:8], 96,
                        "test", "card")


@pytest.mark.parametrize("task", ["segment", "detect", "pose"])
def test_fused_equals_unfused_on_the_card(cuda, full_f32, task):
    """``YOLO(floor checkpoint).fuse()`` on the card against the unfused
    model there: heads within 1e-3, the same detections, each validation
    metric within 0.01 and the floor met; the fused segment validation
    launches the fill kernel (``chip_smoke.fuse_check``)."""
    from chip_smoke import fuse_check

    counts = fuse_check(task, "card")
    assert (counts["fill_polygons"] > 0) == (task == "segment")


def test_pose_head_predict_and_train_step_card_equal_cpu(cuda, full_f32):
    """``YOLO(runs/floor_pose/best.ckpt)`` defaults to the card; its head
    maps and predict outputs equal the CPU port's on the floor images
    (heads within 1e-3, the same detections, boxes and keypoints within
    0.05 px, scores and visibilities within 1e-4), and its train-mode pose
    loss, assignment and gradients at 96 px equal the CPU's (loss 1e-4
    relative, gradients 1e-3 of each tensor's largest;
    ``chip_smoke.card_vs_cpu_predict`` and ``train_card_vs_cpu``)."""
    from chip_smoke import (POSE_CKPT, card_vs_cpu_predict, floor_pose_val_set,
                            train_card_vs_cpu)
    from yolo_contour_regression_tpu_torch import YOLO
    from yolo_contour_regression_tpu_torch.utils.checkpoint import load_checkpoint

    model = YOLO(POSE_CKPT)
    assert model.task == "pose" and all(p.is_cuda for p in model.model.parameters())
    card_vs_cpu_predict(model, YOLO(POSE_CKPT, device="cpu"), floor_pose_val_set()[0][:8], 96,
                        "test", "card")
    train_card_vs_cpu(load_checkpoint(POSE_CKPT), "card", imgsz=96, phase="test")


@pytest.mark.parametrize("k", [5, 17])
def test_pose_loss_card_equals_cpu(cuda, full_f32, k):
    """``pose_loss`` on the same random head maps (imgsz 64, 5 or 17
    keypoints) on the card and on the CPU: the total and each item within
    1e-5 relative, the same assignment, and the gradients w.r.t. the maps
    within 1e-5 of their largest entry."""
    from types import SimpleNamespace

    from yolo_contour_regression_tpu_torch.utils import loss as tloss

    rng = np.random.default_rng(k)
    B, nc, nk, n = 2, 1, 3 * k, 4
    hyp = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5, pose=12.0, kobj=1.0)
    c = rng.uniform(0.3, 0.7, (B, n, 2))
    wh = rng.uniform(0.2, 0.5, (B, n, 2))
    kxy = c[:, :, None] + rng.uniform(-0.5, 0.5, (B, n, k, 2)) * wh[:, :, None]
    vis = rng.choice([0.0, 2.0], (B, n, k), p=[0.2, 0.8])
    batch = {"cls": np.zeros((B, n), np.int32),
             "bboxes": np.concatenate([c, wh], -1).astype(np.float32),
             "mask_gt": np.ones((B, n), bool),
             "keypoints": np.concatenate([kxy, vis[..., None]], -1).astype(np.float32)}
    feats = []
    for s in (8, 16, 32):
        f = rng.normal(0, 2, (B, 64 + nc + nk, 64 // s, 64 // s))
        f[:, :64] -= np.tile(0.6 * np.arange(16), 4)[None, :, None, None]
        f[:, 64 + nc:] *= 0.4
        feats.append(f.astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        fs = [torch.from_numpy(f).to(dev).requires_grad_() for f in feats]
        b = {key: torch.from_numpy(v).to(dev) for key, v in batch.items()}
        res = tloss.pose_loss(fs, b, (8, 16, 32), nc, hyp, (k, 3))
        res.total.backward()
        assign = tloss.detect_targets([f[:, :-nk] for f in fs], b, (8, 16, 32), nc).assign
        out[dev] = (res, assign, [f.grad.cpu() for f in fs])
    (rc, ac, gc), (rg, ag, gg) = out["cpu"], out["cuda"]
    assert torch.equal(ac.fg_mask, ag.fg_mask.cpu()) and bool(ac.fg_mask.any())
    assert torch.equal(ac.target_gt_idx[ac.fg_mask], ag.target_gt_idx.cpu()[ac.fg_mask])
    np.testing.assert_allclose(rg.total.item(), rc.total.item(), rtol=1e-5)
    for key in rc.items:
        np.testing.assert_allclose(rg.items[key].item(), rc.items[key].item(), rtol=1e-5,
                                   err_msg=key)
    for a, b in zip(gg, gc):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("n", [128, 768])
def test_segori_gt_masks_kernel_equals_plain(cuda, n):
    """The segment_ori GT masks (``gt_masks_at``: 360-point contours on the
    160x160 proto grid, one launch of the even-odd kernel) equal the plain
    fill's, at the train step's N 128 and ``max_instances``' 768
    (``chip_smoke.segori_fill_inputs``)."""
    from chip_smoke import SEGORI_PROTO_HW, segori_fill_inputs
    from yolo_contour_regression_tpu_torch.utils.loss import gt_masks_at

    pts, valid = segori_fill_inputs(n)
    hp, wp = SEGORI_PROTO_HW
    segs = (pts / torch.tensor([wp, hp], device=cuda)).reshape(16, -1, 360, 2)
    mask_gt = valid[:, 0].reshape(16, -1)
    before = raster.fill_polygons.launches
    got = gt_masks_at(segs, mask_gt, hp, wp)
    assert raster.fill_polygons.launches == before + 1
    want = gt_masks_at(segs.cpu(), mask_gt.cpu(), hp, wp)
    assert torch.equal(got.cpu(), want) and bool(want.any())


def test_segori_loss_card_equals_cpu(cuda, full_f32):
    """``segmentation_ori_loss`` on the same random head maps and
    prototypes (imgsz 64, nm 8) on the card and on the CPU: the total and
    each item within 1e-5 relative, the gradients w.r.t. the maps and the
    prototypes within 1e-5 of their largest entry; one fill launch."""
    from types import SimpleNamespace

    from chip_smoke import shape_batch
    from yolo_contour_regression_tpu_torch.utils import loss as tloss

    rng = np.random.default_rng(3)
    hyp = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5)
    _, batch = shape_batch(2, 64, 4, seed=3)
    feats = []
    for s in (8, 16, 32):
        f = rng.normal(0, 2, (2, 64 + 2 + 8, 64 // s, 64 // s))
        f[:, :64] -= np.tile(0.6 * np.arange(16), 4)[None, :, None, None]
        feats.append(f.astype(np.float32))
    proto = rng.normal(0, 1, (2, 8, 16, 16)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        fs = [torch.from_numpy(f).to(dev).requires_grad_() for f in feats]
        pr = torch.from_numpy(proto).to(dev).requires_grad_()
        b = {key: torch.from_numpy(v).to(dev) for key, v in batch.items()}
        before = raster.fill_polygons.launches
        res = tloss.segmentation_ori_loss((fs, pr), b, (8, 16, 32), 2, hyp, nm=8)
        res.total.backward()
        assert raster.fill_polygons.launches == before + (dev == "cuda")
        out[dev] = (res, [f.grad.cpu() for f in fs] + [pr.grad.cpu()])
    (rc, gc), (rg, gg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(rg.total.item(), rc.total.item(), rtol=1e-5)
    for key in rc.items:
        np.testing.assert_allclose(rg.items[key].item(), rc.items[key].item(), rtol=1e-5,
                                   err_msg=key)
    for a, b in zip(gg, gc):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_segori_and_classify_predict_card_equal_cpu(cuda, full_f32):
    """The narrow segori checkpoint of the CPU tests on the card against
    the CPU on its val frames at 64, conf 0.001 (heads and prototypes
    within 1e-3, the same detections, boxes 0.05 px, scores 1e-4); the
    floor_classify checkpoint's probabilities within 1e-4 of the CPU's."""
    from pathlib import Path

    from chip_smoke import CLS_CKPT, card_vs_cpu_predict, shape_images, shape_val_set
    from yolo_contour_regression_tpu_torch import YOLO

    ckpt = Path(__file__).resolve().parent / "data" / "torch_port_segori_narrow64.ckpt"
    card_vs_cpu_predict(YOLO(ckpt), YOLO(ckpt, device="cpu"), shape_val_set(8, 48, 64, 41)[0],
                        64, "test", "card", conf=0.001)
    frames = shape_images(2, 480, 640, seed=2)
    got = YOLO(CLS_CKPT).predict(frames, imgsz=64)
    want = YOLO(CLS_CKPT, device="cpu").predict(frames, imgsz=64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.probs.data, w.probs.data, atol=1e-4)


def test_rtdetr_predict_card_equals_cpu(cuda, full_f32):
    """``YOLO(runs/floor_rtdetr/best.ckpt)`` defaults to the card; its
    decoder outputs and predictions equal the CPU port's on the floor
    images: outputs within 1e-3 (queries matched by encoder token), the same
    kept queries, boxes within 0.05 px, scores within 1e-4
    (``chip_smoke.rtdetr_card_vs_cpu_predict``); it launches no kernel."""
    from chip_smoke import (RTDETR_CKPT, RTDETR_IMGSZ, floor_rtdetr_val_set, launch_counts,
                            rtdetr_card_vs_cpu_predict, zero_launch_counts)
    from yolo_contour_regression_tpu_torch import YOLO

    model = YOLO(RTDETR_CKPT)
    assert model.task == "rtdetr" and all(p.is_cuda for p in model.model.parameters())
    zero_launch_counts()
    rtdetr_card_vs_cpu_predict(model, YOLO(RTDETR_CKPT, device="cpu"),
                               floor_rtdetr_val_set()[0][:8], RTDETR_IMGSZ, "test", "card")
    assert not any(launch_counts().values())


def test_rtdetr_train_step_card_equals_cpu(cuda, full_f32):
    """floor_rtdetr's train-mode loss, every layer's assignment and every
    gradient at 192 px batch 4 on the card equal the CPU's with the same dn
    groups, the networks in float64 (loss 1e-4 relative, gradients 1e-3 of
    each tensor's largest; ``chip_smoke.rtdetr_train_card_vs_cpu``); then
    ``make_train_step`` on a
    state that defaults to the card takes two steps with finite losses."""
    from types import SimpleNamespace

    from chip_smoke import RTDETR_CKPT, ckpt_model, rtdetr_train_card_vs_cpu, shape_batch
    from yolo_contour_regression_tpu_torch.engine.step import init_train_state, make_train_step
    from yolo_contour_regression_tpu_torch.utils import optim
    from yolo_contour_regression_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(RTDETR_CKPT)
    rtdetr_train_card_vs_cpu(ckpt, "card")
    model = ckpt_model(ckpt, "cpu")
    hyp = SimpleNamespace(**{**ckpt["train_args"], "optimizer": "AdamW", "warmup_epochs": 0.0})
    opt = optim.build_optimizer(model, hyp, 10, 100)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, hyp)
    images, batch = shape_batch(4, 192, 8, seed=5)
    x, b = torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = [step(state, x, b)["loss"].item() for _ in range(2)]
    assert state.device.type == "cuda" and all(np.isfinite(losses)), losses


def test_rtdetr_l_card_equals_cpu(cuda, full_f32):
    """A fresh rtdetr-l (nc 80, seed 0) on the card against the same model
    on the CPU at 640, batch 2: decoder outputs within 1e-3 (queries
    matched by encoder token), the same kept queries at conf 0.001, boxes
    within 0.05 px, scores within 1e-4; its fused form against the unfused
    within 1e-3; no kernel launched."""
    from chip_smoke import (FUSE_HEAD_ATOL, RASTER_HW, RTDETR_L_PARAMS, RTDETR_L_SEED, VAL_CONF,
                            fresh_model, launch_counts, rtdetr_card_vs_cpu_predict, rtdetr_pair,
                            shape_images, zero_launch_counts)
    from yolo_contour_regression_tpu_torch import YOLO
    from yolo_contour_regression_tpu_torch.nn.fuse import fuse_model

    names = {i: f"class{i}" for i in range(80)}
    model = fresh_model("rtdetr-l.yaml", names, RTDETR_L_SEED)
    assert model.model.num_params == RTDETR_L_PARAMS
    frames = shape_images(2, *RASTER_HW, seed=2)
    zero_launch_counts()
    rtdetr_card_vs_cpu_predict(model, fresh_model("rtdetr-l.yaml", names, RTDETR_L_SEED, "cpu"),
                               frames, 640, "test", "card", conf=VAL_CONF, batch=2)
    fused = YOLO("rtdetr-l.yaml")
    fused.model = fuse_model(copy.deepcopy(model.model))
    worst = rtdetr_pair(fused, model, frames, 640, "test", conf=VAL_CONF, batch=2)
    assert worst["decoder"] <= FUSE_HEAD_ATOL and worst["kept"] > 0
    assert not any(launch_counts().values())


def test_host_chain_seg_step_card_equals_cpu(cuda, full_f32):
    """One batch of the host train chain (``TrainDataset`` with
    ``device_augment=False``, mosaic9 and copy_paste 0.5 on the seg160
    set) through one train step of the seg160 model, on the card and on
    the CPU from the same weights: the losses within 1e-4 relative (the
    host chain's batch is the same bytes on both); the card's step
    launches the GT-ray kernel."""
    from chip_smoke import CKPT, ckpt_model, floor_train_set, train_hyp
    from yolo_contour_regression_tpu_torch.cfg import get_cfg
    from yolo_contour_regression_tpu_torch.data.augment import collate
    from yolo_contour_regression_tpu_torch.data.dataset import TrainDataset
    from yolo_contour_regression_tpu_torch.engine.step import init_train_state, make_train_step
    from yolo_contour_regression_tpu_torch.utils import optim
    from yolo_contour_regression_tpu_torch.utils.checkpoint import load_checkpoint

    images, labels = floor_train_set()
    ds = TrainDataset(images, labels, imgsz=160, device_augment=False,
                      hyp=get_cfg(None, {"mosaic9": 0.5, "copy_paste": 0.5}))
    batch = collate([ds[i] for i in range(4)])
    x = torch.from_numpy(batch.pop("img")).float() / 255.0
    ckpt = load_checkpoint(CKPT)
    losses = {}
    for dev in ("cpu", "cuda"):
        model = ckpt_model(ckpt, dev)
        hyp = train_hyp(ckpt, optimizer="AdamW", warmup_epochs=0.0, batch=4)
        opt = optim.build_optimizer(model, hyp, 10, 100)
        state = init_train_state(model, opt, device=dev)
        rays = gt_rays.gt_rays_rows_fast.launches
        losses[dev] = make_train_step(model, opt, hyp, cand=hyp.cand_per_gt)(
            state, x, {k: torch.from_numpy(v) for k, v in batch.items()})["loss"].item()
        assert (gt_rays.gt_rays_rows_fast.launches > rays) == (dev == "cuda")
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"]), losses


# the planted objects of tests/test_sam_generate.py (x0, y0, x1, y1) on an
# S x S image, for a decoder stub without JAX
STUB_S = 64
STUB_OBJECTS = [(8, 8, 24, 28), (40, 12, 60, 32), (12, 40, 32, 60)]


class StubSam:
    """A torch copy of ``tests/test_sam_generate.py:StubSam`` on ``device``:
    a prompt point inside planted object k returns that object's low-res
    mask at IoU 0.99, a background point -10 everywhere at 0.05."""

    img_size = STUB_S
    mask_threshold = 0.0
    pixel_mean = np.zeros(3, np.float32)
    pixel_std = np.ones(3, np.float32)

    def __init__(self, device="cpu"):
        hq = STUB_S // 4
        gt = np.zeros((len(STUB_OBJECTS), hq, hq), np.float32)
        for k, (x0, y0, x1, y1) in enumerate(STUB_OBJECTS):
            gt[k, y0 // 4: y1 // 4, x0 // 4: x1 // 4] = 1.0
        self.device = torch.device(device)
        self.gt = torch.from_numpy(gt).to(self.device)

    def encode_image(self, image):
        hq = STUB_S // 4
        return torch.zeros((image.shape[0], 8, hq, hq), device=image.device)

    def decode_prompts(self, emb, points, labels, masks=None, multimask=True):
        hq = STUB_S // 4
        pt = points[:, 0]
        ix = torch.div(pt[:, 0], 4, rounding_mode="floor").long().clamp(0, hq - 1)
        iy = torch.div(pt[:, 1], 4, rounding_mode="floor").long().clamp(0, hq - 1)
        inside = self.gt[:, iy, ix]  # (K, P)
        logits = torch.einsum("kp,khw->phw", inside, self.gt * 20.0 - 10.0)
        hit = inside.sum(0) > 0
        logits = torch.where(hit[:, None, None], logits, torch.full_like(logits, -10.0))
        logits = logits[:, None].repeat(1, 3, 1, 1)
        iou = torch.where(hit, 0.99, 0.05)[:, None] * torch.ones((1, 3), device=self.device)
        return logits, iou


def test_generate_on_the_stub_card_equals_cpu(cuda):
    """Everything mode on the stub decoder, crop layers 0 and 1 with the
    small-region cleanup: the card's masks, scores and boxes equal the
    CPU's exactly."""
    from yolo_contour_regression_tpu_torch.models.sam import Predictor

    img = np.full((STUB_S, STUB_S, 3), 127, np.uint8)
    for layers in (0, 1):
        kw = dict(crop_n_layers=layers, points_stride=16, points_batch_size=24,
                  conf_thres=0.5, min_mask_region_area=20)
        gp = Predictor(StubSam("cuda"))
        assert gp.device.type == "cuda"
        got = gp.generate(img, **kw)
        want = Predictor(StubSam("cpu")).generate(img, **kw)
        assert len(want[0]) >= len(STUB_OBJECTS)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_sam_b_predict_card_equals_cpu(cuda, full_f32):
    """sam_b at img_size 256 (``chip_smoke.sam_model``: seeded, relative
    positions drawn) on a 480x640 frame, on ``Predictor``'s default device
    (the card) against the CPU: embeddings within 1e-4 of their largest,
    low-res logits and IoU within 1e-3, masks equal but at pixels whose
    logit lies within 1e-4 of 0."""
    from chip_smoke import (RASTER_HW, SAM_EMB_RTOL, SAM_LOGIT_ATOL, SAM_THRESH_BAND,
                            frame_logits, sam_model, shape_images)
    from yolo_contour_regression_tpu_torch.models.sam import Predictor

    frame = shape_images(1, *RASTER_HW, seed=21)[0]
    cpu_model = sam_model("sam_b", img_size=256)
    gp = Predictor(copy.deepcopy(cpu_model))
    cp = Predictor(cpu_model, device="cpu")
    assert gp.device.type == "cuda" and next(gp.model.parameters()).is_cuda
    gp.set_image(frame)
    cp.set_image(frame)
    err = float((gp._emb.cpu() - cp._emb).abs().max())
    assert err <= SAM_EMB_RTOL * float(cp._emb.abs().max())
    for kw in (dict(point_coords=[[320, 240]], point_labels=[1]), dict(box=[200, 120, 460, 380])):
        gm, gi, gl = gp.predict(**kw, return_logits=True)
        cm, ci, cl = cp.predict(**kw, return_logits=True)
        assert np.abs(gl - cl).max() <= SAM_LOGIT_ATOL and np.abs(gi - ci).max() <= SAM_LOGIT_ATOL
        near = np.abs(frame_logits(cp, torch.from_numpy(cl))) <= SAM_THRESH_BAND
        assert not ((gm != cm) & ~near).any()


def test_fastsam_launches_both_fills(cuda):
    """``FastSAM(runs/floor_seg160/best.ckpt)`` on the card: prompts on
    results at the default ``boxes=True`` read masks filled by the cv2-rule
    kernel, and on results predicted with ``boxes=False`` fill the contours
    with the even-odd kernel; the selected masks equal the CPU's within
    IoU 0.99."""
    from chip_smoke import CKPT, floor_val_set
    from yolo_contour_regression_tpu_torch import FastSAM, FastSAMPrompt

    img = floor_val_set()[0][0]
    card, cpu = FastSAM(CKPT), FastSAM(CKPT, device="cpu")
    for boxes, kernel in ((True, raster.fill_polygons_cv2), (False, raster.fill_polygons)):
        before = kernel.launches
        gres, cres = card.predict(img, boxes=boxes), cpu.predict(img, boxes=boxes)
        assert len(gres[0]) == len(cres[0]) > 0
        b = cres[0].boxes.xyxy[0]
        g = FastSAMPrompt(img, gres).box_prompt(b)[0]
        c = FastSAMPrompt(img, cres).box_prompt(b)[0]
        assert kernel.launches > before
        assert np.logical_and(g, c).sum() >= 0.99 * np.logical_or(g, c).sum()


def test_nas_step_card_equals_cpu_f64(cuda, full_f32):
    """A fresh yolo_nas_s (nc 2) in float64 at imgsz 160 batch 2: the detect
    loss, the assignment and every gradient on the card against the CPU
    (``chip_smoke.train_card_vs_cpu``), and ``NAS`` defaults to the card."""
    from chip_smoke import DETECT_CKPT, fresh_nas, train_card_vs_cpu
    from yolo_contour_regression_tpu_torch import NAS
    from yolo_contour_regression_tpu_torch.utils.checkpoint import load_checkpoint

    assert NAS("yolo_nas_s").device.type == "cuda"
    train_card_vs_cpu(load_checkpoint(DETECT_CKPT), "card", imgsz=160, phase="test", b=2,
                      model=fresh_nas("cpu").model, dtype=torch.float64)
