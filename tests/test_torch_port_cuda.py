"""The port's CUDA kernels on a card, against their plain PyTorch versions.
They skip where there is no card; on one, run

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from yolo_contour_regression_tpu_torch.ops import raster

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


def test_raster_kernel_rejects_what_it_cannot_take(cuda):
    pts, valid = _polygons(0, 4, 12, 32, 32)
    pts, valid = pts.to(cuda), valid.to(cuda)
    with pytest.raises(TypeError):
        raster.fill_polygons(pts.double(), valid, 32, 32)
    with pytest.raises(ValueError):
        raster.fill_polygons(pts, valid.int(), 32, 32)
    with pytest.raises(ValueError):
        raster.fill_polygons(pts.transpose(0, 1), valid.t(), 32, 32)
    with pytest.raises(ValueError):
        raster.fill_polygons(pts, valid.cpu(), 32, 32)
