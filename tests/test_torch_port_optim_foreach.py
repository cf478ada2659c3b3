"""The port's gradient clip and EMA (``utils/optim.py``) run as
``torch._foreach_*`` calls: held here, bit for bit, to the same formulas
written one call a tensor (the form they replaced), on every parameter of
yolov8n-rtdetr (365 tensors), with the clip active and not, in float32 and
float64. Their agreement with JAX is held by the train-step tests."""
import numpy as np
import pytest
import torch

from yolo_contour_regression_tpu_torch.nn.tasks import build_model, init_weights, yaml_model_load
from yolo_contour_regression_tpu_torch.utils import optim


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clip_per_tensor(grads, max_norm=optim.CLIP_NORM):
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def _ema_per_tensor(ema, model, step):
    d = optim.ema_decay(step)
    rest = float(np.float32(1.0) - np.float32(d))
    for name, p in model.named_parameters():
        e = ema[name]
        e.mul_(d).add_(p.detach().to(e.dtype) * rest)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_foreach_clip_and_ema_equal_the_per_tensor_forms(dtype, scale):
    """Random gradients at ``scale`` (a global norm of about 3, not
    clipped, or about 3e4, clipped to 10): the norm and every clipped
    gradient equal; the float32 EMA after an update equal."""
    model = init_weights(build_model(yaml_model_load("yolov8n-rtdetr.yaml")),
                         torch.Generator().manual_seed(0)).to(dtype)
    params = list(model.parameters())
    gen = torch.Generator().manual_seed(1)
    want = [torch.randn(p.shape, generator=gen, dtype=dtype) * scale for p in params]
    for p, g in zip(params, want):
        p.grad = g.clone()
    norm = _clip_per_tensor(want)
    opt = optim.Optimizer(torch.optim.SGD([{"params": params}], lr=0.1), {})
    got = opt.clip_grads()
    assert (float(got) < optim.CLIP_NORM) == (scale < 1)
    assert torch.equal(got, norm)
    assert all(torch.equal(p.grad, g) for p, g in zip(params, want))
    ema = {n: p.detach().float() * 0.9 for n, p in model.named_parameters()}
    ref = {n: t.clone() for n, t in ema.items()}
    _ema_per_tensor(ref, model, 37)
    optim.ema_update(ema, model, 37)
    assert all(torch.equal(ema[n], ref[n]) for n in ref)
