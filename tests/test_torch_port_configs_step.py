"""The four-level configs (yolov8-p2 at strides 4-32, yolov8-p6 and
yolov8-pose-p6 at 8-64) at a narrow width in train mode against the JAX
package on the CPU: one network step against JAX's float64 network, and
a fresh model's head priors against JAX ``BaseModel.init``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_contour_regression_tpu.engine import step as jstep
from yolo_contour_regression_tpu.nn.tasks import build_model as jbuild_model
from yolo_contour_regression_tpu.utils import loss as jloss
from yolo_contour_regression_tpu_torch.engine import step as tstep
from yolo_contour_regression_tpu_torch.nn.tasks import build_model, init_weights
from yolo_contour_regression_tpu_torch.utils import loss as tloss
from yolo_contour_regression_tpu_torch.utils.checkpoint import (from_jax_variables,
                                                                load_jax_variables)

from tests.test_torch_port_configs import narrow
from tests.test_torch_port_configs_graph import _imgsz, _jax_narrow
from tests.test_torch_port_detect import _det_batch
from tests.test_torch_port_pose import HYP, _pose_batch
from tests.test_torch_port_train import _f64, _np, _t
from tests.torch_port_jax_init import compiled_init


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the network step against JAX's float64 network: loss relative, gradients
# of each tensor's largest
STEP_LOSS_RTOL, STEP_GRAD_TOL = 1e-4, 1e-3


@pytest.mark.parametrize("name", ["yolov8n-p2.yaml", "yolov8n-p6.yaml", "yolov8n-pose-p6.yaml"])
def test_four_level_step_matches_jax_f64(name):
    """The narrow four-level graph in train mode, batch 2, both networks in
    float64 (the loss math f32 on both sides): the loss (1e-4), every
    parameter's gradient (1e-3 of its largest) and the assignment on the two
    networks' head maps."""
    cfg, jm, v, imgsz = _jax_narrow(name, 21)
    pose = "pose" in name
    images, batch = (_pose_batch(22, 2, 4, 17, imgsz) if pose else _det_batch(22, 2, 4, imgsz))
    batch["cls"] %= cfg["nc"]  # pose-p6 has one class
    nk = 51 if pose else 0
    with jax.enable_x64(True):
        jm64 = jbuild_model(cfg, dtype=jnp.float64)
        v64 = _f64(v)
        jb = {k: jnp.asarray(a) for k, a in batch.items()}
        fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm64, HYP), has_aux=True))
        (jl, _), jg = fn(v64["params"], v64["batch_stats"], jnp.asarray(images, jnp.float64), jb)
        jl, jg = float(jl), from_jax_variables(_np(jg), {})
        def assign(vv, x, b):  # compiled once: eager dispatch took 20-40 s of this test
            jout, _ = jm64.raw_forward(vv, x, train=True)
            _, a = jloss.detection_loss([o[..., :o.shape[-1] - nk] for o in jout], b,
                                        jm.strides, cfg["nc"], HYP, return_assign=True)
            return a.fg_mask, a.target_gt_idx

        jfg, jidx = (np.asarray(a) for a in jax.jit(assign)(
            v64, jnp.asarray(images, jnp.float64), jb))
    tb = {k: _t(a) for k, a in batch.items()}
    model = load_jax_variables(build_model(cfg), v["params"], v["batch_stats"]).double().train()
    loss, items = tstep.make_loss_fn(model, HYP)(_t(images).double(), tb)
    loss.backward()
    assert items["box_loss"].item() > 0
    np.testing.assert_allclose(loss.item(), jl, rtol=STEP_LOSS_RTOL)
    grads = dict(model.named_parameters())
    assert set(grads) == set(jg)
    for n, w in jg.items():
        err = float((grads[n].grad - w.double()).abs().max())
        assert err <= STEP_GRAD_TOL * float(w.abs().max()), (n, err)
    model = load_jax_variables(build_model(cfg), v["params"], v["batch_stats"]).double().train()
    with torch.no_grad():
        feats = model(_t(images).double().permute(0, 3, 1, 2))
    assign = tloss.detect_targets([f[:, :f.shape[1] - nk] for f in feats], tb, model.strides,
                                  cfg["nc"]).assign
    np.testing.assert_array_equal(assign.fg_mask.numpy(), jfg)
    np.testing.assert_array_equal(assign.target_gt_idx.numpy()[jfg], jidx[jfg])
    assert int(jfg.sum()) > 0



@pytest.mark.parametrize("name", ["yolov8n-p2.yaml", "yolov8n-p6.yaml", "yolov8n-pose-p6.yaml"])
def test_four_level_init_priors_equal_jax(name):
    """A fresh four-level model takes JAX ``BaseModel.init``'s head priors
    at each of its strides: the class bias ``log(5 / nc / (640 / s)^2)`` on
    (the detect child's) ``cv3[i][2]``, the box and keypoint biases 0."""
    cfg = narrow(name)
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    jm = jbuild_model(cfg)
    jv = compiled_init(jm, jax.random.PRNGKey(0), _imgsz(jm.strides))
    layer = len(cfg["backbone"]) + len(cfg["head"]) - 1
    jhead_p, head = jv["params"][f"layer{layer}"], model.model[layer]
    jdet, det = jhead_p.get("detect", jhead_p), getattr(head, "detect", head)
    assert len(model.strides) == 4
    for i, s in enumerate(model.strides):
        for tb, jb in ((det.cv3[i][2].bias, jdet[f"cv3_{i}_2"]),
                       (det.cv2[i][2].bias, jdet[f"cv2_{i}_2"])):
            np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb["bias"]), rtol=1e-6)
        prior = np.log(5 / cfg["nc"] / (640 / s) ** 2)
        assert abs(float(det.cv3[i][2].bias[0].detach()) - prior) < 1e-5
        if hasattr(head, "cv4"):
            np.testing.assert_array_equal(head.cv4[i][2].bias.detach().numpy(),
                                          np.asarray(jhead_p[f"cv4_{i}_2"]["bias"]))
