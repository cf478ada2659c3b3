"""The PyTorch port's config and fresh model against the JAX package on the
CPU: ``DEFAULT_CFG`` against ``cfg/default.yaml``, ``get_cfg``'s merge and
coercion, ``yaml_model_load``'s names, ``init_weights`` against
``build_model(...).init(PRNGKey(seed))`` (names, shapes, constants, the
spread of the random kernels), and the conv graph under bfloat16 autocast
against the JAX model built with ``dtype=bfloat16`` on the same weights."""
import copy
import math

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from tests.torch_port_jax_init import compiled_init
from yolo_contour_regression_tpu.cfg import DEFAULT_CFG_PATH
from yolo_contour_regression_tpu.cfg import get_cfg as jax_get_cfg
from yolo_contour_regression_tpu.nn.tasks import build_model
from yolo_contour_regression_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from yolo_contour_regression_tpu_torch.cfg import DEFAULT_CFG, get_cfg
from yolo_contour_regression_tpu_torch.nn.tasks import (
    YOLOV8_SEG, SegmentationModel, init_weights, yaml_model_load)
from yolo_contour_regression_tpu_torch.utils.checkpoint import (
    load_jax_variables, to_jax_variables)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

NARROW = copy.deepcopy(YOLOV8_SEG)
NARROW.update(nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})
# a random kernel's std against JAX's (relative), where it has this many entries
INIT_STD_RTOL, INIT_MIN_SIZE = 0.05, 4096


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_default_cfg_is_the_yaml():
    """Key for key, in order, the values ``yaml.safe_load`` reads."""
    want = yaml.safe_load(DEFAULT_CFG_PATH.read_text())
    assert list(DEFAULT_CFG) == list(want)
    for k, v in want.items():
        assert DEFAULT_CFG[k] == v and type(DEFAULT_CFG[k]) is type(v), k


@pytest.mark.parametrize("over", [
    {},
    {"epochs": "3", "amp": "false", "lr0": "0.02", "hide_labels": True},
    {"cand_per_gt": "auto", "resume": "last.ckpt", "imgsz": 160.0, "save": "1"},
    {"model": {"nc": 2}, "names": [1, 2], "mosaic": 0.5, "workers": "2"},
])
def test_get_cfg_matches_jax(over):
    """Defaults, overrides, deprecated names and coercion as JAX's."""
    assert vars(get_cfg(overrides=over)) == vars(jax_get_cfg(overrides=over))
    assert vars(get_cfg({"batch": 4}, over)) == vars(jax_get_cfg({"batch": 4}, over))


def test_get_cfg_checks_probabilities():
    for bad in ({"iou": 1.5}, {"mosaic": -0.1}, {"conf": 2}):
        with pytest.raises(ValueError):
            jax_get_cfg(overrides=bad)
        with pytest.raises(ValueError, match="must be in"):
            get_cfg(overrides=bad)


@pytest.mark.parametrize("name", ["yolov8n-seg.yaml", "yolov8s-seg.yaml", "yolov8m-seg.yaml",
                                  "yolov8l-seg.yaml", "yolov8x-seg.yaml", "yolov8-seg.yaml"])
def test_yaml_model_load_matches_jax(name):
    """The config and scale letter JAX's ``yaml_model_load`` reads for the
    name, and for its pose, proto-mask, classify, RT-DETR and P6
    counterparts (its ``yaml_file`` path aside); a name that is no config
    of the JAX package raises."""
    for n in (name, *(name.replace("-seg", t)
                      for t in ("-pose", "-segori", "-cls", "-rtdetr", "-p6"))):
        want = jax_yaml_model_load(n)
        want.pop("yaml_file")
        assert yaml_model_load(n) == want, n
    with pytest.raises(NotImplementedError, match="not a config of the JAX package"):
        yaml_model_load(name.replace("-seg", "-ghost"))


@pytest.fixture(scope="module")
def inits():
    """The full-width yolov8n-seg at nc 2: JAX's init from PRNGKey(0) and
    the port's from a seeded generator, as JAX trees."""
    jm = build_model("yolov8n-seg.yaml", nc=2)
    jv = compiled_init(jm, jax.random.PRNGKey(0), 64)
    tm = SegmentationModel(yaml_model_load("yolov8n-seg.yaml"), nc=2)
    tv = to_jax_variables(init_weights(tm, torch.Generator().manual_seed(0)).state_dict())
    return jm, (_tree(jv["params"]), _tree(jv["batch_stats"])), tv, tm


def test_init_weights_names_and_shapes(inits):
    """Every leaf of JAX's init, by name and shape, and no other."""
    _, (jp, jb), (tp, tb), tm = inits
    for j, t in ((jp, tp), (jb, tb)):
        jl, tl = _leaves(j), _leaves(t)
        assert sorted(tl) == sorted(jl)
        assert all(tl[k].shape == jl[k].shape for k in jl)
    assert tm.num_params == 4271698


def test_init_weights_constants(inits):
    """Conv biases 0 (but the head's), BatchNorm scale 1 and bias 0,
    running mean 0 and variance 1, the class biases ``log(5 / nc / (640 /
    s)^2)`` and the ray biases 1: equal to JAX's."""
    _, (jp, jb), (tp, tb), _ = inits
    jl, tl = _leaves(jp), _leaves(tp)
    consts = [k for k in jl if not k.endswith("kernel")]
    assert len(consts) > 90
    for k in consts:
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    for k, v in _leaves(jb).items():
        np.testing.assert_array_equal(_leaves(tb)[k], v, err_msg=k)
    heads = [k for k in jl if "cv3_" in k and k.endswith("_2/bias")]
    assert len(heads) == 3
    for k, s in zip(sorted(heads), (8, 16, 32)):
        np.testing.assert_allclose(tl[k], math.log(5 / 2 / (640 / s) ** 2), rtol=1e-6)


def test_init_weights_kernels_spread(inits):
    """Each conv kernel of at least ``INIT_MIN_SIZE`` entries has JAX's
    std (``sqrt(1 / fan_in)``) within ``INIT_STD_RTOL``, mean about 0, and
    no entry beyond the truncation at 2 of the underlying std."""
    _, (jp, _), (tp, _), _ = inits
    jl, tl = _leaves(jp), _leaves(tp)
    checked = 0
    for k, j in jl.items():
        if not k.endswith("kernel"):
            continue
        t = tl[k]
        fan_in = int(np.prod(t.shape[:-1]))
        limit = 2 * math.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert np.abs(t).max() <= limit * (1 + 1e-6), k
        assert np.abs(j).max() <= limit * (1 + 1e-6), k
        if t.size >= INIT_MIN_SIZE:
            np.testing.assert_allclose(t.std(), j.std(), rtol=INIT_STD_RTOL, err_msg=k)
            assert abs(t.mean()) < 4 * t.std() / math.sqrt(t.size), k
            checked += 1
    assert checked > 30


def test_init_weights_is_seeded():
    a = SegmentationModel(NARROW)
    b = SegmentationModel(NARROW)
    init_weights(a, torch.Generator().manual_seed(3))
    init_weights(b, torch.Generator().manual_seed(3))
    for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), n


# bf16 head outputs, port under autocast against JAX built in bf16, both on
# the same f32 weights: each level within this share of its largest entry
# (bf16 keeps 8 significant bits, and the two round at other places through
# some 60 convolutions)
AMP_RTOL = 0.05


@pytest.mark.parametrize("train", [False, True])
def test_amp_matches_jax_bf16(train):
    """The conv graph under ``torch.autocast("cpu", torch.bfloat16)`` (the
    trainer's ``amp``) against the JAX model built with ``dtype=bfloat16``
    on the same weights, in eval mode and in train mode (batch statistics):
    the head maps within ``AMP_RTOL`` of each level's largest entry, each
    side as far from the float32 graph as the other, and the head maps in
    bfloat16 where JAX's are."""
    rng = np.random.default_rng(0)
    x = rng.random((2, 64, 64, 3)).astype(np.float32)
    j32 = build_model(NARROW, nc=2)
    jv = compiled_init(j32, jax.random.PRNGKey(1), 64)
    jv = {"params": _tree(jv["params"]),
          "batch_stats": jax.tree_util.tree_map(
              lambda v: np.asarray(v) + rng.uniform(0.0, 0.5, v.shape).astype(np.float32),
              _tree(jv["batch_stats"]))}
    j16 = build_model(NARROW, nc=2, dtype=jnp.bfloat16)
    outs = {}
    for name, m in (("j32", j32), ("j16", j16)):
        out = m.raw_forward(jv, jnp.asarray(x), train=train)
        outs[name] = [np.asarray(o, np.float32) for o in (out[0] if train else out)]
    assert (out[0] if train else out)[0].dtype == jnp.bfloat16
    tm = SegmentationModel(NARROW)
    load_jax_variables(tm, jv["params"], jv["batch_stats"])
    tm.train(train)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        with torch.autocast("cpu", dtype=torch.bfloat16):
            t16 = tm(xt)
    assert t16[0].dtype == torch.bfloat16
    for lvl, (a, b, c) in enumerate(zip(t16, outs["j16"], outs["j32"])):
        a = a.float().permute(0, 2, 3, 1).numpy()
        scale = np.abs(c).max()
        err = np.abs(a - b).max() / scale
        assert err <= AMP_RTOL, (lvl, err)
        # the port's bf16 error against f32 is of the size of JAX's own
        assert np.abs(a - c).max() <= 2 * np.abs(b - c).max() + 1e-3 * scale, lvl
