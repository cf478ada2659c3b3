"""The port's optimizers and their state against the JAX package's optax
ones on the CPU: every optimizer JAX builds (AdamW, SGD, Adam, NAdam,
RAdam, Adamax, RMSProp) takes the same 5 updates, warmup and the global
clip included, on the same float32 parameters and gradients of a narrow
yolov8-seg; the port's state maps to optax's ``opt_state`` and back
exactly; JAX's ``tree_map`` in its resume takes the port's pickled state;
the pickle refers to the classes JAX's own does; ``auto`` picks as JAX's;
and reading and writing work in a fresh interpreter without optax, jax and
yaml."""
import copy
import io
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from yolo_contour_regression_tpu.utils import optim as joptim
from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8_SEG, build_model, init_weights
from yolo_contour_regression_tpu_torch.utils import checkpoint as tckpt
from yolo_contour_regression_tpu_torch.utils import optim as toptim

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads beside the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NARROW = copy.deepcopy(YOLOV8_SEG)
NARROW.update(nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})
NAMES = ("AdamW", "SGD", "Adam", "NAdam", "RAdam", "Adamax", "RMSProp")
STEPS = 5
# parameters and moments after the updates, of each tensor's largest entry;
# the port's AdamW is torch.optim.AdamW, whose float32 bias corrections are
# not optax's (``1 - 0.999 ** t`` loses ~1e-5 of itself to cancellation in
# float32 either way, differently): 7.7e-6 measured at the bias group's
# warmup lr 0.1
RTOL = 1e-6
UPDATE_RTOL = {"AdamW": 1e-5}


def _hyp(name, **over):
    """All 5 updates in the warmup (100 steps), the bias group's lr from
    warmup_bias_lr, the weight decay on (gradient accumulation 2)."""
    return SimpleNamespace(**{**dict(
        optimizer=name, lr0=0.01, lrf=0.01, epochs=10, warmup_epochs=1.0, warmup_bias_lr=0.1,
        momentum=0.9, warmup_momentum=0.8, weight_decay=5e-4, batch=4, nbs=8, accumulate=2,
        nc=2), **over})


def _model():
    return init_weights(build_model(NARROW, nc=2), torch.Generator().manual_seed(0))


def _grads(params, k):
    """Float32 gradients in JAX's tree; at updates 1 and 3 their global
    norm is above the clip's 10."""
    rng = np.random.default_rng(100 + k)
    leaves, tdef = jax.tree_util.tree_flatten(params)
    scale = 5.0 if k in (1, 3) else 0.02
    return jax.tree_util.tree_unflatten(
        tdef, [(rng.standard_normal(x.shape) * scale).astype(np.float32) for x in leaves])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run(name, hyp_over=None, steps=STEPS):
    """The JAX optimizer and the port's, ``steps`` updates each from the
    same parameters and gradients -> (JAX params, JAX opt_state, port
    model, port optimizer)."""
    model = _model()
    params, _ = tckpt.to_jax_variables(dict(model.named_parameters()))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = joptim.build_optimizer(jparams, _hyp(name, **(hyp_over or {})), 10, 100)
    jstate = tx.init(jparams)
    opt = toptim.build_optimizer(model, _hyp(name, **(hyp_over or {})), 10, 100)
    for k in range(steps):
        g = _grads(params, k)
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        sd = tckpt.from_jax_variables(g, {})
        for n, p in model.named_parameters():
            p.grad = sd[n].clone()
        opt.step(k)
    return _np(jparams), _np(jstate), model, opt


def _close(got, want, what, rtol=RTOL):
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(want),
                                 jax.tree_util.tree_leaves_with_path(got), strict=True):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (what, path)
        tol = rtol * max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() <= tol, (what, jax.tree_util.keystr(path),
                                            np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.fixture(scope="module")
def runs():
    return {name: _run(name) for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_updates_match_optax(runs, name):
    """5 updates (warmup, the bias lr, the clip at updates 1 and 3, the
    decay): each parameter within ``RTOL`` of its largest entry of optax's
    (AdamW within ``UPDATE_RTOL``)."""
    jparams, _, model, _ = runs[name]
    got, _ = tckpt.to_jax_variables(dict(model.named_parameters()))
    _close(got, jparams, name, UPDATE_RTOL.get(name, RTOL))


@pytest.mark.parametrize("name", NAMES)
def test_state_maps_to_optax(runs, name):
    """``jax_opt_state`` of the port's optimizer has the structure of JAX's
    ``opt_state`` (every class, nesting and ``MaskedNode``), its moments
    within ``RTOL`` of optax's and its counts the step."""
    _, jstate, model, opt = runs[name]
    params = dict(model.named_parameters())
    tree = toptim.jax_opt_state(toptim.optimizer_spec(opt, STEPS), params,
                                toptim.moment_tensors(opt, model), STEPS)
    loaded = pickle.loads(_dumps(tree))  # optax's own classes, as JAX reads the file
    assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(jstate)
    _close(loaded, jstate, name)
    counts = [x for p, x in jax.tree_util.tree_leaves_with_path(loaded)
              if jax.tree_util.keystr(p).endswith(".count")]
    assert counts and all(int(c) == STEPS for c in counts)


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    tckpt.dump_checkpoint(obj, buf)
    return buf.getvalue()


@pytest.mark.parametrize("name", NAMES)
def test_state_round_trips_exactly(runs, name):
    """port -> optax's tree (pickled and read back by the port's reader) ->
    a fresh optimizer: every moment bit-equal, and the next update equal
    bit for bit to the uninterrupted optimizer's."""
    model, opt = copy.deepcopy(runs[name][2:])  # the optimizer on the copy's parameters
    params = dict(model.named_parameters())
    moments = toptim.moment_tensors(opt, model)
    tree = toptim.jax_opt_state(toptim.optimizer_spec(opt, STEPS), params, moments, STEPS)
    back = tckpt._Unpickler(io.BytesIO(_dumps(tree))).load()
    model2 = copy.deepcopy(model)
    opt2 = toptim.build_optimizer(model2, _hyp(name), 10, 100)
    toptim.load_jax_opt_state(opt2, model2, back, STEPS)
    moments2 = toptim.moment_tensors(opt2, model2)
    assert sorted(moments2) == sorted(moments)
    for k in moments:
        assert torch.equal(moments2[k], moments[k]), k
    g = tckpt.from_jax_variables(_grads(tckpt.to_jax_variables(params)[0], STEPS), {})
    for m, o in ((model, opt), (model2, opt2)):
        for n, p in m.named_parameters():
            p.grad = g[n].clone()
        o.step(STEPS)
    for (n, a), (_, b) in zip(model.named_parameters(), model2.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("name", NAMES)
def test_jax_state_loads_into_the_port(runs, name):
    """JAX's own ``opt_state``, pickled by JAX and read by the port's
    reader, loads into the port's optimizer: every moment equal to optax's
    bit for bit in the parameter's layout; loading it into another
    optimizer, or at another step, raises."""
    _, jstate, model, opt = runs[name]
    read = tckpt._Unpickler(io.BytesIO(pickle.dumps(jstate, protocol=5))).load()
    model2 = copy.deepcopy(model)
    opt2 = toptim.build_optimizer(model2, _hyp(name), 10, 100)
    toptim.load_jax_opt_state(opt2, model2, read, STEPS)
    back = toptim.jax_opt_state(toptim.optimizer_spec(opt2, STEPS),
                                dict(model2.named_parameters()),
                                toptim.moment_tensors(opt2, model2), STEPS)
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jstate),
                              jax.tree_util.tree_leaves_with_path(pickle.loads(_dumps(back))),
                              strict=True):
        if not jax.tree_util.keystr(p).endswith("learning_rate']") and \
                not jax.tree_util.keystr(p).endswith("momentum']"):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(p))
    other = "SGD" if name != "SGD" else "AdamW"
    with pytest.raises(ValueError, match="does not map"):
        toptim.load_jax_opt_state(toptim.build_optimizer(model2, _hyp(other), 10, 100), model2,
                                  read, STEPS)
    with pytest.raises(ValueError, match="counts"):
        toptim.load_jax_opt_state(opt2, model2, read, STEPS + 1)


class _Classes(pickle.Unpickler):
    """Records every class a pickle refers to (and builds nothing)."""

    def __init__(self, data):
        super().__init__(io.BytesIO(data))
        self.seen = set()

    def find_class(self, module, name):
        self.seen.add((module, name))
        return super().find_class(module, name)


@pytest.mark.parametrize("name", NAMES)
def test_pickle_refers_to_jax_classes(runs, name):
    """The port's pickle of its optimizer state refers to exactly the
    classes (optax's, numpy's) that JAX's own pickle of its state does, and
    each optax class it names is one of ``OPTAX_STATES``."""
    _, jstate, model, opt = runs[name]
    tree = toptim.jax_opt_state(toptim.optimizer_spec(opt, STEPS),
                                dict(model.named_parameters()),
                                toptim.moment_tensors(opt, model), STEPS)
    mine, theirs = _Classes(_dumps(tree)), _Classes(pickle.dumps(jstate, protocol=5))
    mine.load()
    theirs.load()
    assert mine.seen == theirs.seen
    assert {c for c in mine.seen if c[0].startswith("optax")} <= set(tckpt.OPTAX_STATES)


@pytest.mark.parametrize("iterations,nc", [(100, 2), (10000, 2), (10001, 2), (10001, 80),
                                           (500, 80), (500, 1)])
def test_auto_picks_as_jax(iterations, nc):
    """``optimizer=auto``: SGD past 10,000 iterations, else AdamW with its
    lr fit to nc; lr0, momentum and warmup_bias_lr set in place as JAX's."""
    model = _model()
    params, _ = tckpt.to_jax_variables(dict(model.named_parameters()))
    jh, th = _hyp("auto", nc=nc), _hyp("auto", nc=nc)
    joptim.build_optimizer(jax.tree_util.tree_map(jnp.asarray, params), jh, 10, iterations)
    opt = toptim.build_optimizer(model, th, 10, iterations)
    assert (th.lr0, th.momentum, th.warmup_bias_lr) == (jh.lr0, jh.momentum, jh.warmup_bias_lr)
    assert opt.name == ("SGD" if iterations > 10000 else "AdamW")


def test_no_weight_decay_drops_the_chain():
    """With ``weight_decay`` 0 JAX chains no ``add_decayed_weights`` before
    the weight group's rule; the port's tree follows, for each rule."""
    for name in ("SGD", "Adam", "RMSProp"):
        _, jstate, model, opt = _run(name, {"weight_decay": 0.0}, steps=1)
        tree = toptim.jax_opt_state(toptim.optimizer_spec(opt, 1), dict(model.named_parameters()),
                                    toptim.moment_tensors(opt, model), 1)
        assert (jax.tree_util.tree_structure(pickle.loads(_dumps(tree)))
                == jax.tree_util.tree_structure(jstate)), name


BLOCKED = ("jax", "jaxlib", "flax", "optax", "yaml", "yolo_contour_regression_tpu")
SCRIPT = r"""
import importlib.abc, sys
BLOCKED = set(sys.argv[1].split(","))

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked: {name}", name=name)
        return None

for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())
import numpy as np, torch
torch.set_num_threads(2)
from yolo_contour_regression_tpu_torch.utils import checkpoint as ck
ckpt = ck.load_checkpoint(sys.argv[2])
st = ckpt["opt_state"]
assert type(st[1]).__name__ == "PartitionState" and type(st[1]).__module__.startswith("optax")
adam = st[1].inner_states["weight"].inner_state[0]
assert type(adam).__name__ == "ScaleByAdamState" and int(adam.count) == ckpt["step"]
ck.write_checkpoint(sys.argv[3], ckpt)
again = ck.load_checkpoint(sys.argv[3])
assert type(again["opt_state"][1]) is type(st[1])
print("ok")
"""


def test_read_and_write_without_optax(tmp_path):
    """A JAX mid-run checkpoint (AdamW ``opt_state`` from optax) is read,
    written and read again in a fresh interpreter where jax, optax, flax,
    yaml and the JAX package cannot be imported; JAX reads the rewritten
    file into optax's own classes, equal to the original."""
    from yolo_contour_regression_tpu.utils import checkpoint as jckpt

    _, jstate, model, _ = _run("AdamW", steps=2)
    params, stats = tckpt.to_jax_variables(model.state_dict())
    src, out = tmp_path / "jax.ckpt", tmp_path / "port.ckpt"
    jckpt.save_checkpoint(src, params, stats, params, jstate, 2, 0, 0.5, {"task": "segment"},
                          NARROW, {0: "a", 1: "b"})
    res = subprocess.run([sys.executable, "-c", SCRIPT, ",".join(BLOCKED), str(src), str(out)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]
    again = jckpt.load_checkpoint(out)
    assert isinstance(again["opt_state"][1], optax.transforms.PartitionState)
    assert jax.tree_util.tree_structure(again["opt_state"]) == jax.tree_util.tree_structure(jstate)
    for a, b in zip(jax.tree_util.tree_leaves(again["opt_state"]), jax.tree_util.tree_leaves(jstate),
                    strict=True):
        np.testing.assert_array_equal(a, b)
