"""The PyTorch port's RT-DETR criterion and train step against the JAX
package on the CPU: the auction (``hungarian_assign``) on uniform,
clustered and crowd costs and at its 600-round cap, bit for bit, and its
optimal cost against scipy's solver; ``match_cost``, both layer losses and
``rtdetr_loss`` on the same maps; ``get_cdn_group`` on JAX's draws and the
port's own draws; the network's loss, assignments and gradients against
the JAX network in float64 with JAX's dn dict; one ``make_train_step``
step against JAX's, and the optimizer groups.

JAX's auction keeps int32 state that x64 mode promotes (its
``while_loop`` then refuses the carry), so where JAX runs in float64 its
assignment is solved in float32 mode on its own float64 costs, as its
``_auction_one`` casts them, and handed to its loss in place of the
solve."""
import copy
from types import SimpleNamespace

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

import jax
import jax.numpy as jnp
import torch

from chip_smoke import shape_batch
from tests.test_torch_port_modules import _randomize
from tests.test_torch_port_train import (ADAM_SIGN_SHARE, STEP_GRAD_TOL, STEP_LOSS_RTOL,
                                         STEP_STATE_TOL, _f64, _hyp, _np, _t)
from yolo_contour_regression_tpu.engine import step as jstep
from yolo_contour_regression_tpu.models.utils import loss as jloss
from yolo_contour_regression_tpu.models.utils import ops as jops
from yolo_contour_regression_tpu.nn.tasks import build_model as jbuild_model
from yolo_contour_regression_tpu.utils import optim as joptim
from yolo_contour_regression_tpu_torch.engine import step as tstep
from yolo_contour_regression_tpu_torch.models.utils import loss as tloss
from yolo_contour_regression_tpu_torch.models.utils import ops as tops
from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8_RTDETR, RTDETRDetectionModel
from yolo_contour_regression_tpu_torch.utils import optim as toptim
from yolo_contour_regression_tpu_torch.utils.checkpoint import (
    checkpoint_variables, from_jax_variables, load_checkpoint, load_jax_variables)

RTDETR_CKPT = "runs/floor_rtdetr/best.ckpt"
# the criterion on the same maps, f32 on both sides (relative), and its
# gradient (relative to each map's largest entry)
LOSS_RTOL = 1e-5
# dn groups on the same draws: a few f32 ulps
CDN_ATOL = 1e-6
# JAX's own test of the auction against scipy's optimum
OPT_RTOL = OPT_ATOL = 1e-4
NC = 2
HYP = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5)
# the narrow graph: yolov8 scaled to [0.33, 0.125, 256] with the full
# decoder (its widths are the JAX module's defaults, not the config's)
NARROW = copy.deepcopy(YOLOV8_RTDETR)
NARROW.update(nc=NC, scale="t", scales={"t": [0.33, 0.125, 256]})


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- the auction ---------------------------------------------------------------

def _costs(kind, seed, n=4, Q=300, G=48):
    """(n, Q, G) float32 costs of one geometry and n_valid, padded GT
    columns at 1e6 as ``match_cost`` gives them."""
    rng = np.random.default_rng(seed)
    out, nv = [], []
    for i in range(n):
        if kind == "uniform":
            c = rng.uniform(0, 10, (Q, G))
        elif kind == "clustered":  # queries near a few GT clusters
            centers = rng.uniform(0, 1, (6, 4))[rng.integers(0, 6, G)]
            q = centers[rng.integers(0, G, Q)] + rng.normal(0, 0.05, (Q, 4))
            c = np.abs(q[:, None] - centers[None]).sum(-1) * 5
        elif kind == "crowd":  # near-duplicate GTs contest the same queries
            centers = np.repeat(rng.uniform(0, 1, (G // 4, 4)), 4, axis=0)
            q = centers[rng.integers(0, G, Q)] + rng.normal(0, 0.02, (Q, 4))
            c = np.abs(q[:, None] - centers[None]).sum(-1) * 5
        else:  # "cap": every GT wants the same few queries, by a hair
            c = np.tile(rng.uniform(0, 1, (Q, 1)), (1, G)) * 10 + rng.uniform(0, 0.01, (Q, G))
        g = G if i == 0 else int(rng.integers(1, G + 1))
        c[:, g:] = 1e6
        out.append(c.astype(np.float32))
        nv.append(g)
    return np.stack(out), np.array(nv)


@pytest.mark.parametrize("kind,Q", [("uniform", 300), ("clustered", 300), ("crowd", 300),
                                    ("crowd", 48), ("cap", 60)])
def test_hungarian_assign_matches_jax(kind, Q):
    """The same (query per GT, -1 for padded GTs) as JAX's vmapped auction,
    entry for entry. "cap" (and here the clustered and the square crowd
    costs) run into the 600-round cap and the greedy completion; the rest
    converge, within JAX's tolerance of scipy's optimum."""
    cost, nv = _costs(kind, {"uniform": 1, "clustered": 2, "crowd": 3, "cap": 4}[kind], Q=Q)
    want = np.asarray(jloss.hungarian_assign(jnp.asarray(cost), jnp.asarray(nv)))
    for c, g, w in zip(cost, nv, want):
        tloss.hungarian_assign.rounds = 0
        got = tloss.hungarian_assign(_t(c[None]), _t(np.array([g]))).numpy()[0]
        np.testing.assert_array_equal(got, w)
        sel = got[:g]
        assert (got[g:] == -1).all() and (sel >= 0).all() and len(set(sel.tolist())) == g
        capped = tloss.hungarian_assign.rounds == tloss.MAX_ROUNDS
        assert capped or kind != "cap"
        if not capped:
            rows, cols = linear_sum_assignment(c[:, :g])
            opt = c[rows, cols].sum()
            assert c[sel, np.arange(g)].sum() <= opt * (1 + OPT_RTOL) + OPT_ATOL


@pytest.mark.parametrize("max_rounds", [1, 5, 37])
def test_hungarian_assign_cut_short_matches_jax(max_rounds, monkeypatch):
    """At a lower round cap (the greedy completion does more of the work),
    still JAX's answer, whatever the host's check interval."""
    cost, nv = _costs("crowd", 5, n=3)
    want = np.asarray(jax.vmap(lambda c, n: jloss._auction_one(c, n, max_rounds=max_rounds))(
        jnp.asarray(cost), jnp.asarray(nv)))
    for every in (1, 10, 600):
        monkeypatch.setattr(tloss, "CHECK_EVERY", every)
        got = tloss.hungarian_assign(_t(cost), _t(nv), max_rounds=max_rounds)
        np.testing.assert_array_equal(got.numpy(), want)


def test_hungarian_assign_batched_equals_one_by_one():
    """Solving many images in one batch (all layers of a step) gives each
    image's own answer; the host checks once every ``CHECK_EVERY`` rounds."""
    cost, nv = _costs("clustered", 6, n=6)
    one = [tloss.hungarian_assign(_t(c[None]), _t(n[None])).numpy()[0] for c, n in zip(cost, nv)]
    for k in ("rounds", "syncs", "solves"):
        setattr(tloss.hungarian_assign, k, 0)
    got = tloss.hungarian_assign(_t(cost), _t(nv)).numpy()
    np.testing.assert_array_equal(got, np.stack(one))
    h = tloss.hungarian_assign
    assert h.solves == 1 and h.rounds == h.syncs * tloss.CHECK_EVERY and h.syncs >= 1


# --- the criterion on the same maps ------------------------------------------

def _maps(seed, B=2, Q=20, G=5):
    """Predicted boxes (B, L, Q, 4) inside the image, logits, GT boxes,
    labels and the mask (image 1 has two GTs; an unassigned GT slot and a
    query 0 in play), as numpy."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (B, Q, 2))
    pb = np.concatenate([c, rng.uniform(0.05, 0.4, (B, Q, 2))], -1).astype(np.float32)
    pl = rng.normal(-1, 2, (B, Q, NC)).astype(np.float32)
    gc = rng.uniform(0.25, 0.75, (B, G, 2))
    gb = np.concatenate([gc, rng.uniform(0.05, 0.4, (B, G, 2))], -1).astype(np.float32)
    gb[:, :2] = pb[:, :2] + 0.01  # near queries 0 and 1
    labels = rng.integers(0, NC, (B, G)).astype(np.int32)
    mask = np.ones((B, G), bool)
    mask[1, 2:] = False
    return pb, pl, gb, labels, mask


def test_match_cost_matches_jax():
    pb, pl, gb, labels, mask = _maps(0)
    want = np.asarray(jloss.match_cost(*(jnp.asarray(a) for a in (pb, pl, gb, labels, mask))))
    got = tloss.match_cost(*(_t(a) for a in (pb, pl, gb, labels, mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-5)
    assert (got[1, :, 2:] == 1e6).all()


def _grad_pair(jfn, tfn, arrays):
    """Values and gradients (of the summed outputs, w.r.t. the float
    arrays) of a JAX and a port function on the same inputs."""
    floats = [i for i, a in enumerate(arrays) if a.dtype == np.float32]

    def jsum(*fa):
        args = list(map(jnp.asarray, arrays))
        for i, a in zip(floats, fa):
            args[i] = a
        return sum(jfn(*args)), jfn(*args)

    # compiled once: eager dispatch took most of these tests' time
    (_, jout), jg = jax.jit(jax.value_and_grad(jsum, argnums=tuple(range(len(floats))),
                                               has_aux=True))(
        *(jnp.asarray(arrays[i]) for i in floats))
    targs = [_t(a).clone().requires_grad_(i in floats) for i, a in enumerate(arrays)]
    tout = tfn(*targs)
    sum(tout).backward()
    return ([np.asarray(x) for x in jout], [np.asarray(g) for g in jg],
            [x.detach().numpy() for x in tout], [targs[i].grad.numpy() for i in floats])


def _close(got, want, what):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=LOSS_RTOL * np.abs(w).max(),
                                   err_msg=what)


def test_detr_layer_loss_matches_jax():
    """One layer's class, L1 and GIoU losses and their gradients on a given
    assignment: a padded GT's -1 goes to the dropped query, not query 0."""
    pb, pl, gb, labels, mask = _maps(1)
    assign = np.array([[0, 4, 7, 1, 9], [2, 0, -1, -1, -1]], np.int64)
    arrays = [pb, pl, gb, labels, mask, assign]
    jv, jg, tv, tg = _grad_pair(
        lambda *a: jloss.detr_layer_loss(*a, NC),
        lambda *a: tloss.detr_layer_loss(*a, NC), arrays)
    _close(tv, jv, "values")
    _close(tg, jg, "gradients")


def test_detr_dn_layer_loss_matches_jax():
    rng = np.random.default_rng(2)
    B, G, N = 2, 3, 5
    _, _, gb, labels, mask = _maps(2, G=N)
    c = rng.uniform(0.2, 0.8, (B, G, 2, N, 2))
    pb = np.concatenate([c, rng.uniform(0.05, 0.4, c.shape)], -1).astype(np.float32)
    pl = rng.normal(-1, 2, (B, G, 2, N, NC)).astype(np.float32)
    jv, jg, tv, tg = _grad_pair(
        lambda *a: jloss.detr_dn_layer_loss(*a, NC),
        lambda *a: tloss.detr_dn_layer_loss(*a, NC), [pb, pl, gb, labels, mask])
    _close(tv, jv, "values")
    _close(tg, jg, "gradients")


@pytest.mark.parametrize("with_dn", [False, True])
def test_rtdetr_loss_matches_jax(with_dn):
    """The whole criterion on the same decoder and encoder maps (3 layers,
    and with 2 dn groups of 2 x 5 queries ahead of the 20 matching ones):
    every item at full gain, the total, and each map's gradient."""
    rng = np.random.default_rng(3)
    L, B, Q, N, G = 3, 2, 20, 5, 2
    T = Q + (G * 2 * N if with_dn else 0)
    c = rng.uniform(0.2, 0.8, (L, B, T, 2))
    dec_b = np.concatenate([c, rng.uniform(0.05, 0.4, c.shape)], -1).astype(np.float32)
    dec_s = rng.normal(-1, 2, (L, B, T, NC)).astype(np.float32)
    ce = rng.uniform(0.2, 0.8, (B, Q, 2))
    enc_b = np.concatenate([ce, rng.uniform(0.05, 0.4, ce.shape)], -1).astype(np.float32)
    enc_s = rng.normal(-1, 2, (B, Q, NC)).astype(np.float32)
    _, _, gb, labels, mask = _maps(4, G=N)
    batch = {"bboxes": gb, "cls": labels, "mask_gt": mask}
    dn = None
    if with_dn:
        dn = {"labels": np.zeros((B, G, 2, N), np.int32),
              "boxes_logit": np.zeros((B, G, 2, N, 4), np.float32)}

    def jfn(*maps):
        total, items = jloss.rtdetr_loss(maps, {k: jnp.asarray(v) for k, v in batch.items()}, NC,
                                         dn=None if dn is None else
                                         {k: jnp.asarray(v) for k, v in dn.items()})
        return total, items

    # compiled once: eager dispatch took most of this test's time
    (jt, jitems), jg = jax.jit(jax.value_and_grad(lambda *m: jfn(*m), argnums=(0, 1, 2, 3),
                                                  has_aux=True))(*map(jnp.asarray,
                                                                      (dec_b, dec_s, enc_b,
                                                                       enc_s)))
    maps = [_t(a).clone().requires_grad_() for a in (dec_b, dec_s, enc_b, enc_s)]
    tt, titems = tloss.rtdetr_loss(tuple(maps), {k: _t(v) for k, v in batch.items()}, NC,
                                   dn=None if dn is None else {k: _t(v) for k, v in dn.items()})
    tt.backward()
    assert set(titems) == set(jitems) and len(titems) == (6 if with_dn else 3)
    for k in jitems:
        np.testing.assert_allclose(titems[k].item(), float(jitems[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(tt.item(), float(jt), rtol=LOSS_RTOL)
    _close([m.grad.numpy() for m in maps], [np.asarray(g) for g in jg], "gradients")


# --- contrastive denoising -----------------------------------------------------

def _jax_draws(key, B, G, N, nc):
    """The draws ``get_cdn_group`` takes from ``key``, in its order."""
    k_cls, k_newcls, k_sign, k_part, _ = jax.random.split(key, 5)
    shape = (B, G, 2, N)
    return {"flip": np.asarray(jax.random.uniform(k_cls, shape)),
            "new_cls": np.asarray(jax.random.randint(k_newcls, shape, 0, nc)),
            "sign": np.asarray(jax.random.randint(k_sign, shape + (4,), 0, 2) * 2.0 - 1.0),
            "part": np.asarray(jax.random.uniform(k_part, shape + (4,)))}


def _cdn_batch(seed, B=2, N=4):
    _, _, gb, labels, mask = _maps(seed, G=N)
    return {"bboxes": gb, "cls": labels, "mask_gt": mask}


@pytest.mark.parametrize("num_dn,N", [(100, 4), (16, 4), (3, 8)])
def test_get_cdn_group_matches_jax_on_its_draws(num_dn, N):
    """The dn dict from JAX's draws (``PRNGKey(17)`` folded with step 3):
    labels equal, box logits within ``CDN_ATOL``; G = max(num_dn // N, 1)."""
    batch = _cdn_batch(5, N=N)
    key = jax.random.fold_in(jax.random.PRNGKey(17), 3)
    want = jops.get_cdn_group({k: jnp.asarray(v) for k, v in batch.items()}, NC, key,
                              num_dn=num_dn)
    G = tops.num_groups(N, num_dn)
    assert want["labels"].shape == (2, G, 2, N)
    got = tops.cdn_group_from_draws({k: _t(v) for k, v in batch.items()},
                                    {k: _t(v) for k, v in _jax_draws(key, 2, G, N, NC).items()})
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_allclose(got["boxes_logit"].numpy(), np.asarray(want["boxes_logit"]),
                               atol=CDN_ATOL)
    assert tops.get_cdn_group({k: _t(v) for k, v in batch.items()}, NC,
                              tops.cdn_generator(0), num_dn=0) is None


def test_port_cdn_draws_have_jax_distribution():
    """The port's own draws (not JAX's, whose arithmetic the test above
    holds): each step's generator repeats itself and differs from the next;
    about a quarter of the labels flip (half of them to themselves), the
    signs are even and the parts uniform; positive copies keep each corner
    within half a box of their GT's, and negative copies land farther from
    the GT than positive ones (JAX's own check); every logit finite."""
    rng = np.random.default_rng(6)
    B, N = 8, 10
    c = rng.uniform(0.3, 0.7, (B, N, 2))
    gb = np.concatenate([c, rng.uniform(0.05, 0.2, c.shape)], -1).astype(np.float32)
    batch = {"bboxes": _t(gb), "cls": _t(rng.integers(0, NC, (B, N))),
             "mask_gt": _t(np.ones((B, N), bool))}
    a = tops.get_cdn_group(batch, NC, tops.cdn_generator(7))
    b = tops.get_cdn_group(batch, NC, tops.cdn_generator(7))
    c8 = tops.get_cdn_group(batch, NC, tops.cdn_generator(8))
    assert torch.equal(a["boxes_logit"], b["boxes_logit"])
    assert not torch.equal(a["boxes_logit"], c8["boxes_logit"])
    G = 100 // N
    assert a["labels"].shape == (B, G, 2, N) and torch.isfinite(a["boxes_logit"]).all()
    changed = (a["labels"] != batch["cls"][:, None, None]).float().mean().item()
    assert 0.05 < changed < 0.2  # 0.25 flipped, half of them to the same class
    draws = tops.cdn_draws(64, 8, 16, NC, tops.cdn_generator(9))
    assert abs(draws["sign"].mean().item()) < 0.05 and abs(draws["part"].mean().item() - 0.5) < 0.02
    assert set(draws["new_cls"].unique().tolist()) == set(range(NC))
    box = torch.sigmoid(a["boxes_logit"].double())
    g = torch.from_numpy(gb).double()[:, None, None]
    corners = lambda x: torch.cat([x[..., :2] - x[..., 2:] / 2, x[..., :2] + x[..., 2:] / 2], -1)  # noqa: E731
    shift = (corners(box) - corners(g)).abs() / torch.cat([g[..., 2:], g[..., 2:]], -1)
    assert shift[:, :, 0].max() <= 0.5 + 1e-3
    d = (box[..., :2] - g[..., :2]).abs().sum(-1)
    assert d[:, :, 1].mean() > d[:, :, 0].mean()


# --- the network and the step ------------------------------------------------

def _narrow_variables():
    jm = jbuild_model(NARROW)
    dn0 = {"labels": jnp.zeros((1, 1, 2, 1), jnp.int32),
           "boxes_logit": jnp.zeros((1, 1, 2, 1, 4))}
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=True,
        head_extra=dn0))
    return _np(_randomize({k: shapes[k] for k in ("params", "batch_stats")}, 3))


def _jax_costs(outs, batch, dn_q):
    """JAX's matching costs of its own float64 outputs, each layer's and
    then the encoder's, cast to float32 as ``_auction_one`` casts them."""
    gb = batch["bboxes"].astype(jnp.float32)
    gl = batch["cls"].astype(jnp.int32)
    mg = batch["mask_gt"].astype(bool)
    pairs = [(outs[0][i][:, dn_q:], outs[1][i][:, dn_q:]) for i in range(outs[0].shape[0])]
    cost = jax.jit(jloss.match_cost)  # compiled once: eager dispatch took most of its time
    return [np.asarray(cost(b, s, gb, gl, mg), np.float32)
            for b, s in pairs + [(outs[2], outs[3])]]


@pytest.fixture(scope="module")
def network():
    """The narrow graph at imgsz 64, batch 2 (4 GT slots, 2 of them in use):
    JAX's dn dict of step 0 (``get_cdn_group`` under ``PRNGKey(17)``), the
    JAX network in float64 (loss and gradients), its assignments, and one
    JAX ``make_train_step`` step (AdamW, no warmup) from the same weights."""
    v = _narrow_variables()
    images, batch = shape_batch(2, 64, 4, seed=6)
    batch = {k: batch[k] for k in ("cls", "bboxes", "mask_gt")}
    hyp = _hyp("AdamW", lr0=0.0002, warmup_epochs=0.0, **vars(HYP))
    n_valid = jnp.asarray(batch["mask_gt"].sum(-1))
    with jax.enable_x64(True):
        jm = jbuild_model(NARROW, dtype=jnp.float64)
        v64 = _f64(v)
        jb = {k: jnp.asarray(a) for k, a in batch.items()}
        x = jnp.asarray(images, jnp.float64)
        dn = jops.get_cdn_group(jb, NC, jax.random.fold_in(jax.random.PRNGKey(17), 0))
        dn_q = int(np.prod(dn["labels"].shape[1:]))
        outs, _ = jax.jit(lambda vv: jm.raw_forward(vv, x, train=True, head_extra=dn))(v64)
        costs = _jax_costs(outs, jb, dn_q)
    auction = jax.jit(jloss.hungarian_assign)
    assign = [np.asarray(auction(jnp.asarray(c), n_valid)) for c in costs]
    real = jloss.hungarian_assign
    calls = iter(assign * 3)  # the loss, then the step's loss, each in layer order
    jloss.hungarian_assign = lambda cost, n: jnp.asarray(next(calls))
    try:
        with jax.enable_x64(True):
            fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm, HYP), has_aux=True))
            (loss, (items, _)), g = fn(v64["params"], v64["batch_stats"], x, jb, 0)
            tx = joptim.build_optimizer(v64["params"], copy.copy(hyp), 10, 100)
            state = jstep.init_train_state(v64, tx)
            step = jstep.make_train_step(jm, tx, copy.copy(hyp), donate=False)
            state, metrics = step(state, x, jb)
            out = dict(loss=float(loss), items={k: float(a) for k, a in items.items()},
                       grads=from_jax_variables(_np(g), {}), step_loss=float(metrics["loss"]),
                       state=from_jax_variables(_np(state.params), _np(state.batch_stats)),
                       ema=from_jax_variables(_np(state.ema_params), {}),
                       dn={k: np.asarray(a) for k, a in dn.items()}, dn_q=dn_q,
                       assign=np.stack(assign))
    finally:
        jloss.hungarian_assign = real
    return v, images, batch, hyp, out


def _port_model(v):
    return load_jax_variables(RTDETRDetectionModel(NARROW), v["params"], v["batch_stats"])


def test_network_loss_and_gradients_match_jax_f64(network):
    """The narrow graph in train mode with JAX's dn dict: the same
    assignment in every layer, the loss and its items within
    ``STEP_LOSS_RTOL``, every gradient within ``STEP_GRAD_TOL`` of its
    tensor's largest entry. The self-attention's key biases have no
    gradient (a softmax does not see a shift common to its row): both
    sides' are rounding noise, held near 0 instead."""
    v, images, batch, _, want = network
    model = _port_model(v).train().double()
    dn = {k: _t(a) for k, a in want["dn"].items()}
    tb = {k: _t(a) for k, a in batch.items()}
    marks = []
    loss, items = tstep.make_loss_fn(model, HYP, mark=marks.append,
                                     dn_fn=lambda b, s: dn)(_t(images).double(), tb)
    assert marks == ["forward", "matching", "loss"]
    loss.backward()
    with torch.no_grad():
        outs = copy.deepcopy(model)(_t(images).double().permute(0, 3, 1, 2), dn=dn)
    np.testing.assert_array_equal(tloss.rtdetr_assign(outs, tb, want["dn_q"]).numpy(),
                                  want["assign"])
    assert ((want["assign"] >= 0) == batch["mask_gt"][None]).all()
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=STEP_LOSS_RTOL)
    for k, w in want["items"].items():
        np.testing.assert_allclose(items[k].item(), w, rtol=STEP_LOSS_RTOL, err_msg=k)
    grads = dict(model.named_parameters())
    assert set(grads) == set(want["grads"])
    scale = max(float(g.abs().max()) for g in want["grads"].values())
    for n, w in want["grads"].items():
        g = grads[n].grad.float()
        if n.endswith("self_attn.key.bias"):
            assert max(float(g.abs().max()), float(w.abs().max())) <= 1e-9 * scale, n
            continue
        err = float((g - w).abs().max())
        assert err <= STEP_GRAD_TOL * float(w.abs().max()), (n, err)


def test_train_step_matches_jax(network):
    """One ``make_train_step`` step (AdamW, no warmup, JAX's dn through
    ``dn_fn``) against JAX's step from the same weights, the network in
    float64: the loss, the parameters, BatchNorm statistics and EMA after
    the update within ``STEP_STATE_TOL``, except AdamW entries whose
    gradient is below the gradient tolerance (they may take the other
    sign: few, each within 2 lr); the stage marks in order."""
    v, images, batch, hyp, want = network
    model = _port_model(v).double()
    opt = toptim.build_optimizer(model, copy.copy(hyp), 10, 100)
    state = tstep.init_train_state(model, opt, device="cpu")
    marks = []
    dn = {k: _t(a) for k, a in want["dn"].items()}
    step = tstep.make_train_step(model, opt, hyp, mark=marks.append, dn_fn=lambda b, s: dn)
    metrics = step(state, _t(images).double(), {k: _t(a) for k, a in batch.items()})
    assert marks == ["forward", "matching", "loss", "backward", "clip_optimizer_ema", "end"]
    assert state.step == 1 and set(metrics) == set(want["items"]) | {"loss"}
    np.testing.assert_allclose(metrics["loss"].item(), want["step_loss"], rtol=STEP_LOSS_RTOL)
    lr = toptim.lr_schedule(hyp, 10)(0)
    got_state = {k: t.float() for k, t in model.state_dict().items()}
    got_ema = {k: t.float() for k, t in state.ema.items()}
    for what, got in (("state", got_state), ("ema", got_ema)):
        for n, wt in want[what].items():
            diff = (got[n] - wt).abs()
            bad = diff > STEP_STATE_TOL
            if not bad.any():
                continue
            gs = want["grads"][n]
            tiny = gs.abs() < STEP_GRAD_TOL * gs.abs().max()
            assert not (bad & ~tiny).any(), (what, n, float(diff.max()))
            assert int(bad.sum()) <= max(ADAM_SIGN_SHARE * bad.numel(), 1), (what, n)
            assert float(diff.max()) <= 2 * lr, (what, n, float(diff.max()))


def test_optimizer_groups_match_jax():
    """Every floor_rtdetr parameter lands in the group JAX's ``label_tree``
    gives its leaf: LayerNorm scales "norm" (not decayed), every bias (the
    (8, 32) attention biases too) "bias", Dense, attention and Embed kernels
    "weight"."""
    params, _ = checkpoint_variables(load_checkpoint(RTDETR_CKPT))
    want = {}
    for path, label in jax.tree_util.tree_flatten_with_path(joptim.label_tree(params))[0]:
        keys = tuple(p.key for p in path)
        leaf = params
        for k in keys:
            leaf = leaf[k]
        nested = leaf
        for k in reversed(keys):
            nested = {k: nested}
        (key,) = from_jax_variables(nested, {}).keys()
        want[key] = label
    model = RTDETRDetectionModel(load_checkpoint(RTDETR_CKPT)["model_yaml"])
    scales = toptim.layer_norm_scales(model)
    got = {n: toptim.param_group_label(n, n in scales) for n, _ in model.named_parameters()}
    assert got == want
    assert got["model.22.dec_layer0.norm1.weight"] == "norm"
    assert got["model.22.dec_layer0.self_attn.query.bias"] == "bias"
    assert got["model.22.denoising_class_embed.embedding"] == "weight"
    opt = toptim.build_optimizer(model, _hyp("AdamW"), 10, 100)
    sizes = {g["name"]: sum(p.numel() for p in g["params"]) for g in opt.opt.param_groups}
    assert sizes["norm"] == sum(p.numel() for n, p in model.named_parameters()
                                if want[n] == "norm")
