"""The PyTorch port's RT-DETR modules against the JAX package on the CPU:
the bilinear sampling, ``MSDeformAttn`` (points outside the maps and on
their border), the deformable decoder layer with and without an attention
mask, ``RTDETRDecoder`` in eval and train form with a dn dict (a narrow
decoder, hd 64, 4 heads, 2 layers, at imgsz 64: the nq cap and tied
top-k scores), its gradient chain; and at full width the yolov8n-rtdetr
config and its 9,483,578 parameters, the floor_rtdetr weights carried to
the port and back (the empty ``detect`` subtree kept), the init priors,
and the deploy fuse against the unfused model and JAX ``fuse_variables``.
Inputs and weights are made from seeds with numpy and handed to both
packages."""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_port_modules import _carry, _randomize
from tests.torch_port_jax_init import compiled_init
from yolo_contour_regression_tpu.nn import fuse as jfuse
from yolo_contour_regression_tpu.nn.modules import head as jhead
from yolo_contour_regression_tpu.nn.modules import transformer as jtr
from yolo_contour_regression_tpu.nn.tasks import build_model as jbuild_model
from yolo_contour_regression_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.nn.modules import head as thead
from yolo_contour_regression_tpu_torch.nn.modules import transformer as ttr
from yolo_contour_regression_tpu_torch.nn.tasks import (YOLOV8_RTDETR, RTDETRDetectionModel,
                                                        build_model, init_weights, yaml_model_load)
from yolo_contour_regression_tpu_torch.utils.checkpoint import (
    checkpoint_variables, from_jax_variables, load_checkpoint, load_jax_variables,
    to_jax_variables)

RTDETR_CKPT = "runs/floor_rtdetr/best.ckpt"
# single modules: f32 sums in other orders than XLA's
MODULE_ATOL = 1e-5
# the decoder head: projections, 2 decoder layers, sigmoid boxes and scores
DECODER_ATOL = 1e-3
# fused against unfused (tests/test_fuse.py's), and each fused conv against
# JAX fuse_variables (the same f32 algebra, a few ulps)
FUSE_TOL, PARAM_TOL = 1e-3, 1e-5
# yolov8n-rtdetr at nc 2 (JAX's build_model(...).init(imgsz=64)), its head
RTDETR_PARAMS, RTDETR_HEAD_PARAMS = 9_483_578, 7_224_042
# the narrow decoder: levels of imgsz 64 at strides 8, 16, 32 (V = 84)
D, NH, NL, NP, DFFN = 64, 4, 3, 4, 128
SHAPES_64 = ((8, 8), (4, 4), (2, 2))
CH = (16, 32, 64)
NC = 3


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _init(jmod, *args, **kw):
    """Random variables of a flax module from its shapes alone."""
    return dict(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args, **kw)))


def _tokens(seed, B, shapes, d=D):
    return _rng(seed).normal(0, 1, (B, sum(h * w for h, w in shapes), d)).astype(np.float32)


# --- sampling and attention -------------------------------------------------

def test_bilinear_grid_sample_matches_jax_at_the_border():
    """``F.grid_sample`` against JAX's gather + lerp on points at pixel
    centres, on the map's edges (x, y = -1 and 1), half a pixel beyond them,
    and far outside: outside corners contribute 0 on both sides."""
    H, W, C = 5, 7, 3
    value = _rng(0).normal(0, 1, (2, H, W, C)).astype(np.float32)
    edge = [-1.0, 1.0, -1 - 1 / W, 1 + 1 / W, -1 + 1 / W, 1 - 1 / W, 0.0, -3.0, 2.5]
    gx, gy = np.meshgrid(edge, edge[:-2] + [-1 - 1 / H, 1 + 1 / H])
    grid = np.stack([gx.ravel(), gy.ravel()], -1).reshape(1, -1, 3, 2)
    grid = np.concatenate([grid, _rng(1).uniform(-1.3, 1.3, grid.shape)]).astype(np.float32)
    want = np.asarray(jtr.bilinear_grid_sample(jnp.asarray(value), jnp.asarray(grid)))
    got = ttr.bilinear_grid_sample(_t(value).permute(0, 3, 1, 2), _t(grid))  # (N, C, Q, P)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=MODULE_ATOL)
    assert (want == 0).all(-1).any()  # some points sample nothing


@pytest.mark.parametrize("refer_dim", [2, 4])
def test_msdeformattn_matches_jax(refer_dim):
    """Random weights (the offsets' kernel no longer zero) over three
    non-square levels; reference points and boxes reach past the maps, so
    sampling points fall outside them and across their border."""
    shapes = ((8, 8), (4, 6), (2, 3))
    B, Q = 2, 12
    rng = _rng(2)
    query = rng.normal(0, 1, (B, Q, D)).astype(np.float32)
    value = _tokens(3, B, shapes)
    xy = rng.uniform(-0.2, 1.2, (B, Q, NL, 2))
    xy[0, :4] = np.array([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [0.5, 0.0]])[:, None]  # corners
    refer = xy if refer_dim == 2 else np.concatenate([xy, rng.uniform(0.05, 0.9, (B, Q, NL, 2))],
                                                     -1)
    refer = refer.astype(np.float32)
    jm = jtr.MSDeformAttn(D, NL, NH, NP)
    args = (jnp.asarray(query), jnp.asarray(refer), jnp.asarray(value), shapes)
    jvars = _randomize(_init(jm, *args), 4)
    want = np.asarray(jm.apply(jvars, *args))
    tm = _carry(jvars, ttr.MSDeformAttn(D, NL, NH, NP))
    with torch.no_grad():
        got = tm(_t(query), _t(refer), _t(value), shapes).numpy()
    np.testing.assert_allclose(got, want, atol=MODULE_ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_decoder_layer_matches_jax(masked):
    """Self-attention (flax's, with a block mask: dn rows see their group and
    the matching rows, matching rows see only theirs), deformable
    cross-attention and the FFN, each with its LayerNorm at eps 1e-6."""
    B, Q = 2, 14
    rng = _rng(5)
    embed = rng.normal(0, 1, (B, Q, D)).astype(np.float32)
    refer = np.concatenate([rng.uniform(0.1, 0.9, (B, Q, 2)), rng.uniform(0.05, 0.5, (B, Q, 2))],
                           -1).astype(np.float32)
    pos = rng.normal(0, 1, (B, Q, D)).astype(np.float32)
    feats = _tokens(6, B, SHAPES_64)
    mask = thead.dn_attn_mask(2, 4, Q - 8, "cpu").numpy() if masked else None
    jm = jtr.DeformableTransformerDecoderLayer(D, NH, DFFN, NL, NP)
    jargs = (jnp.asarray(embed), jnp.asarray(refer), jnp.asarray(feats), SHAPES_64)
    jkw = {"attn_mask": None if mask is None else jnp.asarray(mask), "query_pos": jnp.asarray(pos)}
    jvars = _randomize(_init(jm, *jargs, **jkw), 7)
    want = np.asarray(jm.apply(jvars, *jargs, **jkw))
    tm = _carry(jvars, ttr.DeformableTransformerDecoderLayer(D, NH, DFFN, NL, NP))
    with torch.no_grad():
        got = tm(_t(embed), _t(refer), _t(feats), SHAPES_64,
                 attn_mask=None if mask is None else _t(mask), query_pos=_t(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=MODULE_ATOL)
    if masked:  # the mask changed the answer
        with torch.no_grad():
            free = tm(_t(embed), _t(refer), _t(feats), SHAPES_64, query_pos=_t(pos)).numpy()
        assert np.abs(free - got).max() > 1e-3


def test_inverse_sigmoids_differ_at_the_edges():
    """The decoder's ``inverse_sigmoid`` clips to [0, 1] and bounds each
    side by eps; the CDN one clips to [eps, 1 - eps]: each equals JAX's own."""
    from yolo_contour_regression_tpu.models.utils import ops as jops
    from yolo_contour_regression_tpu_torch.models.utils import ops as tops

    x = np.array([-0.5, 0.0, 1e-6, 1e-5, 0.3, 1 - 1e-6, 1.0, 1.5], np.float32)
    for j, t in ((jtr.inverse_sigmoid, ttr.inverse_sigmoid),
                 (jops.inverse_sigmoid, tops.inverse_sigmoid)):
        np.testing.assert_allclose(t(_t(x)).numpy(), np.asarray(j(jnp.asarray(x))), rtol=1e-6)
    assert ttr.inverse_sigmoid(_t(x))[2] != tops.inverse_sigmoid(_t(x))[2]


# --- the decoder head --------------------------------------------------------

def _feats(seed, B=2, tie=False):
    """NHWC maps of imgsz 64 at strides 8, 16, 32; with ``tie`` every map's
    lower half is one constant pixel, so its tokens (and their scores) tie."""
    rng = _rng(seed)
    out = []
    for (h, w), c in zip(SHAPES_64, CH):
        f = rng.normal(0, 1, (B, h, w, c)).astype(np.float32)
        if tie:
            f[:, h // 2:] = f[:, :1, :1]
        out.append(f)
    return out


def _dn(seed, B=2, G=2, N=3):
    rng = _rng(seed)
    labels = rng.integers(0, NC + 2, (B, G, 2, N))  # some beyond nc: clipped
    return {"labels": labels.astype(np.int32),
            "boxes_logit": rng.normal(0, 1.5, (B, G, 2, N, 4)).astype(np.float32)}


def _decoders(nq, seed=8):
    jd = jhead.RTDETRDecoder(nc=NC, hd=D, nq=nq, ndp=NP, nh=NH, ndl=2, d_ffn=DFFN)
    feats = [jnp.asarray(f) for f in _feats(0)]
    dn = {k: jnp.asarray(v) for k, v in _dn(0).items()}
    jvars = _randomize(_init(jd, feats, train=True, dn=dn), seed)
    td = thead.RTDETRDecoder(nc=NC, ch=CH, hd=D, nq=nq, ndp=NP, nh=NH, ndl=2, d_ffn=DFFN)
    return jd, jvars, _carry(jvars, td)


@pytest.mark.parametrize("nq,tie", [(30, False), (30, True), (300, True)])
def test_rtdetr_decoder_eval_matches_jax(nq, tie):
    """Eval output (B, min(nq, 84), 4 + nc): the query selection (ties to
    the lowest index, as ``lax.top_k``; nq 300 capped at the 84 tokens), the
    decoder layers, boxes and sigmoid scores."""
    jd, jvars, td = _decoders(nq)
    feats = _feats(1, tie=tie)
    want = np.asarray(jd.apply(jvars, [jnp.asarray(f) for f in feats], train=False))
    with torch.no_grad():
        got = td([_t(f).permute(0, 3, 1, 2) for f in feats]).numpy()
    assert got.shape == want.shape == (2, min(nq, 84), 4 + NC)
    np.testing.assert_allclose(got, want, atol=DECODER_ATOL)


@pytest.mark.parametrize("with_dn", [False, True])
def test_rtdetr_decoder_train_matches_jax(with_dn):
    """Train output (dec_bboxes, dec_scores, enc_bboxes, enc_scores), with
    the dn groups ahead of the matching queries under the block mask, and
    the BatchNorm of the projections in train mode."""
    jd, jvars, td = _decoders(30)
    feats = _feats(2, tie=True)
    dn = _dn(3) if with_dn else None
    want, _ = jd.apply(jvars, [jnp.asarray(f) for f in feats], train=True,
                       dn=None if dn is None else {k: jnp.asarray(v) for k, v in dn.items()},
                       mutable=["batch_stats"])
    td.train()
    with torch.no_grad():
        got = td([_t(f).permute(0, 3, 1, 2) for f in feats],
                 dn=None if dn is None else {k: _t(v).long() if k == "labels" else _t(v)
                                             for k, v in dn.items()})
    T = 30 + (2 * 2 * 3 if with_dn else 0)
    assert got[0].shape == (2, 2, T, 4) and got[1].shape == (2, 2, T, NC)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=DECODER_ATOL)


def test_decoder_refinement_chain_gradient():
    """As JAX's: layer 1's box keeps a gradient path into layer 0's bbox
    head (the undetached previous refinement), while the query features and
    the refer fed forward are detached."""
    _, _, td = _decoders(30)
    td.train()
    dec_bboxes = td([_t(f).permute(0, 3, 1, 2) for f in _feats(4)])[0]
    (dec_bboxes[1] ** 2).sum().backward()
    assert float(td.dec_bbox_head0.layers0.weight.grad.abs().sum()) > 0
    assert td.enc_output.weight.grad is None  # embed and refer are detached


# --- full width -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_init():
    """JAX's yolov8n-rtdetr at nc 2, ``init(imgsz=64)`` from PRNGKey(0)."""
    jm = jbuild_model("yolov8n-rtdetr.yaml", nc=2)
    return jm, jax.tree_util.tree_map(np.asarray, compiled_init(jm, jax.random.PRNGKey(0), 64))


def test_yaml_model_load_and_parameters_match_jax(jax_init):
    """The config JAX's ``yaml_model_load`` reads for yolov8n-rtdetr (its
    ``yaml_file`` aside) and at every scale letter; 9,483,578 parameters at
    nc 2, 7,224,042 in the head, JAX's count; strides (8, 16, 32)."""
    for name in ("yolov8n-rtdetr.yaml", "yolov8s-rtdetr.yaml", "yolov8-rtdetr.yaml"):
        want = jax_yaml_model_load(name)
        want.pop("yaml_file")
        assert yaml_model_load(name) == want, name
    _, jv = jax_init
    model = build_model(yaml_model_load("yolov8n-rtdetr.yaml"), nc=2)
    assert isinstance(model, RTDETRDetectionModel) and model.strides == (8, 16, 32)
    assert model.num_params == RTDETR_PARAMS == sum(a.size for a in
                                                    jax.tree_util.tree_leaves(jv["params"]))
    assert sum(p.numel() for p in model.model[-1].parameters()) == RTDETR_HEAD_PARAMS
    assert RTDETRDetectionModel().yaml["head"][-1] == YOLOV8_RTDETR["head"][-1]


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if not v:
                out[prefix + (k,)] = None
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_floor_weights_round_trip_to_jax():
    """floor_rtdetr's trees JAX -> port -> JAX: every leaf back exactly
    (Dense kernels transposed twice, LayerNorm scales, the attention's
    DenseGeneral kernels and biases, the Embed table), and the empty
    ``detect`` subtree of JAX's head init restored; every leaf used once."""
    params, stats = checkpoint_variables(load_checkpoint(RTDETR_CKPT))
    model = load_jax_variables(build_model(load_checkpoint(RTDETR_CKPT)["model_yaml"]),
                               params, stats)
    sd = from_jax_variables(params, stats)
    assert sd["model.22.dec_layer0.self_attn.query.kernel"].shape == (256, 8, 32)
    assert sd["model.22.dec_layer0.self_attn.out.kernel"].shape == (8, 32, 256)
    assert sd["model.22.denoising_class_embed.embedding"].shape == (2, 256)
    assert params["layer22"]["detect"] == {}
    p2, s2 = to_jax_variables(model.state_dict())
    for want, got in ((params, p2), (stats, s2)):
        fw, fg = _flat(want), _flat(got)
        assert set(fw) == set(fg)
        for k in fw:
            if fw[k] is None:
                assert fg[k] is None, k
            else:
                assert fg[k].dtype == np.float32 and np.array_equal(fg[k], fw[k]), k
    assert p2["layer22"]["detect"] == {}


def test_init_weights_takes_jax_priors(jax_init):
    """A fresh port init has JAX's leaves by name and shape (the empty
    ``detect`` included) and JAX's priors: score biases -log(99), zeroed
    last bbox-MLP kernels, the offset grid as the offsets' bias with zero
    kernels, zero attention weights, LayerNorm scale 1 and bias 0; the
    random leaves at JAX's scales (Dense and attention kernels a truncated
    normal of std sqrt(1 / fan_in), the Embed table std sqrt(1 / hd))."""
    _, jv = jax_init
    model = init_weights(build_model(yaml_model_load("yolov8n-rtdetr.yaml"), nc=2),
                         torch.Generator().manual_seed(0))
    tp, tb = to_jax_variables(model.state_dict())
    jp, tpf = _flat(jv["params"]), _flat(tp)
    assert {k: (None if v is None else v.shape) for k, v in jp.items()} == {
        k: (None if v is None else v.shape) for k, v in tpf.items()}
    assert set(_flat(jv["batch_stats"])) == set(_flat(tb))
    head = {k[1:]: v for k, v in tpf.items() if k[0] == "layer22"}
    jhead_ = {k[1:]: v for k, v in jp.items() if k[0] == "layer22"}
    prior = -math.log(99)
    exact = [k for k in head if k[-1] != "kernel" and k[-1] != "embedding" and head[k] is not None]
    for k in exact:  # biases, LayerNorm scales, batch norms: deterministic
        np.testing.assert_allclose(head[k], jhead_[k], atol=1e-6, err_msg=str(k))
    for k in [k for k in head if "score_head" in k[0]]:
        if k[-1] == "bias":
            np.testing.assert_allclose(head[k], prior, rtol=1e-6)
    zero = [k for k in jhead_ if k[-1] == "kernel" and not np.any(jhead_[k])]
    assert len(zero) == 6 + 1 + 12  # bbox MLPs' last layers, offsets and weights a layer
    for k in zero:
        assert not np.any(head[k]), k
    for k, w in jhead_.items():
        if k[-1] in ("kernel", "embedding") and np.any(w):
            g = head[k]
            assert abs(g.std() - w.std()) <= 0.1 * w.std() + 1e-3, (k, g.std(), w.std())
            assert np.abs(g).max() <= max(np.abs(w).max() * 1.5, 1e-6) + 0.05, k


def test_fused_matches_unfused_and_jax_fuse():
    """floor_rtdetr fused (the three ``input_proj{i}`` Conv + BN folded, the
    graph's convs too) against the unfused model: eval outputs within
    ``FUSE_TOL``; each fused leaf against JAX ``fuse_variables`` within
    ``PARAM_TOL``."""
    ckpt = load_checkpoint(RTDETR_CKPT)
    x = _rng(9).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    xt = _t(x).permute(0, 3, 1, 2).contiguous()
    plain = YOLO(RTDETR_CKPT, device="cpu")
    fused = YOLO(RTDETR_CKPT, device="cpu").fuse()
    assert type(fused.model.model[-1].input_proj0).__name__ == "FusedConv"
    with torch.no_grad():
        np.testing.assert_allclose(fused.model(xt).numpy(), plain.model(xt).numpy(),
                                   atol=FUSE_TOL)
    jm = jbuild_model(ckpt["model_yaml"])
    params, stats = checkpoint_variables(ckpt)  # the EMA weights, as the facade loads
    jp, _ = jfuse.fuse_variables(jm, {"params": params, "batch_stats": stats})
    tp, tb = to_jax_variables(fused.model.state_dict())
    want, got = _flat(jax.tree_util.tree_map(np.asarray, jp["params"])), _flat(tp)
    assert tb == {} and set(want) == set(got)
    for k, w in want.items():
        if w is not None:
            np.testing.assert_allclose(got[k], w, atol=PARAM_TOL, err_msg=str(k))
