"""SAM's network in the PyTorch port against the JAX package, on the CPU:
each module on the same numpy inputs with the JAX weights carried over
(float32 on both sides, within 1e-5 of each output's largest entry), sam_b
at full width at img_size 64, its parameter count at 1024, the transposed
conv's kernel flip, and an official segment-anything state dict (the
synthetic one of ``tests/test_sam_convert.py``) loaded strictly."""
from collections import OrderedDict
from typing import Any, Mapping, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_sam_convert import (DEPTH, DHEADS, ED, GLOBAL, HEADS, IMG, IOUH, MLPD, OC, PATCH,
                                    TD, WS, build_tiny_flax, make_state)
from yolo_contour_regression_tpu.models.sam import Sam as JaxSam
from yolo_contour_regression_tpu.models.sam import modules as jm
from yolo_contour_regression_tpu.utils.torch_convert import convert_sam_state_dict
from yolo_contour_regression_tpu_torch.models.sam import Sam, build_sam
from yolo_contour_regression_tpu_torch.models.sam import modules as tm
from yolo_contour_regression_tpu_torch.models.sam.convert import load_official

MODULE_RTOL = 1e-5  # of the largest entry: float32 sums in other orders
EMB_RTOL, LOGIT_RTOL, IOU_ATOL = 1e-4, 1e-3, 1e-4  # sam_b at full width


# --- JAX's variables carried into the port --------------------------------
# The port's keys are the official ones, so this is JAX's own converter
# (``utils/torch_convert.py:_sam_map_key``, ``_sam_map_key_tiny``) run
# backwards: ``jax_path`` maps an official key to its JAX variable and
# ``state_from_jax`` turns JAX's ``Sam.variables`` into the port's state
# dict, so the tests run both packages on the same weights.
#
# official / port key                      JAX (section, collection, path)
# ---------------------------------------  -------------------------------------
# image_encoder.blocks.{i}.attn.qkv.weight encoder params block{i}/attn/qkv/kernel (.T)
# image_encoder.patch_embed.proj.weight    encoder params patch_embed/kernel (OIHW->HWIO)
# image_encoder.neck.{0,2}.weight          encoder params neck{0,1}/kernel
# image_encoder.neck.{1,3}.weight          encoder params neck_ln{0,1}/scale
# prompt_encoder.point_embeddings.{i}.weight prompt params point_embed{i}
# prompt_encoder.mask_downscaling.{0,3,6}  prompt params mask_down{0,1,2}
# mask_decoder.transformer.layers.{l}....  decoder params transformer/layer{l}/...
# mask_decoder.output_upscaling.{0,3}      decoder params upscale{0,1}/kernel: a
#   .weight (in, out, kh, kw)                (kh, kw, in, out) spatially flipped (flax's
#                                            ConvTranspose does not flip its kernel, torch's
#                                            ConvTranspose2d does)
# mask_decoder.output_hypernetworks_mlps.  decoder params hyper{i}/layers{j}
#   {i}.layers.{j}
# image_encoder.layers.{i}.blocks.{j}.     encoder params layer{i}/block{j}/conv1/c/kernel,
#   conv1.{c,bn}.*                           .../bn/{scale,bias}, batch_stats .../bn/{mean,var}

_LN_LEAF = {"weight": "scale", "bias": "bias"}
_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _ln(sec, path, leaf):
    return sec, "params", path + (_LN_LEAF[leaf],), "raw"


def _dense(sec, path, leaf):
    return (sec, "params", path + ("kernel",), "dense") if leaf == "weight" else (
        sec, "params", path + ("bias",), "raw")


def _conv(sec, path, leaf, kind="conv"):
    return (sec, "params", path + ("kernel",), kind) if leaf == "weight" else (
        sec, "params", path + ("bias",), "raw")


def _convbn(path, cb, leaf, key):
    if cb == "c" and leaf == "weight":
        return "encoder", "params", path + ("c", "kernel"), "conv"
    if cb == "bn" and leaf in _BN_LEAF:
        coll, name = _BN_LEAF[leaf]
        return "encoder", coll, path + ("bn", name), "raw"
    raise KeyError(key)


def _tinyvit_path(key: str, rest):
    if rest[0] == "patch_embed" and rest[1] == "seq":
        return _convbn(("patch_embed", f"seq{rest[2]}"), rest[3], rest[4], key)
    base = (f"layer{rest[1]}",)
    sub = rest[2:]
    if sub[0] == "downsample":
        return _convbn(base + ("downsample", sub[1]), sub[2], sub[3], key)
    base += (f"block{sub[1]}",)
    inner, leaf = sub[2:-1], sub[-1]
    if inner[0] in ("conv1", "conv2", "conv3", "local_conv"):
        return _convbn(base + (inner[0],), inner[1], leaf, key)
    if inner == ["attn", "norm"]:
        return _ln("encoder", base + ("attn", "norm"), leaf)
    if inner == ["attn"] and leaf == "attention_biases":
        return "encoder", "params", base + ("attn", leaf), "raw"
    if inner[0] == "attn":
        return _dense("encoder", base + ("attn", inner[1]), leaf)
    if inner == ["mlp", "norm"]:
        return _ln("encoder", base + ("mlp_norm",), leaf)
    if inner[0] == "mlp":
        return _dense("encoder", base + (f"mlp_{inner[1]}",), leaf)
    raise KeyError(key)


def _encoder_path(key: str, rest):
    if rest == ["pos_embed"]:
        return "encoder", "params", ("pos_embed",), "raw"
    if rest[:2] == ["patch_embed", "proj"]:
        return _conv("encoder", ("patch_embed",), rest[2])
    if rest[0] == "blocks":
        base, sub, leaf = (f"block{rest[1]}",), rest[2:-1], rest[-1]
        if sub[0] in ("norm1", "norm2"):
            return _ln("encoder", base + (sub[0],), leaf)
        if sub == ["attn"]:
            return "encoder", "params", base + ("attn", leaf), "raw"
        if sub[0] == "attn":
            return _dense("encoder", base + tuple(sub), leaf)
        return _dense("encoder", base + ("mlp", sub[1]), leaf)
    if rest[0] == "neck":
        idx, leaf = rest[1], rest[2]
        if idx in ("0", "2"):
            return _conv("encoder", ("neck0" if idx == "0" else "neck1",), leaf)
        return _ln("encoder", ("neck_ln0" if idx == "1" else "neck_ln1",), leaf)
    if rest[0] in ("patch_embed", "layers"):
        return _tinyvit_path(key, rest)
    raise KeyError(key)


def _prompt_path(key: str, rest):
    if rest[0] == "pe_layer":
        return "prompt", "params", ("pe_layer", "positional_encoding_gaussian_matrix"), "raw"
    if rest[0] == "point_embeddings":
        return "prompt", "params", (f"point_embed{rest[1]}",), "raw"
    if rest[0] in ("not_a_point_embed", "no_mask_embed"):
        return "prompt", "params", (rest[0],), "raw"
    if rest[0] == "mask_downscaling":
        idx, leaf = rest[1], rest[2]
        conv = {"0": "mask_down0", "3": "mask_down1", "6": "mask_down2"}
        if idx in conv:
            return _conv("prompt", (conv[idx],), leaf)
        return _ln("prompt", ("mask_ln0" if idx == "1" else "mask_ln1",), leaf)
    raise KeyError(key)


def _decoder_path(key: str, rest):
    if rest[0] in ("iou_token", "mask_tokens"):
        return "decoder", "params", (rest[0],), "raw"
    if rest[0] == "transformer":
        if rest[1] == "norm_final_attn":
            return _ln("decoder", ("transformer", "norm_final"), rest[-1])
        if rest[1] == "layers":
            base, sub = ("transformer", f"layer{rest[2]}"), rest[3:-1]
        elif rest[1] == "final_attn_token_to_image":
            base, sub = ("transformer", "final_attn"), rest[2:-1]
        else:
            raise KeyError(key)
        if sub[0].startswith("norm"):
            return _ln("decoder", base + (sub[0],), rest[-1])
        return _dense("decoder", base + tuple(sub), rest[-1])
    if rest[0] == "output_upscaling":
        idx, leaf = rest[1], rest[2]
        if idx in ("0", "3"):
            return _conv("decoder", ("upscale0" if idx == "0" else "upscale1",), leaf, "convT")
        return _ln("decoder", ("upscale_ln",), leaf)
    if rest[0] == "output_hypernetworks_mlps":
        return _dense("decoder", (f"hyper{rest[1]}", f"layers{rest[3]}"), rest[-1])
    if rest[0] == "iou_prediction_head":
        return _dense("decoder", ("iou_head", f"layers{rest[2]}"), rest[-1])
    raise KeyError(key)


def jax_path(key: str) -> Tuple[str, str, Tuple[str, ...], str]:
    """An official (= port) key -> (section, collection, path, kind) of its
    JAX variable; ``kind`` is how the array changes on the way to JAX:
    ``raw`` (as it is), ``dense`` (transposed), ``conv`` (OIHW -> HWIO) or
    ``convT`` ((in, out, kh, kw) -> (kh, kw, in, out), spatially flipped).
    Raises KeyError for a key the map does not know."""
    toks = key.split(".")
    sec, rest = toks[0], toks[1:]
    fn = {"image_encoder": _encoder_path, "prompt_encoder": _prompt_path,
          "mask_decoder": _decoder_path}.get(sec)
    if fn is None or not rest:
        raise KeyError(key)
    try:
        return fn(key, rest)
    except (IndexError, ValueError):
        raise KeyError(key) from None


def from_jax_array(arr: np.ndarray, kind: str) -> np.ndarray:
    """A JAX variable's array in the port's layout (``jax_path``'s
    ``kind``: the transpose, or the transpose and flip, undone)."""
    if kind == "dense":
        return arr.T
    if kind == "conv":
        return arr.transpose(3, 2, 0, 1)
    if kind == "convT":
        return arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return arr


def _get(tree, path):
    for tok in path:
        tree = tree[tok]
    return tree


def state_from_jax(model: torch.nn.Module, variables: Mapping[str, Any]
                   ) -> "OrderedDict[str, torch.Tensor]":
    """The JAX ``Sam.variables`` (numpy or JAX arrays) -> ``model``'s state
    dict (its ``num_batches_tracked`` counters kept). Raises unless every
    key of the model finds its JAX leaf with the same shape and every JAX
    leaf is used."""
    sd = OrderedDict()
    used = set()
    own = model.state_dict()
    for key in own:
        if key.endswith("num_batches_tracked"):
            sd[key] = own[key].clone()
            continue
        sec, coll, path, kind = jax_path(key)
        arr = from_jax_array(np.asarray(_get(variables[sec][coll], path), np.float32), kind)
        if tuple(arr.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: JAX {sec}/{coll}/{'/'.join(path)} has shape {arr.shape}, "
                             f"the port {tuple(own[key].shape)}")
        sd[key] = torch.tensor(np.ascontiguousarray(arr))
        used.add((sec, coll) + path)
    leaves = set()

    def scan(tree, pre):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                scan(v, pre + (k,))
            else:
                leaves.add(pre + (k,))

    for sec, colls in variables.items():
        scan(colls, (sec,))
    unused = sorted("/".join(p) for p in leaves - used)
    if unused:
        raise KeyError(f"JAX leaves without a port key: {unused[:5]}")
    return sd


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs (the suite's workers share
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomized(tree, rng, noise: float = 0.2):
    """Random variables of a JAX variable tree's shapes (a tree of arrays or
    of ``jax.eval_shape`` structs: no init is run): kernels normal with std
    ``1 / sqrt(fan_in)``, LayerNorm and BatchNorm scales ``1 + noise``,
    BatchNorm variances in [0.5, 1.5], every other leaf (biases, relative
    positions, embeddings) normal with std ``noise``."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomized(dict(v), rng, noise)
            continue
        shape = tuple(v.shape)
        if k == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif k == "kernel":
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif k == "scale":
            a = 1 + rng.normal(0, noise, shape)
        else:
            a = rng.normal(0, noise, shape)
        out[k] = a.astype(np.float32)
    return out


def shapes(init, *args):
    return jax.eval_shape(init, jax.random.PRNGKey(0), *args)


def carry(module: torch.nn.Module, prefix: str, strip: int, variables: dict):
    """Load a JAX submodule's variables ({collection: tree}) into the port
    module whose official keys start with ``prefix``: each key's JAX path
    (``jax_path``) without its first ``strip`` entries."""
    sd = module.state_dict()
    for key in sd:
        if key.endswith("num_batches_tracked"):
            continue
        _, coll, path, kind = jax_path(prefix + key)
        node = variables[coll]
        for tok in path[strip:]:
            node = node[tok]
        sd[key] = torch.tensor(np.ascontiguousarray(from_jax_array(np.asarray(node), kind)))
    module.load_state_dict(sd)
    return module.eval()


def close(got, want, rtol=MODULE_RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-12), (err, np.abs(want).max())
    return err


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("hw,ws", [((5, 7), 3), ((4, 4), 14), ((5, 5), 0)],
                         ids=["windowed_padded", "one_padded_window", "global"])
def test_vit_block(hw, ws):
    """A ViT block: windows padded bottom and right then cropped (5x7 in
    windows of 3; the 4x4 grid of img_size 64 in one window of 14) and a
    global block, each with decomposed relative positions."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, *hw, 16)).astype(np.float32)
    blk = jm.ViTBlock(num_heads=2, window_size=ws)
    v = randomized(shapes(blk.init, jnp.asarray(x)), rng)
    want = blk.apply(v, jnp.asarray(x))
    port = carry(tm.Block(16, 2, window_size=ws, input_size=hw), "image_encoder.blocks.0.",
                 1, v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    close(got, want)
    if ws == 0:  # the attention alone, on the block's weights
        av = {"params": v["params"]["attn"]}
        attn = carry(tm.Attention(16, 2, True, hw), "image_encoder.blocks.0.attn.", 2, av)
        with torch.no_grad():
            close(attn(torch.from_numpy(x)), jm.Attention(2, True).apply(av, jnp.asarray(x)))


def test_image_encoder():
    """The ViT encoder (patch embed, pos_embed, a windowed block whose 5x5
    grid pads to windows of 3, a global block, the neck)."""
    rng = np.random.default_rng(1)
    kw = dict(img_size=80, patch_size=16, embed_dim=16, depth=2, num_heads=2, out_chans=8,
              window_size=3, global_attn_indexes=(1,))
    x = rng.normal(0, 1, (2, 80, 80, 3)).astype(np.float32)
    enc = jm.ImageEncoderViT(**kw)
    v = randomized(shapes(enc.init, jnp.asarray(x)), rng)
    port = carry(tm.ImageEncoderViT(**kw), "image_encoder.", 0, v)
    with torch.no_grad():
        got = port(nchw(x)).permute(0, 2, 3, 1)
    close(got, enc.apply(v, jnp.asarray(x)))


PTS = np.array([[[9.0, 21.0], [25.0, 6.0], [3.0, 3.0], [30.0, 31.0], [0.0, 0.0]],
                [[1.0, 2.0], [20.0, 7.0], [4.0, 30.0], [11.0, 11.0], [5.0, 8.0]]], np.float32)
LABS = np.array([[1, 0, 2, 3, -1], [0, 1, 1, -1, 2]], np.int32)


@pytest.mark.parametrize("with_mask", [False, True], ids=["no_mask", "mask"])
def test_prompt_encoder(with_mask):
    """Points of every label (1, 0, the box corners 2 and 3, the -1 pad),
    with the no-mask embedding or the mask-downscaling CNN."""
    rng = np.random.default_rng(2)
    pe = jm.PromptEncoder(embed_dim=16, image_embedding_size=(2, 2), input_image_size=(32, 32))
    dmask = rng.normal(0, 1, (2, 8, 8, 1)).astype(np.float32)
    v = randomized(shapes(pe.init, jnp.asarray(PTS), jnp.asarray(LABS), jnp.asarray(dmask)),
                   rng)
    want = pe.apply(v, jnp.asarray(PTS), jnp.asarray(LABS),
                    jnp.asarray(dmask) if with_mask else None)
    port = carry(tm.PromptEncoder(16, (2, 2), (32, 32)), "prompt_encoder.", 0, v)
    with torch.no_grad():
        got = port(torch.from_numpy(PTS), torch.from_numpy(LABS).long(),
                   nchw(dmask) if with_mask else None)
    close(got[0], want[0])
    close(got[1].permute(0, 2, 3, 1), want[1])
    close(got[2].permute(0, 2, 3, 1), want[2])


def _decoder_inputs(rng, b=2, hw=3, c=16, t=5):
    emb = rng.normal(0, 1, (b, hw, hw, c)).astype(np.float32)
    pe = rng.normal(0, 1, (1, hw, hw, c)).astype(np.float32)
    sparse = rng.normal(0, 1, (b, t, c)).astype(np.float32)
    dense = rng.normal(0, 1, (b, hw, hw, c)).astype(np.float32)
    return emb, pe, sparse, dense


def test_two_way_transformer():
    """Two two-way blocks (the first one's self-attention without its
    residual), the final attention, downsample rate 2."""
    rng = np.random.default_rng(3)
    emb, pe, tokens, _ = _decoder_inputs(rng)
    tr = jm.TwoWayTransformer(num_heads=2, mlp_dim=32)
    v = randomized(shapes(tr.init, jnp.asarray(emb), jnp.asarray(pe), jnp.asarray(tokens)),
                   rng)
    q, k = jax.jit(tr.apply)(v, jnp.asarray(emb), jnp.asarray(pe), jnp.asarray(tokens))
    port = carry(tm.TwoWayTransformer(2, 16, 2, 32), "mask_decoder.transformer.", 1, v)
    with torch.no_grad():
        gq, gk = port(nchw(emb), nchw(pe), torch.from_numpy(tokens))
    close(gq, q)
    close(gk, k)


@pytest.mark.parametrize("multimask", [True, False], ids=["multimask", "single"])
def test_mask_decoder(multimask):
    """The decoder: tokens, the two transposed convs, the hypernetworks and
    the IoU head, with three masks or one."""
    rng = np.random.default_rng(4)
    emb, pe, sparse, dense = _decoder_inputs(rng)
    dec = jm.MaskDecoder(transformer_dim=16, num_heads=2, mlp_dim=32, iou_head_hidden=8)
    args = [jnp.asarray(a) for a in (emb, pe, sparse, dense)]
    v = randomized(shapes(dec.init, *args), rng)
    masks, iou = jax.jit(dec.apply, static_argnames="multimask_output")(
        v, *args, multimask_output=multimask)
    port = carry(tm.MaskDecoder(16, num_heads=2, mlp_dim=32, iou_head_hidden_dim=8),
                 "mask_decoder.", 0, v)
    with torch.no_grad():
        gm, gi = port(nchw(emb), nchw(pe), torch.from_numpy(sparse), nchw(dense), multimask)
    assert gm.shape[1] == (3 if multimask else 1)
    close(gm, masks)
    close(gi, iou)


def test_conv_transpose_flip_pinned():
    """flax's ConvTranspose does not flip its kernel, torch's ConvTranspose2d
    does: the port's kernel is JAX's transposed and flipped in both spatial
    axes (an asymmetric kernel pins which)."""
    import flax.linen as fnn

    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (1, 3, 4, 2)).astype(np.float32)
    ct = fnn.ConvTranspose(3, (2, 2), strides=(2, 2))
    v = ct.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.arange(2 * 2 * 2 * 3, dtype=np.float32).reshape(2, 2, 2, 3) * 0.1 - 1.0
    bias = np.array([0.1, -0.2, 0.3], np.float32)
    want = ct.apply({"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
                    jnp.asarray(x))
    port = torch.nn.ConvTranspose2d(2, 3, 2, 2)
    w = from_jax_array(kernel, "convT")
    assert w.shape == (2, 3, 2, 2)
    for a in range(2):
        for b in range(2):
            np.testing.assert_array_equal(w[:, :, a, b], kernel[1 - a, 1 - b])
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
        port.bias.copy_(torch.from_numpy(bias))
        got = port(nchw(x)).permute(0, 2, 3, 1)
    close(got, want)
    # without the flip the outputs differ
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))))
        assert np.abs(port(nchw(x)).permute(0, 2, 3, 1).numpy() - np.asarray(want)).max() > 0.1


@pytest.fixture(scope="module")
def sam_b64():
    """sam_b at full width at img_size 64: random variables of JAX's shapes
    (relative positions nonzero), carried into the port."""
    js = JaxSam("sam_b", img_size=64)
    rng = np.random.default_rng(6)
    js.variables = randomized(jax.eval_shape(js.init, jax.random.PRNGKey(0)), rng, noise=0.05)
    port = Sam("sam_b", img_size=64, seed=None)
    port.load_state_dict(state_from_jax(port, js.variables))
    return js, port.eval()


def test_sam_b_full_width_at_64(sam_b64):
    """Embeddings within 1e-4 of their largest, low-res logits within 1e-3,
    IoU within 1e-4, for points with the pad point, a box, and a mask
    prompt, three masks and one."""
    js, port = sam_b64
    rng = np.random.default_rng(7)
    img = rng.normal(0, 1, (1, 64, 64, 3)).astype(np.float32)
    emb = jax.jit(js.encode_image)(js.variables, jnp.asarray(img))
    decode = jax.jit(js.decode_prompts, static_argnums=(5,))
    with torch.no_grad():
        temb = port.encode_image(nchw(img))
    close(temb.permute(0, 2, 3, 1), emb, EMB_RTOL)
    mask = rng.normal(0, 2, (1, 16, 16, 1)).astype(np.float32)
    cases = [(np.array([[[20.0, 30.0], [0.0, 0.0]]], np.float32), np.array([[1, -1]]), None),
             (np.array([[[5.0, 6.0], [50.0, 40.0]]], np.float32), np.array([[2, 3]]), None),
             (np.array([[[20.0, 30.0], [40.0, 8.0], [0.0, 0.0]]], np.float32),
              np.array([[1, 0, -1]]), mask)]
    for pts, labs, m in cases:
        for multimask in (True, False):
            lw, iw = decode(js.variables, emb, jnp.asarray(pts), jnp.asarray(labs, jnp.int32),
                            None if m is None else jnp.asarray(m), multimask)
            with torch.no_grad():
                lg, ig = port.decode_prompts(temb, torch.from_numpy(pts),
                                             torch.from_numpy(labs), None if m is None
                                             else nchw(m), multimask)
            close(lg, lw, LOGIT_RTOL)
            np.testing.assert_allclose(ig.numpy(), np.asarray(iw), atol=IOU_ATOL)


@pytest.mark.parametrize("variant", ["sam_b", "mobile_sam"])
def test_parameter_count_at_1024(variant):
    """The port's sam_b and mobile_sam at 1024 have JAX's entries (its
    ``Sam.init`` traced by ``jax.eval_shape``: nothing computed), every
    variable of the same shape."""
    js = JaxSam(variant, img_size=1024)
    shapes = jax.eval_shape(js.init, jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    port = build_sam(variant, 1024, seed=None)
    assert port.num_params == n_jax
    for key, t in port.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        sec, coll, path, kind = jax_path(key)
        node = shapes[sec][coll]
        for tok in path:
            node = node[tok]
        assert from_jax_array(np.zeros(node.shape, np.float32), kind).shape == tuple(t.shape), key
    if variant == "sam_b":
        assert n_jax == 93_735_728


class TinySam(torch.nn.Module):
    """The port's modules at ``tests/test_sam_convert.py``'s tiny geometry,
    under the official names."""

    def __init__(self):
        super().__init__()
        g = IMG // PATCH
        self.image_encoder = tm.ImageEncoderViT(IMG, PATCH, ED, DEPTH, HEADS, OC, WS, GLOBAL)
        self.prompt_encoder = tm.PromptEncoder(OC, (g, g), (IMG, IMG))
        self.mask_decoder = tm.MaskDecoder(TD, num_heads=DHEADS, mlp_dim=MLPD,
                                           iou_head_hidden_dim=IOUH)


def _tiny_jax_variables(sd):
    """JAX's variables of the tiny geometry from ``sd`` (the targets' shapes
    by ``jax.eval_shape``; strict conversion fills every leaf)."""
    enc, pe, dec = build_tiny_flax()
    g = IMG // PATCH
    pts, labs = jnp.zeros((1, 2, 2)), jnp.zeros((1, 2), jnp.int32)
    variables = {"encoder": shapes(enc.init, jnp.zeros((1, IMG, IMG, 3))),
                 "prompt": shapes(pe.init, pts, labs, jnp.zeros((1, 4 * g, 4 * g, 1)))}
    sp, dn, ipe = jax.eval_shape(pe.apply, variables["prompt"], pts, labs)
    variables["decoder"] = shapes(dec.init, jnp.zeros((1, g, g, TD)), ipe, sp, dn)
    new_vars, _ = convert_sam_state_dict(sd, variables, strict=True)
    return (enc, pe, dec), new_vars


def test_official_state_dict():
    """An official-layout state dict loads into the port with strict=True and
    gives the outputs JAX gives through ``convert_sam_state_dict``; JAX's
    converted variables carried back to the port are the official dict
    exactly; a partial dict raises."""
    rng = np.random.default_rng(8)
    sd = make_state(rng)
    port = TinySam()
    report = load_official(port, sd)
    assert not report["missing"] and not report["unexpected"]
    (enc, pe, dec), jv = _tiny_jax_variables(sd)
    back = state_from_jax(port, jv)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)

    img = rng.normal(0, 1, (1, IMG, IMG, 3)).astype(np.float32)
    pts = np.array([[[9.0, 21.0], [25.0, 6.0], [0.0, 0.0]]], np.float32)
    labs = np.array([[1, 2, -1]], np.int32)
    dmask = rng.normal(0, 1, (1, 8, 8, 1)).astype(np.float32)
    emb = jax.jit(enc.apply)(jv["encoder"], jnp.asarray(img))
    sp, dn, ipe = jax.jit(pe.apply)(jv["prompt"], jnp.asarray(pts), jnp.asarray(labs),
                                    jnp.asarray(dmask))
    masks, iou = jax.jit(dec.apply)(jv["decoder"], emb, ipe, sp, dn)
    with torch.no_grad():
        temb = port.image_encoder(nchw(img))
        tsp, tdn, tipe = port.prompt_encoder(torch.from_numpy(pts), torch.from_numpy(labs).long(),
                                             nchw(dmask))
        tm_, ti = port.mask_decoder(temb, tipe, tsp, tdn)
    close(temb.permute(0, 2, 3, 1), emb)
    close(tm_, masks)
    close(ti, iou)

    partial = dict(sd)
    partial.pop("mask_decoder.iou_token.weight")
    with pytest.raises(RuntimeError, match="iou_token"):
        load_official(TinySam(), partial)
