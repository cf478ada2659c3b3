"""MobileSAM's TinyViT encoder in the PyTorch port against the JAX package,
on the CPU: each module and the encoder with JAX's weights carried over
(float32, within 1e-5 of each output's largest entry), the offset-bias
table, mobile_sam at img_size 64 through ``Predictor``, an official
mobile_sam state dict (the synthetic one of
``tests/test_mobilesam_convert.py``) loaded strictly, and the encoder's
parameter count at 1024."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_mobilesam_convert import DEPTHS, ED, HEADS, IMG, WS, make_state
from tests.test_torch_port_sam import carry, close, nchw, randomized, shapes, state_from_jax
from yolo_contour_regression_tpu.models.sam import Predictor as JaxPredictor
from yolo_contour_regression_tpu.models.sam import Sam as JaxSam
from yolo_contour_regression_tpu.models.sam import tinyvit as jt
from yolo_contour_regression_tpu.utils.torch_convert import convert_sam_state_dict
from yolo_contour_regression_tpu_torch.models.sam import Predictor, Sam
from yolo_contour_regression_tpu_torch.models.sam import tinyvit as tt
from yolo_contour_regression_tpu_torch.models.sam.convert import load_official

IOU_ATOL = 1e-4
THRESH_BAND = 1e-4  # a mask pixel whose logit lies this close to 0 may flip


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


CONV_CASES = {
    # name: (JAX module, port module, official prefix, strip, input shape)
    "conv2d_bn": (lambda: jt.Conv2dBN(12, 3, 2, 1, groups=3),
                  lambda: tt.Conv2dBN(6, 12, 3, 2, 1, groups=3),
                  "image_encoder.layers.0.blocks.0.conv1.", 3, (2, 9, 7, 6)),
    "patch_embed": (lambda: jt.PatchEmbed(8), lambda: tt.PatchEmbed(3, 8),
                    "image_encoder.patch_embed.", 1, (2, 16, 12, 3)),
    "mbconv": (lambda: jt.MBConv(6), lambda: tt.MBConv(6),
               "image_encoder.layers.0.blocks.0.", 2, (2, 5, 6, 6)),
    "merge_s2": (lambda: jt.PatchMerging(10, 2), lambda: tt.PatchMerging(6, 10, 2),
                 "image_encoder.layers.0.downsample.", 2, (2, 7, 8, 6)),
    "merge_s1": (lambda: jt.PatchMerging(10, 1), lambda: tt.PatchMerging(6, 10, 1),
                 "image_encoder.layers.2.downsample.", 2, (2, 7, 8, 6)),
    "block_padded": (lambda: jt.TinyViTBlock(2, 3), lambda: tt.TinyViTBlock(8, 2, 3),
                     "image_encoder.layers.1.blocks.0.", 2, (2, 4, 5, 8)),
    "block_whole": (lambda: jt.TinyViTBlock(2, 4), lambda: tt.TinyViTBlock(8, 2, 4),
                    "image_encoder.layers.1.blocks.0.", 2, (2, 4, 4, 8)),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_tinyvit_module(case):
    """Conv2dBN (grouped, strided), PatchEmbed, MBConv, PatchMerging at
    stride 2 and 1, and TinyViT blocks: one padded into windows of 3, one
    whose input is its window (no partition)."""
    jmod, tmod, prefix, strip, shape = CONV_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, shape).astype(np.float32)
    j = jmod()
    v = randomized(shapes(j.init, jnp.asarray(x)), rng)
    want = jax.jit(j.apply)(v, jnp.asarray(x))
    port = carry(tmod(), prefix, strip, v)
    with torch.no_grad():
        close(_nhwc(port(nchw(x))), want)


def test_tiny_attention():
    """TinyViT attention: pre-norm, fused qkv split per head, the offset
    biases."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (3, 9, 8)).astype(np.float32)
    j = jt.TinyAttention(8, 4, 2, resolution=(3, 3))
    v = randomized(shapes(j.init, jnp.asarray(x)), rng)
    port = carry(tt.TinyAttention(8, 4, 2, resolution=(3, 3)),
                 "image_encoder.layers.1.blocks.0.attn.", 3, v)
    with torch.no_grad():
        close(port(torch.from_numpy(x)), j.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("hw", [(7, 7), (14, 14), (2, 3), (1, 1)])
def test_offset_bias_table(hw):
    """The table of unique |offsets| in first-encounter order, JAX's."""
    np.testing.assert_array_equal(tt.bias_idxs(*hw), jt._bias_idxs(*hw))
    assert tt.bias_idxs(*hw).max() + 1 == jt.num_bias_offsets(*hw)


def test_tinyvit_encoder():
    """The encoder at ``tests/test_mobilesam_convert.py``'s geometry (a
    window of 3 on a 4x4 map: padded)."""
    rng = np.random.default_rng(2)
    kw = dict(img_size=IMG, embed_dims=ED, depths=DEPTHS, num_heads=HEADS, window_sizes=WS,
              out_chans=8)
    x = rng.normal(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    j = jt.TinyViT(**kw)
    v = randomized(shapes(j.init, jnp.asarray(x)), rng)
    port = carry(tt.TinyViT(**kw), "image_encoder.", 0, v)
    with torch.no_grad():
        close(_nhwc(port(nchw(x))), jax.jit(j.apply)(v, jnp.asarray(x)))


class TinyEncoder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.image_encoder = tt.TinyViT(IMG, ED, DEPTHS, HEADS, WS, out_chans=8)


def test_official_state_dict():
    """A mobile_sam-layout dict (with its classifier head and BatchNorm
    counters) loads strictly, less the head; JAX's conversion of it carried
    back is the same dict; the outputs are JAX's."""
    rng = np.random.default_rng(5)
    sd = make_state(rng)
    port = TinyEncoder()
    report = load_official(port, sd)
    assert not report["missing"] and not report["unexpected"]
    j = jt.TinyViT(img_size=IMG, embed_dims=ED, depths=DEPTHS, num_heads=HEADS,
                   window_sizes=WS, out_chans=8)
    img = rng.normal(0, 1, (1, IMG, IMG, 3)).astype(np.float32)
    jv, _ = convert_sam_state_dict(sd, {"encoder": shapes(j.init, jnp.asarray(img))},
                                   strict=True)
    back = state_from_jax(port, jv)
    want = {k: v for k, v in sd.items()
            if not k.startswith(("image_encoder.head.", "image_encoder.norm_head."))}
    assert set(back) == set(want)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    with torch.no_grad():
        close(_nhwc(port.eval().image_encoder(nchw(img))),
              jax.jit(j.apply)(jv["encoder"], jnp.asarray(img)))
    partial = dict(sd)
    partial.pop("image_encoder.layers.2.blocks.0.attn.attention_biases")
    with pytest.raises(RuntimeError, match="attention_biases"):
        load_official(TinyEncoder(), partial)


def test_encoder_parameter_count():
    """tiny_vit_5m at 1024: JAX's entries (parameters and running
    statistics; ``jax.eval_shape``), about 6.1 M."""
    j = jt.TinyViT()
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        shapes(j.init, jax.ShapeDtypeStruct((1, 1024, 1024, 3), jnp.float32))))
    port = tt.TinyViT()
    got = sum(v.numel() for k, v in port.state_dict().items()
              if not k.endswith("num_batches_tracked"))
    assert got == n


def _masks_agree(got, want, logits):
    """Masks equal but at pixels whose full-resolution logit is within
    THRESH_BAND of 0 (counted and named)."""
    diff = got != want
    near = np.abs(logits) <= THRESH_BAND
    assert not (diff & ~near).any(), np.argwhere(diff & ~near)[:5]
    return int(diff.sum())


def test_mobile_sam_predictor_at_64():
    """mobile_sam at img_size 64, random variables of JAX's shapes carried
    over: ``Predictor`` on a 48x56 frame with a point, then a box, against
    JAX's."""
    js = JaxSam("mobile_sam", img_size=64)
    rng = np.random.default_rng(3)
    js.variables = randomized(jax.eval_shape(js.init, jax.random.PRNGKey(0)), rng, noise=0.05)
    port = Sam("mobile_sam", img_size=64, seed=None)
    port.load_state_dict(state_from_jax(port, js.variables))
    jp, tp = JaxPredictor(js), Predictor(port, device="cpu")
    img = rng.integers(0, 256, (48, 56, 3), dtype=np.uint8)
    jp.set_image(img)
    tp.set_image(img)
    for kw in (dict(point_coords=[[28, 24]], point_labels=[1]), dict(box=[5, 5, 40, 40])):
        wm, wi, wl = jp.predict(**kw, return_logits=True)
        gm, gi, gl = tp.predict(**kw, return_logits=True)
        np.testing.assert_allclose(gi, wi, atol=IOU_ATOL)
        close(gl, wl, 1e-3)
        import cv2

        r = min(64 / 48, 64 / 56)
        full = np.stack([cv2.resize(cv2.resize(m, (64, 64))[:round(48 * r), :round(56 * r)],
                                    (56, 48)) for m in wl])
        _masks_agree(gm, wm, full)
