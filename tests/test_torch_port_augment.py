"""The PyTorch port's train data path against the JAX package on the CPU:
``apply_augment`` (mosaic, the warp, the merge, MixUp, the flips, HSV)
against JAX ``augment_batch`` given the draws JAX's key yields, the warp
and HSV alone, ``format_sample_raw``, ``TrainDataset`` and ``TrainLoader``
against JAX ``YOLODataset(device_augment=True)`` and ``DataLoader``, and the
committed decoded train set. Inputs are made from seeds with numpy and
handed to both packages."""
from functools import partial
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import FLOOR_JSON, FLOOR_TRAIN, circle_contour, floor_train_set, rect_contour
from tests.helpers import make_shape_dataset
from yolo_contour_regression_tpu.cfg import get_cfg as jax_get_cfg
from yolo_contour_regression_tpu.data import augment as jaug
from yolo_contour_regression_tpu.data import build as jbuild
from yolo_contour_regression_tpu.data import dataset as jdataset
from yolo_contour_regression_tpu.data import device_augment as jda
from yolo_contour_regression_tpu.data.instance import Instances as JInstances
from yolo_contour_regression_tpu_torch.cfg import get_cfg
from yolo_contour_regression_tpu_torch.data import augment as taug
from yolo_contour_regression_tpu_torch.data import dataset as tdataset
from yolo_contour_regression_tpu_torch.data import device_augment as tda
from yolo_contour_regression_tpu_torch.data.build import TrainLoader, use_device_augment
from yolo_contour_regression_tpu_torch.data.instance import Instances as TInstances


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# images, in uint8 levels: against JAX's float32 warps (the gather
# ``_warp_image``, and ``_warp_image_separable(dtype=float32)``, which JAX's
# own test holds to each other within 5e-3 at S=32; 2.4e-3 apart at S=64)
IMG_ATOL = 5e-3
# against JAX's default, the separable resample in bfloat16 (and the
# division by 255 in bfloat16 in the batch transform): the port, in float32,
# must be no further from it than JAX's own float32 warp is, plus IMG_ATOL.
# That gap is measured in each test; JAX's own test bounds it by 1.5 levels
# at S=32 (an output in [128, 256) rounds to a whole level in bfloat16)
# where the affine is not axis-aligned, JAX inverts it with a float32 LU
# (the port in float64): an ulp of its last row moves the sampled canvas by
# up to some 1e-5 px, which noise tiles turn into up to 0.01 levels; HSV
# gains up to 1.7 pass the warp's differences on
IMG_INV_ATOL = 0.02
LABEL_ATOL = 1e-5  # boxes and contours, normalized
S = 64


def _hyp(**kw):
    base = dict(mosaic=1.0, mixup=0.0, degrees=0.0, translate=0.1, scale=0.5, shear=0.0,
                perspective=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, fliplr=0.0, flipud=0.0)
    base.update(kw)
    return SimpleNamespace(**base)


def jax_draws(key, B, S, hyp):
    """The draws ``augment_batch`` and ``_augment_one`` make from ``key``,
    in the port's ``draw_augment`` layout."""
    k_sel, k_aug, k_mix, k_mixr, k_mixp, k_hsv, k_flr, k_fud = jax.random.split(key, 8)

    def f(n, d=0.0):
        return float(getattr(hyp, n, d) or 0.0)

    def u(k, lo, hi, shape=()):
        return np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi), np.float32)

    per = []
    for k in jax.random.split(k_aug, B):
        k_mosaic, k_center, k_aff = jax.random.split(k, 3)
        kp, ka, ks, ksh1, ksh2, ktx, kty = jax.random.split(k_aff, 7)
        per.append({
            "mosaic": np.asarray(jax.random.uniform(k_mosaic) < f("mosaic", 1.0)),
            "center": u(k_center, 0.5 * S, 1.5 * S, (2,)),
            "perspective": u(kp, -f("perspective"), f("perspective"), (2,)),
            "degrees": u(ka, -f("degrees"), f("degrees")),
            "scale": u(ks, 1 - f("scale", 0.5), 1 + f("scale", 0.5)),
            "shear": np.stack([u(k, -f("shear"), f("shear")) for k in (ksh1, ksh2)]),
            "translate": np.stack([u(k, 0.5 - f("translate", 0.1), 0.5 + f("translate", 0.1))
                                   for k in (ktx, kty)]),
        })
    d = {k: np.stack([p[k] for p in per]) for k in per[0]}
    d["partners"] = np.asarray(jax.random.randint(k_sel, (B, 3), 0, B))
    d["mixup"] = np.asarray(jax.random.uniform(k_mix, (B,)) < f("mixup"))
    d["mixup_ratio"] = np.asarray(jax.random.beta(k_mixr, 32.0, 32.0, (B,)), np.float32)
    d["mixup_partner"] = np.asarray(jax.random.randint(k_mixp, (B,), 0, B))
    d["fliplr"] = np.asarray(jax.random.uniform(k_flr, (B,)) < f("fliplr", 0.5))
    d["flipud"] = np.asarray(jax.random.uniform(k_fud, (B,)) < f("flipud"))
    d["hsv"] = np.stack([u(k, -1.0, 1.0, (3,)) for k in jax.random.split(k_hsv, B)])
    return d


def raw_batch(B, n_pad, seed, tiny=0):
    """A raw loader batch: noise images letterboxed into content of random
    size (pads of 114), up to ``n_pad`` circles and rectangles each, some
    crossing the content's edge, 1 in 5 with a box only; ``tiny`` of them
    2 px across (for the candidates filter)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (B, S, S, 3), dtype=np.uint8)
    out = {"cls": np.zeros((B, n_pad), np.int32), "bboxes": np.zeros((B, n_pad, 4), np.float32),
           "segments": np.zeros((B, n_pad, 360, 2), np.float32),
           "mask_gt": np.zeros((B, n_pad), bool), "content_hw": np.zeros((B, 2), np.float32),
           "pad_tl": np.zeros((B, 2), np.float32)}
    for b in range(B):
        short = int(rng.integers(S // 2, S + 1))
        h, w = (S, short) if rng.random() < 0.5 else (short, S)
        top, left = (S - h) // 2, (S - w) // 2
        img[b, :top], img[b, top + h:] = 114, 114
        img[b, :, :left], img[b, :, left + w:] = 114, 114
        out["content_hw"][b], out["pad_tl"][b] = (h, w), (top, left)
        for i in range(int(rng.integers(1, n_pad + 1))):
            cx, cy = rng.uniform(left - 4, left + w + 4), rng.uniform(top - 4, top + h + 4)
            r = 1.0 if i < tiny else rng.uniform(2, S / 4)
            c = (circle_contour(cx, cy, r) if rng.random() < 0.5
                 else rect_contour(cx - r, cy - r / 2, cx + r, cy + r / 2))
            c = np.clip(c, [left, top], [left + w, top + h])
            lo, hi = c.min(0), c.max(0)
            out["cls"][b, i] = rng.integers(0, 3)
            out["bboxes"][b, i] = np.concatenate([(lo + hi) / 2, hi - lo]) / S
            if rng.random() < 0.8:
                out["segments"][b, i] = c / S
            out["mask_gt"][b, i] = True
    return {"img": img, **out}


def _both(batch, hyp, seed, f32=True):
    """JAX ``augment_batch`` (op by op, its separable warp in float32 unless
    ``f32`` is False) and the port's ``apply_augment`` on JAX's draws."""
    n_out = min(4 * batch["mask_gt"].shape[1], 48)
    key = jax.random.PRNGKey(seed)
    warp = jda._warp_image_separable
    if f32:
        jda._warp_image_separable = partial(warp, dtype=jnp.float32)
    try:
        jo = jda.augment_batch(key, {k: jnp.asarray(v) for k, v in batch.items()}, hyp, S, n_out)
    finally:
        jda._warp_image_separable = warp
    draws = jax_draws(key, batch["img"].shape[0], S, hyp)
    to = tda.apply_augment({k: torch.from_numpy(v) for k, v in batch.items()}, draws, hyp, S,
                           n_out)
    return {k: np.asarray(v) for k, v in jo.items()}, {k: v.numpy() for k, v in to.items()}, draws


AUG_CASES = {
    "plain": (dict(mosaic=0.0), 8, IMG_ATOL),
    "mosaic": (dict(), 8, IMG_ATOL),
    "mosaic_n48": (dict(), 48, IMG_ATOL),
    "mosaic_scale": (dict(scale=0.9, translate=0.3), 8, IMG_ATOL),
    "mixup": (dict(mixup=1.0), 8, IMG_ATOL),
    "flips": (dict(mosaic=0.5, fliplr=0.5, flipud=0.5), 8, IMG_ATOL),
    "affine": (dict(degrees=10.0, shear=3.0, perspective=5e-4), 8, IMG_INV_ATOL),
    "hsv": (dict(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4), 8, IMG_INV_ATOL),
    "all": (dict(mixup=0.5, fliplr=0.5, flipud=0.5, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4), 16,
            IMG_INV_ATOL),
}


@pytest.mark.parametrize("name", sorted(AUG_CASES))
def test_apply_augment_matches_jax(name):
    """The port's batch transform on the draws of JAX's key equals JAX
    ``augment_batch``: labels within ``LABEL_ATOL``, ``cls`` and
    ``mask_gt`` exactly (so the merge keeps the same instances in the same
    order, ties included), images within the case's bound. The batches
    hold letterbox pads, instances crossing the edges, box-only instances
    and 2 px ones that the candidates filter drops; B = 4 draws repeated
    mosaic partners, whose instances tie in area."""
    kw, n_pad, img_atol = AUG_CASES[name]
    seed = sorted(AUG_CASES).index(name)
    batch = raw_batch(4, n_pad, seed, tiny=1)
    jo, to, draws = _both(batch, _hyp(**kw), seed)
    assert to["img"].shape == (4, S, S, 3) and to["mask_gt"].shape == jo["mask_gt"].shape
    np.testing.assert_array_equal(to["mask_gt"], jo["mask_gt"])
    np.testing.assert_array_equal(to["cls"], jo["cls"])
    for k in ("bboxes", "segments"):
        np.testing.assert_allclose(to[k], jo[k], atol=LABEL_ATOL, err_msg=k)
    np.testing.assert_allclose(to["img"] * 255, jo["img"] * 255, atol=img_atol)
    assert jo["mask_gt"].sum() > 0 and to["img"].dtype == np.float32


def test_apply_augment_near_jax_default_bf16():
    """Against JAX's default, the separable resample and the division by
    255 in bfloat16: no further than JAX's float32 transform is from it
    (some 2 levels: a level from the resample, half from the division)."""
    batch = raw_batch(4, 8, 11)
    jo16, to, _ = _both(batch, _hyp(), 11, f32=False)
    jo32, _, _ = _both(batch, _hyp(), 11)
    gap = np.abs(jo32["img"] * 255 - jo16["img"].astype(np.float32) * 255).max()
    err = np.abs(to["img"] * 255 - jo16["img"].astype(np.float32) * 255).max()
    assert 0.5 < gap < 3.0 and err <= gap + IMG_ATOL
    np.testing.assert_array_equal(to["mask_gt"], jo16["mask_gt"])


def test_candidates_filter_and_merge_order():
    """The candidates filter drops the 2 px instances, and the merge puts
    the kept instances first, largest first, the dropped ones after in
    index order: as ``jnp.argsort(-prio)`` orders them."""
    batch = raw_batch(4, 8, 3, tiny=2)
    jo, to, _ = _both(batch, _hyp(), 3)
    np.testing.assert_array_equal(to["mask_gt"], jo["mask_gt"])
    area = to["bboxes"][..., 2] * to["bboxes"][..., 3]
    for b in range(4):
        n = int(to["mask_gt"][b].sum())
        assert to["mask_gt"][b, :n].all() and not to["mask_gt"][b, n:].any()
        assert np.all(np.diff(area[b, :n]) <= 1e-6)
    assert to["mask_gt"].sum() < 4 * (batch["mask_gt"].sum())


@pytest.mark.parametrize("case", ["ties", "all_invalid", "mixed"])
def test_by_priority_is_jax_argsort(case):
    """``_by_priority`` equals ``jnp.argsort(-prio)[:n_out]``: equal areas
    and invalid entries go in index order."""
    rng = np.random.default_rng(0)
    keep = {"ties": np.ones((3, 12), bool), "all_invalid": np.zeros((3, 12), bool),
            "mixed": rng.random((3, 12)) < 0.5}[case]
    area = rng.integers(0, 3, (3, 12)).astype(np.float32)
    prio = np.where(keep, area + 1.0, -1.0)
    want = np.asarray(jnp.argsort(-jnp.asarray(prio), axis=1))[:, :7]
    got = tda._by_priority(torch.from_numpy(keep), torch.from_numpy(area), 7).numpy()
    np.testing.assert_array_equal(got, want)


WARP_CASES = {  # (scale a, translation, mosaic, center (y, x), shear)
    "plain_scale_0.5": (0.5, (8.0, -5.0), False, None, 0.0),
    "plain_scale_1.5": (1.5, (-30.0, -20.0), False, None, 0.0),
    "mosaic_center_low_edge": (0.75, (0.0, 0.0), True, (0.5, 0.5), 0.0),
    "mosaic_center_high_edge": (1.25, (-40.0, -40.0), True, (1.5 - 1e-3, 1.5 - 1e-3), 0.0),
    "mosaic_center_mixed": (1.0, (-32.0, -32.0), True, (0.5, 1.5 - 1e-3), 0.0),
    "mosaic_sheared": (1.1, (-30.0, -25.0), True, (0.9, 1.2), 0.2),
}


@pytest.mark.parametrize("name", sorted(WARP_CASES))
def test_warp_matches_jax_warps(name):
    """The port's gather warp, on JAX's own inverse matrix, equals JAX's
    gather warp ``_warp_image`` (it rounds the canvas coordinates as XLA
    does), and on an axis-aligned matrix lies within ``IMG_ATOL`` of
    ``_warp_image_separable`` in float32, and no further from its bfloat16
    default than JAX's gather is: tiles with letterbox pads, mosaic centers
    at the canvas edges, scales 0.5 and 1.5."""
    a, (bx, by), um, center, shear = WARP_CASES[name]
    rng = np.random.default_rng(sorted(WARP_CASES).index(name))
    tiles = rng.integers(0, 255, (4, S, S, 3), dtype=np.uint8)
    chw = np.array([[S, 40], [48, S], [S, S], [S, 20]], np.float32)
    pads = (S - chw) // 2
    for q in range(4):
        (t, l), (h, w) = pads[q].astype(int), chw[q].astype(int)
        tiles[q, :t], tiles[q, t + h:], tiles[q, :, :l], tiles[q, :, l + w:] = 114, 114, 114, 114
    yc, xc = (np.array(center, np.float32) * S) if um else (0.0, 0.0)
    offs = np.zeros((4, 2), np.float32)
    if um:
        offs = np.asarray(jda._tile_offsets(jnp.float32(yc), jnp.float32(xc), jnp.asarray(chw),
                                            jnp.asarray(pads), S))
    t_offs = tda._tile_offsets(torch.tensor([yc], dtype=torch.float32),
                               torch.tensor([xc], dtype=torch.float32),
                               torch.from_numpy(chw)[None], torch.from_numpy(pads)[None])[0]
    np.testing.assert_array_equal(t_offs.numpy() if um else np.zeros((4, 2)), offs)
    M = jnp.asarray([[a, shear, bx], [0.0, a, by], [0.0, 0.0, 1.0]], jnp.float32)
    Minv = jnp.linalg.inv(M)
    args = (jnp.float32(yc), jnp.float32(xc), jnp.asarray(offs), jnp.asarray(um), S)
    g = np.asarray(jda._warp_image(jnp.asarray(tiles), Minv, *args))
    t = tda._warp_images(torch.from_numpy(tiles)[None], torch.from_numpy(np.array(Minv))[None],
                         torch.tensor([yc], dtype=torch.float32),
                         torch.tensor([xc], dtype=torch.float32), torch.from_numpy(offs)[None],
                         torch.tensor([um]), S)[0].numpy()
    np.testing.assert_array_equal(t, g)
    if shear == 0.0:
        f = np.asarray(jda._warp_image_separable(jnp.asarray(tiles), M, *args, dtype=jnp.float32))
        np.testing.assert_allclose(t, f, atol=IMG_ATOL)
        fb = np.asarray(jda._warp_image_separable(jnp.asarray(tiles), M, *args))
        gap = np.abs(fb.astype(np.float32) - g).max()
        assert gap < 3.0 and np.abs(fb.astype(np.float32) - t).max() <= gap + IMG_ATOL


def test_affine_matrix_matches_jax():
    """``_affine_matrix`` on the draws of JAX's key equals JAX
    ``_affine_matrix_dyn``, mosaic (2S input) and plain."""
    hyp = _hyp(degrees=10.0, shear=3.0, perspective=5e-4, scale=0.5, translate=0.2)
    key = jax.random.PRNGKey(5)
    d = jax_draws(key, 4, S, hyp)
    _, k_aug, *_ = jax.random.split(key, 8)
    for b, k in enumerate(jax.random.split(k_aug, 4)):
        k_aff = jax.random.split(k, 3)[2]
        for in_size in (S, 2 * S):
            want, _ = jda._affine_matrix_dyn(k_aff, S, jnp.float32(in_size), hyp)
            got = tda._affine_matrix({n: v[b:b + 1] for n, v in d.items()}, S,
                                     np.array([float(in_size)]))[0]
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_hsv_matches_jax():
    """HSV alone, on the same image and gains: RGB -> HSV -> RGB equals
    JAX's, and the jitter within 5e-3 levels."""
    rng = np.random.default_rng(0)
    img = rng.random((3, 16, 16, 3)).astype(np.float32)
    img[0, :4] = img[0, :4, :, :1]  # gray pixels: no hue
    img[1, :4, :, 0] = img[1, :4, :, 1]  # ties for the largest channel
    h, s, v = jda.rgb_to_hsv(jnp.asarray(img))
    th, ts, tv = tda.rgb_to_hsv(torch.from_numpy(img))
    for a, b in ((th, h), (ts, s), (tv, v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(tda.hsv_to_rgb(th, ts, tv).numpy(),
                               np.asarray(jda.hsv_to_rgb(h, s, v)), atol=1e-6)
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    gains = (0.015, 0.7, 0.4)
    want = np.stack([np.asarray(jda.hsv_jitter(jnp.asarray(img[i]), keys[i], *gains))
                     for i in range(3)])
    r = np.stack([np.asarray(jax.random.uniform(k, (3,), minval=-1.0, maxval=1.0))
                  for k in keys])
    got = tda.hsv_jitter(torch.from_numpy(img), torch.from_numpy(r) * torch.tensor(gains) + 1.0)
    np.testing.assert_allclose(got.numpy() * 255, want * 255, atol=IMG_ATOL)


def test_draw_augment_is_seeded_and_complete():
    """The same seed gives the same draws; every variable is drawn whatever
    the hyp says, so the stream of later steps never depends on it; the
    ranges follow the hyp."""
    hyp = _hyp(mixup=0.0, fliplr=0.0)
    a = tda.draw_augment(np.random.default_rng([0, 3]), 8, hyp, S)
    b = tda.draw_augment(np.random.default_rng([0, 3]), 8, hyp, S)
    c = tda.draw_augment(np.random.default_rng([0, 3]), 8, _hyp(mixup=1.0, fliplr=0.5), S)
    assert set(a) == set(c) == {"partners", "mosaic", "center", "perspective", "degrees",
                                "scale", "shear", "translate", "mixup", "mixup_ratio",
                                "mixup_partner", "fliplr", "flipud", "hsv"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["mixup_ratio"], c["mixup_ratio"])
    np.testing.assert_array_equal(a["hsv"], c["hsv"])
    assert not a["mixup"].any() and c["mixup"].all() and not a["fliplr"].any()
    assert (a["scale"] >= 0.5).all() and (a["scale"] <= 1.5).all()
    assert (a["center"] >= 0.5 * S).all() and (a["center"] < 1.5 * S).all()
    assert (a["partners"] >= 0).all() and (a["partners"] < 8).all()


def test_make_augment_fn_sizes_and_normalize():
    """``make_augment_fn`` gives ``n_out = min(4 * n_in, max_instances)``
    instances; ``normalize_batch`` is the transform without augmentation."""
    hyp = _hyp()
    for n_in, want in ((8, 32), (16, 48), (48, 48)):
        batch = {k: torch.from_numpy(v) for k, v in raw_batch(2, n_in, n_in).items()}
        img = batch.pop("img")
        out_img, out = tda.make_augment_fn(hyp, S, 48)(np.random.default_rng(0), img, batch)
        assert out_img.shape == (2, S, S, 3) and out["mask_gt"].shape == (2, want)
        assert out["segments"].shape == (2, want, 360, 2)
    u8 = raw_batch(2, 8, 0)["img"]
    np.testing.assert_array_equal(tda.normalize_batch(torch.from_numpy(u8)).numpy(),
                                  np.asarray(jda.normalize_batch(jnp.asarray(u8))))


# --- the host side: format_sample_raw, TrainDataset, TrainLoader ---------------------

def _sample_pair(seed, h, w, n_inst):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    c0 = rng.uniform([0, 0], [w / 2, h / 2], (n_inst, 2))
    xyxy = np.concatenate([c0, c0 + rng.uniform(4, [w / 2, h / 2], (n_inst, 2))], -1)
    segs = rng.uniform([0, 0], [w, h], (n_inst, 360, 2)).astype(np.float32)
    cls = rng.integers(0, 3, n_inst).astype(np.float32)
    return (jaug.Sample(img, JInstances(cls, xyxy.astype(np.float32), segs.copy())),
            taug.Sample(img, TInstances(cls, xyxy.astype(np.float32), segs.copy())))


@pytest.mark.parametrize("h,w,new", [(120, 200, 160), (300, 500, 160), (64, 64, 160),
                                     (50, 70, 64)])
def test_format_sample_raw_matches_jax(h, w, new):
    """``format_sample_raw`` of a letterboxed (upscaling) sample equals
    JAX's: uint8 BGR image, padded labels, ``content_hw`` and ``pad_tl``."""
    js, ts = _sample_pair(h * w, h, w, 5)
    jd = jaug.format_sample_raw(jaug.letterbox_sample(js, new, scaleup=True), 48)
    td = taug.format_sample_raw(taug.letterbox_sample(ts, new, scaleup=True), 48)
    assert sorted(td) == sorted(jd)
    for k in jd:
        assert td[k].dtype == jd[k].dtype, k
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)


def test_collate_raw_buckets_match_jax():
    """``collate`` of raw samples trims the labels' instance axis to JAX's
    bucket and leaves ``content_hw`` and ``pad_tl`` whole."""
    for counts in ((1, 3), (9, 2), (17, 4), (33, 1), (48, 0)):
        jd, td = [], []
        for i, n in enumerate(counts):
            js, ts = _sample_pair(i + 10 * n, 64, 80, n)
            jd.append(jaug.format_sample_raw(jaug.letterbox_sample(js, 64), 48))
            td.append(taug.format_sample_raw(taug.letterbox_sample(ts, 64), 48))
        jb, tb = jaug.collate(jd), taug.collate(td)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=f"{counts} {k}")


@pytest.fixture(scope="module")
def shape_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapes")
    make_shape_dataset(root, n_train=12, n_val=2, imgsz=96, img_w=128, seed=3)
    files = sorted((root / "images" / "train").glob("*.jpg"))
    labels = [root / "labels" / "train" / (f.stem + ".txt") for f in files]
    return root, [cv2.imread(str(f)) for f in files], labels


def _jax_train_set(root, imgsz):
    cfg = jax_get_cfg(overrides=dict(task="segment", imgsz=imgsz))
    return jdataset.YOLODataset(str(root / "images" / "train"), imgsz=imgsz, augment=True,
                                hyp=cfg, device_augment=True, cache=False)


@pytest.mark.parametrize("imgsz", [64, 128, 160])
def test_train_dataset_matches_jax_dataset(shape_dir, imgsz):
    """``TrainDataset`` over the cv2-decoded images and their label files
    gives JAX ``YOLODataset(augment=True, device_augment=True)``'s samples
    byte for byte: pre-resized by INTER_LINEAR both ways (shrinking at 64,
    none at 128, enlarging at 160), letterboxed with upscaling."""
    root, images, labels = shape_dir
    jds = _jax_train_set(root, imgsz)
    tds = tdataset.TrainDataset(images, labels, imgsz=imgsz)
    assert len(tds) == len(jds) == 12
    for i in (0, 7, 11):
        jd, td = jds[i], tds[i]
        assert sorted(td) == sorted(jd)
        for k in jd:
            assert td[k].dtype == jd[k].dtype, k
            np.testing.assert_array_equal(td[k], jd[k], err_msg=k)


@pytest.mark.parametrize("workers", [1, 3])
def test_train_loader_matches_jax_loader(shape_dir, workers):
    """``TrainLoader`` batches equal JAX ``DataLoader``'s with one worker
    (the same ``random.Random(seed)`` order, the last partial batch
    dropped, epochs running on), whatever the port's worker count; an
    abandoned iterator leaves no worker behind."""
    import threading

    root, images, labels = shape_dir
    jl = jbuild.DataLoader(_jax_train_set(root, 96), 5, shuffle=True, infinite=True, workers=1,
                           seed=7, drop_last=True)
    tl = TrainLoader(tdataset.TrainDataset(images, labels, imgsz=96), 5, workers=workers, seed=7)
    assert len(tl) == len(jl) == 2
    before = threading.active_count()
    ji, ti = iter(jl), iter(tl)
    for _ in range(5):
        jb, tb = next(ji), next(ti)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    ji.close()
    ti.close()
    assert threading.active_count() <= before


def test_train_loader_raises_worker_errors():
    """A sample that fails raises in the consumer."""
    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError("bad sample")

    with pytest.raises(RuntimeError, match="bad sample"):
        next(iter(TrainLoader(Bad(), 2, workers=2)))
    with pytest.raises(ValueError, match="no batch"):
        next(iter(TrainLoader(Bad(), 8)))


def test_use_device_augment_matches_jax():
    """The port trains where JAX augments on the device, and says so
    where JAX would take its host cv2 pipeline."""
    for over in ({}, {"device_augment": False}, {"mosaic9": 0.5}, {"copy_paste": 0.1}):
        cfg = dict(task="segment", **over)
        assert use_device_augment(get_cfg(overrides=cfg)) == \
            jbuild.use_device_augment(jax_get_cfg(overrides=cfg))


def test_floor_train_set_file_is_the_floor_set(tmp_path):
    """``tests/data/torch_port_floor_seg160_train64.npz`` (what the card's
    floor training reads: its machine decodes no JPEG) holds exactly the
    seg160 floor set's 64 train images, decoded by cv2, and their label
    files' text: regenerated here and compared byte for byte."""
    import json

    cfg = json.loads(FLOOR_JSON.read_text())["config"]
    make_shape_dataset(tmp_path, n_train=cfg["n_train"], n_val=cfg["n_val"], imgsz=cfg["imgsz"],
                       seed=cfg["seed"])
    files = sorted((tmp_path / "images" / "train").glob("*.jpg"))
    label_files = [tmp_path / "labels" / "train" / (f.stem + ".txt") for f in files]
    images = np.stack([cv2.imread(str(f)) for f in files])
    texts = np.array([p.read_text() for p in label_files])
    z = np.load(FLOOR_TRAIN)
    assert sorted(z.files) == ["images", "labels"]
    assert z["images"].dtype == np.uint8 and z["images"].shape == (64, 160, 160, 3)
    assert z["images"].tobytes() == images.tobytes()
    assert z["labels"].dtype == texts.dtype and z["labels"].tobytes() == texts.tobytes()
    got_images, got_labels = floor_train_set()
    assert sum(len(c) for c, _, _ in got_labels) == 123
    for (c, b, s), p in zip(got_labels, label_files):
        for g, w in zip((c, b, s), tdataset.parse_label_file(str(p))):
            np.testing.assert_array_equal(g, w)
