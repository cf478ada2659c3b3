"""The port's host train chain against the JAX package's (and so against
cv2) on the CPU: ``data/imgproc.py``'s copies of the cv2 functions against
cv2 itself (the colour conversions over all 2^24 colours, the warps, blurs,
CLAHE and INTER_AREA on seeded random images and matrices), ``fill_poly``
against ``cv2.fillPoly``, the ``Instances`` geometry, and each transform of
``data/augment.py`` against JAX's on the same inputs and a copy of the same
``random.Random`` state: ``mosaic4``, ``mosaic9``, ``copy_paste``,
``random_perspective`` (affine and perspective, with degrees and shear,
keypoints and box-only labels), ``mixup`` (its beta from numpy's global
state on both sides), ``random_hsv``, ``random_flip`` with ``flip_idx``,
``pixel_augment`` with every branch forced, and ``train_transform`` end to
end over seeds for box, polygon and keypoint labels; then ``TrainDataset``'s
host mode against JAX's ``YOLODataset`` draws, its ``plan`` against its
own ``__getitem__``, and ``close_mosaic``.

Images are held byte for byte (no transform needs a tolerance); labels
within ``LABEL_ATOL`` px, and the generators must end in the same state."""
import copy
import random
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from yolo_contour_regression_tpu.data import augment as ja
from yolo_contour_regression_tpu.data.instance import Instances as JI
from yolo_contour_regression_tpu_torch.data import augment as ta
from yolo_contour_regression_tpu_torch.data import imgproc
from yolo_contour_regression_tpu_torch.data.build import TrainLoader
from yolo_contour_regression_tpu_torch.data.dataset import TrainDataset
from yolo_contour_regression_tpu_torch.data.instance import Instances as TI

# labels: the same float32 arithmetic on both sides (px)
LABEL_ATOL = 1e-4
FLIP_IDX = (1, 0, 2, 4, 3)
HYP = dict(mosaic=1.0, mosaic9=0.0, copy_paste=0.0, mixup=0.0, degrees=0.0, translate=0.1,
           scale=0.5, shear=0.0, perspective=0.0, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, fliplr=0.5,
           flipud=0.0)


def _hyp(**kw):
    return SimpleNamespace(**{**HYP, **kw})


def _labels(rng, n, h, w, kind):
    """n instances on an h x w image: ellipse contours (every third one
    box-only for "segment"), all box-only for "detect", and for "pose" box
    labels with 5 keypoints each."""
    t = np.linspace(0, 2 * np.pi, 360, endpoint=False)
    segs, boxes = [], []
    for i in range(n):
        c = rng.uniform(0.2, 0.8, 2) * [w, h]
        rx, ry = rng.uniform(4, 0.3 * w), rng.uniform(4, 0.3 * h)
        s = np.stack([c[0] + rx * np.cos(t), c[1] + ry * np.sin(t)], -1)
        if kind != "segment" or i % 3 == 2:
            s = np.zeros_like(s)
        segs.append(s)
        boxes.append([c[0] - rx, c[1] - ry, c[0] + rx, c[1] + ry])
    kpts = None
    if kind == "pose":
        kpts = np.concatenate([rng.uniform(0, 1, (n, 5, 2)) * [w, h],
                               rng.integers(0, 3, (n, 5, 1))], -1).astype(np.float32)
    return (np.arange(n) % 3).astype(np.float32), np.asarray(boxes, np.float32), \
        np.asarray(segs, np.float32), kpts


def _samples(seed, count, kind="segment", sizes=((90, 120), (120, 96), (64, 64), (150, 100))):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        h, w = sizes[i % len(sizes)]
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        out.append((img, *_labels(rng, 1 + i % 4, h, w, kind)))
    return out


def _pair(item):
    img, c, b, s, k = item
    cp = (lambda a: None if a is None else a.copy())
    return (ja.Sample(img.copy(), JI(c.copy(), b.copy(), s.copy(), cp(k))),
            ta.Sample(img.copy(), TI(c.copy(), b.copy(), s.copy(), cp(k))))


def _check(js, ts, jrng=None, trng=None):
    assert ts.img.dtype == np.uint8 and np.array_equal(ts.img, js.img)
    assert len(ts.inst) == len(js.inst)
    np.testing.assert_array_equal(ts.inst.cls, js.inst.cls)
    for k in ("bboxes", "segments", "keypoints"):
        jv, tv = getattr(js.inst, k), getattr(ts.inst, k)
        assert (jv is None) == (tv is None), k
        if jv is not None:
            np.testing.assert_allclose(tv, jv, atol=LABEL_ATOL, err_msg=k)
    if jrng is not None:
        assert jrng.getstate() == trng.getstate()


# --- the cv2 copies ---------------------------------------------------------

@pytest.fixture(scope="module")
def all_colours():
    c = np.arange(1 << 24, dtype=np.int64)
    return np.stack([c & 255, (c >> 8) & 255, c >> 16], -1).astype(np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("name", ["bgr2hsv", "hsv2bgr", "bgr2lab", "lab2bgr"])
def test_colour_conversions_equal_cv2_on_every_colour(all_colours, name):
    """Every one of the 2^24 inputs (hue taken mod 180 for HSV2BGR)."""
    img = all_colours
    if name == "hsv2bgr":
        img = img.copy()
        img[..., 0] %= 180
    fn, code = {"bgr2hsv": (imgproc.bgr_to_hsv, cv2.COLOR_BGR2HSV),
                "hsv2bgr": (imgproc.hsv_to_bgr, cv2.COLOR_HSV2BGR),
                "bgr2lab": (imgproc.bgr_to_lab, cv2.COLOR_BGR2LAB),
                "lab2bgr": (imgproc.lab_to_bgr, cv2.COLOR_LAB2BGR)}[name]
    assert np.array_equal(fn(img), cv2.cvtColor(img, code))


def _matrix(rng, h, w, perspective):
    """T @ S @ R @ P @ C as ``random_perspective`` builds it, from rng."""
    C = np.eye(3)
    C[:2, 2] = -w / 2, -h / 2
    P = np.eye(3)
    if perspective:
        P[2, :2] = rng.uniform(-1e-3, 1e-3, 2)
    R = np.eye(3)
    a, sc = rng.uniform(-30, 30), rng.uniform(0.5, 1.5)
    R[:2] = imgproc.rotation_matrix_2d(a, sc)
    assert np.array_equal(R[:2], cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=sc))
    S = np.eye(3)
    S[0, 1], S[1, 0] = np.tan(rng.uniform(-10, 10, 2) * np.pi / 180)
    T = np.eye(3)
    T[:2, 2] = rng.uniform(0.4, 0.6, 2) * [w, h]
    return T @ S @ R @ P @ C


@pytest.mark.parametrize("perspective", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warps_equal_cv2(perspective, seed):
    """``warp_affine`` / ``warp_perspective`` against ``cv2.warpAffine`` /
    ``cv2.warpPerspective`` (INTER_LINEAR, border 114) on random images,
    maps and output sizes (widths on and off the kernels' 16-pixel
    vectors), 3 and 1 channels."""
    rng = np.random.default_rng(seed)
    for _ in range(6):
        h, w = (int(v) for v in rng.integers(20, 260, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        m = _matrix(rng, h, w, perspective)
        ow, oh = int(rng.integers(20, 260)), int(rng.integers(20, 260))
        for im in (img, img[..., 1].copy()):
            if perspective:
                want = cv2.warpPerspective(im, m, dsize=(ow, oh), borderValue=(114, 114, 114))
                got = imgproc.warp_perspective(im, m, (ow, oh))
            else:
                want = cv2.warpAffine(im, m[:2], dsize=(ow, oh), borderValue=(114, 114, 114))
                got = imgproc.warp_affine(im, m[:2], (ow, oh))
            assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_blurs_equal_cv2(k):
    """``box_blur`` (BORDER_REFLECT_101) and ``median_blur``
    (BORDER_REPLICATE) against cv2 on odd sizes."""
    rng = np.random.default_rng(k)
    for h, w in ((37, 91), (64, 64), (160, 120)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        assert np.array_equal(imgproc.box_blur(img, k), cv2.blur(img, (k, k)))
        assert np.array_equal(imgproc.median_blur(img, k), cv2.medianBlur(img, k))


@pytest.mark.parametrize("hw", [(64, 64), (160, 160), (100, 77), (64, 77)])
def test_clahe_equals_cv2(hw):
    """CLAHE (clip 4, 8x8 tiles) on smooth and noisy gray images, sizes
    that are and are not multiples of the tiles (reflected to one)."""
    rng = np.random.default_rng(sum(hw))
    clahe = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8))
    noise = rng.integers(0, 256, hw, dtype=np.uint8)
    for g in (noise, cv2.GaussianBlur(noise, (0, 0), 3), cv2.GaussianBlur(noise, (0, 0), 3) // 4):
        assert np.array_equal(imgproc.clahe(g, 4.0, (8, 8)), clahe.apply(g))


@pytest.mark.parametrize("src,dst", [((320, 320), (160, 160)), ((480, 240), (160, 80)),
                                     ((400, 400), (100, 100)), ((300, 200), (160, 107)),
                                     ((640, 427), (160, 107)), ((161, 100), (160, 99))])
def test_resize_area_equals_cv2(src, dst):
    """INTER_AREA at integer ratios (2 and 4, the fast path) and fractional
    ones (the general path), 3 channels and 1."""
    img = np.random.default_rng(src[0]).integers(0, 256, src + (3,), dtype=np.uint8)
    for im in (img, img[..., 0].copy()):
        want = cv2.resize(im, dst[::-1], interpolation=cv2.INTER_AREA)
        assert np.array_equal(imgproc.resize_area(im, *dst), want)


@pytest.mark.parametrize("seed", range(4))
def test_fill_poly_equals_cv2(seed):
    """``fill_poly`` against ``cv2.fillPoly(mask, [pts.astype(int32)], 1)``
    on 360-point star polygons clipped to the image (edges on its right and
    bottom border leave it, as copy_paste's contours do)."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(40, 160, 2))
        t = np.sort(rng.uniform(0, 2 * np.pi, 360))
        r = rng.uniform(2, 0.5 * min(h, w), 360)
        c = rng.uniform(0, 1, 2) * [w, h]
        pts = np.stack([c[0] + r * np.cos(t), c[1] + r * np.sin(t)], -1).clip(0, [w, h])
        pts = pts.astype(np.float32).astype(np.int32)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        assert np.array_equal(ta.fill_poly(np.zeros((h, w), np.uint8), pts), want)


# --- Instances ----------------------------------------------------------------

def test_instances_geometry_matches_jax():
    """fliplr with ``flip_idx``, flipud, clip, boxes from contours,
    ``remove_degenerate``, ``select`` and ``concatenate`` (keypoints kept
    only when every part has them)."""
    rng = np.random.default_rng(3)
    c, b, s, k = _labels(rng, 6, 80, 100, "segment")
    k = rng.uniform(-10, 110, (6, 5, 3)).astype(np.float32)
    j, t = JI(c, b.copy(), s.copy(), k.copy()), TI(c, b.copy(), s.copy(), k.copy())
    for fn, args in (("fliplr", (100, FLIP_IDX)), ("flipud", (80,)), ("clip", (100, 80)),
                     ("sync_boxes_from_segments", ())):
        getattr(j, fn)(*args)
        getattr(t, fn)(*args)
    j, t = j.remove_degenerate(), t.remove_degenerate()
    keep = np.arange(len(j)) % 2 == 0
    j = JI.concatenate([j, j.select(keep), JI(c[:1], b[:1], s[:1])])
    t = TI.concatenate([t, t.select(keep), TI(c[:1], b[:1], s[:1])])
    assert t.keypoints is None and j.keypoints is None
    for name in ("cls", "bboxes", "segments"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


# --- the transforms -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["segment", "detect", "pose"])
def test_mosaic4_matches_jax(kind):
    """The 2x2 canvas, its centre drawn from the generator, each tile's
    long side resized to imgsz (INTER_LINEAR), labels moved and clipped."""
    for seed in range(3):
        pairs = [_pair(x) for x in _samples(seed, 4, kind)]
        jr, tr = random.Random(seed), random.Random(seed)
        js = ja.mosaic4([p[0] for p in pairs], 64, jr)
        ts = ta.mosaic4([p[1] for p in pairs], 64, tr)
        _check(js, ts, jr, tr)


def test_mosaic9_matches_jax():
    """The 3x3 grid's centre 2 imgsz crop; labels clipped and the
    degenerate ones dropped."""
    pairs = [_pair(x) for x in _samples(5, 9, "pose")]
    js = ja.mosaic9([p[0] for p in pairs], 64, random.Random(0))
    ts = ta.mosaic9([p[1] for p in pairs], 64, random.Random(0))
    _check(js, ts)


@pytest.mark.parametrize("p", [0.3, 0.5, 1.0])
def test_copy_paste_matches_jax(p):
    """The mirrored instances pasted where they do not collide, by their
    int32 contours' fill; the samples drawn as JAX draws them."""
    for seed in range(3):
        pairs = [_pair(x) for x in _samples(seed + 10, 4, "segment")]
        jr, tr = random.Random(seed), random.Random(seed)
        js = ja.copy_paste(ja.mosaic4([q[0] for q in pairs], 96, jr), p, jr)
        ts = ta.copy_paste(ta.mosaic4([q[1] for q in pairs], 96, tr), p, tr)
        _check(js, ts, jr, tr)


@pytest.mark.parametrize("kind", ["segment", "detect", "pose"])
@pytest.mark.parametrize("warp", ["default", "degrees_shear", "perspective"])
def test_random_perspective_matches_jax(kind, warp):
    """The warp of image and labels (contours, box corners where there is
    no contour, keypoints losing their visibility outside), with the mosaic
    border and without."""
    kw = {"default": {}, "degrees_shear": dict(degrees=20.0, shear=5.0),
          "perspective": dict(degrees=10.0, shear=2.0, perspective=0.0008)}[warp]
    for seed in range(3):
        js, ts = _pair(_samples(seed + 20, 1, kind, sizes=((128, 128),))[0])
        jr, tr = random.Random(seed), random.Random(seed)
        border = (-32, -32) if seed % 2 else (0, 0)
        j = ja.random_perspective(js, 64, jr, border=border, **kw)
        t = ta.random_perspective(ts, 64, tr, border=border, **kw)
        _check(j, t, jr, tr)


def test_mixup_matches_jax():
    """beta(32, 32) from numpy's global state on both sides, the blend in
    float32 truncated to uint8, labels concatenated."""
    (ja_, ta_), (jb, tb) = (_pair(x) for x in _samples(30, 2, "segment", sizes=((64, 64),)))
    np.random.seed(4)
    j = ja.mixup(ja_, jb, random.Random(0))
    np.random.seed(4)
    t = ta.mixup(ta_, tb, np.random)
    _check(j, t)


def test_random_hsv_and_flip_match_jax():
    """The HSV jitter (its three draws, the LUTs, cv2's conversions) and
    the flips (up-down, then left-right with ``flip_idx``)."""
    for seed in range(4):
        js, ts = _pair(_samples(seed + 40, 1, "pose", sizes=((72, 96),))[0])
        jr, tr = random.Random(seed), random.Random(seed)
        jimg = ja.random_hsv(js.img, jr, 0.1, 0.7, 0.4)
        timg = ta.random_hsv(ts.img, tr, 0.1, 0.7, 0.4)
        assert np.array_equal(timg, jimg) and jr.getstate() == tr.getstate()
        j = ja.random_flip(js, jr, 0.5, 0.5, FLIP_IDX)
        t = ta.random_flip(ts, tr, 0.5, 0.5, FLIP_IDX)
        _check(j, t, jr, tr)


@pytest.mark.parametrize("seed", range(4))
def test_pixel_augment_forced_matches_jax(seed):
    """Every branch forced (p=1: blur, median, gray, CLAHE on Lab's L, each
    drawing as JAX does), and each branch alone against its cv2 call."""
    img = _samples(seed + 50, 1, sizes=((96, 80),))[0][0]
    jr, tr = random.Random(seed), random.Random(seed)
    assert np.array_equal(ta.pixel_augment(img.copy(), tr, p=1.0),
                          ja.pixel_augment(img.copy(), jr, p=1.0))
    assert jr.getstate() == tr.getstate()
    lab = cv2.cvtColor(img, cv2.COLOR_BGR2LAB)
    lab[..., 0] = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8)).apply(lab[..., 0])
    want = cv2.cvtColor(lab, cv2.COLOR_LAB2BGR)
    lab = imgproc.bgr_to_lab(img)
    lab[..., 0] = imgproc.clahe(lab[..., 0])
    assert np.array_equal(imgproc.lab_to_bgr(lab), want)
    gray = cv2.cvtColor(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), cv2.COLOR_GRAY2BGR)
    assert np.array_equal(np.repeat(ta.bgr_to_gray(img)[..., None], 3, -1), gray)


@pytest.mark.parametrize("kind", ["segment", "detect", "pose"])
@pytest.mark.parametrize("seed", range(6))
def test_train_transform_matches_jax(kind, seed):
    """The whole chain over seeds: mosaic4 or mosaic9, copy_paste, the warp
    (perspective on some seeds), MixUp, or the letterbox branch, then the
    pixel branches, HSV and flips; the generators end in step."""
    data = _samples(seed + 60, 8, kind)
    hyp = _hyp(mosaic=0.0 if seed == 5 else 1.0, mosaic9=0.5, copy_paste=0.5, mixup=0.5,
               degrees=10.0, shear=2.0, perspective=0.0005 if seed % 2 else 0.0, flipud=0.3)
    jr, tr = random.Random(seed), random.Random(seed)
    np.random.seed(seed)
    j = ja.train_transform(lambda i: _pair(data[i])[0], seed % 8, 8, 64, hyp, jr,
                           flip_idx=FLIP_IDX if kind == "pose" else None)
    np.random.seed(seed)
    t = ta.train_transform(lambda i: _pair(data[i])[1], seed % 8, 8, 64, hyp, tr, np.random,
                           flip_idx=FLIP_IDX if kind == "pose" else None)
    _check(j, t, jr, tr)


# --- the dataset --------------------------------------------------------------

def _dataset(kind, **kw):
    data = _samples(70, 8, kind)
    labels = []
    for img, c, b, s, k in data:
        h, w = img.shape[:2]
        xywh = np.concatenate([(b[:, :2] + b[:, 2:]) / 2, b[:, 2:] - b[:, :2]], -1) / [w, h, w, h]
        lab = (c.astype(np.int32), xywh.astype(np.float32), (s / [w, h]).astype(np.float32))
        labels.append(lab + ((k / [w, h, 1]).astype(np.float32),) if k is not None else lab)
    return TrainDataset([d[0] for d in data], labels, imgsz=64, device_augment=False,
                        kpt_shape=(5, 3) if kind == "pose" else None,
                        flip_idx=FLIP_IDX if kind == "pose" else None, **kw)


def test_dataset_plans_render_as_it_reads():
    """``plan(i)`` made in read order and rendered in reverse gives what
    ``__getitem__`` gives in read order; the loader (rendering in forked
    processes) gives the same batches with one worker and with four."""
    hyp = _hyp(mosaic9=0.5, copy_paste=0.5, mixup=0.5)
    a, b = _dataset("segment", hyp=hyp), _dataset("segment", hyp=hyp)
    plans = [b.plan(i % 8) for i in range(12)]
    rendered = [b.render(p) for p in plans[::-1]][::-1]
    for i in range(12):
        got = a[i % 8]
        assert all(np.array_equal(got[k], rendered[i][k]) for k in got), i
    batches = []
    for workers in (1, 4):
        it = iter(TrainLoader(_dataset("segment", hyp=hyp), 4, workers=workers, in_order=True))
        batches.append([next(it) for _ in range(3)])
        it.close()
    for x, y in zip(*batches):
        assert all(np.array_equal(x[k], y[k]) for k in x)


@pytest.mark.parametrize("kind", ["segment", "pose"])
def test_dataset_samples_match_jax_chain(kind):
    """``TrainDataset`` in host mode gives JAX's ``train_transform`` then
    ``format_sample`` on its samples (uint8 RGB, JAX's float image times
    255), drawing from ``random.Random(seed)`` and the given noise; after
    ``close_mosaic`` the letterbox branch."""
    hyp = _hyp(mosaic9=0.3, copy_paste=0.5, mixup=0.5)
    np.random.seed(1)
    ds = _dataset(kind, hyp=hyp, seed=3, noise=np.random)
    jr = random.Random(3)
    jnoise = np.random.RandomState(1)
    for i in range(8):
        if i == 5:
            ds.close_mosaic()
            hyp = copy.copy(hyp)
            hyp.mosaic, hyp.mixup = 0.0, 0.0
        state = np.random.get_state()
        np.random.set_state(jnoise.get_state())
        js = ja.train_transform(lambda j: _jax_raw(ds, j), i, 8, 64, hyp, jr,
                                flip_idx=ds.flip_idx)
        jnoise.set_state(np.random.get_state())
        np.random.set_state(state)
        want = ja.format_sample(js, 48)
        got = ds[i]
        np.testing.assert_array_equal(got["img"].astype(np.float32) / 255.0, want["img"])
        for k in ("cls", "mask_gt") + (("keypoints",) if kind == "pose" else ()):
            np.testing.assert_allclose(got[k], want[k], atol=LABEL_ATOL, err_msg=k)
        for k in ("bboxes", "segments"):
            np.testing.assert_allclose(got[k], want[k], atol=LABEL_ATOL / 64, err_msg=k)
    assert ds.rng.getstate() == jr.getstate()


def _jax_raw(ds, i):
    """Sample i of the port's dataset as a JAX ``Sample``."""
    s = ds.load_raw(i)
    inst = s.inst
    return ja.Sample(s.img.copy(), JI(inst.cls.copy(), inst.bboxes.copy(), inst.segments.copy(),
                                      None if inst.keypoints is None else inst.keypoints.copy()))
