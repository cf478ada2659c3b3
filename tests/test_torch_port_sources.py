"""The port's inference sources on the CPU against the JAX package's:
``iter_source`` on files, directories, globs and mixed lists (the same
names and arrays; files decoded by ``data/imcodec.py``), ``LoadStreams``
with synthetic captures (batching and drain, the re-served last frame,
live mode's dropped frames, ``vid_stride``, the ``.streams`` file and its
errors), ``predict(stream=True)``, the label files of ``save_txt``, the
batched multi-stream predict, and every ported ``Results`` method on the
same detections. IMGSZ 64."""
import glob
import time
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import SyntheticCapture, shape_images
from yolo_contour_regression_tpu.data.streams import LoadStreams as JaxLoadStreams
from yolo_contour_regression_tpu.engine import results as jax_results
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.engine.predictor import iter_source as jax_iter_source
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.data.streams import LoadStreams
from yolo_contour_regression_tpu_torch.engine import predictor as P
from yolo_contour_regression_tpu_torch.engine import results as port_results
from yolo_contour_regression_tpu_torch.engine.predictor import iter_source

ROOT = Path(__file__).resolve().parent.parent
SEG_CKPT = ROOT / "runs" / "floor_seg160" / "best.ckpt"
IMGSZ = 64
PX_ATOL = 0.05
SCORE_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return YOLO(SEG_CKPT, device="cpu"), JaxYOLO(str(SEG_CKPT))


@pytest.fixture()
def image_dir(tmp_path):
    """JPEG and PNG files written by cv2, one in a subdirectory, and a file
    that is no image."""
    imgs = shape_images(4, 72, 96, seed=3)
    cv2.imwrite(str(tmp_path / "b.jpg"), imgs[0])
    cv2.imwrite(str(tmp_path / "a.png"), imgs[1])
    (tmp_path / "sub").mkdir()
    cv2.imwrite(str(tmp_path / "sub" / "c.jpeg"), imgs[2])
    cv2.imwrite(str(tmp_path / "sub" / "d.PNG"), imgs[3])
    (tmp_path / "notes.txt").write_text("not an image")
    return tmp_path


def _assert_same_items(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_iter_source_files_dirs_and_mixed_lists(image_dir):
    arr = np.zeros((16, 16, 3), np.uint8)
    for source in (str(image_dir / "b.jpg"), str(image_dir / "a.png"), str(image_dir),
                   image_dir / "sub", arr, [arr, str(image_dir / "b.jpg"), arr],
                   [str(image_dir / "sub"), arr]):
        got, want = list(iter_source(source)), list(jax_iter_source(source))
        assert got
        _assert_same_items(got, want)
    names = [n for n, _ in iter_source(str(image_dir))]
    assert len(names) == 4 and names == sorted(names)


def test_iter_source_globs(image_dir):
    """A glob yields its sorted matches, each as JAX yields that file."""
    for pattern in (str(image_dir / "*.jpg"), str(image_dir / "**" / "*.*g"),
                    str(image_dir / "sub" / "[cd].*")):
        files = sorted(glob.glob(pattern, recursive=True))
        got = list(iter_source(pattern))
        assert len(got) == len(files) > 0
        _assert_same_items(got, list(jax_iter_source(files)))
    with pytest.raises(FileNotFoundError):
        list(iter_source(str(image_dir / "*.webp")))


@pytest.mark.parametrize("spec, words", [
    ("clip.mp4", "video"), ("0", "camera"), ("rtsp://cam/1", "URL"),
    ("https://x/y.jpg", "URL"), ("screen 0", "mss")])
def test_iter_source_without_a_decoder_raises(spec, words):
    with pytest.raises(NotImplementedError, match=words):
        list(iter_source(spec))


def test_iter_source_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        list(iter_source(str(tmp_path / "none.jpg")))


def _frames(stream_id, n, size=8):
    return [np.full((size, size, 3), stream_id * 10 + j, np.uint8) for j in range(n)]


def _both(make_caps, sources, **kw):
    """The batches of the port's and JAX's loaders over the same captures."""
    out = []
    for cls in (LoadStreams, JaxLoadStreams):
        caps = make_caps()
        with cls(sources, open_fn=lambda s: caps[s], **kw) as ld:
            batches = list(ld)
        out.append((batches, ld))
    return out


def _values(batches):
    return [(paths, [int(f[0, 0, 0]) for f in frames]) for paths, frames in batches]


def test_loadstreams_batches_and_drains():
    (got, ld), (want, jld) = _both(lambda: {str(i): SyntheticCapture(_frames(i, 3)) for i in range(4)},
                                   [str(i) for i in range(4)], buffer=True)
    assert _values(got) == _values(want)
    assert len(got) == 3 and len(ld) == 4
    assert ld.frames_read == jld.frames_read == [3] * 4
    assert ld.frames_dropped == jld.frames_dropped == [0] * 4


def test_loadstreams_ended_stream_reserves_last_frame():
    (got, _), (want, _) = _both(lambda: {"a": SyntheticCapture(_frames(0, 2)), "b": SyntheticCapture(_frames(1, 4))},
                                ["a", "b"], buffer=True)
    assert _values(got) == _values(want)
    assert [v[1][0] for v in _values(got)] == [0, 1, 1, 1]


def test_loadstreams_vid_stride():
    (got, _), (want, _) = _both(lambda: {"cam": SyntheticCapture(_frames(0, 9))}, ["cam"], buffer=True,
                                vid_stride=2)
    assert _values(got) == _values(want)
    assert [v[1][0] for v in _values(got)] == [0, 2, 4, 6, 8]


@pytest.mark.parametrize("cls", [LoadStreams, JaxLoadStreams])
def test_loadstreams_live_mode_drops_stale_frames(cls):
    """buffer=False keeps only the newest frame: a slow consumer sees
    dropped frames and ends on the last one (both loaders)."""
    cap = SyntheticCapture(_frames(0, 50))
    ld = cls(["cam"], buffer=False, open_fn=lambda s: cap)
    for _ in range(200):
        if not ld._alive[0]:
            break
        time.sleep(0.005)
    last = None
    for _, frames in ld:
        last = frames[0]
    assert last[0, 0, 0] == 49 and ld.frames_dropped[0] > 0
    ld.close()


def test_loadstreams_file_and_errors(tmp_path):
    lst = tmp_path / "cams.streams"
    lst.write_text("0\n1\n\n")
    for cls in (LoadStreams, JaxLoadStreams):
        caps = {s: SyntheticCapture(_frames(int(s), 1)) for s in ("0", "1")}
        with cls(lst, open_fn=lambda s: caps[s]) as ld:
            assert ld.sources == ["0", "1"]
        with pytest.raises(ValueError):
            cls([], open_fn=lambda s: SyntheticCapture(_frames(0, 1)))
        with pytest.raises(ConnectionError):
            cls(["dead"], open_fn=lambda s: SyntheticCapture([]))
    with pytest.raises(NotImplementedError, match="open_fn"):
        LoadStreams(["rtsp://cam/1"])  # no video decoder is ported


def test_predict_stream_generator_matches_jax(models, image_dir, tmp_path):
    """``predict(stream=True)`` over a directory is a generator giving the
    list's results, and JAX's (names, boxes, contours)."""
    port, jax = models
    gen = port.predict(str(image_dir), imgsz=IMGSZ, stream=True)
    assert isinstance(gen, types.GeneratorType)
    got = list(gen)
    want = list(jax.predict(str(image_dir), imgsz=IMGSZ, stream=True, save=False,
                            project=str(tmp_path / "jax")))
    assert [r.path for r in got] == [r.path for r in want]
    listed = port(str(image_dir), imgsz=IMGSZ)
    for g, w, l in zip(got, want, listed):
        assert len(g) == len(w) == len(l)
        np.testing.assert_array_equal(g.boxes.data, l.boxes.data)
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, atol=PX_ATOL)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, atol=SCORE_ATOL)
        np.testing.assert_allclose(g.contours.points, w.contours.points, atol=PX_ATOL)
    assert sum(len(r) for r in got) > 0


@pytest.mark.parametrize("save_conf", [False, True])
def test_predict_save_txt_matches_jax(models, image_dir, tmp_path, save_conf):
    """The label files of ``save_txt`` (``save_conf``) hold JAX's lines: the
    same files, classes and point counts, the coordinates within 0.05 px
    of the image and the confidences within 1e-4 (the two models' float32
    sums differ in the last digits; ``Results.save_txt`` itself is held
    byte for byte below). JAX runs with ``save=False``: the port draws
    nothing."""
    port, jax = models
    list(port.predict(str(image_dir), imgsz=IMGSZ, stream=True, save_txt=True,
                      save_conf=save_conf, project=str(tmp_path / "port")))
    list(jax.predict(str(image_dir), imgsz=IMGSZ, stream=True, save=False, save_txt=True,
                     save_conf=save_conf, project=str(tmp_path / "jax")))
    got = sorted((tmp_path / "port" / "predict" / "labels").glob("*.txt"))
    want = sorted((tmp_path / "jax" / "predict" / "labels").glob("*.txt"))
    assert [f.name for f in got] == [f.name for f in want] and len(got) == 4
    n_lines = 0
    for g, w in zip(got, want):
        glines, wlines = g.read_text().splitlines(), w.read_text().splitlines()
        assert len(glines) == len(wlines), g.name
        for gl, wl in zip(glines, wlines):
            gv, wv = np.array(gl.split(), float), np.array(wl.split(), float)
            assert gv.shape == wv.shape and gv[0] == wv[0]
            xy = slice(1, -1) if save_conf else slice(1, None)
            np.testing.assert_allclose(gv[xy], wv[xy], atol=PX_ATOL / 72)
            if save_conf:
                assert abs(gv[-1] - wv[-1]) <= SCORE_ATOL
            n_lines += 1
    assert n_lines > 0


def test_batched_multistream_predict_matches_jax(models, monkeypatch):
    """N synthetic streams: one batch-N forward a step, the results split
    back per stream, equal to JAX's batched multi-stream predict."""
    port, jax = models
    frames = {str(i): shape_images(2, 48, 64, seed=20 + i) for i in range(3)}
    shapes = []
    real = P.SegmentationPredictor.eval_batch

    def spy(self, model, images):
        shapes.append(tuple(images.shape))
        return real(self, model, images)

    monkeypatch.setattr(P.SegmentationPredictor, "eval_batch", spy)
    caps = {s: SyntheticCapture(f) for s, f in frames.items()}
    got = port.predict(LoadStreams(list(caps), buffer=True, open_fn=lambda s: caps[s]),
                       imgsz=IMGSZ)
    jcaps = {s: SyntheticCapture(f) for s, f in frames.items()}
    want = jax.predict(JaxLoadStreams(list(jcaps), buffer=True, open_fn=lambda s: jcaps[s]),
                       imgsz=IMGSZ, save=False)
    assert shapes == [(3, IMGSZ, IMGSZ, 3)] * 2
    assert [r.path for r in got] == [r.path for r in want]
    assert [r.path.split("#")[0] for r in got[:3]] == ["0", "1", "2"]
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, atol=PX_ATOL)
        np.testing.assert_allclose(g.contours.points, w.contours.points, atol=PX_ATOL)
    # a list of two or more live specs asks for LoadStreams (which needs open_fn here)
    with pytest.raises(NotImplementedError, match="open_fn"):
        port.predict(["rtsp://a/1", "rtsp://b/2"], imgsz=IMGSZ)


# ---------------------------------------------------------------------------- Results


def _detections(seed=0, n=4, h=60, w=80, k=5):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (n, 2)) * [w * 0.6, h * 0.6]
    wh = rng.uniform(4, 20, (n, 2))
    boxes = np.concatenate([xy, xy + wh, rng.uniform(0.2, 1, (n, 1)),
                            rng.integers(0, 3, (n, 1))], -1).astype(np.float32)
    t = np.linspace(0, 2 * np.pi, 36, endpoint=False)
    c = (xy + wh / 2)[:, None]
    pts = (c + np.stack([np.cos(t), np.sin(t)], -1) * (wh.min(1) / 2)[:, None, None])
    valid = rng.uniform(size=(n, 36)) > 0.2
    valid[0, 2:] = False  # one contour of fewer than 3 points
    kpts = np.concatenate([rng.uniform(0, w, (n, k, 2)), rng.uniform(0, 1, (n, k, 1))], -1)
    masks = rng.uniform(size=(n, h, w)) > 0.7
    return dict(img=np.zeros((h, w, 3), np.uint8), boxes=boxes,
                contours=(pts.astype(np.float32), valid), keypoints=kpts.astype(np.float32),
                masks=masks, probs=rng.dirichlet(np.ones(5)).astype(np.float32))


NAMES = {0: "circle", 1: "rect", 2: "person", 3: "car", 4: "dog"}


def _pair(d, fields, lazy=False):
    kw = {k: d[k] for k in fields}
    return (port_results.Results(d["img"], "im.jpg", NAMES, device="cpu", lazy_masks=lazy, **kw),
            jax_results.Results(d["img"], "im.jpg", NAMES, lazy_masks=lazy, **kw))


@pytest.mark.parametrize("fields", [("boxes",), ("boxes", "contours"), ("boxes", "keypoints"),
                                    ("boxes", "masks"), ("probs",), ("masks",), ()])
def test_results_methods_match_jax(fields, tmp_path):
    d = _detections(seed=len(fields))
    got, want = _pair(d, fields)
    assert len(got) == len(want)
    assert got.keys == want.keys
    assert got.verbose() == want.verbose()
    for normalize in (False, True):
        assert got.tojson(normalize=normalize) == want.tojson(normalize=normalize)
    for save_conf in (False, True):
        a = got.save_txt(str(tmp_path / "p" / f"{save_conf}.txt"), save_conf=save_conf)
        b = want.save_txt(str(tmp_path / "j" / f"{save_conf}.txt"), save_conf=save_conf)
        assert Path(a).read_bytes() == Path(b).read_bytes()
    assert got.cpu() is got and got.numpy() is got and got.to("cpu") is got
    new = got.new()
    assert (new.orig_img is got.orig_img and new.path == got.path and new.names == got.names
            and new.keys == want.new().keys == [])
    if "boxes" in fields:
        for attr in ("xyxy", "xywh", "xyxyn", "xywhn", "conf", "cls"):
            np.testing.assert_array_equal(getattr(got.boxes, attr), getattr(want.boxes, attr))
    if "contours" in fields:
        for a, b in zip(got.contours.xy, want.contours.xy):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("idx", [0, 2, slice(1, 3), np.array([True, False, True, False])])
def test_results_getitem_matches_jax(idx):
    """Indexing keeps the leading instance axis and the lazy-masks flag (no
    fill), as JAX's."""
    d = _detections(seed=7)
    got, want = _pair(d, ("boxes", "contours", "keypoints"), lazy=True)
    g, w = got[idx], want[idx]
    assert g._masks is None and g._lazy_masks and len(g) == len(w)
    assert g.keys == w.keys
    np.testing.assert_array_equal(g.boxes.data, w.boxes.data)
    np.testing.assert_array_equal(g.contours.points, w.contours.points)
    np.testing.assert_array_equal(g.keypoints, w.keypoints)
    np.testing.assert_array_equal(g.masks.data, w.masks.data)  # filled lazily, JAX's rule
    gm, wm = _pair(d, ("boxes", "masks"))
    assert gm[idx].masks.data.shape == wm[idx].masks.data.shape
    np.testing.assert_array_equal(gm[idx].masks.data, wm[idx].masks.data)


def test_results_update_matches_jax():
    d = _detections(seed=9)
    got, want = _pair(d, ())
    for r in (got, want):
        r.update(boxes=d["boxes"][:2], masks=d["masks"][:3], probs=d["probs"])
    assert len(got) == len(want) == 2 and got.keys == want.keys
    np.testing.assert_array_equal(got.masks.data, want.masks.data)
    assert got.verbose() == want.verbose()


def test_results_len_counts_masks_only():
    """A result holding only masks counts them, as JAX's ``__len__``
    (boxes, then masks, then contours)."""
    d = _detections(seed=11)
    got, want = _pair(d, ("masks",))
    assert len(got) == len(want) == len(d["masks"]) == 4
    empty = port_results.Results(d["img"], "x", NAMES, device="cpu")
    empty.update(masks=d["masks"][:3])
    assert len(empty) == 3


def test_results_drawing_waits_for_the_annotator():
    """Drawing and saving images raise (not ported); the masks' contours
    (``Masks.xy``, ``.xyn``) are the JAX result's."""
    got, want = _pair(_detections(), ("boxes", "masks"))
    for call in (got.plot, lambda: got.save("x.jpg"), lambda: got.save_crop("crops")):
        with pytest.raises(NotImplementedError, match="not ported"):
            call()
    for a, b in zip(got.masks.xy + got.masks.xyn, want.masks.xy + want.masks.xyn):
        np.testing.assert_array_equal(a, b)
    assert len(got.masks.xy) == len(want.masks.xy)
