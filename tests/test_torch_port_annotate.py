"""``auto_annotate`` and ``convert_coco`` of the port (``data/annotator.py``,
``data/converter.py``, no cv2) against the JAX package's, on the CPU:

- ``auto_annotate``'s polar mode with the seg160 checkpoint on PNG files of
  the floor set: the same files, lines, classes and point counts; the
  5-decimal coordinates within ``COORD_ATOL`` (the two networks' contours
  differ by ~1e-5 px, which can move a last decimal). On the same
  detections (a stand-in detector feeding both sides one result), the label
  files are byte-equal, in the polar mode and in the SAM mode with JAX's
  stub decoder and with seeded sam_b at img_size 64 carried over through
  the SAM weight map;
- ``convert_coco`` on a synthetic COCO json of polygons (one and several
  parts), uncompressed and compressed RLE, crowd entries, entries with a box
  only and the 91 -> 80 class map (unused ids dropped), with and without
  segments and the map: the label files byte-equal; its helpers equal."""
import json

import jax
import numpy as np
import pytest
import torch

import yolo_contour_regression_tpu.engine.model as jax_model_mod
from chip_smoke import CKPT, floor_val_set, png_bytes
from tests.test_sam_generate import OBJECTS, S
from tests.test_sam_generate import StubSam as JaxStub
from tests.test_torch_port_cuda import STUB_OBJECTS, STUB_S, StubSam
from tests.test_torch_port_sam import randomized, state_from_jax
from yolo_contour_regression_tpu.data import annotator as jax_annotator
from yolo_contour_regression_tpu.data import converter as jax_converter
from yolo_contour_regression_tpu.engine.results import Results as JaxResults
from yolo_contour_regression_tpu.models.sam import Sam as JaxSam
from yolo_contour_regression_tpu_torch.data import annotator, converter
from yolo_contour_regression_tpu_torch.engine import model as model_mod
from yolo_contour_regression_tpu_torch.engine.results import Results
from yolo_contour_regression_tpu_torch.models.sam import Sam

COORD_ATOL = 2e-5  # normalized: a last decimal (1e-5) and the networks' ~1e-5 px over 160


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.txt"))}


def test_polar_mode_with_the_network_equals_jax(tmp_path):
    images, _ = floor_val_set()
    src = tmp_path / "images"
    src.mkdir()
    for i, img in enumerate(images[:6]):
        (src / f"{i:02d}.png").write_bytes(png_bytes(img))
    jax_annotator.auto_annotate(str(src), det_model=str(CKPT), output_dir=str(tmp_path / "j"),
                                imgsz=160)
    annotator.auto_annotate(str(src), det_model=str(CKPT), output_dir=str(tmp_path / "p"),
                            imgsz=160, device="cpu")
    got, want = _files(tmp_path / "p"), _files(tmp_path / "j")
    assert list(got) == list(want) and len(got) == 6
    worst, same = 0.0, 0
    for name in want:
        gl, wl = got[name].decode().splitlines(), want[name].decode().splitlines()
        assert len(gl) == len(wl) and len(wl) > 0, name
        for g, w in zip(gl, wl):
            g, w = g.split(), w.split()
            assert g[0] == w[0] and len(g) == len(w), name
            worst = max(worst, float(np.abs(np.float64(g[1:]) - np.float64(w[1:])).max()))
        same += got[name] == want[name]
    print(f"polar mode: {same} of {len(want)} files byte-equal, worst coordinate {worst:.1e}")
    assert worst <= COORD_ATOL


class _Detector:
    """A stand-in detector: ``predict`` yields the results it was given."""

    results = []

    def __init__(self, model, **kw):
        pass

    def predict(self, source, **kw):
        yield from _Detector.results


def _annotate_both(tmp_path, monkeypatch, port_res, jax_res, port_kw, jax_kw):
    src = tmp_path / "imgs"
    src.mkdir(exist_ok=True)
    monkeypatch.setattr(jax_model_mod, "YOLO", _Detector)
    _Detector.results = jax_res
    jax_annotator.auto_annotate(str(src), output_dir=str(tmp_path / "j"), **jax_kw)
    monkeypatch.setattr(model_mod, "YOLO", _Detector)
    _Detector.results = port_res
    annotator.auto_annotate(str(src), output_dir=str(tmp_path / "p"), device="cpu", **port_kw)
    got, want = _files(tmp_path / "p"), _files(tmp_path / "j")
    assert got == want and len(got) == len(port_res)
    return got


def test_polar_mode_on_the_same_detections_byte_equal(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    pts = rng.uniform(5, 90, (3, 36, 2)).astype(np.float32)
    valid = rng.random((3, 36)) < 0.8
    valid[2, 2:] = False  # fewer than 3 points: skipped
    boxes = np.array([[5, 5, 50, 50, 0.9, 0], [20, 10, 90, 80, 0.7, 1], [1, 1, 9, 9, 0.5, 0]],
                     np.float32)
    img = np.zeros((96, 100, 3), np.uint8)
    kw = dict(names={0: "a", 1: "b"}, boxes=boxes, contours=(pts, valid))
    port_res = [Results(img, f"x{i}.jpg", device="cpu", **kw) for i in range(2)]
    jax_res = [JaxResults(img, f"x{i}.jpg", **kw) for i in range(2)]
    files = _annotate_both(tmp_path, monkeypatch, port_res, jax_res, {}, {})
    assert len(files["x0.txt"].splitlines()) == 2


def _box_results(cls, img, objects, n):
    boxes = np.array([list(o) + [0.9, k % 3] for k, o in enumerate(objects)], np.float32)
    return [cls(img, f"im{i}.png", names={0: "a", 1: "b", 2: "c"}, boxes=boxes[i:],
                **({"device": "cpu"} if cls is Results else {})) for i in range(n)]


def test_sam_mode_with_the_stub_byte_equal(tmp_path, monkeypatch):
    """JAX's stub decoder (``tests/test_sam_generate.py``) and its torch
    copy: each box's mask is its planted object's."""
    assert STUB_S == S and list(STUB_OBJECTS) == list(OBJECTS)
    img = np.full((S, S, 3), 127, np.uint8)
    files = _annotate_both(tmp_path, monkeypatch, _box_results(Results, img, OBJECTS, 2),
                           _box_results(JaxResults, img, OBJECTS, 2),
                           {"sam_model": StubSam()}, {"sam_model": JaxStub()})
    assert len(files["im0.png".replace(".png", ".txt")].splitlines()) == len(OBJECTS)


def test_sam_mode_with_seeded_sam_b_byte_equal(tmp_path, monkeypatch):
    """sam_b at full width at img_size 64 on seeded variables of JAX's
    shapes, carried into the port (``tests/test_torch_port_sam.py``); the
    boxes of a 64x64 frame of shapes prompt both."""
    js = JaxSam("sam_b", img_size=64)
    js.variables = randomized(jax.eval_shape(js.init, jax.random.PRNGKey(0)),
                              np.random.default_rng(21), noise=0.05)
    port = Sam("sam_b", img_size=64, seed=None)
    port.load_state_dict(state_from_jax(port, js.variables))
    img = np.random.default_rng(22).integers(0, 80, (64, 64, 3)).astype(np.uint8)
    for k, (x0, y0, x1, y1) in enumerate(OBJECTS):
        img[y0:y1, x0:x1] = 120 + 40 * k
    files = _annotate_both(tmp_path, monkeypatch, _box_results(Results, img, OBJECTS, 1),
                           _box_results(JaxResults, img, OBJECTS, 1),
                           {"sam_model": port.eval()}, {"sam_model": js})
    assert files["im0.txt"].strip()


def _rle_string(counts):
    """pycocotools' compressed RLE string of ``counts`` (rleToString)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr(c + (0x20 if more else 0) + 48))
    return "".join(out)


def coco_fixture(rng):
    """Two COCO json files: images of several sizes, annotations of every
    kind the converter reads."""
    files = {}
    for split in ("train", "val"):
        images, anns = [], []
        for i in range(4):
            h, w = int(rng.integers(30, 70)), int(rng.integers(30, 90))
            images.append({"id": 10 + i, "file_name": f"sub/{split}_{i}.jpg", "height": h,
                           "width": w})
            yy, xx = np.mgrid[:h, :w]
            for k in range(6):
                cat = int(rng.choice([1, 3, 12, 26, 44, 90, 91, 57]))
                m = ((yy - rng.uniform(0, h)) ** 2 + (xx - rng.uniform(0, w)) ** 2
                     < rng.uniform(9, 200)).astype(np.uint8)
                m[rng.integers(0, h):, rng.integers(0, w):] |= rng.random() < 0.3
                ann = {"id": len(anns), "image_id": 10 + i, "category_id": cat, "iscrowd": 0,
                       "bbox": [float(v) for v in rng.uniform(0, 20, 4)]}
                kind = (i + k) % 6
                if kind == 0:  # one polygon
                    ann["segmentation"] = [rng.uniform(0, w, 8).round(2).tolist()]
                elif kind == 1:  # several parts, merged
                    ann["segmentation"] = [rng.uniform(0, min(h, w), n).round(2).tolist()
                                           for n in (6, 10, 8)]
                elif kind == 2:  # uncompressed RLE, crowd
                    ann.update(iscrowd=1, segmentation=jax_converter.mask_to_rle(m))
                elif kind == 3:  # compressed RLE
                    rle = jax_converter.mask_to_rle(m)
                    ann["segmentation"] = {"size": rle["size"],
                                           "counts": _rle_string(rle["counts"])}
                elif kind == 4:  # a crowd polygon: skipped
                    ann.update(iscrowd=1, segmentation=[rng.uniform(0, w, 6).tolist()])
                else:  # a box only
                    ann.pop("iscrowd")
                anns.append(ann)
        files[f"instances_{split}.json"] = {"images": images, "annotations": anns}
    return files


@pytest.mark.parametrize("use_segments", [True, False])
@pytest.mark.parametrize("cls91to80", [True, False])
def test_convert_coco_byte_equal(tmp_path, use_segments, cls91to80):
    src = tmp_path / "json"
    src.mkdir()
    for name, data in coco_fixture(np.random.default_rng(8)).items():
        (src / name).write_text(json.dumps(data))
    for mod, out in ((jax_converter, "j"), (converter, "p")):
        assert mod.convert_coco(str(src), save_dir=str(tmp_path / out),
                                use_segments=use_segments, cls91to80=cls91to80) == str(
            tmp_path / out)
    for split in ("train", "val"):
        got, want = _files(tmp_path / "p/labels" / split), _files(tmp_path / "j/labels" / split)
        assert got == want and len(got) == 4
        assert sum(len(v.splitlines()) for v in got.values()) > 8


def test_converter_helpers_equal_jax():
    assert converter.coco91_to_coco80_class() == jax_converter.coco91_to_coco80_class()
    rng = np.random.default_rng(9)
    for _ in range(30):
        h, w = rng.integers(1, 40, 2)
        m = (rng.random((h, w)) < rng.uniform(0.1, 0.9)).astype(np.uint8)
        rle = converter.mask_to_rle(m)
        assert rle == jax_converter.mask_to_rle(m)
        s = _rle_string(rle["counts"])
        assert converter._decode_compressed_rle(s.encode()) == \
            jax_converter._decode_compressed_rle(s.encode()) == rle["counts"]
        np.testing.assert_array_equal(converter.rle_to_mask({"counts": s}, h, w), m)
        got, want = converter.mask_to_polygons(m), jax_converter.mask_to_polygons(m)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        parts = [rng.uniform(0, 50, (int(rng.integers(3, 8)), 2)).astype(np.float32)
                 for _ in range(int(rng.integers(1, 4)))]
        np.testing.assert_array_equal(converter.merge_multi_segment(parts),
                                      jax_converter.merge_multi_segment(parts))
