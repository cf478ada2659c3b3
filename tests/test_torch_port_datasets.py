"""The port's datasets on disk (``data/utils.py``, the file sources of
``data/dataset.py``, ``data="x.yaml"`` in the validator, trainers and
facade) against the JAX package on the CPU: the yaml subset reader against
``yaml.safe_load`` (the test imports ``yaml``; the port may not), and its
errors; ``check_det_dataset``, ``check_cls_dataset``, ``img2label_paths``
and the image scan against JAX's; the datasets' items from files against
JAX's ``YOLODataset`` and ``ClassificationDataset`` byte for byte; and
``YOLO(ckpt).val(data=yaml)`` against JAX's metrics."""
import copy
import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tests.helpers import make_cls_dataset, make_pose_dataset, make_shape_dataset
from yolo_contour_regression_tpu.cfg import DATASETS_DIR as JAX_DATASETS_DIR
from yolo_contour_regression_tpu.data import dataset as jdataset
from yolo_contour_regression_tpu.data import utils as jutils
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu_torch import YOLO
from yolo_contour_regression_tpu_torch.cfg import DATASETS_DIR
from yolo_contour_regression_tpu_torch.data import dataset as tdataset
from yolo_contour_regression_tpu_torch.data import utils as tutils
from yolo_contour_regression_tpu_torch.nn.tasks import YOLOV8_SEG

ROOT = Path(__file__).resolve().parent.parent
SEG_CKPT = ROOT / "runs" / "floor_seg160" / "best.ckpt"
METRIC_ATOL = 0.01


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sets")
    return {"shape": make_shape_dataset(tmp / "shape", n_train=4, n_val=8, imgsz=96, seed=3),
            "wide": make_shape_dataset(tmp / "wide", n_train=2, n_val=3, imgsz=96, img_w=128,
                                       seed=4),
            "pose": make_pose_dataset(tmp / "pose", n_train=2, n_val=3, imgsz=96, seed=5),
            "cls": make_cls_dataset(tmp / "cls", n_train=3, n_val=2, imgsz=48, seed=6),
            "tmp": tmp}


# --- the yaml subset ----------------------------------------------------------

JAX_YAMLS = sorted(JAX_DATASETS_DIR.glob("*.yaml"))

SUBSET_CASES = {
    "comments_and_quotes": "# head\npath: ../x  # tail\nname: 'it''s'\nq: \"a # b\\tc\"\n",
    "flow_lists": "kpt_shape: [17, 3]\nflip_idx: [0, 2, 1, 4, 3]\nnested: [[1, 2], [], ['a', b]]\n",
    "names_list": "names:\n  - person\n  - 'bi cycle'\n  -  car\nnc: 3\n",
    "names_map": "names:\n  0: person\n  1: bicycle\n  '2': quoted key\n",
    "list_at_key_indent": "train:\n- a/images\n- b/images\nval: c\n",
    "scalars": ("a: yes\nb: Off\nc: ~\nd: null\ne: 0x1F\nf: 010\ng: 1_000\nh: 1e-3\ni: .5\n"
                "j: -.inf\nk: 1:30\nl: 2.5e+3\nm: +7\nn: -0\no: true\np:\n"),
    "nested_maps": "a:\n  b:\n    c: 1\n    d: [x]\n  e: f\ng: h\n",
    "nested_lists": "a:\n  -\n    - 1\n    - 2\n  - 3\n",
}

BAD_CASES = {
    "anchor": ("a: &x 1\n", 1), "alias": ("a: 1\nb: *x\n", 2), "flow_map": ("a: {b: 1}\n", 1),
    "block_scalar": ("a: |\n  text\n", 1), "map_in_list": ("a:\n  - b: 1\n", 2),
    "multiline_scalar": ("a: b\n  c\n", 2), "document": ("---\na: 1\n", 1),
    "unterminated": ("a: 'b\n", 1), "tag": ("a: !!str 1\n", 1), "tab": ("a:\n\t- 1\n", 2),
    "duplicate": ("a: 1\na: 2\n", 2),
}


@pytest.mark.parametrize("path", JAX_YAMLS, ids=lambda p: p.name)
def test_yaml_reader_equals_safe_load_on_the_dataset_yamls(path):
    """Every yaml of the JAX package's ``cfg/datasets/``; the port keeps
    byte-equal copies of them under its own ``DATASETS_DIR``."""
    with open(path) as fh:
        assert tutils.load_yaml(path) == yaml.safe_load(fh)
    assert filecmp.cmp(path, DATASETS_DIR / path.name, shallow=False)


@pytest.mark.parametrize("kind", ["shape", "pose"])
def test_yaml_reader_equals_safe_load_on_the_test_sets(sets, kind):
    with open(sets[kind]) as fh:
        assert tutils.load_yaml(sets[kind]) == yaml.safe_load(fh)


@pytest.mark.parametrize("name", list(SUBSET_CASES))
def test_yaml_reader_equals_safe_load_on_the_subset(name):
    text = SUBSET_CASES[name]
    got, want = tutils.parse_yaml(text), yaml.safe_load(text)
    assert got == want or (repr(got) == repr(want)), (got, want)


@pytest.mark.parametrize("name", list(BAD_CASES))
def test_yaml_reader_refuses_the_rest_with_a_line_number(name):
    text, line = BAD_CASES[name]
    with pytest.raises(tutils.YamlSubsetError, match=f"line {line}:"):
        tutils.parse_yaml(text)


# --- dataset resolution and scans ------------------------------------------------

def _det_variants(sets):
    """Dataset yamls of several forms, on the shape set's files."""
    tmp, shape = sets["tmp"], sets["shape"]
    root = shape.parent
    out = {"shape": shape, "pose": sets["pose"], "wide": sets["wide"]}
    forms = {
        "names_list_relative_path": "path: shape\ntrain: images/train\nval: images/val\n"
                                    "names: [circle, rect]\n",
        "nc_only_no_val": f"path: {root}\ntrain: images/train\ntest: images/val\nnc: 2\n",
        "no_path": f"train: {root}/images/train\nval: {root}/images/val\nnames:\n  0: a\n  1: b\n",
        "txt_list": f"path: {root}\ntrain: train.txt\nval: images/val\nnames: [a, b]\n",
    }
    (root / "train.txt").write_text("\n".join(
        f"./images/train/{p.name}" for p in sorted((root / "images" / "train").iterdir())))
    for name, text in forms.items():
        p = tmp / f"{name}.yaml"
        p.write_text(text)
        out[name] = p
    return out


def test_check_det_dataset_equals_jax(sets):
    """Split paths, names, nc and the yaml's other keys: JAX's, for yamls
    and for the dict form."""
    for name, p in _det_variants(sets).items():
        got, want = tutils.check_det_dataset(str(p)), jutils.check_det_dataset(str(p))
        assert got == want, name
    d = {"path": str(sets["shape"].parent), "train": "images/train", "val": "images/val",
         "names": ["a", "b"]}
    assert tutils.check_det_dataset(dict(d)) == jutils.check_det_dataset(dict(d))


def test_check_det_dataset_raises_on_a_missing_split(sets):
    """A ``val`` split not on disk raises and names it (JAX would run the
    yaml's download); a yaml found nowhere raises too; a bare name is
    looked up in ``DATASETS_DIR`` (the copies name splits not on disk)."""
    p = sets["tmp"] / "missing.yaml"
    p.write_text("path: nowhere\ntrain: images/train\nval: images/val\nnames: [a]\n"
                 "download: https://example.invalid/x.zip\n")
    with pytest.raises(FileNotFoundError, match="split 'val' not found.*download"):
        tutils.check_det_dataset(str(p))
    with pytest.raises(FileNotFoundError, match="dataset yaml not found"):
        tutils.check_det_dataset(str(sets["tmp"] / "absent.yaml"))
    with pytest.raises(FileNotFoundError, match="coco8-seg"):
        tutils.check_det_dataset("coco8-seg.yaml")


def test_check_cls_dataset_equals_jax(sets):
    """A root with ``train/`` and ``val/``; a root of class folders alone
    (train and val the root)."""
    root = sets["cls"]
    assert tutils.check_cls_dataset(str(root)) == jutils.check_cls_dataset(str(root))
    assert tutils.check_cls_dataset(str(root / "train")) == jutils.check_cls_dataset(
        str(root / "train"))
    with pytest.raises(FileNotFoundError):
        tutils.check_cls_dataset(str(root / "absent"))


def test_scan_and_label_paths_equal_jax(sets):
    """The image files of a directory, a ``.txt`` list, a file and a list
    of those are JAX ``YOLODataset``'s ``im_files``; their label paths are
    ``img2label_paths``'."""
    root = sets["shape"].parent
    _det_variants(sets)  # writes train.txt
    for src in (str(root / "images" / "val"), str(root / "train.txt"),
                str(root / "images" / "val" / "0001.jpg"),
                [str(root / "images" / "train"), str(root / "images" / "val")]):
        want = jdataset.YOLODataset(src, imgsz=64, cache=False).im_files
        assert tutils.scan_images(src) == want, src
        assert tutils.img2label_paths(want) == jutils.img2label_paths(want)
        assert [tdataset.img2label_path(f) for f in want] == jutils.img2label_paths(want)
    with pytest.raises(FileNotFoundError):
        tutils.scan_images(str(root / "absent"))


# --- datasets from files -----------------------------------------------------------

def _same_items(td, jd, n, float_img):
    assert len(td) == len(jd) == n
    for i in range(n):
        t, j = td[i], jd[i]
        assert set(t) == set(j)
        for k in j:
            got = t[k].astype(np.float32) / 255.0 if (k == "img" and float_img) else t[k]
            assert got.dtype == j[k].dtype, k
            np.testing.assert_array_equal(got, j[k], err_msg=f"{i} {k}")


@pytest.mark.parametrize("kind,imgsz", [("shape", 64), ("shape", 128), ("wide", 64),
                                        ("pose", 64)])
def test_val_dataset_from_files_equals_jax(sets, kind, imgsz):
    """``ValDataset(split)`` (files decoded by ``data/imcodec.py``, labels
    from the files beside them, shrunk by INTER_AREA or enlarged by
    INTER_LINEAR as JAX's val mode) gives JAX ``YOLODataset``'s val items
    byte for byte (the port's uint8 image as float / 255)."""
    data = jutils.check_det_dataset(str(sets[kind]))
    kpt = data.get("kpt_shape")
    jd = jdataset.YOLODataset(data["val"], imgsz=imgsz, augment=False, cache=False,
                              kpt_shape=kpt)
    td = tdataset.ValDataset(data["val"], imgsz=imgsz, kpt_shape=kpt)
    _same_items(td, jd, len(jd.im_files), float_img=True)


@pytest.mark.parametrize("kind", ["shape", "wide"])
def test_train_dataset_from_files_equals_jax_raw_mode(sets, kind):
    """``TrainDataset(split)`` for the augmentation on the device: JAX's
    raw items (letterboxed with upscaling, uint8 BGR, the letterbox
    geometry), byte for byte; ``fraction`` keeps the same first files."""
    data = jutils.check_det_dataset(str(sets[kind]))
    jd = jdataset.YOLODataset(data["train"], imgsz=64, augment=True, cache=False,
                              device_augment=True)
    td = tdataset.TrainDataset(data["train"], imgsz=64, device_augment=True)
    _same_items(td, jd, len(jd.im_files), float_img=False)
    jf = jdataset.YOLODataset(data["train"], imgsz=64, augment=True, cache=False,
                              device_augment=True, fraction=0.5)
    tf = tdataset.TrainDataset(data["train"], imgsz=64, device_augment=True, fraction=0.5)
    assert tf.files == jf.im_files
    _same_items(tf, jf, len(jf.im_files), float_img=False)


def test_classification_dataset_from_folders_equals_jax(sets):
    """``ClassificationDataset(root)``: JAX's samples (the sorted class
    folders numbered) and eval items, byte for byte."""
    root = sets["cls"] / "val"
    jd = jdataset.ClassificationDataset(str(root), imgsz=32)
    td = tdataset.ClassificationDataset(str(root), imgsz=32)
    assert td.classes == jd.classes and td.images == [f for f, _ in jd.samples]
    _same_items(td, jd, len(jd.samples), float_img=False)


def test_cache_keeps_resized_copies(sets):
    """With ``cache`` the resized image is kept after its first decode;
    without it every read decodes again, with the same bytes."""
    val = jutils.check_det_dataset(str(sets["wide"]))["val"]
    cached, fresh = tdataset.ValDataset(val, imgsz=64), tdataset.ValDataset(val, imgsz=64,
                                                                            cache=False)
    a, b = cached[0], fresh[0]
    assert cached.images[0] is not None and cached.images[0].shape[:2] == (48, 64)
    assert fresh.images[0] is None
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# --- data="x.yaml" end to end ------------------------------------------------------

def test_val_data_yaml_matches_jax(sets):
    """``YOLO(runs/floor_seg160/best.ckpt).val(data=yaml)`` in the port on
    the shape set's val split (8 JPEGs on disk) against JAX's validator on
    the same yaml: each metric within 0.01."""
    p = str(sets["shape"])
    want = JaxYOLO(str(SEG_CKPT)).val(data=p, imgsz=96, batch=4,
                                      project=str(sets["tmp"] / "jax_runs"))
    got = YOLO(SEG_CKPT, device="cpu").val(data=p, imgsz=96, batch=4)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])
    assert got["metrics/mAP50-95(M)"] > 0


def test_train_and_val_from_yaml(sets):
    """``train(data=yaml)`` reads both splits from disk and records the
    yaml; the trained checkpoint's ``val()`` takes that yaml's val split
    by default (a checkpoint whose yaml is gone raises); classify trains
    and validates from a folder root."""
    narrow = copy.deepcopy(YOLOV8_SEG)
    narrow.update(nc=2, scale="t", scales={"t": [0.33, 0.125, 256]})
    project = sets["tmp"] / "runs"
    m = YOLO("yolov8n-seg.yaml", device="cpu")
    metrics = m.train(data=str(sets["shape"]), model=narrow, epochs=1, imgsz=64, batch=2, nbs=2,
                      workers=1, project=str(project), name="seg")
    assert m.trainer.state.step == 2 and m.trainer.args.data == str(sets["shape"])
    assert m.ckpt_path.name == "best.ckpt" and m.overrides["data"] == str(sets["shape"])
    again = m.val(imgsz=64, batch=2)
    assert again == m.val(data=str(sets["shape"]), imgsz=64, batch=2)
    assert set(again) == set(metrics)
    c = YOLO("yolov8n-cls.yaml", device="cpu")
    c.train(data=str(sets["cls"]), epochs=1, imgsz=32, batch=2, nbs=2, workers=1,
            project=str(project), name="cls")
    assert c.trainer.state.step == 3  # 6 train images, batch 2
    top1 = c.val(data=str(sets["cls"]), imgsz=32)["metrics/accuracy_top1"]
    assert 0.0 <= top1 <= 1.0
    # the floor checkpoint's training yaml is not in the repository
    with pytest.raises(FileNotFoundError, match="floor_seg160/dataset/data.yaml"):
        YOLO(SEG_CKPT, device="cpu").val()
