"""The port's ``yolo`` CLI (``cfg/__init__.py:entrypoint``,
``python -m yolo_contour_regression_tpu_torch``) against the JAX
package's on the CPU: ``parse_key_value_args`` types values as JAX's
(``yaml.safe_load``) on a table of strings; ``cfg`` prints the defaults as
yaml that ``yaml.safe_load`` reads back to JAX's ``DEFAULT_CFG`` on every
key; ``segment val`` gives ``YOLO.val``'s metrics exactly; the special
commands; the mode that is not ported raises."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from tests.helpers import make_shape_dataset
from yolo_contour_regression_tpu import cfg as jcfg
from yolo_contour_regression_tpu_torch import YOLO, __version__
from yolo_contour_regression_tpu_torch import cfg as tcfg
from yolo_contour_regression_tpu_torch.data.utils import parse_yaml
from yolo_contour_regression_tpu_torch.utils import settings as tsettings

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs" / "floor_seg160" / "best.ckpt"


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads beside the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ARGS = ["epochs=3", "lr0=0.01", "lr0=1e-3", "momentum=.9", "imgsz=640", "imgsz=[640, 480]",
        "batch=-1", "amp=True", "amp=false", "val=no", "save=yes", "plots=Off", "conf=null",
        "conf=~", "name=", "model=runs/floor_seg160/best.ckpt", "data=/abs/path/data.yaml",
        "source=https://host/a.jpg", "name=a=b", "project=x:y", "classes=[0, 2]",
        "tracker='botsort.yaml'", 'name="quoted # not a comment"', "name=text # comment",
        "seed=0x1F", "seed=010", "lr0=1_000.5", "fraction=.inf", "device=0", "device=cuda:0",
        "optimizer=auto", "resume=runs/x/last.ckpt", "save_period=-1", "k=v1,v2", "mode=",
        "hsv_h=0.015", "flag=True", "names=[a, 'b c']", "noequals", "close_mosaic=15.0"]


def test_parse_key_value_args_matches_jax():
    """The same dict as JAX's for each of the strings (numbers, yaml 1.1
    booleans, null, lists, paths, URLs, strings with '=', ':' and '#',
    octal and hexadecimal, quoted strings, an argument without '=')."""
    for a in ARGS:
        assert tcfg.parse_key_value_args([a]) == jcfg.parse_key_value_args([a]), a
    assert tcfg.parse_key_value_args(ARGS) == jcfg.parse_key_value_args(ARGS)


def test_cfg_prints_the_defaults(capsys, tmp_path, monkeypatch):
    """``yolo cfg`` prints yaml that ``yaml.safe_load`` reads back to JAX's
    ``DEFAULT_CFG`` on every key the port has (it has them all) and the
    port's reader to the port's; ``copy-cfg`` writes the same text to
    ``default_copy.yaml`` in the working directory."""
    assert tcfg.entrypoint(["cfg"]) == 0
    text = capsys.readouterr().out
    got = yaml.safe_load(text)
    assert list(got) == list(tcfg.DEFAULT_CFG) and set(got) == set(jcfg.DEFAULT_CFG_DICT)
    for k, v in got.items():
        assert v == jcfg.DEFAULT_CFG_DICT[k] and type(v) is type(jcfg.DEFAULT_CFG_DICT[k]), k
    assert parse_yaml(text) == tcfg.DEFAULT_CFG
    monkeypatch.chdir(tmp_path)
    assert tcfg.entrypoint(["copy-cfg"]) == 0
    assert (tmp_path / "default_copy.yaml").read_text() == text


@pytest.mark.parametrize("value", [1e-05, 2.5e+20, 3.0, -0.0, "yes", "null", "3", "a: b",
                                   "'q'", " pad", "x # y", "[1]", "", "0x10", "botsort.yaml"])
def test_yaml_scalars_read_back(value):
    """Each scalar ``cfg`` writes reads back, by ``yaml.safe_load``, to the
    value with its type."""
    got = yaml.safe_load(f"k: {tcfg._yaml_scalar(value)}")["k"]
    assert got == value and type(got) is type(value)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_shape_dataset(tmp_path_factory.mktemp("cli") / "ds", n_train=4, n_val=4,
                              imgsz=64, seed=3)


def test_segment_val_gives_the_facade_metrics(dataset, capsys):
    """``yolo segment val model=<seg160 best.ckpt> data=<yaml>`` prints the
    metrics ``YOLO(ckpt).val(data=yaml)`` returns, exactly, exit code 0; an
    argument val does not take is dropped."""
    argv = ["segment", "val", f"model={CKPT}", f"data={dataset}", "device=cpu", "imgsz=64",
            "batch=4", "plots=False"]
    assert tcfg.entrypoint(argv) == 0
    printed = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    want = YOLO(CKPT, device="cpu").val(data=str(dataset), imgsz=64, batch=4)
    assert printed == want


def test_segment_predict_and_train(dataset, capsys, tmp_path):
    """``yolo predict`` on an image file prints a result for it (the task
    from the checkpoint); ``yolo segment train`` trains the named config
    and prints its metrics."""
    img = sorted((dataset.parent / "images" / "val").glob("*.jpg"))[0]
    assert tcfg.entrypoint(["predict", f"model={CKPT}", f"source={img}", "device=cpu",
                            "imgsz=64"]) == 0
    assert capsys.readouterr().out.strip()
    argv = ["segment", "train", "model=yolov8n-seg.yaml", f"data={dataset}", "epochs=1",
            "imgsz=64", "batch=2", "nbs=2", "workers=1", "device=cpu", f"project={tmp_path}"]
    assert tcfg.entrypoint(argv) == 0
    metrics = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert "metrics/mAP50-95(M)" in metrics
    assert (tmp_path / "segment_train" / "weights" / "best.ckpt").exists()


def test_special_commands(capsys, tmp_path, monkeypatch):
    """help, version, checks (Python, torch and the device in place of jax
    and flax), settings (a json file; reset), and what raises: hub (the
    network), export of a format the port does not write (the facade's
    recipe), an unknown mode. benchmark is a mode the CLI runs (its run:
    ``tests/test_torch_port_benchmarks.py``)."""
    for argv in ([], ["help"], ["--help"]):
        assert tcfg.entrypoint(argv) == 0
        assert "usage: yolo TASK MODE" in capsys.readouterr().out
    assert tcfg.entrypoint(["version"]) == 0
    assert capsys.readouterr().out.strip() == __version__
    assert tcfg.entrypoint(["checks"]) == 0
    out = capsys.readouterr().out
    assert f"torch: {torch.__version__}" in out and "python:" in out and "devices:" in out
    monkeypatch.setattr(tsettings, "SETTINGS_PATH", tmp_path / "settings.json")
    monkeypatch.setattr(tsettings, "SETTINGS", None)
    assert tcfg.entrypoint(["settings"]) == 0
    assert "runs_dir=runs" in capsys.readouterr().out
    (tmp_path / "settings.json").write_text("{not json")
    monkeypatch.setattr(tsettings, "SETTINGS", None)
    assert tcfg.entrypoint(["settings", "reset"]) == 0
    assert "settings reset" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="network"):
        tcfg.entrypoint(["hub", "login", "KEY"])
    assert "benchmark" in tcfg.MODES and not hasattr(tcfg, "NOT_PORTED")
    with pytest.raises(NotImplementedError, match="Offline recipe"):
        tcfg.entrypoint(["detect", "export", "format=tflite", "device=cpu"])
    with pytest.raises(ValueError, match="mode"):
        tcfg.entrypoint(["mode=fly"])


def test_python_dash_m_runs_the_cli():
    """``python -m yolo_contour_regression_tpu_torch version`` exits 0 and
    prints the version."""
    res = subprocess.run([sys.executable, "-m", "yolo_contour_regression_tpu_torch", "version"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == __version__, res.stderr[-2000:]
