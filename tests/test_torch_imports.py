"""The PyTorch port imports nothing that a CUDA machine with only torch,
numpy and the standard library lacks: in a fresh interpreter that refuses
jax, flax, optax, cv2, PIL, yaml, torchvision, triton and the JAX package,
every module of the port and ``chip_smoke`` import, and the CPU predict runs
on the committed seg160 checkpoint."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "cv2", "PIL", "yaml", "torchvision", "triton",
           "yolo_contour_regression_tpu")

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = set(sys.argv[1].split(","))

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked: {name}", name=name)
        return None

for name in list(sys.modules):  # anything a site hook imported already
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())

import numpy as np
import yolo_contour_regression_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke

model = pkg.YOLO("runs/floor_seg160/best.ckpt", device="cpu")
res = model.predict(chip_smoke.shape_images(2, 120, 200, seed=0), imgsz=160)
assert sum(len(r) for r in res) > 0
assert all(r.masks.data.shape[1:] == (120, 200) for r in res)
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(mods), "modules;", sum(len(r) for r in res), "detections")
"""


def test_port_imports_and_predicts_without_jax_cv2_yaml_triton():
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, ",".join(BLOCKED)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "detections" in res.stdout
    n_mods = int(res.stdout.split("imported ")[1].split()[0])
    assert n_mods >= 15  # ops, nn, utils, engine, data modules of the port
