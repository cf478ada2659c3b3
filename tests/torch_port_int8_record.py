"""Writes JAX's int8 record of the seg160 checkpoint,
``tests/data/torch_port_int8_seg160.npz``, which the port's CPU tests
(``tests/test_torch_port_quant.py``) and ``chip_smoke.py``'s int8 phase hold
the port's int8 model to::

    JAX_PLATFORMS=cpu python -m tests.torch_port_int8_record

The JAX package quantizes ``runs/floor_seg160/best.ckpt`` (``YOLO.quantize``:
its fuse, then calibration) on ``chip_smoke.int8_calib_batches()`` (the 16
floor val frames at 160, RGB in [0, 1], batches of 4), and validates the
int8 model on the floor set as its validator reads it (``make_shape_dataset``
at ``floor.json``'s config; the committed frames are their cv2 decodes) at
160, batch 4. The record keeps the calibration (key, absmax, shape
features), the quantize counts, the eight metrics and fitness, and the int8
model's raw head outputs on the first ``HEAD_FRAMES`` calibration frames.
"""
import json
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from chip_smoke import CKPT, INT8_IMGSZ, INT8_RECORD, int8_calib_batches
from tests.helpers import make_shape_dataset
from yolo_contour_regression_tpu.engine.model import YOLO as JaxYOLO
from yolo_contour_regression_tpu.nn import quant as jquant

ROOT = Path(__file__).resolve().parent.parent
FLOOR = json.loads((ROOT / "runs" / "floor_seg160" / "floor.json").read_text())
HEAD_FRAMES = 2
FEATURES = ("h", "w", "cin", "cout", "groups")


def jax_int8_record(project: Path) -> dict:
    """JAX's quantize of the seg160 checkpoint on the int8 calibration
    batches, its counts, its metrics on the floor set and its head outputs
    (see the module docstring)."""
    calib = int8_calib_batches()
    m = JaxYOLO(str(CKPT))
    m.fuse()
    cal = jquant.calibrate(m.model, m.variables, calib)
    _, n_q, n_skip = jquant.quantize_tree(m.variables["params"], cal)
    m.quantize(calib)
    cfg = FLOOR["config"]
    yaml = make_shape_dataset(project / "floor", n_train=cfg["n_train"], n_val=cfg["n_val"],
                              imgsz=cfg["imgsz"], seed=cfg["seed"])
    metrics = m.val(data=str(yaml), imgsz=INT8_IMGSZ, batch=4, plots=False,
                    project=str(project / "runs"))
    heads = m.model.raw_forward(m.variables, jnp.asarray(calib[0][:HEAD_FRAMES]))
    return {"cal": cal, "n_quantized": n_q, "n_skipped": n_skip,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "heads": [np.asarray(h, np.float32) for h in jax.tree_util.tree_leaves(heads)]}


def main():
    with tempfile.TemporaryDirectory() as d:
        rec = jax_int8_record(Path(d))
    keys = list(rec["cal"])
    np.savez_compressed(
        INT8_RECORD, written_by=np.array("tests/torch_port_int8_record.py"),
        cal_keys=np.array(keys), cal_absmax=np.array([rec["cal"][k]["absmax"] for k in keys]),
        cal_features=np.array([[rec["cal"][k][f] for f in FEATURES] for k in keys]),
        n_quantized=rec["n_quantized"], n_skipped=rec["n_skipped"],
        metric_names=np.array(list(rec["metrics"])),
        metrics=np.array(list(rec["metrics"].values())), head_frames=HEAD_FRAMES,
        n_heads=len(rec["heads"]), **{f"head_{i}": h for i, h in enumerate(rec["heads"])})
    print(INT8_RECORD, rec["n_quantized"], rec["n_skipped"], rec["metrics"])


if __name__ == "__main__":
    main()
