"""Checks (counterpart of the JAX package's ``utils/checks.py``):
``check_imgsz``, ``check_version``, ``check_file`` (local files only: this
port fetches nothing), ``print_args`` and ``check_yolo``, the environment
summary of ``yolo checks`` (Python, torch, CUDA and the cards in place of
jax and flax)."""
from __future__ import annotations

import glob
import logging
import math
import platform
import re
import sys
from pathlib import Path
from typing import Optional

import torch

LOGGER = logging.getLogger(__name__)


def check_imgsz(imgsz, stride: int = 32, min_dim: int = 1, floor: int = 0):
    """The image size rounded up to a multiple of ``stride`` (JAX's
    ``check_imgsz``): an int for an int with ``min_dim`` 1, else a list."""
    sizes = [imgsz] if isinstance(imgsz, int) else list(imgsz)
    new = [max(math.ceil(s / stride) * stride, floor) for s in sizes]
    if new != sizes:
        LOGGER.warning(f"imgsz {sizes} must be multiple of stride {stride}; using {new}")
    if min_dim == 1 and isinstance(imgsz, int):
        return new[0]
    if len(new) == 1:
        return [new[0], new[0]]
    return new


def parse_version(v: str):
    return tuple(int(x) for x in re.findall(r"\d+", str(v))[:3] or [0])


def check_version(current: str, required: str = "0.0.0", name: str = "version",
                  hard: bool = False) -> bool:
    """Whether ``current`` meets a ``'>=1.2.3'``-style constraint; logs (or
    with ``hard`` raises) when it does not."""
    m = re.match(r"([<>=!]+)?\s*([\d.]+)", required.strip())
    op = m.group(1) or ">="
    want, cur = parse_version(m.group(2)), parse_version(current)
    ok = {">=": cur >= want, "<=": cur <= want, "==": cur == want,
          ">": cur > want, "<": cur < want, "!=": cur != want}[op]
    if not ok:
        msg = f"{name}{required} required, found {current}"
        if hard:
            raise ModuleNotFoundError(msg)
        LOGGER.warning(msg)
    return ok


def check_file(file) -> str:
    """A local file: the path as given, then the port's dataset yamls
    (``cfg/datasets``), then a search below the working directory. A URL
    raises: nothing is fetched."""
    if not file or str(file).startswith(("http://", "https://")):
        raise FileNotFoundError(f"cannot fetch remote files: {file}")
    f = Path(file)
    if f.exists():
        return str(f)
    from ..cfg import DATASETS_DIR

    if (DATASETS_DIR / f.name).exists():
        return str(DATASETS_DIR / f.name)
    hits = glob.glob(f"**/{f.name}", recursive=True)
    if hits:
        return hits[0]
    raise FileNotFoundError(f"'{file}' not found")


def print_args(args: Optional[dict] = None):
    LOGGER.info("args: " + ", ".join(f"{k}={v}" for k, v in (args or {}).items()))


def check_yolo(verbose: bool = True) -> dict:
    """The environment of ``yolo checks``: the port's version, Python, the
    platform, torch and its CUDA, and each visible card's name (or the CPU)."""
    from .. import __version__

    info = {"version": __version__, "python": sys.version.split()[0],
            "platform": platform.platform(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "cuda_available": torch.cuda.is_available()}
    if info["cuda_available"]:
        info["devices"] = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    else:
        info["devices"] = ["cpu"]
    if verbose:
        for k, v in info.items():
            LOGGER.info(f"{k}: {v}")
    return info
