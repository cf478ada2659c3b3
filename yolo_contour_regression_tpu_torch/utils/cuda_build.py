"""Build a CUDA source of this package into a shared library and load it.

Each ``csrc/*.cu`` file exposes a plain C interface (pointers, ints and the
stream; no PyTorch headers), so ``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The library goes into ``yolo_contour_regression_tpu_torch/_build/`` (listed
in ``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt on first use. A file lock keeps two processes from building
the same library at once. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the kernels reproduce their plain PyTorch versions
    # bit for bit
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, named by its source and flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not out.exists():  # another process may have built it meanwhile
                tmp = out.with_suffix(f".tmp{os.getpid()}.so")
                cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"nvcc failed ({res.returncode}) for {name}.cu:\n{res.stdout}{res.stderr}"
                    )
                tmp.replace(out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    return ctypes.CDLL(str(build(name)))
