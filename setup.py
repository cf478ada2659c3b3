"""Package metadata + console scripts (reference setup.py:76 registers the
``yolo``/``ultralytics`` console scripts; ours registers ``yolo`` and
``ycr``)."""
from pathlib import Path

from setuptools import find_packages, setup

setup(
    name="yolo_contour_regression_tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas/pjit) polar contour-regression instance "
        "segmentation framework with the capabilities of "
        "ai4in/YOLO-Contour-Regression"
    ),
    long_description=(Path(__file__).parent / "README.md").read_text(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=["yolo_contour_regression_tpu*"]),
    include_package_data=True,
    package_data={
        "yolo_contour_regression_tpu": ["cfg/*.yaml", "cfg/**/*.yaml"],
        "yolo_contour_regression_tpu_torch": ["csrc/*.cu", "cfg/datasets/*.yaml"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "numpy", "pyyaml", "opencv-python",
    ],
    entry_points={
        "console_scripts": [
            "yolo=yolo_contour_regression_tpu.cfg:entrypoint",
            "ycr=yolo_contour_regression_tpu.cfg:entrypoint",
        ],
    },
)
