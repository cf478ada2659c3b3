"""``python -m yolo_contour_regression_tpu_torch`` is the ``yolo`` CLI
(``cfg/__init__.py:entrypoint``)."""
import sys

from .cfg import entrypoint

if __name__ == "__main__":
    sys.exit(entrypoint() or 0)
