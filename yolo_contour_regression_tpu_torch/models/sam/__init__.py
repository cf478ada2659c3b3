"""SAM, MobileSAM and everything mode (counterpart of the JAX package's
``models/sam/``)."""
from .amg import generate_crop_boxes, point_grid, stability_score
from .model import SAM, Predictor, Sam, build_sam

__all__ = ["SAM", "Sam", "Predictor", "build_sam", "point_grid", "generate_crop_boxes",
           "stability_score"]
