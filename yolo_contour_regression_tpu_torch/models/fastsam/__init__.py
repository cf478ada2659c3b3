"""FastSAM: everything mode by the polar segment model, then prompts on its
masks (counterpart of the JAX package's ``models/fastsam/``)."""
from .model import FastSAM
from .prompt import FastSAMPrompt

__all__ = ["FastSAM", "FastSAMPrompt"]
