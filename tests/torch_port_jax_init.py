"""JAX's ``BaseModel.init`` compiled for the port's tests
(``tests/test_torch_port_rtdetr.py``, ``tests/test_torch_port_pose.py`` and
the trainer comparisons): flax's init dispatched eagerly, one operation at a
time, took most of several tests' time."""
import contextlib

import jax
import numpy as np

from yolo_contour_regression_tpu.nn import tasks as jtasks


# the compiled init of each flax module (equal modules, built from equal
# configs, share one: a second init in the process is neither traced nor
# compiled again)
_COMPILED = {}


class _CompiledInit:
    """A flax module with its ``init`` compiled as one program; every other
    attribute its own."""

    def __init__(self, module):
        self._module = module
        if module not in _COMPILED:
            _COMPILED[module] = jax.jit(module.init, static_argnames=("train",))
        self.init = _COMPILED[module]

    def __getattr__(self, name):
        return getattr(self._module, name)


def compiled_init(jm, rng, imgsz: int, init=jtasks.BaseModel.init):
    """JAX ``BaseModel.init(rng, imgsz)`` (``init``) with the flax module's
    init compiled for the call: the same variables bit for bit (checked
    against the eager init on the full-width yolov8n-seg and yolov8n-rtdetr,
    on the narrow configs of the port's tests and on the narrow pose config
    built in float64), 3-18 s where the eager init took 20-63 s, well under
    a second for a module already compiled in the process."""
    module, jm.module = jm.module, _CompiledInit(jm.module)
    try:
        return init(jm, rng, imgsz=imgsz)
    finally:
        jm.module = module


@contextlib.contextmanager
def compiled_trainer_init():
    """While open, every JAX ``BaseModel.init`` runs through
    ``compiled_init``, and a numpy copy of the variables of the last one
    (taken before a train step donates them) lands in the yielded dict's
    ``"v"``. JAX's trainer initializes its model once, so the port can start
    from those variables without a second init."""
    seen, orig = {}, jtasks.BaseModel.init

    def init(self, rng=None, imgsz: int = 640):
        rng = rng if rng is not None else jax.random.PRNGKey(0)
        v = compiled_init(self, rng, imgsz, init=orig)
        seen["v"] = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), v)
        return v

    jtasks.BaseModel.init = init
    try:
        yield seen
    finally:
        jtasks.BaseModel.init = orig
