"""Devices, process groups and data parallelism (counterpart of the JAX
package's ``parallel/mesh.py``).

JAX builds one ``Mesh`` over every visible chip and lets GSPMD shard the
global batch: BatchNorm statistics, the loss normalizers and the gradient
are those of the global batch. The port runs one process per device (a
rank) in a ``torch.distributed`` process group and makes the same
quantities global by hand: ``BatchNorm2d`` (``nn/modules/conv.py``) reduces
its per-channel sums with ``all_sum_grad``, the losses sum their
normalizers with ``all_sum``, the step sums the gradients with
``all_reduce_grads`` before the clip. So a step on W ranks computes the
one-device step on the concatenated batch, to rounding.

- ``Mesh``, ``create_mesh``, ``build_train_mesh``: the devices and the
  ``batch`` axis, JAX's rule for how many devices a batch uses. A model
  axis (``tp > 1``) raises: tensor parallelism is not ported.
- ``initialize_distributed``: join the group that ``torchrun`` describes
  in the environment.
- ``launch(fn, devices)``: spawn one rank a device with
  ``torch.multiprocessing`` (the spawn start method); the ranks meet
  through a ``FileStore`` in a temporary directory (no TCP port to pick),
  over NCCL on distinct cards and gloo otherwise (the CPU, or ranks
  sharing a card); the group has a finite timeout. A rank that raises
  makes ``launch`` stop the others and raise with its traceback.
- ``world_size``, ``rank``, ``all_sum``, ``all_sum_grad``, ``all_max``,
  ``broadcast_float``, ``barrier``, ``all_reduce_grads``: the collectives
  the port uses, each the identity (no call into ``torch.distributed``)
  without a group or at world size 1, so one device runs today's code.
- ``replicate``, ``shard_batch``, ``rank_rows``, ``shard_microbatches``:
  copies of a module to each device, and contiguous row slices of a
  batch (JAX's ``P("batch")`` placement).

Spatial partitioning (JAX ``spatial_sharding``, ``shard_spatial``) lies on
no path and is not ported, with the model axis.
"""
from __future__ import annotations

import copy
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

BATCH = "batch"
# a collective waits at most this long for the other ranks (validation on
# rank 0 included: the other ranks wait for its fitness)
DEFAULT_TIMEOUT_S = 1800.0
TP_NOT_PORTED = ("tensor parallelism (tp > 1, a 'model' mesh axis) is not ported: ROADMAP.md "
                 "Queue 1 item 2.1")


@dataclass(frozen=True)
class Mesh:
    """Devices along named axes; the port's meshes have the ``batch`` axis
    alone."""

    devices: Tuple[torch.device, ...]
    axes: Tuple[Tuple[str, int], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        return len(self.devices)


def as_device(d) -> torch.device:
    """``torch.device(d)``, a bare ``"cuda"`` as ``cuda:0``."""
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def visible_devices() -> List[torch.device]:
    """Every visible card (JAX's ``jax.devices()``); raises without one."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device: pass the devices (e.g. ['cpu', 'cpu']) to run on "
                           "the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def resolve_devices(device) -> List[torch.device]:
    """A ``device`` argument as a list: ``"cuda"`` is every visible card, a
    list or tuple its devices, anything else that one device."""
    if isinstance(device, (list, tuple)):
        return [as_device(d) for d in device]
    if isinstance(device, str) and device == "cuda":
        return visible_devices()
    return [as_device(device)]


def create_mesh(devices: Optional[Sequence] = None, axes: Optional[Dict[str, int]] = None
                ) -> Mesh:
    """A mesh over ``devices`` (default: every visible card), 1-D along
    ``batch`` unless ``axes`` says otherwise; an axis other than ``batch``
    raises (tensor parallelism is not ported)."""
    devs = tuple(as_device(d) for d in (devices if devices is not None else visible_devices()))
    if not devs:
        raise ValueError("a mesh needs at least one device")
    axes = dict(axes or {BATCH: len(devs)})
    if any(name != BATCH and size > 1 for name, size in axes.items()):
        raise NotImplementedError(TP_NOT_PORTED)
    size = 1
    for s in axes.values():
        size *= int(s)
    if size != len(devs):
        raise ValueError(f"mesh axes {axes} need {size} devices, have {len(devs)}")
    return Mesh(devs, tuple((k, int(v)) for k, v in axes.items()))


def build_train_mesh(devices: Sequence, batch: int, tp: int = 1) -> Mesh:
    """The trainer's mesh (JAX's rule): 1-D along ``batch`` over the largest
    count of ``devices`` that divides ``batch``; ``tp > 1`` raises."""
    devices = list(devices)
    if max(1, int(tp or 1)) > 1:
        raise NotImplementedError(TP_NOT_PORTED)
    n_use = max(d for d in range(1, len(devices) + 1) if int(batch) % d == 0)
    return create_mesh(devices[:n_use])


# ---------------------------------------------------------------------------
# the process group and its collectives
# ---------------------------------------------------------------------------

def _group_active() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def world_size() -> int:
    """The size of the default process group, 1 without one."""
    return torch.distributed.get_world_size() if _group_active() else 1


def rank() -> int:
    """This process's rank, 0 without a group."""
    return torch.distributed.get_rank() if _group_active() else 0


def initialize_distributed(timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group that ``torchrun`` describes (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``): NCCL with
    ``cuda:LOCAL_RANK`` as this process's card, gloo without a card. A
    no-op without those variables, at world size 1 or in a group already.
    Returns whether a group of more than one rank is active."""
    env = os.environ
    if not _group_active() and int(env.get("WORLD_SIZE", "1")) > 1 and "RANK" in env \
            and "MASTER_ADDR" in env:
        backend = "gloo"
        if torch.cuda.is_available():
            torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
            backend = "nccl"
        torch.distributed.init_process_group(
            backend, init_method="env://", timeout=datetime.timedelta(seconds=timeout_s))
    return world_size() > 1


def global_batch(n: int) -> int:
    """The global batch of a rank's ``n`` rows: the ranks hold equal
    shares (``build_train_mesh`` picks a world size that divides the
    batch)."""
    return int(n) * world_size()


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of a detached tensor over the ranks (itself at world size
    1)."""
    if world_size() == 1:
        return t
    t = t.detach().clone()
    torch.distributed.all_reduce(t)
    return t


class _AllSum(torch.autograd.Function):
    """A sum over the ranks whose backward sums the incoming gradients over
    the ranks: the gradient of the global loss, the sum of every rank's
    share, with respect to each rank's input."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        torch.distributed.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        torch.distributed.all_reduce(g)
        return g


def all_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """``all_sum`` that gradients flow through (``_AllSum``)."""
    return t if world_size() == 1 else _AllSum.apply(t)


def all_max(n: int, device="cpu") -> int:
    """The largest of an int over the ranks."""
    if world_size() == 1:
        return int(n)
    t = torch.tensor([int(n)], dtype=torch.int64, device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return int(t.item())


def broadcast_float(x: float, src: int = 0, device="cpu") -> float:
    """Rank ``src``'s float on every rank."""
    if world_size() == 1:
        return float(x)
    t = torch.tensor([float(x)], dtype=torch.float64, device=device)
    torch.distributed.broadcast(t, src)
    return float(t.item())


def barrier():
    if world_size() > 1:
        torch.distributed.barrier()


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.Tensor]):
    """Sum every parameter's gradient over the ranks, in place: one flat
    buffer a dtype and device, one all-reduce each."""
    if world_size() == 1:
        return
    groups: Dict[Tuple, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            groups.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in groups.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        torch.distributed.all_reduce(flat)
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()


# ---------------------------------------------------------------------------
# placement helpers
# ---------------------------------------------------------------------------

def replicate(module: nn.Module, devices: Sequence) -> List[nn.Module]:
    """One copy of ``module`` on each device (a copy per entry, also where
    two entries name the same device)."""
    return [copy.deepcopy(module).to(as_device(d)) for d in devices]


def rank_rows(x, r: int, world: int, axis: int = 0):
    """Rows ``[r * b, (r + 1) * b)`` of ``x`` along ``axis``, ``b`` its
    length over ``world`` (which must divide it); a dict maps over its
    values."""
    if isinstance(x, dict):
        return {k: rank_rows(v, r, world, axis) for k, v in x.items()}
    n = x.shape[axis]
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    b = n // world
    idx = (slice(None),) * axis + (slice(r * b, (r + 1) * b),)
    return x[idx]


def shard_batch(x, n: int) -> list:
    """``x`` (an array, a tensor or a dict of them) as ``n`` contiguous
    row slices along dim 0."""
    return [rank_rows(x, r, n) for r in range(n)]


def shard_microbatches(x, r: int, world: int):
    """Rank ``r``'s rows of every micro-batch of stacked (accumulate, B,
    ...) inputs."""
    return rank_rows(x, r, world, axis=1)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

class RankFailed(RuntimeError):
    """A rank raised or died; the message holds its traceback."""


def _rank_main(r: int, world: int, store_path: str, backend: str, timeout_s: float,
               device: str, threads: int, job_path: str, results):
    """A spawned rank: load ``(fn, args)`` from ``job_path``, join the group
    through the file store, run ``fn(r, device, *args)`` and put ``(r, ok,
    result or traceback)`` on ``results``."""
    try:
        with open(job_path, "rb") as fh:
            fn, args = pickle.load(fh)
        torch.set_num_threads(max(1, int(threads)))
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank on this host
        dev = as_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = torch.distributed.FileStore(store_path, world)
        torch.distributed.init_process_group(
            backend, store=store, rank=r, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        # plain pickle bytes: tensors copied, not shared through file
        # descriptors that close with this process
        out = pickle.dumps(fn(r, dev, *args))
    except BaseException:
        results.put((r, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((r, True, out))
    torch.distributed.destroy_process_group()


def default_backend(devices: Sequence) -> str:
    """NCCL where every rank has a card of its own, gloo otherwise (the
    CPU; NCCL refuses two ranks on one card)."""
    devs = [as_device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def launch(fn: Callable, devices: Sequence, args: tuple = (), backend: Optional[str] = None,
           timeout_s: float = DEFAULT_TIMEOUT_S, threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, device, *args)`` in one spawned process a device,
    all in one process group, and return their results by rank. ``fn`` and
    ``args`` cross to the ranks by pickle (``fn`` a module-level function).
    ``backend``: ``default_backend(devices)`` if None. Each rank runs
    ``threads`` torch threads (default: the caller's count). A rank that
    raises or dies makes ``launch`` stop the others and raise
    ``RankFailed`` with its traceback."""
    import torch.multiprocessing as mp

    devices = [str(as_device(d)) for d in devices]
    world = len(devices)
    backend = backend or default_backend(devices)
    threads = torch.get_num_threads() if threads is None else int(threads)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ycr_ranks_")
    # the job crosses in a file: a process's start writes its arguments into a
    # pipe that blocks the caller if the process dies before reading them all
    job_path = os.path.join(tmp, "job.pkl")
    try:
        with open(job_path, "wb") as fh:
            pickle.dump((fn, args), fh)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, world, os.path.join(tmp, "store"), backend, timeout_s,
                               devices[r], threads, job_path, results))
             for r in range(world)]
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                r, ok, payload = results.get(timeout=0.2)
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if i not in out and p.exitcode not in (None, 0)]
                if dead:
                    try:  # its traceback may still be on its way
                        r, ok, payload = results.get(timeout=2.0)
                    except queue.Empty:
                        i, code = dead[0]
                        raise RankFailed(
                            f"rank {i} of {world} exited with code {code} before reporting "
                            "(its error output says why; spawned ranks import the main "
                            "module, which must be a file with a __main__ guard)") from None
                else:
                    continue
            if not ok:
                raise RankFailed(f"rank {r} of {world} failed:\n{payload}")
            out[r] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=60)
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
