"""Process groups for data parallelism: the port's counterpart of
tpu_asr/parallel/mesh.py, with one process per rank and `torch.distributed`
(NCCL between cards, gloo on the CPU or for ranks that share a card) in
place of JAX's `data` mesh axis.

The contract is that of JAX's single-process mesh: a run with N ranks takes
the steps that the same flags take on one rank. Every step has one global
batch, split into N equal blocks of rows (data/dataset.py), and rank r holds
rows [r B/N, (r+1) B/N). So a rank's rows begin at `row_offset(n)` of a
global batch of `global_rows(n)` rows, where n is its own row count, for the
batch and for any tensor whose rows are batch-major (row = b * L + l).

- Losses are shares: each rank's loss is its part of the single-rank loss,
  its own sum over the global normaliser (`batch_mean` for an element mean,
  `global_sum` for a data-dependent count), so the shares add up to the
  single-rank loss and the gradients are summed across ranks
  (train/trainer.py).
- Statistics over the batch (BatchNorm, the router's aggregation) reduce
  across ranks: `global_mean` through the differentiable `all_reduce_sum`,
  `all_gather_rows` for small integer vectors.
- Random draws that depend on the row (dither, SpecAugment, Gumbel, noise)
  are drawn at the global batch's shape and cut to the rank's rows
  (`draw_rows`); the dropout streams are counter hashes of the row, so a
  rank shifts its base seeds by its row offset.

Host scalars (`cross_process_sum`, `broadcast_int`, `sync_processes`, the
preemption flag) go through a gloo group on the CPU beside the default
group, so reading them never waits for the card. Every call is a no-op, and
every helper the identity, when no group is initialised or the world is one
rank: single-rank code paths are unchanged.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_CONTROL = {"group": None}


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def is_main_process() -> bool:
    """The rank that owns side effects on the file system (metrics,
    checkpoints, rotation, the tokenizer sidecar): Lightning's
    rank_zero_only."""
    return process_index() == 0


def init_distributed(world: Optional[int] = None, rank: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     init_method: Optional[str] = None,
                     timeout: float = 600.0) -> torch.device:
    """Join the default process group and return this rank's device.

    Without `world` and `rank` the group is a launcher's (torchrun):
    RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT from the
    environment, the device cuda:LOCAL_RANK unless `device` says otherwise.
    `backend` defaults to 'nccl' for a CUDA device and 'gloo' for the CPU;
    every collective of the group fails after `timeout` seconds."""
    env = world is None and rank is None
    if env:
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        if device is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = (f"cuda:{local}" if torch.cuda.is_available()
                      else "cpu")
        init_method = init_method or "env://"
    if init_method is None:
        raise ValueError("init_distributed: give init_method "
                         "('tcp://localhost:<port>') with world and rank")
    device = torch.device(device if device is not None else "cpu")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    td = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world), rank=int(rank),
                            timeout=td, **kw)
    _CONTROL["group"] = (dist.new_group(backend="gloo", timeout=td)
                         if backend != "gloo" else dist.group.WORLD)
    return device


def shutdown() -> None:
    """Leave the process group (all ranks together)."""
    if initialized():
        dist.destroy_process_group()
    _CONTROL["group"] = None


def _control():
    """The gloo group that carries host scalars (created at
    init_distributed; for a group made elsewhere, created here, which every
    rank must reach together)."""
    if _CONTROL["group"] is None:
        _CONTROL["group"] = (dist.group.WORLD
                             if dist.get_backend() == "gloo"
                             else dist.new_group(backend="gloo"))
    return _CONTROL["group"]


# ---------------------------------------------------------------------------
# host scalars
# ---------------------------------------------------------------------------

def cross_process_sum(values: Sequence[float]) -> np.ndarray:
    """The sum of a small float64 vector over the ranks (torchmetrics'
    dist_reduce_fx='sum' for WER's (scores, words) and the eval sums)."""
    vals = np.asarray(values, np.float64)
    if process_count() == 1:
        return vals
    t = torch.from_numpy(vals.copy())
    dist.all_reduce(t, group=_control())
    return t.numpy()


def broadcast_int(value: int) -> int:
    """Rank 0's `value` on every rank (the experiment directory's version
    suffix, so the ranks do not race to different directories)."""
    if process_count() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.broadcast(t, src=0, group=_control())
    return int(t.item())


def sync_processes(tag: str = "") -> None:
    """A barrier: around file-system changes that only rank 0 makes, so no
    rank sees a half-written checkpoint or a missing sidecar."""
    if process_count() > 1:
        dist.barrier(group=_control())


def any_process(flag: bool) -> bool:
    """Whether `flag` is set on any rank (a SIGTERM that reached some)."""
    return bool(cross_process_sum([float(bool(flag))])[0] > 0)


def local_rows(x):
    """This rank's rows of a batch output: every rank holds only its own,
    so the identity (JAX's local_rows cuts them from a global array)."""
    return x


# ---------------------------------------------------------------------------
# rows of the global batch
# ---------------------------------------------------------------------------

def row_offset(n_local: int) -> int:
    """Where this rank's `n_local` rows begin in the global batch."""
    return process_index() * int(n_local)


def global_rows(n_local: int) -> int:
    """Rows of the global batch when each rank holds `n_local`."""
    return process_count() * int(n_local)


def draw_rows(draw: Callable, shape, dim: int = 0) -> torch.Tensor:
    """`draw(global shape)` cut to this rank's rows along `dim`: a random
    tensor whose rows are those the single-rank run draws for the same
    rows of the global batch (the generator advances as it does there)."""
    world = process_count()
    if world == 1:
        return draw(tuple(shape))
    shape = list(shape)
    n = shape[dim]
    shape[dim] = n * world
    return draw(tuple(shape)).narrow(dim, row_offset(n), n)


# ---------------------------------------------------------------------------
# collectives on tensors
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of `x`, differentiable: the backward sums the
    cotangents over the ranks too (each rank's `x` feeds every rank's
    result)."""
    if process_count() == 1:
        return x
    return _AllReduceSum.apply(x)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of `x`, without gradient (a normaliser)."""
    if process_count() == 1:
        return x.detach()
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


def global_mean(x: torch.Tensor, dim) -> torch.Tensor:
    """The mean over `dim` of the global batch's `x`, every rank's `x` of
    one shape (BatchNorm's statistics); differentiable."""
    if process_count() == 1:
        return x.mean(dim=dim)
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    n = 1
    for d in dims:
        n *= x.shape[d]
    return all_reduce_sum(x.sum(dim=dims)) / (n * process_count())


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the global batch's element mean of `x`: its
    element sum over the global element count (every rank's `x` of one
    shape), so the shares add up to the single-rank mean."""
    m = x.mean()
    return m if process_count() == 1 else m / process_count()


def all_gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order (small
    vectors: the router's per-sample step counts). Built from one all-reduce
    of a zero-filled global tensor, which NCCL and gloo (also on a CUDA
    tensor) both run; an integer vector travels as float32, exact below
    2^24."""
    world = process_count()
    if world == 1:
        return x
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * world
    dt = x.dtype if x.is_floating_point() else torch.float32
    full = torch.zeros(shape, dtype=dt, device=x.device)
    full.narrow(dim, row_offset(n), n).copy_(x)
    dist.all_reduce(full)
    return full.to(x.dtype)
