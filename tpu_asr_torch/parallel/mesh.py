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

Packed training (train/trainer.py, `packed=True`) splits one packing plan
of the global batch by its rows: rank r holds packed rows [r R/N,
(r+1) R/N) and the utterances they hold (`packed_rank_block`), which need
not be a contiguous block nor as many on every rank. Inside
`utterance_rows(index, count)` the helpers above take the rank's rows to
be those global rows: `batch_mean` and `global_mean` divide by the global
batch's count, `draw_rows` and `all_gather_rows` place each row at its
global index, and `row_index` gives the dropout streams' rows. The packed
rows themselves are equal blocks, so the encoder runs outside it.

Host scalars (`cross_process_sum`, `broadcast_int`, `sync_processes`, the
preemption flag) go through a gloo group on the CPU beside the default
group, so reading them never waits for the card. Every call is a no-op, and
every helper the identity, when no group is initialised or the world is one
rank: single-rank code paths are unchanged.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_CONTROL = {"group": None}
# this rank's utterances as rows of the global batch (utterance_rows)
_ROWS = {"index": None, "count": 0}


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


def gather_objects(obj) -> list:
    """Every rank's picklable `obj` in rank order (small host values: the
    utterances each rank wrote to a feature cache)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=_control())
    return out


def gather_host_rows(x: np.ndarray) -> np.ndarray:
    """Every rank's numpy `x`, one shape on every rank, concatenated along
    axis 0 in rank order, through the host group (a harvested batch of
    teacher features, which every rank's cache then holds)."""
    if process_count() == 1:
        return x
    x = np.ascontiguousarray(x)
    # as bytes: gloo has no unsigned 16-bit type (bfloat16's bits)
    t = torch.from_numpy(x.reshape(x.shape[0], -1).view(np.uint8))
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t, group=_control())
    return torch.cat(parts).numpy().view(x.dtype).reshape(
        (-1,) + x.shape[1:])


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

@contextlib.contextmanager
def utterance_rows(index, count: int):
    """Within it, this rank's rows are the rows `index` (a (B_r,) integer
    tensor or array, ascending) of a global batch of `count` rows, for
    every helper of this section and `batch_mean`, `global_mean`,
    `all_gather_rows`. A tensor's rows may be k rows an utterance,
    batch-major (row = b * k + j)."""
    prev = dict(_ROWS)
    _ROWS["index"] = torch.as_tensor(np.asarray(index), dtype=torch.long)
    _ROWS["count"] = int(count)
    try:
        yield
    finally:
        _ROWS.update(prev)


def row_share() -> float:
    """The fraction of the global batch's rows that this rank holds."""
    if _ROWS["index"] is not None:
        return len(_ROWS["index"]) / _ROWS["count"]
    return 1.0 / process_count()


def row_index(n_local: int, device=None) -> torch.Tensor:
    """The global rows (int64) of this rank's `n_local` rows."""
    idx = _ROWS["index"]
    if idx is None:
        return torch.arange(n_local, device=device) + process_index() * \
            int(n_local)
    k = n_local // len(idx)
    if k * len(idx) != n_local:
        raise ValueError(f"row_index: {n_local} rows for {len(idx)} "
                         "utterances")
    return (idx[:, None] * k + torch.arange(k)).reshape(-1).to(device)


def row_offset(n_local: int) -> int:
    """Where this rank's `n_local` rows begin in the global batch (its
    rows are one contiguous block: not inside utterance_rows)."""
    if _ROWS["index"] is not None:
        raise ValueError("row_offset: this rank's rows are not a block")
    return process_index() * int(n_local)


def global_rows(n_local: int) -> int:
    """Rows of the global batch when this rank holds `n_local`."""
    return int(round(int(n_local) / row_share()))


def draw_rows(draw: Callable, shape, dim: int = 0) -> torch.Tensor:
    """`draw(global shape)` cut to this rank's rows along `dim`: a random
    tensor whose rows are those the single-rank run draws for the same
    rows of the global batch (the generator advances as it does there)."""
    if process_count() == 1 and _ROWS["index"] is None:
        return draw(tuple(shape))
    shape = list(shape)
    n = shape[dim]
    shape[dim] = global_rows(n)
    full = draw(tuple(shape))
    if _ROWS["index"] is None:
        return full.narrow(dim, row_offset(n), n)
    return full.index_select(dim, row_index(n, full.device))


ROW_KEYS = ("pk_src_utt", "pk_src_pos", "pk_seg")     # (R, Tp) plan keys


def packed_rank_block(batch: dict, world: Optional[int] = None,
                      rank: Optional[int] = None) -> dict:
    """Rank `rank`'s part of a packed global batch (tensors or numpy
    arrays: the batch's (B, ...) rows and the plan of
    data/packing.train_pack_arrays): packed rows [r R/N, (r+1) R/N) of the
    plan, the utterances they hold in global order, `pk_row` based at the
    rank's first row, `pk_src_utt` at its first utterance, and `pk_utt`
    (their global indices) and `pk_n_utt` (B) for the packed step's
    `utterance_rows`. R must be a multiple of the world
    (train_pack_arrays' `row_multiple`), so that every rank's packed rows,
    and BatchNorm's statistics over them, have one shape; every rank must
    hold an utterance."""
    world = process_count() if world is None else int(world)
    rank = process_index() if rank is None else int(rank)
    as_np = lambda v: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v))
    n_rows = as_np(batch["pk_seg"]).shape[0]
    if n_rows % world:
        raise ValueError(f"packed_rank_block: {n_rows} packed rows for "
                         f"{world} ranks (plan with row_multiple={world})")
    per = n_rows // world
    lo = rank * per
    pk_row = as_np(batch["pk_row"]).astype(np.int64)
    utt = np.nonzero((pk_row >= lo) & (pk_row < lo + per))[0]
    if not len(utt):
        raise ValueError(f"packed_rank_block: rank {rank} of {world} holds "
                         "no utterance")
    local_of = np.zeros(len(pk_row), np.int64)
    local_of[utt] = np.arange(len(utt))

    def like(v, a):
        if isinstance(v, torch.Tensor):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=v.device, dtype=v.dtype)
        return np.ascontiguousarray(a).astype(np.asarray(v).dtype)

    out = {}
    n_utt = len(pk_row)
    for k, v in batch.items():
        if k in ROW_KEYS:
            a = as_np(v)[lo:lo + per]
            if k == "pk_src_utt":
                a = np.where(as_np(batch["pk_seg"])[lo:lo + per] > 0,
                             local_of[a], 0)
            out[k] = like(v, a)
        elif k == "pk_row":
            out[k] = like(v, pk_row[utt] - lo)
        elif isinstance(v, (torch.Tensor, np.ndarray)) and \
                v.shape[:1] == (n_utt,):
            out[k] = v[torch.from_numpy(utt).to(v.device)] if isinstance(
                v, torch.Tensor) else v[utt]
        else:
            out[k] = v
    out["pk_utt"] = utt
    out["pk_n_utt"] = n_utt
    return out


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
    return all_reduce_sum(x.sum(dim=dims)) / global_rows(n)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the global batch's element mean of `x`: its
    element sum over the global element count (`x`'s rows are this rank's
    rows), so the shares add up to the single-rank mean."""
    m = x.mean()
    return m if process_count() == 1 else m * row_share()


def all_gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order (small
    vectors: the router's per-sample step counts). Built from one all-reduce
    of a zero-filled global tensor, which NCCL and gloo (also on a CUDA
    tensor) both run; an integer vector travels as float32, exact below
    2^24."""
    if process_count() == 1:
        return x
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = global_rows(n)
    dt = x.dtype if x.is_floating_point() else torch.float32
    full = torch.zeros(shape, dtype=dt, device=x.device)
    full.index_copy_(dim % x.dim(), row_index(n, x.device), x.to(dt))
    dist.all_reduce(full)
    return full.to(x.dtype)
