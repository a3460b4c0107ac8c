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

Tensor and pipeline parallelism (`make_mesh(dp, tp)`, `make_pp_mesh(dp, pp,
tp)`, the counterparts of JAX's meshes): the world's ranks form a (data,
pipe, model) grid, rank = (d pp + p) tp + m as JAX's device reshape orders
them, with a process group along each axis (`Mesh`). Once a mesh is set
(`use_mesh`; `make_mesh` and `make_pp_mesh` set theirs) every row helper above
acts on the DATA axis: the ranks of one model or pipe group hold the same
rows, `row_offset` and `global_rows` count data ranks, `all_reduce_sum`
and `global_mean` reduce over the data group, and `cross_process_sum`
sums the metrics' shares over the data ranks. Without a mesh the data axis
is the world. The model axis has Megatron's conjugate pair
(`model_input`: identity forward, sum of the cotangents backward, where a
replicated activation enters a column-parallel product; `model_sum`: sum
forward, identity backward, at a row-parallel output) and `model_gather`
(a sharded tensor whole on every rank; backward: the rank's slice of the
cotangent, which every rank of the group holds alike). `gather` joins
any axis's slices without gradient, and `send_to` / `recv_from` carry the
pipeline's activations between neighbouring stages. gloo takes CUDA
tensors in all_reduce but not in send or recv: there they travel through
pinned host memory. Every
gather is an all_reduce of a zero-filled whole tensor, which NCCL and gloo
both run on CUDA tensors, exact (each element has one nonzero term); gloo
reduces bf16 as fp32.
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
# the (data, pipe, model) layout of the world (use_mesh), or None: the data
# axis is the world
_MESH = {"mesh": None}


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
    _MESH["mesh"] = None


# ---------------------------------------------------------------------------
# the (data, pipe, model) grid
# ---------------------------------------------------------------------------

class Mesh:
    """This rank's place on a (data, pipe, model) grid of the world's ranks
    and the process groups along each axis: `groups[axis]` holds the ranks
    that differ only in that axis's index (None where the axis has one
    rank), `data_host` the data group's ranks in a gloo group on the CPU
    (the metrics' host sums). `rank_of(d, p, m)` is the global rank of
    grid point (d, p, m)."""

    AXES = ("data", "pipe", "model")

    def __init__(self, dp: int, pp: int, tp: int):
        world, rank = process_count(), process_index()
        if dp * pp * tp != world:
            raise ValueError(f"mesh {dp}x{pp}x{tp} for a world of {world} "
                             "rank(s): the grid must hold every rank")
        self.shape = {"data": dp, "pipe": pp, "model": tp}
        self.index = {"data": rank // (pp * tp),
                      "pipe": rank // tp % pp, "model": rank % tp}
        self.groups = {a: None for a in self.AXES}
        self.data_host = None
        if world == 1:
            return
        gloo = dist.get_backend() == "gloo"
        for axis in self.AXES:
            if self.shape[axis] == 1:
                continue
            for line in self._lines(axis):
                # every rank makes every group, in one order
                g = dist.new_group(line)
                if rank in line:
                    self.groups[axis] = g
                if axis == "data":
                    h = g if gloo else dist.new_group(line, backend="gloo")
                    if rank in line:
                        self.data_host = h

    def rank_of(self, d: int, p: int, m: int) -> int:
        return (d * self.shape["pipe"] + p) * self.shape["model"] + m

    def _lines(self, axis: str):
        """Every group of ranks along `axis`, in a fixed order."""
        others = [a for a in self.AXES if a != axis]
        out = []
        for i in range(self.shape[others[0]]):
            for j in range(self.shape[others[1]]):
                at = {others[0]: i, others[1]: j}
                out.append([self.rank_of(*(at.get(a, k) for a in self.AXES))
                            for k in range(self.shape[axis])])
        return out

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, pipe={self.shape['pipe']},"
                f" model={self.shape['model']}, at {self.index})")


def use_mesh(m: Optional[Mesh]) -> Optional[Mesh]:
    """Set the layout that the row helpers and collectives follow (None:
    the data axis is the world); returns the previous one."""
    prev, _MESH["mesh"] = _MESH["mesh"], m
    return prev


def current_mesh() -> Optional[Mesh]:
    return _MESH["mesh"]


def make_mesh(dp_size: int = -1, tp_size: int = 1) -> Mesh:
    """The ('data', 'model') grid of the world (JAX's make_mesh): dp_size
    -1 takes world / tp_size. Every rank calls it, in the same order as
    every other group it makes; the mesh becomes the current one."""
    world = process_count()
    if dp_size == -1:
        dp_size = world // tp_size
    m = Mesh(dp_size, 1, tp_size)
    use_mesh(m)
    return m


def make_pp_mesh(dp_size: int = 1, pp_size: int = 2,
                 tp_size: int = 1) -> Mesh:
    """The ('data', 'pipe'[, 'model']) grid of the world (JAX's
    parallel/pipeline.make_pp_mesh); it becomes the current mesh."""
    m = Mesh(dp_size, pp_size, tp_size)
    use_mesh(m)
    return m


def axis_size(axis: str) -> int:
    """Ranks along `axis` of the current mesh (data: the world without
    one)."""
    m = _MESH["mesh"]
    if m is None:
        return process_count() if axis == "data" else 1
    return m.shape[axis]


def axis_index(axis: str) -> int:
    m = _MESH["mesh"]
    if m is None:
        return process_index() if axis == "data" else 0
    return m.index[axis]


def axis_group(axis: str):
    """The device process group along `axis` (None: the default group,
    which is the data axis without a mesh)."""
    m = _MESH["mesh"]
    return None if m is None else m.groups[axis]


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

def cross_process_sum(values: Sequence[float],
                      axis: str = "data") -> np.ndarray:
    """The sum of a small float64 vector over the data ranks (torchmetrics'
    dist_reduce_fx='sum' for WER's (scores, words), the eval sums and the
    metrics' shares: the ranks of one model or pipe group hold the same
    rows and count them once), or over every rank with axis='world'."""
    vals = np.asarray(values, np.float64)
    m = _MESH["mesh"]
    if process_count() == 1 or (axis == "data" and m is not None
                                and m.shape["data"] == 1):
        return vals
    group = (m.data_host if axis == "data" and m is not None
             else _control())
    t = torch.from_numpy(vals.copy())
    dist.all_reduce(t, group=group)
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
    return bool(cross_process_sum([float(bool(flag))], "world")[0] > 0)


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
    return 1.0 / axis_size("data")


def row_index(n_local: int, device=None) -> torch.Tensor:
    """The global rows (int64) of this rank's `n_local` rows."""
    idx = _ROWS["index"]
    if idx is None:
        return torch.arange(n_local, device=device) + axis_index("data") * \
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
    return axis_index("data") * int(n_local)


def global_rows(n_local: int) -> int:
    """Rows of the global batch when this rank holds `n_local`."""
    return int(round(int(n_local) / row_share()))


def draw_rows(draw: Callable, shape, dim: int = 0) -> torch.Tensor:
    """`draw(global shape)` cut to this rank's rows along `dim`: a random
    tensor whose rows are those the single-rank run draws for the same
    rows of the global batch (the generator advances as it does there)."""
    if axis_size("data") == 1 and _ROWS["index"] is None:
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

def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place (gloo reduces bf16 and fp16 as fp32);
    returns it."""
    if t.dtype in (torch.bfloat16, torch.float16) and (
            dist.get_backend(group) == "gloo"):
        w = t.float()
        dist.all_reduce(w, group=group)
        return t.copy_(w)
    dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum forward and backward (each rank's x feeds every rank's sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _SumBackward(torch.autograd.Function):
    """Identity forward, sum of the cotangents backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _SumForward(torch.autograd.Function):
    """Sum forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """Every rank's x along `axis` concatenated along `dim` in index
    order, through one all_reduce of a zero-filled whole tensor."""
    n, i = axis_size(axis), axis_index(axis)
    if n == 1:
        return x
    dim = dim % x.dim()
    shape = list(x.shape)
    k = shape[dim]
    shape[dim] = n * k
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(dim, i * k, k).copy_(x)
    return _all_reduce(full, axis_group(axis))


class _GatherSlice(torch.autograd.Function):
    """Gather forward; backward the rank's slice of the cotangent, which
    every rank of the group holds alike."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.k = dim, axis, x.shape[dim]
        return gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        i = axis_index(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.k, ctx.k).contiguous(), None, None


def model_input(x: torch.Tensor) -> torch.Tensor:
    """A replicated activation entering this rank's slice of a
    column-parallel product: identity forward, its cotangents summed over
    the model group backward."""
    if axis_size("model") == 1:
        return x
    return _SumBackward.apply(x, axis_group("model"))


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of a row-parallel product's partial
    outputs; identity backward (the cotangent is replicated)."""
    if axis_size("model") == 1:
        return x
    return _SumForward.apply(x, axis_group("model"))


def model_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's slices of a sharded tensor, whole; backward the
    rank's slice of the (replicated) cotangent."""
    if axis_size("model") == 1:
        return x
    return _GatherSlice.apply(x, dim, "model")


def axis_sum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of `x` over `axis`, without gradient (a gradient or a
    norm's square sum over the ranks that hold parts of it)."""
    if axis_size(axis) == 1:
        return x
    return _all_reduce(x.detach().clone(), axis_group(axis))


def _staged(dev_type: str) -> bool:
    """Whether point-to-point tensors go through host memory: gloo does
    not send or receive CUDA tensors."""
    return dev_type == "cuda" and dist.get_backend() == "gloo"


def send_to(x: torch.Tensor, dst: int) -> None:
    """Send x to the global rank `dst` (blocking; through pinned host
    memory where the backend is gloo and x lies on a card)."""
    if _staged(x.device.type):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        dist.send(host, dst)
    else:
        dist.send(x.contiguous(), dst)


def recv_from(shape, dtype, device, src: int) -> torch.Tensor:
    """A tensor of `shape` and `dtype` from the global rank `src`, on
    `device`."""
    device = torch.device(device)
    if _staged(device.type):
        host = torch.empty(shape, dtype=dtype, pin_memory=True)
        dist.recv(host, src)
        return host.to(device, non_blocking=False)
    out = torch.empty(shape, dtype=dtype, device=device)
    dist.recv(out, src)
    return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of `x`, differentiable: the backward sums the
    cotangents over the ranks too (each rank's `x` feeds every rank's
    result)."""
    if axis_size("data") == 1:
        return x
    return _AllReduceSum.apply(x, axis_group("data"))


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of `x`, without gradient (a normaliser)."""
    if axis_size("data") == 1:
        return x.detach()
    return _all_reduce(x.detach().clone(), axis_group("data"))


def global_mean(x: torch.Tensor, dim) -> torch.Tensor:
    """The mean over `dim` of the global batch's `x`, every rank's `x` of
    one shape (BatchNorm's statistics); differentiable."""
    if axis_size("data") == 1:
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
    return m if axis_size("data") == 1 else m * row_share()


def all_gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order (small
    vectors: the router's per-sample step counts). Built from one all-reduce
    of a zero-filled global tensor, which NCCL and gloo (also on a CUDA
    tensor) both run; an integer vector travels as float32, exact below
    2^24."""
    if axis_size("data") == 1:
        return x
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = global_rows(n)
    dt = x.dtype if x.is_floating_point() else torch.float32
    full = torch.zeros(shape, dtype=dt, device=x.device)
    full.index_copy_(dim % x.dim(), row_index(n, x.device), x.to(dt))
    return _all_reduce(full, axis_group("data")).to(x.dtype)
