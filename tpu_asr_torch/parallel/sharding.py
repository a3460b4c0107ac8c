"""Tensor-parallel sharding rules: the counterpart of
tpu_asr/parallel/sharding.py on the port's NeMo `state_dict` keys.

JAX annotates its parameter tree with PartitionSpecs (TP_RULES, matched
against path suffixes) and lets GSPMD insert the collectives. The port
keeps the same leaves in the same places, in PyTorch's (out, in) layouts:

- conformer FF `linear1` weight and bias: the output dim (column-parallel);
  FF `linear2` weight: the input dim (row-parallel);
- attention `linear_q/k/v` weight and bias, `linear_pos` weight: the output
  dim (heads); `linear_out` weight: the input dim; `pos_bias_u/v`: heads;
- the CTC decoder's `decoder_layers.0` weight and bias: the vocab dim.

As in JAX, a dimension that the model axis does not divide stays replicated
(129 classes with the blank at tp 2). Everything else is replicated. The
rules apply to the student's and the teacher's encoder and decoder, the
leaves JAX's suffixes reach in a DistilCTCModel.

`shard_module` keeps this rank's slice of every sharded parameter of a
whole module (the counterpart of `apply_sharding`), records its split dim
on the parameter (`tp_dim`), and tells the modules that use them how to
run: the attention sublayer runs its local heads (models/conformer.py), the
FF sublayers and the decoder gather their weights over the model group
(`mesh.model_gather`). `full_state_dict` gathers the whole state back on
every rank (over the model group, and over the stages of a pipelined
model: parallel/pipeline.py), and `shard_state_dict` cuts a whole state
into this rank's, so a checkpoint written at one layout restores at any
other.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from tpu_asr_torch.parallel import mesh

# (key suffix, the dim split over the model axis) in PyTorch layouts
TP_RULES: Sequence[Tuple[Tuple[str, ...], int]] = (
    (("feed_forward1", "linear1", "weight"), 0),
    (("feed_forward1", "linear1", "bias"), 0),
    (("feed_forward1", "linear2", "weight"), 1),
    (("feed_forward2", "linear1", "weight"), 0),
    (("feed_forward2", "linear1", "bias"), 0),
    (("feed_forward2", "linear2", "weight"), 1),
    (("self_attn", "linear_q", "weight"), 0),
    (("self_attn", "linear_q", "bias"), 0),
    (("self_attn", "linear_k", "weight"), 0),
    (("self_attn", "linear_k", "bias"), 0),
    (("self_attn", "linear_v", "weight"), 0),
    (("self_attn", "linear_v", "bias"), 0),
    (("self_attn", "linear_pos", "weight"), 0),
    (("self_attn", "linear_out", "weight"), 1),
    (("self_attn", "pos_bias_u"), 0),
    (("self_attn", "pos_bias_v"), 0),
    (("decoder_layers", "0", "weight"), 0),
    (("decoder_layers", "0", "bias"), 0),
)
ROOTS = ("student.", "teacher.", "encoder.", "decoder.")


def split_dim(key: str, shape, tp: int) -> Optional[int]:
    """The dim of the parameter `key` (a state_dict key of a
    DistilCTCModel or CTCModel) of `shape` split over tp model ranks, or
    None (replicated): a matching rule whose dim tp divides."""
    if tp <= 1 or not key.startswith(ROOTS):
        return None
    names = tuple(key.split("."))
    for suffix, dim in TP_RULES:
        if names[-len(suffix):] == suffix:
            return dim if dim < len(shape) and shape[dim] % tp == 0 else None
    return None


def split_dims(state: Dict[str, torch.Tensor], tp: int) -> Dict[str, int]:
    """{key: split dim} of the sharded entries of a whole state."""
    out = {}
    for k, v in state.items():
        dim = split_dim(k, tuple(v.shape), tp)
        if dim is not None:
            out[k] = dim
    return out


def _slice(t: torch.Tensor, dim: int, tp: int, index: int) -> torch.Tensor:
    k = t.shape[dim] // tp
    return t.narrow(dim, index * k, k).contiguous()


def shard_state_dict(state: Dict[str, torch.Tensor], tp: int,
                     index: int) -> Dict[str, torch.Tensor]:
    """This model rank's (index of tp) entries of a whole state."""
    dims = split_dims(state, tp)
    return {k: (_slice(v, dims[k], tp, index) if k in dims else v)
            for k, v in state.items()}


def _tp_owners(model: nn.Module):
    """(name prefix, module) of the modules that run sharded weights."""
    from tpu_asr_torch.models.conformer import (FeedForward,
                                                RelPositionMultiHeadAttention)
    from tpu_asr_torch.models.decoder import ConvASRDecoder
    kinds = (RelPositionMultiHeadAttention, FeedForward, ConvASRDecoder)
    return [(n, m) for n, m in model.named_modules() if isinstance(m, kinds)]


def shard_module(model: nn.Module, m: Optional[mesh.Mesh] = None
                 ) -> nn.Module:
    """Keep this rank's slice of every parameter the rules split over the
    mesh's model axis (the current mesh by default), in place: the
    counterpart of apply_sharding. Every rank must hold the same whole
    weights before. Returns the model."""
    m = m or mesh.current_mesh()
    tp = 1 if m is None else m.shape["model"]
    if tp == 1:
        return model
    index = m.index["model"]
    split, dims = set(), {}
    for name, p in list(model.named_parameters()):
        dim = split_dim(global_key(model, name), tuple(p.shape), tp)
        if dim is None:
            continue
        owner, leaf = _owner(model, name)
        new = nn.Parameter(_slice(p.data, dim, tp, index),
                           requires_grad=p.requires_grad)
        new.tp_dim, new.tp_split = dim, (tp, index)
        setattr(owner, leaf, new)
        split.add(name)
        dims[global_key(model, name)] = dim
    for name, mod in _tp_owners(model):
        if not any(k.startswith(name + ".") for k in split):
            continue
        if getattr(mod, "n_heads", tp) % tp:
            raise ValueError(f"{name}: {mod.n_heads} heads do not split "
                             f"over {tp} model ranks")
        mod.tp = (tp, index)
    model.__dict__["_tp"] = (tp, index)
    model.__dict__["_tp_dims"] = dims
    return model


def _owner(model: nn.Module, name: str):
    *path, leaf = name.split(".")
    owner = model
    for p in path:
        owner = getattr(owner, p)
    return owner, leaf


def global_key(model: nn.Module, name: str) -> str:
    """The whole model's key of the parameter or buffer `name` (a
    pipeline stage numbers its layers from its first: pipeline.py)."""
    fn = model.__dict__.get("_global_key")
    return fn(name) if fn is not None else name


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole model's state on every rank: the model group's slices
    joined along their split dims and, for a pipelined model, every
    stage's layers under their global keys. Every rank of the world calls
    it."""
    state = {global_key(model, k): v.detach()
             for k, v in model.state_dict().items()}
    dims = model.__dict__.get("_tp_dims", {})
    state = {k: (mesh.gather(v, dims[k], "model") if k in dims else v)
             for k, v in state.items()}
    return gather_stages(state, model)


def gather_stages(entries: Dict[str, torch.Tensor],
                  model: nn.Module) -> Dict[str, torch.Tensor]:
    """`entries` (keyed by the whole model's keys) with every stage's
    entries of its own layers, on every stage, through the host group, for
    a pipelined model (parallel/pipeline.apply_pp_sharding); `entries`
    itself otherwise. Every rank of the world calls it."""
    stage = model.__dict__.get("_stage")
    if stage is None or mesh.axis_size("pipe") == 1:
        return entries
    own = [k for k in stage["keys"] if k in entries]
    parts = mesh.gather_objects({k: entries[k].cpu() for k in own})
    m = mesh.current_mesh()
    out = {k: v for k, v in entries.items() if k not in own}
    dev = next(iter(entries.values())).device
    d0, mi = m.index["data"], m.index["model"]
    for p in range(m.shape["pipe"]):
        for k, v in parts[m.rank_of(d0, p, mi)].items():
            out[k] = v.to(dev)
    return out


def load_full_state_dict(model: nn.Module,
                         state: Dict[str, torch.Tensor]) -> None:
    """Load a whole state (`full_state_dict`, or a checkpoint of any
    layout) into a sharded or pipelined model: each rank takes its
    slices and its stage's layers."""
    tp, index = model.__dict__.get("_tp", (1, 0))
    if tp > 1:
        state = shard_state_dict(state, tp, index)
    local = model.__dict__.get("_local_key")
    if local is not None:
        state = {local(k): v for k, v in state.items()
                 if local(k) is not None}
    model.load_state_dict(state, strict=True)


def sharded_axes(p: torch.Tensor) -> Tuple[str, ...]:
    """The axes over which a parameter is split: ('model',) for a TP
    slice, ('pipe',) for a stage's layer, both, or ()."""
    out = ()
    if getattr(p, "tp_dim", None) is not None:
        out += ("model",)
    if getattr(p, "pp_stage", False):
        out += ("pipe",)
    return out


def _indexed_params(opt: torch.optim.Optimizer):
    """The optimizer's parameters in its state_dict's index order."""
    return [p for g in opt.param_groups for p in g["params"]]


def full_optimizer_state(opt: torch.optim.Optimizer) -> dict:
    """The optimizer's state_dict with every per-parameter tensor of a
    tensor-parallel slice gathered whole over the model group: the
    one-rank optimizer's state_dict, since sharding keeps the parameters'
    order. Every rank of the model group calls it."""
    sd = opt.state_dict()
    params = _indexed_params(opt)
    state = {}
    for i, st in sd["state"].items():
        dim = getattr(params[i], "tp_dim", None)
        state[i] = {k: (mesh.gather(v, dim, "model")
                        if dim is not None and torch.is_tensor(v)
                        and v.shape == params[i].shape else v)
                    for k, v in st.items()}
    return {**sd, "state": state}


def shard_optimizer_state(opt: torch.optim.Optimizer, sd: dict) -> dict:
    """A whole optimizer state_dict (`full_optimizer_state`, or a one-rank
    checkpoint's) cut to this rank's slices of its parameters."""
    params = _indexed_params(opt)
    state = {}
    for i, st in sd["state"].items():
        p = params[int(i)]
        dim = getattr(p, "tp_dim", None)
        tp, index = (p.tp_split if dim is not None else (1, 0))
        state[i] = {k: (_slice(v, dim, tp, index)
                        if dim is not None and torch.is_tensor(v)
                        and v.dim() == p.dim() and v.shape != p.shape else v)
                    for k, v in st.items()}
    return {**sd, "state": state}
