"""Pipeline parallelism for the conformer layer stack: the counterpart of
tpu_asr/parallel/pipeline.py, GPipe over the `pipe` axis of a mesh
(parallel/mesh.make_pp_mesh), one process per stage.

JAX has it for the scale rows (Large 121 M, XLarge 635 M) and runs it
as one XLA program: the stacked layers sharded over 'pipe', a scan of M + S
- 1 ticks with a ring `ppermute`, the rest of the step in GSPMD auto mode.
The port keeps its entry points, its guards (`_check_cfg`, JAX's
messages) and its parity contract, in PyTorch's idiom:

- `apply_pp_sharding`: stage s keeps only layers [s L/S, (s+1) L/S) of the
  pipelined encoder (the student's in a DistilCTCModel, the encoder of a
  CTCModel), and, where the mesh has a model axis, the tensor-parallel
  slices of parallel/sharding.py. Its state keeps the whole model's keys
  (sharding.full_state_dict gathers every stage's layers).
- The schedule is GPipe: stage s runs microbatch m once it has received
  it from stage s - 1 (`recv_from`), sends its (mb, T', D) output on
  (`send_to`) and goes on with m + 1, so the stages overlap after S - 1
  microbatches; each stage knows every microbatch's lengths, so the masks
  are not sent. Every stage's per-layer features are then gathered to every
  stage (an all_reduce of a zero-filled (L, B, T', D) stack), so the
  encoder output (the stack's last layer), the CTC head, the frozen teacher
  and the KD losses run replicated on every stage, as GSPMD runs them in
  JAX (`pipeline_layer_stack_feats`, `distil_forward_pipelined`).
- The backward (`_PipelineStack.backward`) walks each stage's microbatches
  in reverse, in the same order on every stage: it receives the next
  stage's input gradient, adds it to its last layer's share of the
  gathered-feature gradient (every stage holds the same one), runs its
  layers' backward, and sends its own input gradient back. Blocking
  send/recv in one fixed order cannot deadlock. Stage 0's input gradient
  is then summed over the stages (the others add zeros), so the
  pre-encode, replicated on every stage, gets the same gradient
  everywhere; so do the decoder and the KD modules. Each stage's layer
  gradients are its own (train/optim.split_sum counts them once).
- Data parallelism (a mesh with dp > 1): each data replica's losses are
  its shares of the global batch's, as in the data-parallel Trainer, so
  the backward ends by summing over the data axis what it added to every
  trained parameter's gradient (`_sum_over_data`, queued on autograd's
  engine from the stack's backward), and every replica holds the global
  batch's gradients, as JAX's dp x pp step does.
- Dropout: each microbatch keeps its rows' global offset (the encoder's
  seeds shifted by models/conformer.shift_seeds), so the pipelined step
  draws the unpipelined step's masks. JAX's per-(stage, microbatch)
  `fold_in` streams cannot share bits with the port's counter hash; the
  ROADMAP's rule for random draws across the packages applies, and the
  port's pipelined step equals its own unpipelined step instead.
- gloo does not send CUDA tensors: ranks that share a card (gloo) stage
  the activations through pinned host memory (mesh.send_to).

Scope, as in JAX: the regular encode path (no streaming caches, no packed
segments); in training the conv module must use layer_norm, stochastic
depth must be 0, and a dropout rate needs a generator.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch import nn

from tpu_asr_torch.config import EncoderConfig
from tpu_asr_torch.parallel import mesh
from tpu_asr_torch.parallel.mesh import make_pp_mesh  # noqa: F401
from tpu_asr_torch.parallel.sharding import shard_module


def _check_cfg(cfg: EncoderConfig, train: bool,
               have_rng: bool = False) -> None:
    """JAX's guards (tpu_asr/parallel/pipeline.py::_check_cfg), with its
    messages."""
    if train and not have_rng and (cfg.dropout > 0 or cfg.dropout_att > 0
                                   or cfg.dropout_pre_encoder > 0):
        raise ValueError("pipelined training with dropout needs a "
                         "dropout rng (pass rngs={'dropout': key}); "
                         "without one, set the dropout rates to 0")
    if train and cfg.stochastic_depth_drop_prob > 0:
        raise ValueError("stochastic depth is not supported in the "
                         "pipelined encode path")
    if train and cfg.conv_norm_type == "batch_norm":
        raise ValueError("pipelined training requires "
                         "conv_norm_type='layer_norm' (BN batch-stats "
                         "mutation is not pipelined)")
    if cfg.reduction is not None and cfg.reduction_factor > 1:
        raise ValueError("mid-stack reduction cannot be pipelined "
                         "(changes T between stages)")
    if getattr(cfg, "feat_out", -1) > 0 and cfg.feat_out != cfg.d_model:
        raise ValueError("feat_out projection not supported in the "
                         "pipelined encode path")


def _encoder_of(model: nn.Module, encoder_path: str):
    return (model.student if encoder_path == "student" else model).encoder


def apply_pp_sharding(model: nn.Module, m: Optional[mesh.Mesh] = None,
                      encoder_path: str = "student") -> nn.Module:
    """Cut a whole DistilCTCModel (encoder_path 'student') or CTCModel
    ('') to this rank's stage of the mesh's pipe axis, and to its
    tensor-parallel slices where the mesh has a model axis: JAX's
    apply_pp_sharding. Every rank must hold the same whole weights
    before. Returns the model."""
    m = m or mesh.current_mesh()
    n_stages, s = m.shape["pipe"], m.index["pipe"]
    enc = _encoder_of(model, encoder_path)
    n_layers = enc.cfg.n_layers
    if n_layers % n_stages:
        raise ValueError(f"n_layers={n_layers} not divisible by "
                         f"pipe={n_stages}")
    n_local = n_layers // n_stages
    first = s * n_local
    enc.layers = nn.ModuleList(list(enc.layers)[first:first + n_local])
    for p in enc.layers.parameters():
        p.pp_stage = True
    enc.stage = (first, n_local)
    prefix = ("student." if encoder_path == "student" else "") + \
        "encoder.layers."

    def renumber(key: str, shift: int, keep=None):
        if not key.startswith(prefix):
            return key
        i, rest = key[len(prefix):].split(".", 1)
        j = int(i) + shift
        if keep is not None and not keep(j):
            return None
        return f"{prefix}{j}.{rest}"

    model.__dict__["_global_key"] = lambda k: renumber(k, first)
    model.__dict__["_local_key"] = lambda k: renumber(
        k, -first, lambda j: 0 <= j < n_local)
    model.__dict__["_stage"] = {"keys": [
        renumber(k, first) for k in model.state_dict()
        if k.startswith(prefix)]}
    shard_module(model, m)
    return model


class _Plan:
    """What one pipelined stack needs besides its input: the stage's
    layers and the encoder that runs them, the position table, the mask,
    the per-microbatch seeds, the microbatch count and the neighbours."""

    def __init__(self, enc, pos_emb, mask, seeds, n_micro, trained=()):
        self.enc, self.pos_emb, self.mask = enc, pos_emb, mask
        self.seeds, self.n_micro = seeds, n_micro
        self.trained = list(trained)
        self.first, self.n_local = enc.stage
        m = mesh.current_mesh()
        self.n_stages, self.s = m.shape["pipe"], m.index["pipe"]
        d, mi = m.index["data"], m.index["model"]
        self.prev = (m.rank_of(d, self.s - 1, mi) if self.s > 0 else None)
        self.next = (m.rank_of(d, self.s + 1, mi)
                     if self.s < self.n_stages - 1 else None)


def _run_forward(x: torch.Tensor, plan: _Plan, graph: bool):
    """The stage's GPipe forward: per microbatch its input (a leaf that
    requires grad when `graph`) and its (n_local, mb, T, D) features."""
    b, t, d = x.shape
    mb = b // plan.n_micro
    ins, outs = [], []
    for i in range(plan.n_micro):
        rows = slice(i * mb, (i + 1) * mb)
        xin = (x[rows] if plan.prev is None else mesh.recv_from(
            (mb, t, d), x.dtype, x.device, plan.prev))
        xin = xin.detach().requires_grad_(graph)
        seeds = (None if plan.seeds is None else
                 plan.seeds(i * mb))
        with torch.enable_grad() if graph else contextlib.nullcontext():
            y, feats = plan.enc._run(plan.enc.layers, plan.first, xin,
                                     plan.pos_emb, plan.mask[rows], seeds,
                                     None, None)
            stack = torch.stack(feats)
        if plan.next is not None:
            mesh.send_to(y.detach(), plan.next)
        ins.append(xin)
        outs.append(stack)
    return ins, outs


def _gathered(outs, plan: _Plan) -> torch.Tensor:
    """Every stage's features, (L, B, T, D) in layer order, on every
    stage."""
    local = torch.cat([o.detach() for o in outs], dim=1)
    return mesh.gather(local, 0, "pipe")


def _sum_over_data(params, held) -> None:
    """Sum over the data axis what the backward added to each gradient of
    `params` (`held`: the gradients some of them had before it)."""
    for p in params:
        if p.grad is None:
            continue
        before = held.get(p)
        added = p.grad if before is None else p.grad - before
        total = mesh.axis_sum(added, "data")
        p.grad.copy_(total if before is None else before + total)


class _PipelineStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ins, outs = _run_forward(x, plan, graph=True)
        ctx.plan, ctx.ins, ctx.outs = plan, ins, outs
        ctx.x_shape = x.shape
        ctx.held = {p: p.grad.detach().clone() for p in plan.trained
                    if p.grad is not None}
        return _gathered(outs, plan)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        if plan.trained:
            # runs once the whole backward has ended, the replicated
            # modules' gradients included
            params, held = plan.trained, ctx.held
            torch.autograd.Variable._execution_engine.queue_callback(
                lambda: _sum_over_data(params, held))
        n_local, s = plan.n_local, plan.s
        b, t, d = ctx.x_shape
        mb = b // plan.n_micro
        g_local = g.narrow(0, s * n_local, n_local)
        dx = [None] * plan.n_micro
        for i in reversed(range(plan.n_micro)):
            cot = g_local[:, i * mb:(i + 1) * mb].clone()
            if plan.next is not None:
                cot[-1] += mesh.recv_from((mb, t, d), g.dtype, g.device,
                                          plan.next)
            torch.autograd.backward(ctx.outs[i], cot)
            xin = ctx.ins[i]
            gx = (xin.grad if xin.grad is not None
                  else torch.zeros_like(xin))
            if plan.prev is not None:
                mesh.send_to(gx, plan.prev)
            else:
                dx[i] = gx
        ctx.ins = ctx.outs = None
        full = (torch.cat(dx) if plan.prev is None
                else torch.zeros(ctx.x_shape, dtype=g.dtype, device=g.device))
        return mesh.axis_sum(full, "pipe"), None


def _stack(enc, x, pos_emb, mask, seeds, n_micro,
           trained=()) -> torch.Tensor:
    """The pipelined layer stack on x (B, T, D): (L, B, T, D) features;
    `trained`: the parameters whose gradients the backward sums over the
    data axis (at dp > 1)."""
    trained = ([p for p in trained if p.requires_grad]
               if mesh.axis_size("data") > 1 else [])
    plan = _Plan(enc, pos_emb, mask, seeds, n_micro, trained)
    graph = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad
                               for p in enc.layers.parameters()))
    if graph:
        return _PipelineStack.apply(x, plan)
    return _gathered(_run_forward(x, plan, graph=False)[1], plan)


def encode_pipelined_feats(model, features: torch.Tensor,
                           lengths: torch.Tensor, n_micro: int,
                           train: bool = False,
                           generator: Optional[torch.Generator] = None,
                           trained: Optional[nn.Module] = None):
    """The encoder of a stage-cut CTCModel (`apply_pp_sharding`) on
    (B, F, T) log-mel with its layer stack pipelined over the mesh's pipe
    axis: (encoded (B, T', D), lengths (B,), layer_feats (L, B, T', D)),
    the encoder output being the stack's last layer. The same numbers as
    `model.encoder(features, lengths, train, generator)` on the whole
    model. `train` draws the dropout seeds from `generator` as the
    encoder does. At dp > 1 the backward sums the gradients of `trained`
    (default `model`) over the data axis."""
    from tpu_asr_torch.models.conformer import (SEEDS_PER_LAYER,
                                                shift_seeds)
    from tpu_asr_torch.ops.dropout import dropout
    from tpu_asr_torch.ops.positions import rel_positional_encoding

    enc = model.encoder
    cfg = enc.cfg
    _check_cfg(cfg, train, have_rng=generator is not None)
    x, out_len = enc.subsample(features, lengths)
    b, t, d = x.shape
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    x = x.to(enc.dtype)
    if cfg.xscaling:
        x = x * math.sqrt(cfg.d_model)
    seeds = None
    if train:
        base = shift_seeds(torch.randint(
            0, 2 ** 31 - 1, (1 + SEEDS_PER_LAYER * cfg.n_layers,),
            generator=generator).tolist(), mesh.row_offset(b), cfg.n_heads)
        x = dropout(x, cfg.dropout_pre_encoder, base[0])
        seeds = lambda row0: shift_seeds(base, row0, cfg.n_heads)
    mask = torch.arange(t, device=x.device)[None, :] < out_len[:, None]
    x = x.masked_fill(~mask[..., None], 0.0)
    pos_emb = rel_positional_encoding(t, cfg.d_model, x.device)
    feats = _stack(enc, x, pos_emb, mask, seeds, n_micro,
                   (model if trained is None else trained).parameters())
    return feats[-1], out_len, feats


def encode_pipelined(model, features: torch.Tensor, lengths: torch.Tensor,
                     n_micro: int, train: bool = False,
                     generator: Optional[torch.Generator] = None):
    """`encode_pipelined_feats` without the feature stack: (encoded,
    lengths)."""
    encoded, out_len, _ = encode_pipelined_feats(model, features, lengths,
                                                 n_micro, train, generator)
    return encoded, out_len


def distil_forward_pipelined(model, signal: torch.Tensor,
                             signal_len: torch.Tensor,
                             transcripts: Optional[torch.Tensor],
                             transcript_lengths: Optional[torch.Tensor],
                             n_micro: int, rngs=None, train: bool = True):
    """The DistilCTCModel forward (a stage-cut model, `apply_pp_sharding`)
    with the STUDENT's layer stack pipelined: featurization (dither and
    SpecAugment from rngs['specaug'] when training), the pipelined
    encode (dropout seeds from rngs['dropout']), then
    `forward_with_student_encode` (the frozen teacher, every KD loss and the
    CTC head) on every stage. Returns the DistilOutput of the unpipelined
    forward on the same draws; at dp > 1 the backward sums every trained
    gradient over the data axis."""
    rngs = rngs or {}
    feats, feat_len, _ = model.student._features(signal, signal_len, train,
                                                 rngs)
    encoded, out_len, stu_feats = encode_pipelined_feats(
        model.student, feats, feat_len, n_micro, train, rngs.get("dropout"),
        trained=model)
    return model.forward_with_student_encode(
        encoded, out_len, stu_feats, signal, signal_len, transcripts,
        transcript_lengths, train, rngs=rngs)


def ctc_forward_pipelined(model, signal: torch.Tensor,
                          signal_len: torch.Tensor, n_micro: int):
    """Featurize -> pipelined encode -> decode of a stage-cut CTCModel
    (`apply_pp_sharding(model, encoder_path='')`) in eval: (log_probs,
    encoded_len)."""
    with torch.no_grad():
        feats, feat_len = model.featurizer(signal, signal_len, False, None)
        encoded, out_len = encode_pipelined(model, feats, feat_len, n_micro)
        return model.decode_logits(encoded), out_len
