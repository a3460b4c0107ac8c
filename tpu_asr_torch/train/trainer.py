"""The distil train step: the PyTorch counterpart of
tpu_asr/train/trainer.py::make_distil_train_step.

One step: forward with training randomness, loss, backward, the optional
`skip_nan_grad` guard (non-finite gradient elements zeroed and counted),
optional global-norm clipping, and the optimizer update at the schedule's
learning rate for this step. Per-step randomness comes from generators
seeded from (seed, step), the analogue of JAX's fold_in(base_rng, step):
the same seed and step give the same dither, SpecAugment masks, dropout
masks, router draws and diffm noise. Metrics stay on the device:
'loss/<name>' for each loss, the model's own metrics (the router's mean
step count, the interCTC losses), 'grad_norm' (before clipping) and, with
skip_nan_grad, 'nonfinite_grad_elems'.

Data parallelism (parallel/mesh.py): when a process group is initialised,
the step runs the model through `torch.nn.parallel.DistributedDataParallel`
(`ddp_model`, one wrapper a model), built over the trainable parameters;
the frozen teacher's take no gradient and are never reduced. Each rank
holds its block of the global batch and its losses are its shares of the
single-rank losses, so the wrapper's communication hook SUMS the gradients
(DDP's own hook averages); the gradients are views into its buckets, so
no copy runs between them. BatchNorm's statistics are already global and
equal on every rank, so buffers are not broadcast. The non-finite guard and
the clipping run on the reduced gradients, so every rank decides alike.
The generators are seeded alike on every rank; each draw that depends on
the row is the global batch's, cut to the rank's rows. Packed training
(`packed=True`) at N ranks splits one plan of the global batch by its
packed rows (parallel/mesh.packed_rank_block): BatchNorm's statistics run
over every rank's packed frames, the dropout streams of the packed rows
begin at the rank's first row, and the per-utterance draws and the losses
are taken at each utterance's place in the global batch, so the N-rank
step is the one-rank packed step on the same plan. The packed step goes
through the DDP wrapper as the bucketed one does (DistilCTCModel.forward's
`packed`).

Tensor parallelism (a ('data', 'model') mesh, parallel/mesh.make_mesh,
and the model sharded by parallel/sharding.shard_module): DDP wraps over
the data group only (its construction broadcasts the data group's first
rank's parameters, which hold the same slices), and only where the data
axis has more than one rank. The ranks of a model group hold the same rows
and compute the same loss; their replicated parameters' gradients are
equal, and a slice's gradient is its own. The global norm and the
non-finite count take each slice's part over the model group once
(train/optim.split_sum), so every rank decides the clipping and the
guard alike.

`make_distil_multi_step` runs K steps on a batch stacked (K, ...)
(`steps_per_dispatch`); the harvest and cached variants of the step serve
the teacher feature caches (train/loop.py).

`make_distil_eval_step` is the counterpart of JAX's of that name: the model
in eval mode under `torch.no_grad()`, its losses, the per-sample CTC NLLs
(`per_sample_ctc`, so an evaluation can weigh real rows only) and the
greedy tokens, all left on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from tpu_asr_torch.config import OptimConfig
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.ops.ctc import ctc_greedy_decode_ids, ctc_loss
from tpu_asr_torch.parallel import mesh
from tpu_asr_torch.train.optim import (Schedule, build_optimizer,
                                       clip_by_global_norm, global_norm,
                                       set_lr, split_sum)


@dataclass
class DistilTrainState:
    model: DistilCTCModel
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    optim_cfg: OptimConfig
    step: int = 0
    epoch: int = 0          # the fit loop's epoch in progress
    epoch_step: int = 0     # the step at which that epoch began

    @classmethod
    def create(cls, model: DistilCTCModel,
               optim_cfg: OptimConfig) -> "DistilTrainState":
        opt, schedule = build_optimizer(optim_cfg, model)
        return cls(model, opt, schedule, optim_cfg)


def step_rngs(seed: int, step: int,
              device) -> Dict[str, torch.Generator]:
    """'specaug' on `device` (dither, SpecAugment), 'dropout' on the CPU
    (the dropout seeds), 'gumbel' (the router's draw) and 'noise' (diffm's
    noise, the fresh layerwise projection) on `device`, all seeded from
    (seed, step)."""
    base = (int(seed) * 1_000_003 + int(step)) % (2 ** 63)
    gen = lambda salt, dev=device: torch.Generator(device=dev).manual_seed(
        base ^ salt)
    return {"specaug": gen(0), "dropout": gen(0x5DEECE66D, "cpu"),
            "gumbel": gen(0x2545F491), "noise": gen(0x9E3779B9)}


PACK_KEYS = ("pk_src_utt", "pk_src_pos", "pk_seg", "pk_row", "pk_start")
SPLIT_KEYS = ("pk_utt", "pk_n_utt")      # a rank's part of a split plan


def _sum_hook(group, bucket):
    """DDP communication hook: the SUM of each gradient bucket over the
    ranks (each rank's loss is already its share of the global loss)."""
    work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def unused_parameters_possible(model: DistilCTCModel) -> bool:
    """Whether some trainable parameter of `model` may take no gradient in
    a step, which DDP must then look for (find_unused_parameters): DiffKD's
    teacher encoder (its latent is detached before every use), a router
    without its entropy term (its budget term has no gradient), a decoder
    that no loss reads, and the diffm pipelines."""
    d = model.distill
    router = d.router if model.routed else None
    return bool(d.use_diffkd or d.use_diffm
                or (router is not None and not router.entropy_weight > 0)
                or not (d.use_ctc or d.use_logit_distillation))


def ddp_model(model: DistilCTCModel) -> torch.nn.Module:
    """The model's DistributedDataParallel wrapper with the summing
    communication hook, built once a process group (its construction
    broadcasts rank 0's parameters and buffers; a second wrapper would
    reduce every gradient twice) and kept on the model; the model itself
    when no process group is initialised."""
    if not mesh.initialized() or mesh.axis_size("data") == 1:
        return model
    data = mesh.axis_group("data")
    group = data if data is not None else dist.group.WORLD
    held, wrapped = model.__dict__.get("_ddp", (None, None))
    if held is not group:
        dev = next(model.parameters()).device
        wrapped = DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False, gradient_as_bucket_view=True,
            find_unused_parameters=unused_parameters_possible(model),
            process_group=data)
        wrapped.register_comm_hook(data, _sum_hook)
        # in __dict__, outside nn.Module's registry: not a submodule
        model.__dict__["_ddp"] = (group, wrapped)
    return wrapped


def make_distil_train_step(model: DistilCTCModel, packed: bool = False,
                           cached_teacher: bool = False,
                           harvest_teacher: bool = False,
                           cached_all_layers: bool = False,
                           harvest_all: bool = False) -> Callable:
    """Returns train_step(state, batch, seed) -> (state, metrics); batch
    holds `signal` (B, L) f32, `signal_len` (B,), `tokens` (B, S) and
    `token_len` (B,) on the model's device. Under an initialised process
    group the batch is this rank's block of the global batch and the
    forward runs through `ddp_model`.

    `packed`: packed-segment training (model.forward_packed_train); the
    batch also carries the plan of data/packing.train_pack_arrays,
    `pk_src_utt`, `pk_src_pos`, `pk_seg` (R, Tp) and `pk_row`, `pk_start`
    (B,), as tensors or numpy arrays. At more than one rank it is this
    rank's part of one plan of the global batch
    (parallel/mesh.packed_rank_block, which adds `pk_utt` and `pk_n_utt`).

    The teacher feature caches (train/loop.TeacherFeatureCache):
    `cached_teacher` reads `batch['tch_last_feat']` (B, T', Dt) and
    `cached_all_layers` `batch['tch_all_feat']` (B, L, T', Dt), batch-major
    as JAX's, instead of running the frozen teacher; `harvest_teacher`
    returns (state, metrics, (tch_last, tch_feats, encoded_len)), the
    teacher's outputs of the step, tch_feats (L, B, T', Dt) only with
    `harvest_all` (else None), all detached on the device."""
    forward = ddp_model(model)

    def train_step(state: DistilTrainState, batch: Dict[str, torch.Tensor],
                   seed: int):
        dev = batch["signal"].device
        model.train()
        rngs = step_rngs(seed, state.step, dev)
        args = (batch["signal"], batch["signal_len"], batch["tokens"],
                batch["token_len"])
        kw = {}
        if packed:
            kw["packed"] = {k: batch[k] for k in PACK_KEYS + SPLIT_KEYS
                            if k in batch}
        if cached_teacher:
            kw["tch_last_feat"] = batch["tch_last_feat"]
        if cached_all_layers:
            kw["tch_all_feat"] = batch["tch_all_feat"].transpose(0, 1)
        out = forward(*args, train=True, rngs=rngs, **kw)
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        out.losses["total"].backward()
        params = [p for g in opt.param_groups for p in g["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        metrics = {f"loss/{k}": v.detach() for k, v in out.losses.items()}
        metrics.update({k: v.detach() for k, v in out.metrics.items()})
        if model.student_cfg.skip_nan_grad:
            bad = [~torch.isfinite(g) for g in grads]
            metrics["nonfinite_grad_elems"] = split_sum(
                [b.sum() for b in bad], params)
            for g, b in zip(grads, bad):
                g.masked_fill_(b, 0.0)
        norm = global_norm(grads, params)
        metrics["grad_norm"] = norm
        clip = state.optim_cfg.gradient_clip_val
        if clip and clip > 0:
            clip_by_global_norm(grads, clip, norm)
        set_lr(opt, state.schedule(state.step))
        opt.step()
        state.step += 1
        if harvest_teacher:
            feats = out.tch_feats if harvest_all else None
            return state, metrics, (
                out.tch_last.detach(),
                feats.detach() if feats is not None else None,
                out.encoded_len.detach())
        return state, metrics

    return train_step


def make_distil_multi_step(model: DistilCTCModel) -> Callable:
    """Returns multi_step(state, batches, seed) -> (state, metrics): K
    train steps back to back on `batches`, whose every array is stacked
    (K, ...) along a leading steps axis (data/dataset.stack_batches),
    and the metrics stacked (K,). The same as K `train_step` calls: each
    step draws from (seed, state.step) as they do. Nothing waits on the
    device between the steps (no .item(), no copy to the host), so the host
    queues the K steps' work ahead of the card."""
    train_step = make_distil_train_step(model)

    def multi_step(state: DistilTrainState, batches: Dict[str, torch.Tensor],
                   seed: int) -> Tuple[DistilTrainState, Dict]:
        per_step = []
        for i in range(batches["signal"].shape[0]):
            state, metrics = train_step(
                state, {k: v[i] for k, v in batches.items()}, seed)
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step])
                       for k in per_step[0]}

    return multi_step


def make_distil_eval_step(model: DistilCTCModel) -> Callable:
    """Returns eval_step(state, batch) -> (metrics, (tokens (B, T') int32
    left-packed with -1 padding, n_tokens (B,))): 'loss/<name>' for each
    loss and, when the batch has tokens, 'per_sample_ctc' (B,), the CTC
    NLL of each row. The model is put in eval mode."""

    def eval_step(state: DistilTrainState, batch: Dict[str, torch.Tensor]):
        model.eval()
        with torch.no_grad():
            out = model(batch["signal"], batch["signal_len"],
                        batch.get("tokens"), batch.get("token_len"),
                        train=False)
            blank = out.log_probs.shape[-1] - 1
            decoded = ctc_greedy_decode_ids(out.greedy, out.encoded_len,
                                            blank)
            metrics = {f"loss/{k}": v for k, v in out.losses.items()}
            if batch.get("tokens") is not None:
                metrics["per_sample_ctc"] = ctc_loss(
                    out.log_probs, batch["tokens"], out.encoded_len,
                    batch["token_len"], reduction="none",
                    backend=model.ctc_backend)
        return metrics, decoded

    return eval_step
