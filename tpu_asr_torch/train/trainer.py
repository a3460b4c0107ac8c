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

`make_distil_eval_step` is the counterpart of JAX's of that name: the model
in eval mode under `torch.no_grad()`, its losses, the per-sample CTC NLLs
(`per_sample_ctc`, so an evaluation can weigh real rows only) and the
greedy tokens, all left on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from tpu_asr_torch.config import OptimConfig
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.ops.ctc import ctc_greedy_decode_ids, ctc_loss
from tpu_asr_torch.train.optim import (Schedule, build_optimizer,
                                       clip_by_global_norm, global_norm,
                                       set_lr)


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


def make_distil_train_step(model: DistilCTCModel,
                           packed: bool = False) -> Callable:
    """Returns train_step(state, batch, seed) -> (state, metrics); batch
    holds `signal` (B, L) f32, `signal_len` (B,), `tokens` (B, S) and
    `token_len` (B,) on the model's device. `packed`: packed-segment
    training (model.forward_packed_train); the batch also carries the plan
    of data/packing.train_pack_arrays, `pk_src_utt`, `pk_src_pos`, `pk_seg`
    (R, Tp) and `pk_row`, `pk_start` (B,), as tensors or numpy arrays."""

    def train_step(state: DistilTrainState, batch: Dict[str, torch.Tensor],
                   seed: int) -> Tuple[DistilTrainState, Dict]:
        dev = batch["signal"].device
        model.train()
        rngs = step_rngs(seed, state.step, dev)
        args = (batch["signal"], batch["signal_len"], batch["tokens"],
                batch["token_len"])
        if packed:
            out = model.forward_packed_train(
                *args, *(batch[k] for k in PACK_KEYS), train=True, rngs=rngs)
        else:
            out = model(*args, train=True, rngs=rngs)
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
            metrics["nonfinite_grad_elems"] = sum(b.sum() for b in bad)
            for g, b in zip(grads, bad):
                g.masked_fill_(b, 0.0)
        norm = global_norm(grads)
        metrics["grad_norm"] = norm
        clip = state.optim_cfg.gradient_clip_val
        if clip and clip > 0:
            clip_by_global_norm(grads, clip, norm)
        set_lr(opt, state.schedule(state.step))
        opt.step()
        state.step += 1
        return state, metrics

    return train_step


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
