"""Logit-KL and layerwise feature-MSE distillation losses: the PyTorch
counterpart of tpu_asr/kd/losses.py (reference asr_train.py:404-414,
725-748), reference quirks kept:

- logit KL: the student's ALREADY log-softmaxed outputs go through a second
  log-softmax at temperature T; KL(teacher || student) summed over every
  element, padded frames included, divided by the batch size B only
  (torch 'batchmean'), times T^2;
- layerwise MSE: per-layer mean squared error, summed over layers, then
  (optionally) averaged over them.

Teacher inputs are detached (JAX's stop_gradient).
"""

from __future__ import annotations

import torch


def logit_kl_loss(stu_log_probs: torch.Tensor, tch_log_probs: torch.Tensor,
                  temperature: float = 1.0) -> torch.Tensor:
    """(B, T, V) student and teacher log-softmax outputs -> scalar."""
    t = temperature
    stu = torch.log_softmax(stu_log_probs.float() / t, dim=-1)
    tch = torch.softmax(tch_log_probs.detach().float() / t, dim=-1)
    log_tch = torch.log(torch.clamp(tch, min=1e-38))
    kl = torch.sum(tch * (log_tch - stu)) / stu_log_probs.shape[0]
    return kl * (t * t)


def layerwise_mse_loss(stu_feats_proj: torch.Tensor, tch_feats: torch.Tensor,
                       average_layers: bool = True) -> torch.Tensor:
    """(L, B, T, C_t) projected student and teacher features -> scalar."""
    err = torch.square(stu_feats_proj.float() - tch_feats.detach().float())
    total = err.mean(dim=(1, 2, 3)).sum()
    return total / stu_feats_proj.shape[0] if average_layers else total
