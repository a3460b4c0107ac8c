"""Optimizer and LR schedules: the PyTorch counterpart of
tpu_asr/train/optim.py (NeMo's NoamAnnealing / CosineAnnealing on AdamW).

A schedule maps optax's update count (0 for the first update) to the
learning rate of that update, so `count + 1` is NeMo's step.
`torch.optim.AdamW` applies the same decoupled decay as `optax.adamw`
(on every parameter, with the update's own learning rate). Gradient
clipping is optax's `clip_by_global_norm`; parameters under a top-level
`teacher` module are frozen (left out of the optimizer).
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch

from tpu_asr_torch.config import OptimConfig

Schedule = Callable[[int], float]


def noam_annealing_schedule(lr: float, d_model: int, warmup_steps: int,
                            min_lr: float = 0.0) -> Schedule:
    norm = d_model ** -0.5

    def schedule(count: int) -> float:
        step = max(count + 1, 1)
        if warmup_steps and warmup_steps > 0:
            mult = norm * min(step ** -0.5, step * warmup_steps ** -1.5)
        else:
            mult = norm * step ** -0.5
        out = lr * mult
        # NeMo applies the min_lr floor only past warmup
        return max(out, min_lr) if step > warmup_steps else out

    return schedule


def cosine_annealing_schedule(lr: float, warmup_steps: int, max_steps: int,
                              min_lr: float = 0.0) -> Schedule:
    def schedule(count: int) -> float:
        step = count + 1
        if step <= warmup_steps:
            return lr * step / max(warmup_steps, 1)
        progress = min(max((step - warmup_steps)
                           / max(max_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi
                                                              * progress))

    return schedule


def build_schedule(cfg: OptimConfig) -> Schedule:
    name = cfg.sched_name.lower()
    if name in ("noamannealing", "noam"):
        return noam_annealing_schedule(cfg.lr, cfg.d_model, cfg.warmup_steps,
                                       cfg.min_lr)
    if name in ("cosineannealing", "cosine"):
        return cosine_annealing_schedule(cfg.lr, cfg.warmup_steps,
                                         cfg.max_steps, cfg.min_lr)
    if name in ("none", "constant"):
        return lambda count: cfg.lr
    raise ValueError(f"unknown scheduler: {cfg.sched_name}")


def build_optimizer(cfg: OptimConfig, model: torch.nn.Module,
                    freeze_teacher: bool = True
                    ) -> Tuple[torch.optim.Optimizer, Schedule]:
    """(AdamW over the trainable parameters, schedule). The caller sets
    each update's learning rate from the schedule (`set_lr`)."""
    if cfg.name.lower() != "adamw":
        raise ValueError(f"tpu_asr_torch does not implement optimizer "
                         f"{cfg.name!r}")
    params = [p for name, p in model.named_parameters()
              if not (freeze_teacher and name.split(".")[0] == "teacher")]
    schedule = build_schedule(cfg)
    opt = torch.optim.AdamW(params, lr=schedule(0), betas=tuple(cfg.betas),
                            eps=1e-8, weight_decay=cfg.weight_decay)
    return opt, schedule


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: g * max_norm / max(norm,
    max_norm)."""
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale)
