"""Optimizers and LR schedules: the PyTorch counterpart of
tpu_asr/train/optim.py (NeMo's NoamAnnealing / CosineAnnealing; the five
optimizers of its `_base_optimizer`).

A schedule maps optax's update count (0 for the first update) to the
learning rate of that update, so `count + 1` is NeMo's step.

- `adamw`, `adam`, `sgd`: torch.optim.AdamW / Adam / SGD, whose updates
  are optax's `adamw` (the same decoupled decay, with the update's own
  learning rate), `adam` (eps 1e-8) and `sgd` (momentum = betas[0]: torch's
  buffer starts at the first gradient, optax's trace at 0 + g).
- `novograd`, `adafactor`: written out (`NovoGrad`, `Adafactor`) after
  optax's update rules. Both work on optax's leaves. JAX scans the encoder
  layers (tpu_asr/models/conformer.py:974-1010), so one leaf there is a
  parameter of every layer of a scan segment, stacked; the port keeps one
  tensor a layer, and `optax_leaves` groups `*.encoder.layers.{i}.<name>`
  (and `layers_post`) back into those stacks: novograd's squared norm, and
  adafactor's parameter scale and update clipping, are taken over the
  whole stack. Adafactor's factored statistics are symmetric in a matrix's
  two axes, so a leaf keeps the port's layout, except the meta encoders'
  attention projections, whose JAX kernels are (d, heads, dh) and (heads,
  dh, out) (`_jax_view`). torch.optim.Adafactor is another algorithm.

Gradient clipping is optax's `clip_by_global_norm`; parameters under a
top-level `teacher` module are frozen (left out of the optimizer).
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tpu_asr_torch.config import OptimConfig
from tpu_asr_torch.parallel.mesh import axis_sum
from tpu_asr_torch.parallel.sharding import sharded_axes

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


OPTIMIZERS = ("adamw", "adam", "sgd", "novograd", "adafactor")
_STACKED = re.compile(r"^(.*\.layers(?:_post)?)\.(\d+)\.(.+)$")

# A leaf: its parameters (one, or one a layer of a scan segment) and the
# view that turns each of them into JAX's layout: (perm, shape) applied as
# t.permute(perm).reshape(shape), or None for the port's own layout.
Leaf = Tuple[List[torch.nn.Parameter], Optional[Tuple[tuple, tuple]]]


def _jax_views(model: torch.nn.Module) -> Dict[str, Tuple[tuple, tuple]]:
    """{parameter name: view} where JAX's leaf has another shape: a
    MultiHeadAttention's query / key / value kernels (d, heads, dh) and
    biases (heads, dh), its out kernel (heads, dh, out)."""
    from tpu_asr_torch.kd.meta_encoders import MultiHeadAttention
    views = {}
    for mname, m in model.named_modules():
        if not isinstance(m, MultiHeadAttention):
            continue
        h = m.n_heads
        for proj in ("query", "key", "value"):
            w = getattr(m, proj).weight                 # (h * dh, d)
            views[f"{mname}.{proj}.weight"] = ((1, 0), (w.shape[1], h, -1))
            views[f"{mname}.{proj}.bias"] = ((0,), (h, -1))
        w = m.out.weight                                # (out, h * dh)
        views[f"{mname}.out.weight"] = ((1, 0), (h, -1, w.shape[0]))
    return views


def optax_leaves(model: torch.nn.Module,
                 params: Sequence[Tuple[str, torch.nn.Parameter]]
                 ) -> List[Leaf]:
    """The trainable `params` (name, parameter) grouped as optax's leaves:
    a layer-stack per `<prefix>.layers.{i}.<name>` (and `layers_post`),
    every other parameter alone, in first-seen order."""
    views = _jax_views(model)
    groups: Dict[str, Leaf] = {}
    for name, p in params:
        m = _STACKED.match(name)
        key = f"{m[1]}.*.{m[3]}" if m else name
        if key not in groups:
            groups[key] = ([], views.get(name))
        groups[key][0].append(p)
    return list(groups.values())


class _LeafOptimizer(torch.optim.Optimizer):
    """Base of the optimizers that work on optax leaves: each step reads a
    leaf's gradients and weights as stacked tensors in JAX's layout (a
    missing gradient reads as zeros, as JAX's is), calls `_update(g, w,
    state, lr)` for the leaf's update in that layout, and adds it to the
    parameters. The state of a leaf is kept under its first parameter."""

    def __init__(self, leaves: List[Leaf], defaults: dict):
        params = [p for ps, _ in leaves for p in ps]
        super().__init__(params, defaults)
        self.leaves = leaves

    @staticmethod
    def _stack(tensors, view, stacked: bool) -> torch.Tensor:
        if view is not None:
            perm, shape = view
            tensors = [t.permute(perm).reshape(shape) for t in tensors]
        return torch.stack(tensors) if stacked else tensors[0]

    @staticmethod
    def _unstack(u: torch.Tensor, params, view, stacked: bool):
        for i, p in enumerate(params):
            ui = u[i] if stacked else u
            if view is not None:
                perm, _ = view
                inv = sorted(range(len(perm)), key=perm.__getitem__)
                ui = ui.reshape([p.shape[j] for j in perm]).permute(inv)
            p.add_(ui.to(p.dtype))

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.param_groups[0]["lr"]
        for ps, view in self.leaves:
            stacked = len(ps) > 1
            g = self._stack([p.grad if p.grad is not None
                             else torch.zeros_like(p) for p in ps],
                            view, stacked).float()
            w = self._stack([p.detach() for p in ps], view, stacked).float()
            u = self._update(g, w, self.state[ps[0]], lr)
            self._unstack(u, ps, view, stacked)

    def _update(self, g, w, state, lr):
        raise NotImplementedError


class NovoGrad(_LeafOptimizer):
    """optax.novograd(lr, b1, b2, eps=1e-6, weight_decay): nu, the moving
    average of a leaf's squared norm (nu = |g|^2 on the first step, then
    b2 nu + (1 - b2) |g|^2), mu = g / (sqrt(nu) + eps) + wd w on the first
    step, then b1 mu + that; the update is -lr mu."""

    def __init__(self, leaves: List[Leaf], lr: float, betas=(0.9, 0.25),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(leaves, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _update(self, g, w, state, lr):
        d = self.defaults
        b1, b2 = d["betas"]
        sq = g.square().sum()
        if "nu" not in state:
            state["nu"] = sq
            mu = g / (state["nu"].sqrt() + d["eps"]) + d["weight_decay"] * w
        else:
            state["nu"] = (1 - b2) * sq + b2 * state["nu"]
            mu = b1 * state["mu"] + (g / (state["nu"].sqrt() + d["eps"])
                                     + d["weight_decay"] * w)
        state["mu"] = mu
        return -lr * mu


def _factored_dims(shape, min_dim: int = 128):
    """optax's _factored_dims: the two largest axes (second-largest,
    largest), or None when the second-largest is below `min_dim`."""
    if len(shape) < 2:
        return None
    import numpy as np
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_LeafOptimizer):
    """optax.adafactor(lr) at its defaults: decay 0.8 (the rate 1 -
    (count + 1)^-0.8), second moments factored into row and column
    averages where a leaf's second-largest axis is at least 128, eps 1e-30
    added to g^2; the scaled gradient clipped to an RMS of 1.0, times lr
    and the leaf's RMS (at least 1e-3); no momentum, no weight decay."""

    def __init__(self, leaves: List[Leaf], lr: float,
                 decay_rate: float = 0.8, eps: float = 1e-30,
                 clipping_threshold: float = 1.0, min_scale: float = 1e-3):
        super().__init__(leaves, dict(lr=lr, decay_rate=decay_rate, eps=eps,
                                      clipping_threshold=clipping_threshold,
                                      min_scale=min_scale))

    def _update(self, g, w, state, lr):
        d = self.defaults
        count = state.get("count", 0)
        rate = 1.0 - (count + 1.0) ** (-d["decay_rate"])
        state["count"] = count + 1
        g_sq = g.square() + d["eps"]
        dims = _factored_dims(tuple(g.shape))
        if dims is not None:
            d1, d0 = dims
            v_row = rate * state.get("v_row", 0.0) + (1 - rate) * g_sq.mean(d0)
            v_col = rate * state.get("v_col", 0.0) + (1 - rate) * g_sq.mean(d1)
            state["v_row"], state["v_col"] = v_row, v_col
            red = d1 - 1 if d1 > d0 else d1
            row = (v_row / v_row.mean(red, keepdim=True)) ** -0.5
            u = g * row.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
        else:
            v = rate * state.get("v", 0.0) + (1 - rate) * g_sq
            state["v"] = v
            u = g * v ** -0.5
        u = u / torch.clamp(u.square().mean().sqrt()
                            / d["clipping_threshold"], min=1.0)
        rms = w.square().mean().sqrt()
        scale = torch.where(rms <= d["min_scale"],
                            torch.full_like(rms, d["min_scale"]), rms)
        return -lr * scale * u


def build_optimizer(cfg: OptimConfig, model: torch.nn.Module,
                    freeze_teacher: bool = True
                    ) -> Tuple[torch.optim.Optimizer, Schedule]:
    """(the named optimizer over the trainable parameters, schedule). The
    caller sets each update's learning rate from the schedule
    (`set_lr`)."""
    name = cfg.name.lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer: {cfg.name}")
    named = [(n, p) for n, p in model.named_parameters()
             if not (freeze_teacher and n.split(".")[0] == "teacher")]
    params = [p for _, p in named]
    schedule = build_schedule(cfg)
    lr, betas = schedule(0), tuple(cfg.betas)
    if name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                weight_decay=cfg.weight_decay)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=betas[0])
    elif name == "novograd":
        opt = NovoGrad(optax_leaves(model, named), lr, betas,
                       weight_decay=cfg.weight_decay)
    else:
        opt = Adafactor(optax_leaves(model, named), lr)
    return opt, schedule


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def global_norm(grads: List[torch.Tensor],
                params: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The L2 norm of all of `grads`. With `params` (the gradients'
    parameters) under tensor or pipeline parallelism: each square sum
    counted once, a slice's summed over the ranks that hold the other
    slices (parallel/sharding.sharded_axes) and a replicated parameter's
    taken as it is, equal on every rank."""
    return torch.sqrt(split_sum([g.float().square().sum() for g in grads],
                                params))


def split_sum(values: List[torch.Tensor],
              params: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The sum of per-parameter scalars `values`, each summed over the
    axes its parameter is split on (all ranks agree on the result)."""
    if params is None:
        return sum(values)
    buckets = {}
    for v, p in zip(values, params):
        axes = sharded_axes(p)
        buckets[axes] = buckets.get(axes, 0) + v
    total = 0
    for axes, v in buckets.items():
        for axis in axes:
            v = axis_sum(torch.as_tensor(v), axis)
        total = total + v
    return total


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: g * max_norm / max(norm,
    max_norm)."""
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale)
