"""Flow-matching KD (FM-KT) module: the PyTorch counterpart of
tpu_asr/kd/flow_matching.py (reference FlowMatchingModule,
asr_train.py:1220-1377).

- The Euler loop `x <- x - v(x, t) / N`, t = N/N .. 1/N, runs over a
  static trip count `max_steps` with per-row step counts N (a row updates
  while j < N and keeps the velocity of j = N - 1).
- With the `mlp` meta encoder it runs as one fused call
  (ops/cuda_fm.py::fused_fm_euler), the time embedding Linear(1 -> E)
  folded outside the call and under autograd:
  w1x = fc1.W[:, :C], a = fc1.W[:, C:] te.W[:, 0], c = fc1.W[:, C:] te.b +
  fc1.b, so gradients reach the time embedding and fc1's time columns.
  `euler_backend` 'pallas' calls the kernel wrapper (the CUDA kernel for
  CUDA tensors, the plain loop for CPU tensors) and raises where the kernel
  refuses the shape; 'auto' calls it where the kernel takes the shape (C,
  H, max_steps, dtype) and the plain loop elsewhere, as JAX's 'auto' falls
  back to XLA; 'xla' the plain loop.
- Any other meta encoder (`cnn`, `swin`, `conformer`, `unet`) runs the
  generic masked loop of JAX's _EulerStep scan: t embedded by
  `time_embed` in x's dtype, concatenated to x, the meta encoder called
  (in training with its dropout seeds from the `generator`), x updated
  under the active mask. `euler_backend='pallas'` raises for them, as
  JAX's resolve_euler_backend does.
- The training loss uses only the LAST velocity (t = 1/N):
  x_hat = (dalpha_dt s_f - last_v) / (-dsigma_dt), then the shape transform
  (identity, linear or conv1d with kernel 1), then mse or cosine
  (mean(1 - cos) over positions), then `loss_layers` L * mean when the rows
  are L stacked layers.
- `group_loss` (the dynamic router's aggregation): the sum over step
  counts of each group's mean error; with `loss_layers=L` the groups are
  (layer, step count) pairs of the B-major rows (row = b * L + l), which
  is the per-layer group loss summed over layers.
- Under data parallelism (parallel/mesh.py) the loss is the rank's share:
  the element mean over the ranks' count, each group's sum over the global
  group's count.

Parameters carry the JAX module's paths: `euler.time_embed`,
`euler.meta_encoder.*` (the `mlp`'s fc1 and fc2, or the other meta
encoder's own, kd/meta_encoders.py), and `shape_transform` or
`shape_transform_conv`.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tpu_asr_torch.config import FlowMatchingConfig
from tpu_asr_torch.kd.meta_encoders import build_meta_encoder
from tpu_asr_torch.kd.schedules import get_noise_schedule
from tpu_asr_torch.ops._kernels import use_kernel
from tpu_asr_torch.ops.cuda_fm import (fm_euler_plain, fm_refusal,
                                       fused_fm_euler)
from tpu_asr_torch.parallel.mesh import batch_mean, global_sum

BACKENDS = ("auto", "pallas", "xla")


class _EulerStep(nn.Module):
    """The shared parameters of one Euler step: time embedding and meta
    encoder."""

    def __init__(self, c: FlowMatchingConfig):
        super().__init__()
        self.time_embed = nn.Linear(1, c.time_embed_dim)
        self.meta_encoder = build_meta_encoder(
            c.meta_encoder_type, in_dim=c.student_dim + c.time_embed_dim,
            out_dim=c.student_dim, hidden_dim=c.hidden_dim,
            n_heads=c.student_head_num)


class FlowMatchingModule(nn.Module):
    def __init__(self, cfg: FlowMatchingConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.euler_backend not in BACKENDS:
            raise ValueError(f"tpu_asr_torch does not implement "
                             f"euler_backend {cfg.euler_backend!r}")
        if cfg.euler_backend == "pallas" and cfg.meta_encoder_type != "mlp":
            raise ValueError(
                "euler_backend='pallas' implements only the 'mlp' meta "
                f"encoder (got meta_encoder_type={cfg.meta_encoder_type!r}); "
                "use 'xla'")
        self.cfg, self.dtype, self.backend = cfg, dtype, cfg.euler_backend
        self.euler = _EulerStep(cfg)
        if cfg.shape_transform == "linear":
            self.shape_transform = nn.Linear(cfg.student_dim, cfg.teacher_dim)
        elif cfg.shape_transform == "conv1d":
            self.shape_transform_conv = nn.Conv1d(cfg.student_dim,
                                                  cfg.teacher_dim, 1)
        elif cfg.shape_transform != "identity":
            raise ValueError(
                f"Unknown shape_transform type: {cfg.shape_transform}")
        if cfg.loss not in ("mse", "cosine"):
            raise ValueError(f"Unknown loss type: {cfg.loss}")

    def _shape_transform(self, x: torch.Tensor) -> torch.Tensor:
        t = self.cfg.shape_transform
        if t == "identity":
            return x
        layer = (self.shape_transform if t == "linear"
                 else self.shape_transform_conv)
        w = layer.weight[..., 0] if t == "conv1d" else layer.weight
        return F.linear(x, w.to(x.dtype), layer.bias.to(x.dtype))

    def _metric_loss(self, pred: torch.Tensor,
                     target: torch.Tensor) -> torch.Tensor:
        pred, target = pred.float(), target.float()
        if self.cfg.loss == "mse":
            return torch.square(pred - target)
        num = torch.sum(pred * target, dim=-1)
        den = (torch.linalg.vector_norm(pred, dim=-1)
               * torch.linalg.vector_norm(target, dim=-1))
        return (1.0 - num / torch.clamp(den, min=1e-8))[..., None]

    def euler_weights(self):
        """(w1x (C, H), a (H,), c (H,), w2 (H, C), b2 (C,)) in fp32, the time
        embedding folded into a and c."""
        cs = self.cfg.student_dim
        te, mlp = self.euler.time_embed, self.euler.meta_encoder
        w1 = mlp.fc1.weight                          # (H, C + E)
        w1t = w1[:, cs:]
        return (w1[:, :cs].t(), w1t @ te.weight[:, 0],
                w1t @ te.bias + mlp.fc1.bias, mlp.fc2.weight.t(),
                mlp.fc2.bias)

    def uses_kernel(self, w1x: torch.Tensor, max_steps: int) -> bool:
        """Whether the Euler loop takes the kernel wrapper for the folded
        W1x (C, H) and max_steps."""
        return use_kernel(self.backend, fm_refusal(
            w1x.shape[0], w1x.shape[1], int(max_steps), self.dtype))

    def euler_loop(self, x0: torch.Tensor, steps_b: torch.Tensor,
                   max_steps: int, train: bool = False,
                   generator: Optional[torch.Generator] = None):
        """(x_final, last_v) of the generic masked Euler loop (JAX's
        _EulerStep scan), for any meta encoder, in x0's dtype."""
        te, meta = self.euler.time_embed, self.euler.meta_encoder
        b, t_len, _ = x0.shape
        dt = x0.dtype
        n = steps_b.float()[:, None, None]
        x, last_v = x0, torch.zeros_like(x0)
        for j in range(int(max_steps)):
            t = ((n - j) / n).to(dt).expand(b, t_len, 1)
            emb = F.linear(t, te.weight.to(dt), te.bias.to(dt))
            v = meta(torch.cat([x, emb], dim=-1), train, generator)
            x = torch.where(j < n, x - v / n.to(dt), x)
            last_v = torch.where(n - 1.0 == j, v, last_v)
        return x, last_v

    def forward(self, s_f: torch.Tensor, t_f: Optional[torch.Tensor] = None,
                steps: Union[int, torch.Tensor, None] = None,
                max_steps: Optional[int] = None, train: bool = False,
                group_loss: bool = False,
                loss_layers: Optional[int] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, x_final (B, T, C_s) in the compute dtype) for the student
        feature s_f (B, T, C_s) and, in training, the teacher feature t_f
        (B, T, C_t). `loss_layers=L`: the rows are L stacked layers,
        B-major (row = b * L + l). `generator`: the dropout seeds of a
        meta encoder with dropout, in training."""
        c = self.cfg
        b = s_f.shape[0]
        if loss_layers is not None and b % loss_layers:
            raise ValueError(f"FlowMatchingModule: {b} rows are not "
                             f"{loss_layers} stacked layers")
        if steps is None:
            steps = c.training_sampling if train else c.inference_sampling
        if max_steps is None:
            max_steps = (steps if isinstance(steps, int)
                         else c.router_max_sampling_steps)
        steps_b = torch.as_tensor(steps, dtype=torch.int32,
                                  device=s_f.device).expand(b)
        x0 = s_f.to(self.dtype)
        if c.meta_encoder_type == "mlp":
            weights = self.euler_weights()
            run = (fused_fm_euler if self.uses_kernel(weights[0], max_steps)
                   else fm_euler_plain)
            x, last_v = run(x0, steps_b, *weights, max_steps=max_steps,
                            compute_dtype=self.dtype)
        else:
            x, last_v = self.euler_loop(x0, steps_b, max_steps, train,
                                        generator)
        loss = torch.zeros((), device=s_f.device)
        if train and t_f is not None:
            _, schedule_deriv = get_noise_schedule(c.noise_schedule)
            t_last = 1.0 / steps_b.float()[:, None, None]
            dalpha_dt, dsigma_dt = schedule_deriv(t_last)
            x_hat = (dalpha_dt * s_f.float() - last_v.float()) / (-dsigma_dt)
            err = self._metric_loss(self._shape_transform(
                x_hat.to(self.dtype)), t_f)
            if group_loss:
                loss = self._group_loss(err.reshape(b, -1), steps_b,
                                        max_steps, loss_layers)
            else:
                loss = batch_mean(err) if loss_layers is None else \
                    loss_layers * batch_mean(err)
        return loss, x

    @staticmethod
    def _group_loss(err: torch.Tensor, steps_b: torch.Tensor,
                    max_steps: int, loss_layers: Optional[int]
                    ) -> torch.Tensor:
        """Sum over groups of the group's mean of `err` (rows, elements):
        groups by step count 1..max_steps, or with `loss_layers` by (layer
        row % L, min(step count, max_steps)); an empty group adds 0. Under
        data parallelism a group's count is that of the global batch, so
        this rank's sums over it are its share."""
        rows, dev = err.shape[0], err.device
        if loss_layers is not None:
            per_row = err.mean(dim=1)
            n_seg = loss_layers * (max_steps + 1)
            seg = ((torch.arange(rows, device=dev) % loss_layers)
                   * (max_steps + 1) + steps_b.long().clamp(max=max_steps))
            sums = torch.zeros(n_seg, device=dev).index_add_(0, seg, per_row)
            counts = global_sum(torch.zeros(n_seg, device=dev).index_add_(
                0, seg, torch.ones(rows, device=dev)))
        else:
            ks = torch.arange(1, max_steps + 1, device=dev)
            in_group = (steps_b[:, None] == ks).float()           # (rows, K)
            sums = err.sum(dim=1) @ in_group
            counts = global_sum(in_group.sum(dim=0))
            counts_el = counts * err.shape[1]
            return torch.where(counts > 0, sums / counts_el.clamp(min=1.0),
                               0.0).sum()
        return torch.where(counts > 0, sums / counts.clamp(min=1.0),
                           0.0).sum()
