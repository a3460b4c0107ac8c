"""SpecAugment: the PyTorch counterpart of tpu_asr/ops/specaug.py, with the
masks drawn from an explicit `torch.Generator`.

- `freq_masks` frequency stripes per sample: width ~ U{0..freq_width},
  start ~ U{0..max(1, D - freq_width) - 1};
- `time_masks` time stripes per sample: with `time_width` < 1 the largest
  width is max(1, floor(time_width * length)) per sample; width and start
  are drawn as uniform fractions of their ranges, as the JAX version does.
Masked cells take `mask_value`. Same semantics as the JAX version, other
random numbers (the two frameworks' generators differ).
"""

from __future__ import annotations

import torch

from tpu_asr_torch.config import SpecAugmentConfig
from tpu_asr_torch.parallel.mesh import draw_rows


def spec_augment(spec: torch.Tensor, length: torch.Tensor,
                 cfg: SpecAugmentConfig,
                 generator: torch.Generator) -> torch.Tensor:
    """(B, D, T) log-mel, (B,) valid frames -> masked (B, D, T)."""
    b, d, t = spec.shape
    dev = spec.device
    kw = dict(generator=generator, device=dev)
    # each row's draws are those of its row in the global batch
    rand = lambda shape: draw_rows(lambda s: torch.rand(s, **kw), shape)
    randint = lambda lo, hi, shape: draw_rows(
        lambda s: torch.randint(lo, hi, s, **kw), shape)
    mask = torch.zeros((b, d, t), dtype=torch.bool, device=dev)
    if cfg.freq_masks > 0:
        widths = randint(0, cfg.freq_width + 1, (b, cfg.freq_masks))
        starts = randint(0, max(1, d - cfg.freq_width), (b, cfg.freq_masks))
        f_idx = torch.arange(d, device=dev)[None, None, :]
        fmask = (f_idx >= starts[..., None]) & (
            f_idx < (starts + widths)[..., None])
        mask |= fmask.any(dim=1)[:, :, None]
    if cfg.time_masks > 0:
        if cfg.time_width < 1.0:
            max_w = (length.float() * cfg.time_width).long().clamp(min=1)
        else:
            max_w = torch.full((b,), int(cfg.time_width), device=dev)
        u_w = rand((b, cfg.time_masks))
        widths = (u_w * (max_w[:, None] + 1).float()).long()
        start_hi = (length[:, None] - widths).clamp(min=1)
        u_s = rand((b, cfg.time_masks))
        starts = (u_s * start_hi.float()).long()
        t_idx = torch.arange(t, device=dev)[None, None, :]
        tmask = (t_idx >= starts[..., None]) & (
            t_idx < (starts + widths)[..., None])
        mask |= tmask.any(dim=1)[:, None, :]
    return spec.masked_fill(mask, cfg.mask_value)
