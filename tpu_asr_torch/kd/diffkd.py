"""DiffKD, latent denoising KD: the PyTorch counterpart of
tpu_asr/kd/diffkd.py (reference DiffKDModule, asr_train.py:244-312).

A teacher 1x1-conv autoencoder (`encoder`, `decoder`) whose latent z_t is
detached BEFORE decoding (so the recon MSE trains the decoder alone), a
student 1x1-conv projection (`proj`) into the latent, and `steps`
iterations of `x <- x - conv2(relu(conv1(x))) / steps` (k=3 convs,
`denoiser_conv1`, `denoiser_conv2`), then MSE(x, z_t). Returns recon MSE +
KD MSE. Convolutions run feature-last in the compute dtype, the losses in
fp32.

`loss_layers=L` declares that the rows are L encoder layers stacked into
the batch: every mean is over equal-size layer slabs, so L times the mean
over all rows is the per-layer loss summed over layers (the reference's
aggregation, asr_train.py:754-757). Under data parallelism each mean is
the rank's share (parallel/mesh.py batch_mean).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_asr_torch.config import DiffKDConfig
from tpu_asr_torch.kd.meta_encoders import conv_btc
from tpu_asr_torch.parallel.mesh import batch_mean


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return batch_mean(torch.square(a.float() - b.float()))


class DiffKDModule(nn.Module):
    def __init__(self, cfg: DiffKDConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        lat = cfg.latent
        self.encoder = nn.Conv1d(cfg.teacher_dim, lat, 1)
        self.decoder = nn.Conv1d(lat, cfg.teacher_dim, 1)
        self.proj = nn.Conv1d(cfg.student_dim, lat, 1)
        self.denoiser_conv1 = nn.Conv1d(lat, lat, 3, padding=1)
        self.denoiser_conv2 = nn.Conv1d(lat, lat, 3, padding=1)

    def forward(self, stu_feat: torch.Tensor, tch_feat: torch.Tensor,
                loss_layers: Optional[int] = None) -> torch.Tensor:
        """(B, T, C_s) student and (B, T, C_t) teacher features -> scalar."""
        steps = self.cfg.steps
        z_t = conv_btc(self.encoder, tch_feat.to(self.dtype)).detach()
        ae_loss = _mse(conv_btc(self.decoder, z_t), tch_feat)
        x = conv_btc(self.proj, stu_feat.to(self.dtype))
        for _ in range(steps):
            noise = conv_btc(self.denoiser_conv2,
                          F.relu(conv_btc(self.denoiser_conv1, x)))
            x = x - noise / steps
        loss = ae_loss + _mse(x, z_t)
        return loss if loss_layers is None else loss_layers * loss
