"""The latent AE + FM/diffusion KD pipeline ("diffm"): the PyTorch
counterpart of tpu_asr/kd/diffm.py (reference asr_train_diffm.py:400-729).

- Teacher AE (`tae_enc`, `tae_dec`, 1x1 convs): recon = dec(enc(t)) is
  computed BEFORE z_t is detached, so the recon MSE trains encoder and
  decoder (the opposite order of kd/diffkd.py); the KD and FM uses see z_t
  detached. The recon criterion is MSE whatever `kd_loss_type` says.
- Student projection `sproj` (1x1) into the latent.
- NoiseAdapter `adapter`: gamma = sigmoid(g2(relu(g1(z)))) (one channel),
  z_noisy = gamma z + (1 - gamma) eps, eps standard normal from the
  `noise` generator.
- SimpleDenoiser `denoiser`: `diffusion_steps` iterations of
  x <- x - conv2(relu(conv1(x))) / steps (k=3 convs).
- Latent FMs `fm_latent`, `fm_latent_2`: FlowMatchingModule with the
  latent width for student and teacher and the identity transform
  (`latent_fm_config`). With the `mlp` meta encoder their Euler loop is the
  fused kernel (ops/cuda_fm.py) for CUDA tensors.

Versions (`_compute_v_losses_one_layer`, :645-729):
  v1 AE+KD | v2 AE+FM | v3 AE+noise+diff+KD | v4 FMpre + noise+diff+KDpost
  v5 noise+diff -> FMpost | v6 FMpre (chained) -> noise+diff -> FMpost (fm2)
  v7 FMpre (unchained) + noise+diff -> FMpost (fm2)
  v8 FMpre (chained) + KDpost
Only the submodules a version calls are built, as flax creates only the
parameters a call reaches.

Under data parallelism each loss is the rank's share (parallel/mesh.py
batch_mean) and the noise is the global batch's, cut to the rank's rows.

`loss_layers=L`: the rows are L encoder layers stacked B-major; every loss
is then the per-layer loss summed over layers (the elementwise means scaled
by L, the FMs with their own loss_layers).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_asr_torch.config import DiffmConfig, FlowMatchingConfig
from tpu_asr_torch.kd.flow_matching import FlowMatchingModule
from tpu_asr_torch.kd.meta_encoders import conv_btc
from tpu_asr_torch.parallel.mesh import batch_mean, draw_rows

LOSSES = ("recon_loss", "kd_loss_pre", "fm_loss_pre", "kd_loss_post",
          "fm_loss_post")
_USES = {1: (), 2: ("fm1",), 3: ("noise",), 4: ("fm1", "noise"),
         5: ("noise", "fm1"), 6: ("fm1", "noise", "fm2"),
         7: ("fm1", "noise", "fm2"), 8: ("fm1", "noise")}


def latent_fm_config(cfg: DiffmConfig) -> FlowMatchingConfig:
    """FMLatent's config (asr_train_diffm.py:468-479): the latent width
    for student and teacher, identity shape transform."""
    return dataclasses.replace(cfg.fm, student_dim=cfg.latent_dim,
                               teacher_dim=cfg.latent_dim,
                               shape_transform="identity")


class NoiseAdapter(nn.Module):
    def __init__(self, latent_dim: int):
        super().__init__()
        self.g1 = nn.Conv1d(latent_dim, latent_dim, 1)
        self.g2 = nn.Conv1d(latent_dim, 1, 1)

    def gamma(self, z: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(conv_btc(self.g2, F.relu(conv_btc(self.g1, z))))

    def forward(self, z: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        eps = draw_rows(lambda s: torch.randn(
            s, generator=generator, device=z.device, dtype=z.dtype), z.shape)
        gamma = self.gamma(z)
        return gamma * z + (1.0 - gamma) * eps


class SimpleDenoiser(nn.Module):
    def __init__(self, latent_dim: int, steps: int = 5):
        super().__init__()
        self.steps = steps
        self.conv1 = nn.Conv1d(latent_dim, latent_dim, 3, padding=1)
        self.conv2 = nn.Conv1d(latent_dim, latent_dim, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        for _ in range(self.steps):
            x = x - conv_btc(self.conv2, F.relu(conv_btc(self.conv1, x))) \
                / self.steps
        return x


class LatentKDPipeline(nn.Module):
    def __init__(self, cfg: DiffmConfig, diffusion_steps: int = 9,
                 kd_loss_type: str = "mse",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.model_version not in _USES:
            raise ValueError(f"model_version must be 1..8, got "
                             f"{cfg.model_version}")
        if kd_loss_type not in ("mse", "l1"):
            raise ValueError(f"unknown kd_loss_type: {kd_loss_type}")
        self.cfg, self.dtype, self.kd_loss_type = cfg, dtype, kd_loss_type
        lat, uses = cfg.latent_dim, _USES[cfg.model_version]
        self.tae_enc = nn.Conv1d(cfg.teacher_dim, lat, 1)
        self.tae_dec = nn.Conv1d(lat, cfg.teacher_dim, 1)
        self.sproj = nn.Conv1d(cfg.student_dim, lat, 1)
        if "noise" in uses:
            self.adapter = NoiseAdapter(lat)
            self.denoiser = SimpleDenoiser(lat, diffusion_steps)
        if "fm1" in uses:
            self.fm_latent = FlowMatchingModule(latent_fm_config(cfg), dtype)
        if "fm2" in uses:
            self.fm_latent_2 = FlowMatchingModule(latent_fm_config(cfg),
                                                  dtype)

    def _kd_crit(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        d = a.float() - b.float()
        return batch_mean(d.abs() if self.kd_loss_type == "l1" else d * d)

    def forward(self, stu_feat: torch.Tensor, tch_feat: torch.Tensor,
                train: bool = False, loss_layers: Optional[int] = None,
                rngs: Optional[Dict[str, torch.Generator]] = None
                ) -> Dict[str, torch.Tensor]:
        """The five losses of LOSSES (zero where the version has none) from
        (B, T, C_s) student and (B, T, C_t) teacher features. Versions 3-8
        draw their noise from rngs['noise']; a latent FM's meta encoder
        with dropout draws its seeds from rngs['dropout']."""
        v = self.cfg.model_version
        lscale = float(loss_layers) if loss_layers else 1.0
        rngs = rngs or {}
        generator = rngs.get("noise")
        if "noise" in _USES[v] and generator is None:
            raise ValueError(f"diffm ver{v} needs the 'noise' generator")
        z_t = conv_btc(self.tae_enc, tch_feat.to(self.dtype))
        rec = conv_btc(self.tae_dec, z_t)
        z_t = z_t.detach()
        out = {k: torch.zeros((), device=stu_feat.device) for k in LOSSES}
        out["recon_loss"] = lscale * batch_mean(torch.square(
            rec.float() - tch_feat.float()))
        z_s = conv_btc(self.sproj, stu_feat.to(self.dtype))
        fm = lambda mod, z: mod(z, z_t, train=train, loss_layers=loss_layers,
                                generator=rngs.get("dropout"))
        noisy = lambda z: self.denoiser(self.adapter(z, generator))
        kd = lambda z: lscale * self._kd_crit(z, z_t)
        if v == 1:
            out["kd_loss_pre"] = kd(z_s)
        elif v == 2:
            out["fm_loss_pre"] = fm(self.fm_latent, z_s)[0]
        elif v == 3:
            out["kd_loss_post"] = kd(noisy(z_s))
        elif v == 4:
            out["fm_loss_pre"] = fm(self.fm_latent, z_s)[0]
            out["kd_loss_post"] = kd(noisy(z_s))
        elif v == 5:
            out["fm_loss_post"] = fm(self.fm_latent, noisy(z_s))[0]
        elif v in (6, 8):
            out["fm_loss_pre"], z_aligned = fm(self.fm_latent, z_s)
            if v == 6:
                out["fm_loss_post"] = fm(self.fm_latent_2,
                                         noisy(z_aligned))[0]
            else:
                out["kd_loss_post"] = kd(noisy(z_aligned))
        else:                                               # v == 7
            out["fm_loss_pre"] = fm(self.fm_latent, z_s)[0]
            out["fm_loss_post"] = fm(self.fm_latent_2, noisy(z_s))[0]
        return out
