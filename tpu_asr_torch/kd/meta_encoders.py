"""Velocity-field ("meta encoder") networks for flow-matching KD: the
PyTorch counterpart of tpu_asr/kd/meta_encoders.py.

Only the `mlp` meta encoder (Linear -> ReLU -> Linear, reference
asr_train.py:1244-1250) is ported: it is the flagship's, and the one the
fused Euler kernel (ops/cuda_fm.py) implements. `build_meta_encoder` raises
for `cnn`, `swin`, `conformer` and `unet`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MLPMetaEncoder(nn.Module):
    """fc1 (in_dim -> hidden_dim) -> ReLU -> fc2 (hidden_dim -> out_dim),
    applied in x's dtype."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        h = F.relu(F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        return F.linear(h, self.fc2.weight.to(dt), self.fc2.bias.to(dt))


def build_meta_encoder(meta_encoder_type: str, in_dim: int, out_dim: int,
                       hidden_dim: int) -> nn.Module:
    if meta_encoder_type == "mlp":
        return MLPMetaEncoder(in_dim, hidden_dim, out_dim)
    if meta_encoder_type in ("cnn", "swin", "conformer", "unet"):
        raise ValueError(f"tpu_asr_torch does not implement meta encoder "
                         f"{meta_encoder_type!r}")
    raise ValueError(f"Unknown meta_encoder type: {meta_encoder_type}")
