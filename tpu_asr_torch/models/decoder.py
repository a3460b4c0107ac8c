"""CTC head: the PyTorch counterpart of tpu_asr/models/decoder.py. A 1x1
Conv1d (NeMo key `decoder_layers.0`) from encoder features to vocab + blank
logits, then log_softmax in fp32. Blank is the last index."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_asr_torch.config import DecoderConfig


class ConvASRDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.decoder_layers = nn.Sequential(
            nn.Conv1d(cfg.feat_in, cfg.num_classes + 1, 1))

    def forward(self, encoded: torch.Tensor) -> torch.Tensor:
        """(B, T, D) in the compute dtype -> log-probs (B, T, V + 1) fp32."""
        conv = self.decoder_layers[0]
        dt = encoded.dtype
        logits = F.linear(encoded, conv.weight[..., 0].to(dt),
                          conv.bias.to(dt)).float()
        if self.cfg.temperature != 1.0:
            logits = logits / self.cfg.temperature
        return torch.log_softmax(logits, dim=-1)
