"""CTCModel, eval path: the PyTorch counterpart of
tpu_asr/models/ctc_model.py. FilterbankFeatures -> ConformerEncoder ->
ConvASRDecoder, returning the same five fields as the JAX CTCModelOutput.
The featurizer holds no parameters, so `state_dict()` has exactly NeMo's
`encoder.*` and `decoder.*` keys."""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from tpu_asr_torch.host import ModelConfig
from tpu_asr_torch.models.conformer import ConformerEncoder
from tpu_asr_torch.models.decoder import ConvASRDecoder
from tpu_asr_torch.ops.features import FilterbankFeatures


class CTCModelOutput(NamedTuple):
    log_probs: torch.Tensor      # (B, T', V+1) fp32
    encoded_len: torch.Tensor    # (B,)
    greedy: torch.Tensor         # (B, T') argmax token ids
    encoded: torch.Tensor        # (B, T', D)
    layer_feats: torch.Tensor    # (L, B, T', D)


class CTCModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.featurizer = FilterbankFeatures(cfg.preprocessor)
        self.encoder = ConformerEncoder(cfg.encoder,
                                        getattr(torch, cfg.compute_dtype))
        self.decoder = ConvASRDecoder(cfg.decoder)

    def forward(self, input_signal: torch.Tensor,
                input_signal_length: torch.Tensor) -> CTCModelOutput:
        """(B, L) waveforms and (B,) sample counts."""
        feats, feat_len = self.featurizer(input_signal, input_signal_length)
        return self.forward_features(feats, feat_len)

    def forward_features(self, processed_signal: torch.Tensor,
                         processed_signal_length: torch.Tensor
                         ) -> CTCModelOutput:
        """(B, F, T) log-mel and (B,) frame counts."""
        encoded, encoded_len, layer_feats = self.encoder(
            processed_signal, processed_signal_length)
        log_probs = self.decoder(encoded)
        return CTCModelOutput(log_probs, encoded_len,
                              log_probs.argmax(dim=-1), encoded, layer_feats)
