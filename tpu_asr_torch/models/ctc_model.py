"""CTCModel: the PyTorch counterpart of tpu_asr/models/ctc_model.py.
FilterbankFeatures -> (training: SpecAugment) -> ConformerEncoder ->
ConvASRDecoder, returning the same five fields as the JAX CTCModelOutput.
The featurizer holds no parameters, so `state_dict()` has exactly NeMo's
`encoder.*` and `decoder.*` keys.

Training randomness comes from `rngs`, a dict of `torch.Generator`s as
train/trainer.py::step_rngs makes them: 'specaug' (on the model's device)
draws dither and SpecAugment masks, 'dropout' (CPU) the dropout seeds."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from tpu_asr_torch.config import ModelConfig
from tpu_asr_torch.models.conformer import ConformerEncoder
from tpu_asr_torch.models.decoder import ConvASRDecoder
from tpu_asr_torch.ops.features import FilterbankFeatures
from tpu_asr_torch.ops.specaug import spec_augment


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
                input_signal_length: torch.Tensor, train: bool = False,
                rngs: Optional[Dict[str, torch.Generator]] = None
                ) -> CTCModelOutput:
        """(B, L) waveforms and (B,) sample counts."""
        encoded, encoded_len, layer_feats = self.encode(
            input_signal, input_signal_length, train, rngs)
        return self._output(encoded, encoded_len, layer_feats)

    def forward_features(self, processed_signal: torch.Tensor,
                         processed_signal_length: torch.Tensor
                         ) -> CTCModelOutput:
        """(B, F, T) log-mel and (B,) frame counts."""
        return self._output(*self.encoder(processed_signal,
                                          processed_signal_length))

    def encode(self, input_signal, input_signal_length, train: bool = False,
               rngs: Optional[Dict[str, torch.Generator]] = None):
        """Preprocess (+ dither and SpecAugment when training) and encode:
        (encoded (B, T', D), lengths (B,), layer_feats (L, B, T', D))."""
        feats, feat_len, rngs = self._features(input_signal,
                                               input_signal_length, train,
                                               rngs)
        return self.encoder(feats, feat_len, train, rngs.get("dropout"))

    def _features(self, input_signal, input_signal_length, train: bool,
                  rngs: Optional[Dict[str, torch.Generator]]):
        """Log-mel (B, F, T) and (B,) frames, with dither and SpecAugment
        drawn from rngs['specaug'] when training; and the rngs."""
        if train and rngs is None:
            raise ValueError("CTCModel: training needs rngs")
        rngs = rngs or {}
        feats, feat_len = self.featurizer(input_signal, input_signal_length,
                                          train, rngs.get("specaug"))
        if train and self.cfg.spec_augment is not None:
            feats = spec_augment(feats, feat_len, self.cfg.spec_augment,
                                 rngs["specaug"])
        return feats, feat_len, rngs

    def decode_logits(self, encoded: torch.Tensor) -> torch.Tensor:
        return self.decoder(encoded)

    def pre_encode(self, processed_signal: torch.Tensor,
                   processed_signal_length: torch.Tensor):
        """The subsampling front of the encoder only: (B, F, T) log-mel ->
        raw (B, T', D) frames (before xscale and masking) and (B,)
        lengths. The packed-serving split point (data/packing.py)."""
        return self.encoder.subsample(processed_signal,
                                      processed_signal_length)

    def forward_packed(self, packed: torch.Tensor, seg_id: torch.Tensor):
        """Packed-segment inference: `packed` (R, Tp, D) rows of
        `pre_encode` frames (data/packing.pack_frames), `seg_id` (R, Tp) int
        (0 = guard/pad). Each segment's log-probs are those of its
        per-utterance forward. Returns (log_probs (R, Tp, V+1), greedy ids
        (R, Tp)) without gradient; packed training runs `pre_encode_aug`
        and `encode_packed` (DistilCTCModel.forward_packed_train)."""
        with torch.no_grad():
            log_probs = self.decoder(self.encode_packed(packed, seg_id)[0])
        return log_probs, log_probs.argmax(dim=-1)

    def pre_encode_aug(self, input_signal, input_signal_length,
                       train: bool = False,
                       rngs: Optional[Dict[str, torch.Generator]] = None):
        """Featurize (+ dither and SpecAugment from rngs['specaug'] when
        `train`) and subsample: (B, L) waveforms -> raw (B, T', D) frames
        (before xscale and masking) and (B,) lengths. The packed-training
        split point: augmentation stays per utterance, before the frames are
        gathered into packed rows (data/packing.py)."""
        feats, feat_len, _ = self._features(input_signal,
                                            input_signal_length, train, rngs)
        return self.encoder.subsample(feats, feat_len)

    def encode_packed(self, packed: torch.Tensor, seg_id: torch.Tensor,
                      train: bool = False,
                      rngs: Optional[Dict[str, torch.Generator]] = None):
        """The encoder on packed rows (R, Tp, D) of `pre_encode_aug` frames
        with the (R, Tp) segment map, in training (dropout seeds from
        rngs['dropout']) or eval: (encoded (R, Tp, D), valid frames a row
        (R,), layer_feats (L, R, Tp, D))."""
        if train and rngs is None:
            raise ValueError("CTCModel.encode_packed(train=True) needs rngs")
        return self.encoder.encode_frames(
            packed, None, train, (rngs or {}).get("dropout"), seg_id=seg_id)

    def stream_step(self, processed_signal: torch.Tensor,
                    processed_signal_length: torch.Tensor, cache,
                    drop_extra_pre_encoded: int):
        """One cache-aware streaming step (JAX's CTCModel.stream_step):
        (B, F, T) log-mel of a chunk prefixed with its pre-encode context
        frames, (B,) frames counting them, the stacked encoder caches
        (models/streaming.py keeps both). Returns (log_probs, encoded
        lengths, new cache) without gradient."""
        with torch.no_grad():
            encoded, enc_len, new_cache = self.encoder.stream_step(
                processed_signal, processed_signal_length, cache,
                drop_extra_pre_encoded)
            return self.decoder(encoded), enc_len, new_cache

    def _output(self, encoded, encoded_len, layer_feats) -> CTCModelOutput:
        log_probs = self.decoder(encoded)
        return CTCModelOutput(log_probs, encoded_len,
                              log_probs.argmax(dim=-1), encoded, layer_feats)
