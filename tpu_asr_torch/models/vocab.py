"""Vocabulary and decoding-strategy swaps: the PyTorch counterpart of
tpu_asr/models/vocab.py (EncDecCTCModel's `change_vocabulary` /
`change_decoding_strategy`).

A strategy change builds a new CTCDecoding; `change_vocabulary` gives a
model for a new tokenizer with a fresh CTC head (its vocabulary + blank)
and every other weight carried over, NeMo's fine-tune-to-a-new-language
flow."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from tpu_asr_torch.config import ModelConfig
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.ops.decoding import CTCDecoding


def change_decoding_strategy(tokenizer, strategy: str = "greedy",
                             **kwargs) -> CTCDecoding:
    return CTCDecoding(tokenizer, strategy=strategy, **kwargs)


def change_vocabulary(model: CTCModel, new_tokenizer,
                      generator: torch.Generator
                      ) -> Tuple[ModelConfig, CTCModel]:
    """(new config, new model) on `model`'s device and in its mode: the
    encoder's weights and statistics copied, the head drawn from
    `generator` (on its own device): LeCun-normal weights (std
    1/sqrt(feat_in)) and zero biases, as flax's Dense initialises JAX's
    head."""
    cfg = model.cfg
    new_cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, num_classes=new_tokenizer.vocab_size))
    new = CTCModel(new_cfg)
    kept = {k: v for k, v in model.state_dict().items()
            if not k.startswith("decoder.")}
    missing, unexpected = new.load_state_dict(kept, strict=False)
    if unexpected or any(not k.startswith("decoder.") for k in missing):
        raise ValueError(f"change_vocabulary: {missing}, {unexpected}")
    head = new.decoder.decoder_layers[0]
    with torch.no_grad():
        w = torch.randn(head.weight.shape, generator=generator,
                        device=generator.device)
        head.weight.copy_(w / math.sqrt(head.weight.shape[1]))
        head.bias.zero_()
    dev = next(model.parameters()).device
    return new_cfg, new.to(dev).train(model.training)
