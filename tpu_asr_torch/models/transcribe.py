"""Transcriber: the PyTorch counterpart of
tpu_asr/models/transcribe.py::Transcriber. Audio in, text out, greedy CTC.

Batching is the JAX package's: utterances sorted by length, batches of
`batch_size`, each padded up to a multiple of `bucket_seconds` (at least
one quantum), so the model sees a few fixed widths."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from tpu_asr_torch.data.audio import load_audio
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.ops.decoding import CTCDecoding


class Transcriber:
    """Moves `model` to `device` in eval mode and transcribes with it."""

    def __init__(self, model: CTCModel, tokenizer,
                 decoding: Optional[CTCDecoding] = None,
                 batch_size: int = 8, bucket_seconds: float = 4.0,
                 device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.decoding = decoding or CTCDecoding(tokenizer, "greedy")
        self.batch_size = batch_size
        self.bucket_seconds = bucket_seconds
        self.sample_rate = model.cfg.sample_rate

    def _load(self, item) -> np.ndarray:
        if isinstance(item, str) or hasattr(item, "__fspath__"):
            return load_audio(item, self.sample_rate)
        return np.asarray(item, np.float32)

    def transcribe(self, audio: Sequence, return_hypotheses: bool = False):
        """audio: file paths and/or float32 waveforms -> texts (or
        Hypothesis objects), in input order."""
        signals = [self._load(a) for a in audio]
        order = np.argsort([len(s) for s in signals])
        quantum = int(self.bucket_seconds * self.sample_rate)
        results: List = [None] * len(signals)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start:start + self.batch_size]
            batch = [signals[i] for i in idxs]
            max_len = max(len(s) for s in batch)
            pad = max(quantum, int(math.ceil(max_len / quantum) * quantum))
            sig = np.zeros((len(batch), pad), np.float32)
            ln = np.zeros((len(batch),), np.int64)
            for j, s in enumerate(batch):
                sig[j, :len(s)] = s
                ln[j] = len(s)
            with torch.inference_mode():
                out = self.model(torch.from_numpy(sig).to(self.device),
                                 torch.from_numpy(ln).to(self.device))
                decoded = self.decoding.ctc_decoder_predictions_tensor(
                    out.greedy, out.encoded_len, out.log_probs.shape[-1] - 1,
                    return_hypotheses=return_hypotheses)
            for j, i in enumerate(idxs):
                results[i] = decoded[j]
        return results
