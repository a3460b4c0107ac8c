"""Transcriber and PackedTranscriber: the PyTorch counterparts of
tpu_asr/models/transcribe.py's. Audio in, text out, greedy CTC.

Batching is the JAX package's: utterances sorted by length, batches of
`batch_size` (`pre_batch`), each padded up to a multiple of
`bucket_seconds` (at least one quantum), so the model sees a few fixed
widths. PackedTranscriber then packs the subsampled frames of all
utterances into dense rows of `t_pack` frames (data/packing.py) and runs
the encoder once over them."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from tpu_asr_torch.data.audio import load_audio
from tpu_asr_torch.data.packing import (guard_frames, pack_frames,
                                        plan_packing, unpack_rows)
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

    def transcribe(self, audio: Sequence, return_hypotheses: bool = False):
        """audio: file paths and/or float32 waveforms -> texts (or
        Hypothesis objects), in input order."""
        signals = [_load(a, self.sample_rate) for a in audio]
        results: List = [None] * len(signals)
        for idxs, sig, ln in _buckets(signals, self.batch_size,
                                      self.bucket_seconds, self.sample_rate):
            with torch.inference_mode():
                out = self.model(torch.from_numpy(sig).to(self.device),
                                 torch.from_numpy(ln).to(self.device))
                decoded = self.decoding.ctc_decoder_predictions_tensor(
                    out.greedy, out.encoded_len, out.log_probs.shape[-1] - 1,
                    return_hypotheses=return_hypotheses)
            for j, i in enumerate(idxs):
                results[i] = decoded[j]
        return results


def _load(item, sample_rate: int) -> np.ndarray:
    if isinstance(item, str) or hasattr(item, "__fspath__"):
        return load_audio(item, sample_rate)
    return np.asarray(item, np.float32)


def _buckets(signals, batch_size: int, bucket_seconds: float,
             sample_rate: int):
    """(indices, (b, pad) float32 waveforms, (b,) int64 lengths) per batch of
    the length-sorted signals, each padded to a multiple of the quantum."""
    order = np.argsort([len(s) for s in signals])
    quantum = int(bucket_seconds * sample_rate)
    for start in range(0, len(order), batch_size):
        idxs = order[start:start + batch_size]
        batch = [signals[i] for i in idxs]
        max_len = max(len(s) for s in batch)
        pad = max(quantum, int(math.ceil(max_len / quantum) * quantum))
        sig = np.zeros((len(batch), pad), np.float32)
        ln = np.zeros((len(batch),), np.int64)
        for j, s in enumerate(batch):
            sig[j, :len(s)] = s
            ln[j] = len(s)
        yield idxs, sig, ln


class PackedTranscriber:
    """Packed-segment greedy transcription (data/packing.py): several
    utterances a row of the encoder, separated by zeroed guard frames, with
    segment attention, each utterance's ids those of its own forward.

    Pipeline: bucketed featurize + `pre_encode` per `pre_batch` -> one
    device gather into (rows, t_pack) packed frames -> one `forward_packed`
    -> host unpack and greedy collapse. Utterances longer than `t_pack`
    subsampled frames (20.5 s at 512 x 40 ms) raise."""

    def __init__(self, model: CTCModel, tokenizer, t_pack: int = 512,
                 row_multiple: int = 4, pre_batch: int = 32,
                 bucket_seconds: float = 4.0, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.decoding = CTCDecoding(tokenizer, "greedy")
        self.t_pack = t_pack
        self.row_multiple = row_multiple
        self.pre_batch = pre_batch
        self.bucket_seconds = bucket_seconds
        self.sample_rate = model.cfg.sample_rate
        self.guard = guard_frames(model.cfg.encoder.conv_kernel_size)
        self.blank = model.cfg.decoder.num_classes
        self.last_plan = None          # the PackPlan of the last call

    def greedy_ids(self, audio: Sequence) -> List[np.ndarray]:
        """audio -> per-utterance greedy frame ids (before the collapse)."""
        plan, _, greedy = self.packed_outputs(audio)
        return unpack_rows(greedy, plan)

    def packed_outputs(self, audio: Sequence):
        """audio -> (PackPlan, log_probs (R, t_pack, V+1), greedy ids
        (R, t_pack)) of the packed rows, on the device; `unpack_rows` with
        the plan splits them per utterance."""
        signals = [_load(a, self.sample_rate) for a in audio]
        n = len(signals)
        lengths = np.zeros(n, np.int64)
        row_of = np.zeros(n, np.int64)  # row of utterance i in `big`
        chunks, off = [], 0
        with torch.inference_mode():
            for idxs, sig, ln in _buckets(signals, self.pre_batch,
                                          self.bucket_seconds,
                                          self.sample_rate):
                feats, feat_len = self.model.featurizer(
                    torch.from_numpy(sig).to(self.device),
                    torch.from_numpy(ln).to(self.device))
                pre_x, pre_len = self.model.pre_encode(feats, feat_len)
                chunks.append(pre_x)
                lengths[idxs] = pre_len.cpu().numpy()
                row_of[idxs] = off + np.arange(len(idxs))
                off += len(idxs)
            t_src = max(c.shape[1] for c in chunks)
            big = torch.cat([torch.nn.functional.pad(
                c, (0, 0, 0, t_src - c.shape[1])) for c in chunks])
            plan = plan_packing(lengths, t_pack=self.t_pack,
                                guard=self.guard,
                                row_multiple=self.row_multiple)
            packed = pack_frames(big, plan, utt_rows=row_of)
            log_probs, greedy = self.model.forward_packed(
                packed, torch.from_numpy(plan.seg_id).to(self.device))
        self.last_plan = plan
        return plan, log_probs, greedy

    def transcribe(self, audio: Sequence) -> List[str]:
        """audio: file paths and/or float32 waveforms -> texts, in input
        order."""
        texts = []
        for ids in self.greedy_ids(audio):
            keep = (ids[np.concatenate(([True], ids[1:] != ids[:-1]))]
                    if len(ids) else ids)
            toks = keep[keep != self.blank]
            texts.append(self.decoding.decode_tokens_to_str(
                [int(t) for t in toks]))
        return texts
