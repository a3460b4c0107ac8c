"""Transcriber, PackedTranscriber and ChunkedTranscriber: the PyTorch
counterparts of tpu_asr/models/transcribe.py's. Audio in, text out.

Batching is the JAX package's: utterances sorted by length, batches of
`batch_size` (`pre_batch`), each padded up to a multiple of
`bucket_seconds` (at least one quantum), so the model sees a few fixed
widths. Transcriber decodes with any CTCDecoding strategy; plain greedy
collapses the model's own argmax ids. PackedTranscriber packs the
subsampled frames of all utterances into dense rows of `t_pack` frames
(data/packing.py) and runs the encoder once over them. ChunkedTranscriber
serves long audio in fixed windows with overlap, keeping the frames of
each window's centre."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from tpu_asr_torch.data.audio import load_audio
from tpu_asr_torch.data.packing import (guard_frames, pack_frames,
                                        plan_packing, unpack_rows)
from tpu_asr_torch.models.conformer import subsampled_length
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

    def transcribe(self, audio: Sequence, return_hypotheses: bool = False,
                   timestamps: bool = False):
        """audio: file paths and/or float32 waveforms -> texts (or
        Hypothesis objects), in input order. `timestamps` (NeMo's
        transcribe(..., timestamps=True)) returns Hypothesis objects whose
        offset dicts also carry 'start' / 'end' in seconds (offset x hop x
        subsampling / sample rate)."""
        if timestamps:
            if not self.decoding.compute_timestamps:
                self.decoding = CTCDecoding(
                    self.tokenizer, self.decoding.strategy,
                    beam_width=self.decoding.beam_width,
                    compute_timestamps=True,
                    confidence_cfg=self.decoding.confidence_cfg)
            return_hypotheses = True
        signals = [_load(a, self.sample_rate) for a in audio]
        results: List = [None] * len(signals)
        for idxs, sig, ln in _buckets(signals, self.batch_size,
                                      self.bucket_seconds, self.sample_rate):
            with torch.inference_mode():
                out = self.model(torch.from_numpy(sig).to(self.device),
                                 torch.from_numpy(ln).to(self.device))
                if self.decoding.plain_greedy:
                    decoded = self.decoding.greedy_ids_predictions(
                        out.greedy, out.encoded_len,
                        out.log_probs.shape[-1] - 1, return_hypotheses)
                else:
                    decoded = self.decoding.ctc_decoder_predictions_tensor(
                        out.log_probs, out.encoded_len, return_hypotheses)
            for j, i in enumerate(idxs):
                results[i] = decoded[j]
        if timestamps:
            frame_s = (self.model.cfg.preprocessor.hop_length
                       * self.model.cfg.encoder.subsampling_factor
                       / self.sample_rate)
            for h in results:
                if isinstance(h.timestamp, dict):
                    for kind in ("char", "word", "segment"):
                        for off in h.timestamp[kind]:
                            off["start"] = off["start_offset"] * frame_s
                            off["end"] = (off["end_offset"] + 1) * frame_s
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


class ChunkedTranscriber:
    """Long-form greedy transcription in fixed windows: each window of
    `chunk_seconds` (the first and last possibly shorter) overlaps its
    neighbours by `overlap_seconds` on each side, and keeps only the
    encoded frames whose window centre lies in its own hop, so the stitched
    tokens cover the audio once. The model is moved to `device` in eval
    mode; the decode runs there, and only tokens reach the host."""

    def __init__(self, model: CTCModel, tokenizer,
                 chunk_seconds: float = 16.0, overlap_seconds: float = 2.0,
                 device="cuda"):
        if not overlap_seconds * 2 < chunk_seconds:
            raise ValueError("ChunkedTranscriber: the two overlaps must be "
                             "shorter than the chunk")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.decoding = CTCDecoding(tokenizer, "greedy")
        self.sample_rate = model.cfg.sample_rate
        self.chunk = int(chunk_seconds * self.sample_rate)
        self.overlap = int(overlap_seconds * self.sample_rate)
        self.hop = self.chunk - 2 * self.overlap

    def _frames_for_samples(self, n: int) -> int:
        mel_frames = n // self.model.cfg.preprocessor.hop_length + 1
        return int(subsampled_length(
            torch.tensor(mel_frames),
            self.model.cfg.encoder.subsampling_factor))

    def _log_probs(self, seg: np.ndarray, n: int):
        """(log-probs (T', V+1), encoded frames) of one window."""
        out = self.model(torch.from_numpy(seg[None]).to(self.device),
                         torch.tensor([n], device=self.device))
        return out.log_probs[0], int(out.encoded_len[0])

    def transcribe(self, audio) -> str:
        x = _load(audio, self.sample_rate)
        with torch.inference_mode():
            if len(x) <= self.chunk:
                lp, n = self._log_probs(x, len(x))
                return self.decoding.ctc_decoder_predictions_tensor(
                    lp[None], torch.tensor([n], device=self.device))[0]
            tokens: List[int] = []
            pos, first = 0, True
            while pos < len(x):
                lo = max(0, pos - self.overlap)
                seg = x[lo:lo + self.chunk]
                seg_len = len(seg)
                if seg_len < self.chunk:
                    seg = np.pad(seg, (0, self.chunk - seg_len))
                lp, n_frames = self._log_probs(seg, seg_len)
                # the frames whose window centre lies in [pos, pos + hop)
                left = 0 if first else self._frames_for_samples(pos - lo)
                right = (n_frames if lo + seg_len >= len(x)
                         else self._frames_for_samples(pos - lo + self.hop))
                keep = lp[left:right]
                if keep.shape[0] > 0:
                    hyp = self.decoding.ctc_decoder_predictions_tensor(
                        keep[None], torch.tensor([keep.shape[0]],
                                                 device=self.device),
                        return_hypotheses=True)[0]
                    tokens.extend(hyp.y_sequence)
                pos += self.hop
                first = False
        return self.decoding.decode_tokens_to_str(tokens)
