"""Serialized inference artifact: the counterpart of
tpu_asr/convert/export.py, with `torch.export` in place of `jax.export`.

Each duration bucket's whole eval program (signal, length) -> (log_probs,
encoded_len) — the mel frontend, the conformer encoder and the CTC head,
with the weights inside — is traced by `torch.export.export` at static
shapes and written by `torch.export.save`; the programs, the tokenizer and
the decode metadata go into one `.tasrx` tar.

The hand-written kernels are inside the program. Traced with CUDA tensors,
each serving wrapper records its `torch.library` custom op
(`tpu_asr_torch::logmel`, `::subsampling`, `::relpos_attention_block`,
`::ffn_sublayer`, `::ffn_sublayer_int8`, `::conv_module`, whichever the
model's routes reach; ops/_kernels.py), whose CUDA implementation
launches the kernel and counts the launch; the kernel-layout weights are
built at the first call of the loaded program and kept per weight
(`_kernels.prepared`). Exported on the CPU, the model takes its plain code
and the program holds no op.

A consumer needs only `load_exported(path)`: no model code, no checkpoint,
no config tree, only the port's op registrations (imported here). The
kernels build at first use, as always.

Layout of the tar (JAX's, with `.pt2` programs):
    manifest.json             buckets, sample rate, frame math, platforms
    program_<i>.pt2           torch.export.save of one bucket's program
    tokenizer.model           SentencePiece ModelProto (if SP-backed)

As JAX's, the artifact freezes eval-mode behaviour (no dropout, frozen
batch-norm statistics) and static bucket shapes: audio is padded to the
smallest bucket that fits.
"""

from __future__ import annotations

import io
import json
import tarfile
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

# the serving wrappers' custom ops, which a loaded program calls
from tpu_asr_torch.ops import (cuda_attention, cuda_conv,  # noqa: F401
                               cuda_features, cuda_ffn, cuda_subsampling)

MANIFEST = "manifest.json"
FORMAT_VERSION = 1


class _Program(torch.nn.Module):
    """The exported function: (B, L) float32 waveforms and (B,) int32
    sample counts -> (log_probs (B, T', V+1) fp32, encoded_len (B,))."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, signal, length):
        out = self.model(signal, length)
        return out.log_probs, out.encoded_len


def export_inference(model, tokenizer, path,
                     buckets: Sequence[Tuple[int, float]] = ((8, 4.0),
                                                             (8, 8.0),
                                                             (8, 16.0)),
                     device="cuda") -> Path:
    """Serialize the bucketed inference program of `model` (a CTCModel,
    moved to `device` in eval mode) to `path`. buckets: (batch_size,
    seconds) static shapes to trace. Returns the artifact path."""
    device = torch.device(device)
    model = model.to(device).eval()
    sample_rate = model.cfg.sample_rate
    program = _Program(model)
    entries, blobs = [], []
    for i, (bs, seconds) in enumerate(buckets):
        pad = int(round(seconds * sample_rate))
        args = (torch.zeros((bs, pad), dtype=torch.float32, device=device),
                torch.full((bs,), pad, dtype=torch.int32, device=device))
        with torch.no_grad():
            ep = torch.export.export(program, args, strict=False)
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        blobs.append(buf.getvalue())
        entries.append({"file": f"program_{i}.pt2", "batch_size": bs,
                        "pad_samples": pad, "seconds": seconds})

    pre = model.cfg.preprocessor
    manifest = {
        "format_version": FORMAT_VERSION,
        "sample_rate": sample_rate,
        "hop_length": pre.hop_length,
        "subsampling_factor": model.cfg.encoder.subsampling_factor,
        "num_classes": model.cfg.decoder.num_classes,
        "platforms": [device.type],
        "buckets": entries,
    }

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with tarfile.open(path, "w") as tar:
        def add_bytes(name, data):
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tar.addfile(ti, io.BytesIO(data))

        add_bytes(MANIFEST, json.dumps(manifest, indent=1).encode())
        for e, blob in zip(entries, blobs):
            add_bytes(e["file"], blob)
        if tokenizer is not None and hasattr(tokenizer, "serialized_proto"):
            add_bytes("tokenizer.model", tokenizer.serialized_proto())
    return path


class ExportedTranscriber:
    """Runs a `.tasrx` artifact: bucket pick -> loaded program call -> CTC
    decoding. Mirrors `Transcriber.transcribe` for the greedy path and
    JAX's ExportedTranscriber's bucketing. `programs` are callables of
    (signal, length) tensors on the artifact's platform."""

    def __init__(self, manifest, programs, tokenizer, decoding=None):
        from tpu_asr_torch.ops.decoding import CTCDecoding
        self.manifest = manifest
        self.sample_rate = manifest["sample_rate"]
        self.device = torch.device(manifest["platforms"][0])
        self.buckets = sorted(
            zip(manifest["buckets"], programs),
            key=lambda bp: (bp[0]["pad_samples"], bp[0]["batch_size"]))
        self.tokenizer = tokenizer
        self.decoding = decoding or (CTCDecoding(tokenizer, "greedy")
                                     if tokenizer is not None else None)

    def _pick(self, n_samples: int) -> int:
        """Index of the smallest bucket that fits `n_samples` (the last
        bucket when nothing fits: only then is audio cropped)."""
        for bi, (e, _) in enumerate(self.buckets):
            if n_samples <= e["pad_samples"]:
                return bi
        return len(self.buckets) - 1

    def batches(self, audio: Sequence):
        """(indices, (bs, pad) float32 waveforms, (bs,) int32 lengths, the
        bucket's program) per batch: clips grouped by the bucket each one
        needs before batching, so that no clip is cropped to a smaller
        bucket's length."""
        from tpu_asr_torch.data.audio import load_audio
        signals = [np.asarray(load_audio(a, self.sample_rate)
                              if isinstance(a, str)
                              or hasattr(a, "__fspath__") else a,
                              np.float32)
                   for a in audio]
        by_bucket: dict = {}
        for i, s in enumerate(signals):
            by_bucket.setdefault(self._pick(len(s)), []).append(i)
        for bi in sorted(by_bucket):
            e, prog = self.buckets[bi]
            pad, bs = e["pad_samples"], e["batch_size"]
            idxs_all = by_bucket[bi]
            for pos in range(0, len(idxs_all), bs):
                idxs = idxs_all[pos:pos + bs]
                sig = np.zeros((bs, pad), np.float32)
                ln = np.zeros((bs,), np.int32)
                for j, i in enumerate(idxs):
                    s = signals[i][:pad]
                    sig[j, : len(s)] = s
                    ln[j] = len(s)
                yield idxs, sig, ln, prog

    def transcribe(self, audio: Sequence, return_hypotheses: bool = False):
        """Texts (or Hypothesis objects) of `audio` (paths and/or float32
        waveforms), in input order."""
        results: List = [None] * len(audio)
        for idxs, sig, ln, prog in self.batches(audio):
            with torch.inference_mode():
                log_probs, enc_len = prog(
                    torch.from_numpy(sig).to(self.device),
                    torch.from_numpy(ln).to(self.device))
                decoded = self.decoding.ctc_decoder_predictions_tensor(
                    log_probs, enc_len, return_hypotheses=return_hypotheses)
            for j, i in enumerate(idxs):
                results[i] = decoded[j]
        return results


def load_exported(path, decoding=None) -> ExportedTranscriber:
    """Load a `.tasrx` artifact produced by `export_inference`."""
    from tpu_asr_torch.data.tokenizer import SentencePieceBPETokenizer

    with tarfile.open(path, "r") as tar:
        manifest = json.loads(tar.extractfile(MANIFEST).read())
        if manifest["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"artifact format {manifest['format_version']} is newer "
                f"than this loader ({FORMAT_VERSION})")
        programs = [torch.export.load(io.BytesIO(
            tar.extractfile(e["file"]).read())).module()
            for e in manifest["buckets"]]
        tokenizer = None
        try:
            data = tar.extractfile("tokenizer.model").read()
            tokenizer = SentencePieceBPETokenizer.from_bytes(data)
        except KeyError:
            pass
    return ExportedTranscriber(manifest, programs, tokenizer, decoding)
