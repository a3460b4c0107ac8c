"""Cache-aware streaming inference: the PyTorch counterpart of
tpu_asr/models/streaming.py (NeMo's cache-aware streaming Conformer:
`setup_streaming_params`, `get_initial_cache_state` and the encoder's cache
path, `CacheAwareStreamingConfig`).

The cache is an explicit tuple (last_channel (L, B, C, D), last_channel_len
(B,), last_time (L, B, pad_l, D)) threaded through
`CTCModel.stream_step`, which takes a chunk of mel frames prefixed with the
stream's raw pre-encode context and drops the `drop_extra_pre_encoded`
subsampled frames it recomputes. With left-only padding those frames equal
the previous step's, so streaming gives the offline forward's frames.

A step runs no host synchronisation: every cache rolls by each sample's
valid count on the device.

The first step of a session takes its chunk alone and drops nothing, as
NeMo's first streaming step does. JAX's streamer prefixes it with a tail of
zero mel frames and drops two frames: the first conv of the causal
subsampling turns those zeros into relu(bias), where the offline forward
pads its output with zeros, so its first frames differ from the offline
forward's wherever a bias of that conv is positive. From the second step
on, the port's steps are JAX's.

As in JAX, a step runs plain PyTorch (the kernels take no cache), but for
the FFN sublayers of an int8 model (`quantization='int8'`), which run the
int8 FFN kernel on a CUDA tensor as offline int8 serving does; `stream`
featurizes the whole clip first, on the log-mel kernel for a CUDA tensor.

Requires a streaming encoder: `causal_downsampling=True`,
`conv_context_size='causal'`, `att_context_style='chunked_limited'` with
`att_context_size=(left, chunk - 1)`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from tpu_asr_torch.config import EncoderConfig
from tpu_asr_torch.data.audio import load_audio
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.ops.decoding import CTCDecoding


@dataclass
class CacheAwareStreamingConfig:
    """The streaming geometry (NeMo's CacheAwareStreamingConfig fields that
    the streaming loop reads)."""

    chunk_size: int                 # raw mel frames consumed per step
    shift_size: int                 # == chunk_size (cache_drop_size = 0)
    valid_out_len: int              # encoded frames emitted per full step
    last_channel_cache_size: int    # C: attention left-context cache frames
    last_time_cache_size: int       # pad_l: depthwise-conv left context
    pre_encode_cache_size: int      # raw mel frames of subsampling context
    drop_extra_pre_encoded: int     # re-encoded leading frames to drop
    cache_drop_size: int = 0


def setup_streaming_params(cfg: EncoderConfig, max_context: int = 10000
                           ) -> CacheAwareStreamingConfig:
    """The streaming geometry of an encoder config (the chunked_limited
    case); refuses a config that cannot stream."""
    if not cfg.causal_downsampling:
        raise ValueError("cache-aware streaming requires "
                         "causal_downsampling=True")
    if cfg.conv_context[1] != 0:
        raise ValueError("cache-aware streaming requires "
                         "conv_context_size='causal'")
    if cfg.att_context_style != "chunked_limited":
        raise ValueError("cache-aware streaming requires "
                         "att_context_style='chunked_limited'")
    left, right = cfg.att_context_size
    if right < 0:
        raise ValueError("right att context (chunk lookahead) must be >= 0")
    valid_out = right + 1                       # encoded frames per chunk
    sf = cfg.subsampling_factor
    # the causal two-stage (k=3, s=2, left pad 2) subsampling sees 6 raw
    # frames back; a whole subsampling stride of them makes the dropped
    # re-encoded frames land on earlier outputs exactly
    pre = 2 * sf
    return CacheAwareStreamingConfig(
        chunk_size=valid_out * sf,
        shift_size=valid_out * sf,
        valid_out_len=valid_out,
        last_channel_cache_size=left if left >= 0 else max_context,
        last_time_cache_size=cfg.conv_context[0],
        pre_encode_cache_size=pre,
        drop_extra_pre_encoded=pre // sf,
    )


def get_initial_cache_state(cfg: EncoderConfig, batch_size: int,
                            dtype: torch.dtype = torch.float32,
                            stream_cfg: Optional[CacheAwareStreamingConfig]
                            = None, device=None):
    """Zeroed stacked caches (last_channel, last_channel_len,
    last_time)."""
    sc = stream_cfg or setup_streaming_params(cfg)
    lc = torch.zeros(cfg.n_layers, batch_size, sc.last_channel_cache_size,
                     cfg.d_model, dtype=dtype, device=device)
    lc_len = torch.zeros(batch_size, dtype=torch.int64, device=device)
    lt = torch.zeros(cfg.n_layers, batch_size, sc.last_time_cache_size,
                     cfg.d_model, dtype=dtype, device=device)
    return lc, lc_len, lt


class CacheAwareStreamer:
    """Stepwise streaming transcription with a CTCModel, moved to `device`
    in eval mode. `stream(audio)` gives offline greedy decoding's frame ids
    while touching each chunk once: only the fixed pre-encode tail is
    computed twice."""

    def __init__(self, model: CTCModel, tokenizer=None, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.stream_cfg = setup_streaming_params(self.cfg.encoder)
        self.decoding = CTCDecoding(tokenizer, "greedy") if tokenizer else None

    def init_state(self, batch_size: int):
        """(encoder cache, raw-feature tail) of a fresh session; the tail
        is empty (B, F, 0) until the first step."""
        sc = self.stream_cfg
        cache = get_initial_cache_state(
            self.cfg.encoder, batch_size, getattr(torch,
                                                  self.cfg.compute_dtype),
            sc, self.device)
        feat_tail = torch.zeros(batch_size, self.cfg.preprocessor.features,
                                0, device=self.device)
        return cache, feat_tail

    def step(self, state, mel_chunk: torch.Tensor, chunk_len: torch.Tensor):
        """One streaming step: `mel_chunk` (B, F, chunk_size) zero-padded,
        `chunk_len` (B,) its true frames. Returns (log_probs (B,
        valid_out_len, V+1), encoded lengths (B,), new state).

        Batched streams of unequal length: every cache (attention channel,
        conv time, pre-encode tail) rolls by each sample's own valid count,
        so a partial final chunk pushes no pad frame into its history, and
        an exhausted stream rides along with chunk_len 0 (caches unchanged,
        encoded length 0). A partial chunk must be its stream's last audio:
        one mid-stream would move the chunk boundaries that chunked_limited
        attention is defined by."""
        cache, feat_tail = state
        sc = self.stream_cfg
        pre, held = sc.pre_encode_cache_size, feat_tail.shape[2]
        feats = torch.cat([feat_tail, mel_chunk.to(feat_tail.dtype)], dim=2)
        chunk_len = chunk_len.to(device=feats.device, dtype=torch.int64)
        log_probs, enc_len, new_cache = self.model.stream_step(
            feats, chunk_len + held, cache,
            sc.drop_extra_pre_encoded if held else 0)
        # the `pre` frames that end at each sample's last valid frame, zeros
        # before the stream's first
        j = (held + chunk_len[:, None]
             + torch.arange(pre, device=feats.device))
        new_tail = torch.gather(F.pad(feats, (pre, 0)), 2,
                                j[:, None, :].expand(-1, feats.shape[1], -1))
        return log_probs, enc_len, (new_cache, new_tail)

    def stream(self, audio: Union[str, np.ndarray],
               return_ids: bool = False):
        """Featurize one utterance, stream it chunk by chunk and
        greedy-decode the concatenated frame argmaxes (offline greedy
        decoding's ids)."""
        x = (load_audio(audio, self.cfg.sample_rate)
             if isinstance(audio, str) or hasattr(audio, "__fspath__")
             else np.asarray(audio, np.float32))
        with torch.inference_mode():
            feats, feat_len = self.model.featurizer(
                torch.from_numpy(x[None]).to(self.device),
                torch.tensor([len(x)], device=self.device))
        return self.stream_features(feats, feat_len, return_ids=return_ids)

    def stream_features(self, feats: torch.Tensor, feat_len,
                        return_ids: bool = False):
        """Stream precomputed mel features (1, F, T) chunk by chunk."""
        sc = self.stream_cfg
        feats = torch.as_tensor(feats).to(self.device)
        n = int(feat_len[0])
        state = self.init_state(feats.shape[0])
        ids: List[int] = []
        pos = 0
        with torch.inference_mode():
            while pos < n:
                take = min(sc.chunk_size, n - pos)
                chunk = torch.zeros(feats.shape[0], feats.shape[1],
                                    sc.chunk_size, device=self.device)
                chunk[:, :, :take] = feats[:, :, pos:pos + take]
                log_probs, enc_len, state = self.step(
                    state, chunk, torch.tensor([take], device=self.device))
                k = int(enc_len[0])
                ids.extend(log_probs[0, :k].argmax(-1).tolist())
                pos += take
        if return_ids or self.decoding is None:
            return ids
        return self.transcribe_ids(ids)

    def transcribe_ids(self, ids: List[int]) -> str:
        """Collapse streamed per-frame argmax ids to text (CTC rules)."""
        if self.decoding is None:
            raise ValueError("CacheAwareStreamer: no tokenizer to decode with")
        collapsed: List[int] = []
        blank = self.cfg.decoder.num_classes
        prev = -1
        for t in ids:
            if t != prev and t != blank:
                collapsed.append(int(t))
            prev = t
        return self.decoding.decode_tokens_to_str(collapsed)
