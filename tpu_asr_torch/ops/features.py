"""Mel-spectrogram frontend, eval path: the PyTorch counterpart of
tpu_asr/ops/features.py::FilterbankFeatures.

    preemphasis -> reflect pad by n_fft // 2 -> windowed |DFT|^mag_power
    -> mel -> log(x + guard) when cfg.log
                                 [ops/cuda_features.py: kernel or plain]
    -> normalisation over valid frames ('per_feature', 'all_features' or
       none) -> pad_value fill

Constants are re-derived here in numpy (the JAX package's ops modules import
JAX): the hann window (symmetric, centred in n_fft) is folded into the DFT
basis, and the filterbank is librosa's slaney-scale, slaney-normalised mel.
Training adds dither (`cfg.dither` * standard normal noise) from an explicit
`torch.Generator` before preemphasis, as the JAX frontend does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_asr_torch.config import PreprocessorConfig
from tpu_asr_torch.ops._kernels import use_kernel
from tpu_asr_torch.ops.cuda_features import (fused_logmel, logmel_plain,
                                             logmel_refusal)


def _hz_to_mel(freqs: np.ndarray) -> np.ndarray:
    freqs = np.asarray(freqs, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    mels = freqs / f_sp
    log_part = min_log_hz / f_sp + np.log(np.maximum(freqs, 1e-10)
                                          / min_log_hz) / logstep
    return np.where(freqs >= min_log_hz, log_part, mels)


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    f_sp * mels)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Triangular slaney mel filterbank (n_mels, 1 + n_fft // 2), float32 —
    `librosa.filters.mel(htk=False, norm='slaney')`."""
    fmax = sample_rate / 2.0 if fmax is None else fmax
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    lo, hi = _hz_to_mel(np.array([fmin, fmax]))
    mel_pts = _mel_to_hz(np.linspace(lo, hi, n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def dft_basis(n_fft: int, win_length: int, window: str = "hann") -> np.ndarray:
    """Windowed [cos | sin] DFT basis (n_fft, 2 * (1 + n_fft // 2)) float32;
    the window is centred in n_fft as torch.stft pads it."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(1 + n_fft // 2)[None, :]
    angle = -2.0 * np.pi * n * k / n_fft
    if window == "hann":
        win = np.hanning(win_length)      # symmetric == periodic=False
    elif window in (None, "ones", "none"):
        win = np.ones(win_length)
    else:
        raise ValueError(f"unsupported window: {window}")
    left = (n_fft - win_length) // 2
    win_full = np.zeros(n_fft)
    win_full[left:left + win_length] = win
    cos_b = (np.cos(angle) * win_full[:, None]).astype(np.float32)
    sin_b = (np.sin(angle) * win_full[:, None]).astype(np.float32)
    return np.concatenate([cos_b, sin_b], axis=1)


def stft_seq_len(length: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Frames of a centre-padded STFT: len // hop + 1 (NeMo get_seq_len)."""
    return (length + 2 * (n_fft // 2) - n_fft) // hop + 1


class FilterbankFeatures(nn.Module):
    """wav (B, L) -> normalised log-mel (B, n_mels, T) fp32 + frames (B,).

    backend: 'auto' or 'pallas' -> `fused_logmel` (a CUDA kernel for a
    CUDA tensor, its plain version for a CPU tensor) where a kernel takes
    the shape (`uses_kernel`); 'xla' -> the plain version. The constants
    are non-persistent buffers: `.to(device)` moves them and `state_dict()`
    leaves them out."""

    def __init__(self, cfg: Optional[PreprocessorConfig] = None,
                 backend: str = "auto"):
        super().__init__()
        self.cfg = c = cfg or PreprocessorConfig()
        if backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown features backend: {backend!r}")
        if c.normalize not in ("per_feature", "all_features", None, "none"):
            raise ValueError(f"unknown normalize mode: {c.normalize}")
        self.backend = backend
        self.n_fft, self.hop = c.n_fft, c.hop_length
        fb = mel_filterbank(c.sample_rate, c.n_fft, c.features, c.lowfreq,
                            c.highfreq)
        self.register_buffer(
            "basis", torch.from_numpy(dft_basis(c.n_fft, c.win_length,
                                                c.window)),
            persistent=False)
        self.register_buffer("fb_t", torch.from_numpy(np.ascontiguousarray(
            fb.T)), persistent=False)

    def seq_len(self, length: torch.Tensor) -> torch.Tensor:
        return stft_seq_len(length, self.n_fft, self.hop)

    def uses_kernel(self) -> bool:
        """Whether the route takes the kernel wrapper."""
        return use_kernel(self.backend, logmel_refusal(
            self.n_fft, self.hop, self.fb_t.shape[0]))

    def forward(self, signal: torch.Tensor, length: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`generator` (on the signal's device) draws the training dither."""
        c = self.cfg
        x = signal.float()
        if train and c.dither > 0.0 and generator is not None:
            x = x + c.dither * torch.randn(x.shape, generator=generator,
                                           device=x.device)
        if c.preemph:
            x = torch.cat([x[:, :1], x[:, 1:] - c.preemph * x[:, :-1]], dim=1)
        pad = self.n_fft // 2
        xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0].contiguous()
        n_frames = (xp.shape[1] - self.n_fft) // self.hop + 1
        logmel = fused_logmel if self.uses_kernel() else logmel_plain
        mel = logmel(xp, n_frames, self.basis, self.fb_t, self.hop,
                     c.log_zero_guard_value, c.mag_power,
                     bool(c.log))                               # (B, T, M)

        seq_len = self.seq_len(length)
        valid = (torch.arange(n_frames, device=mel.device)[None, :]
                 < seq_len[:, None]).to(mel.dtype)[..., None]   # (B, T, 1)
        if c.normalize in ("per_feature", "all_features"):
            # per feature: statistics over valid frames; all features: over
            # valid frames and every mel bin together
            dims = (1,) if c.normalize == "per_feature" else (1, 2)
            n = torch.clamp(seq_len.to(mel.dtype), min=2.0)[:, None, None]
            if c.normalize == "all_features":
                n = n * mel.shape[2]
            mean = (mel * valid).sum(dim=dims, keepdim=True) / n
            var = ((mel - mean) ** 2 * valid).sum(dim=dims,
                                                  keepdim=True) / (n - 1.0)
            mel = (mel - mean) / (torch.sqrt(torch.clamp(var, min=0.0))
                                  + 1e-5)
        mel = mel * valid + c.pad_value * (1.0 - valid)
        out = mel.transpose(1, 2)                               # (B, M, T)
        if c.pad_to > 1 and out.shape[-1] % c.pad_to:
            out = F.pad(out, (0, c.pad_to - out.shape[-1] % c.pad_to),
                        value=c.pad_value)
        return out, seq_len
