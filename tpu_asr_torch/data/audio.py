"""Audio loading for the port: RIFF/WAVE through the standard library's
`wave` module, mono float32, resampled with scipy's polyphase filter.
Any other container raises: the port reads WAV only."""

from __future__ import annotations

import wave
from math import gcd
from pathlib import Path

import numpy as np
from scipy.signal import resample_poly


def read_wav(path) -> tuple:
    """(mono float32 waveform in [-1, 1], sample rate) of a PCM WAV file
    (8, 16, 24 or 32 bit)."""
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise ValueError(f"tpu_asr_torch reads WAV only; {Path(path).name} "
                         "is not a RIFF/WAVE file")
    try:
        with wave.open(str(path), "rb") as w:
            n_ch, width, sr = w.getnchannels(), w.getsampwidth(), \
                w.getframerate()
            raw = w.readframes(w.getnframes())
    except wave.Error as e:
        raise ValueError(f"tpu_asr_torch reads PCM WAV only: {e}") from e
    if width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        x = np.where(v >= 1 << 23, v - (1 << 24), v).astype(np.float32) \
            / float(1 << 23)
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported PCM sample width {width}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return np.ascontiguousarray(x, np.float32), sr


def load_audio(path, target_sr: int = 16000) -> np.ndarray:
    """Decode a WAV file to mono float32 at `target_sr`."""
    x, sr = read_wav(path)
    if sr == target_sr:
        return x
    g = gcd(sr, target_sr)
    return resample_poly(x, target_sr // g, sr // g).astype(np.float32)
