"""Audio loading for the port: the counterpart of tpu_asr/data/audio.py.

`read_audio` dispatches by magic bytes, as JAX's does:
- RIFF/WAVE: PCM 8/16/24/32-bit and IEEE float through the native decoder
  (tpu_asr_torch/native, a copy of native/wavio.c); `read_wav_bytes` is its
  plain Python version;
- FLAC: the native decoder (a copy of native/flacio.c); the pure-Python
  decoder (data/flac.py) is its plain version. LibriSpeech ships FLAC;
- NIST SPHERE: PCM16 (`read_sph_bytes`);
- MP3 (`ID3` or an MPEG frame sync; CommonVoice) through libmpg123 and
  Ogg/Opus (`OggS`; GigaSpeech) through libopus, by ctypes
  (data/codecs.py, a copy of JAX's); a missing library raises, naming it.
The native library builds with the host C compiler at first use; a failed
build raises, and no route takes another decoder on its own. Every format
decodes to mono float32 (the channel mean), resampled with scipy's
polyphase filter. `write_wav` writes PCM16 mono.
"""

from __future__ import annotations

import re
import struct
import wave
from math import gcd
from pathlib import Path
from typing import Tuple

import numpy as np


def read_audio(path) -> Tuple[np.ndarray, int]:
    """(mono float32 waveform in [-1, 1], sample rate) of a WAV, FLAC, NIST
    SPHERE, MP3 or Ogg/Opus file."""
    return read_audio_bytes(Path(path).read_bytes(), path)


def read_audio_bytes(data: bytes, path="<bytes>") -> Tuple[np.ndarray, int]:
    magic = data[:8]
    if magic[:4] == b"fLaC":
        from tpu_asr_torch.native import flac_decode
        return flac_decode(data)
    if magic[:7] == b"NIST_1A":
        return read_sph_bytes(data)
    if magic[:4] == b"OggS":
        from tpu_asr_torch.data.codecs import decode_ogg_opus
        return decode_ogg_opus(data)
    if magic[:3] == b"ID3" or (len(data) >= 2 and data[0] == 0xFF
                               and (data[1] & 0xE0) == 0xE0):
        from tpu_asr_torch.data.codecs import decode_mp3
        return decode_mp3(data)
    if magic[:4] == b"RIFF":
        from tpu_asr_torch.native import wav_decode
        return wav_decode(data)
    return read_wav_bytes(data, path)


def read_sph_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """NIST SPHERE PCM16 -> (mono float32, sample rate)."""
    if not data.startswith(b"NIST_1A"):
        raise ValueError("not a NIST SPHERE file")
    header_size = int(data[8:16].decode().strip())
    header = data[:header_size].decode("latin-1")
    fields = dict(re.findall(r"^(\S+) -[is]\d* (\S+)$", header, re.M))
    fmt = fields.get("sample_coding", "pcm")
    if fmt != "pcm":
        raise ValueError(f"unsupported SPHERE sample_coding {fmt!r} "
                         "(shorten-compressed spheres need conversion)")
    rate = int(fields.get("sample_rate", 16000))
    samples = np.frombuffer(data[header_size:], dtype="<i2")
    n_channels = int(fields.get("channel_count", 1))
    if n_channels > 1:
        samples = samples.reshape(-1, n_channels).mean(axis=1)
    return samples.astype(np.float32) / 32768.0, rate


def read_wav_bytes(data: bytes, path="<bytes>") -> Tuple[np.ndarray, int]:
    """RIFF/WAVE bytes -> (mono float32, sample rate): PCM 8/16/24/32-bit
    and IEEE float 32/64, WAVE_FORMAT_EXTENSIBLE included. The plain
    Python version of the native decoder (`read_audio` takes the native
    one), with its arithmetic: each sample scaled in float64, the channel
    mean in float64, one rounding to float32; an extensible file's format
    is its subformat's tag. (JAX's Python reader takes the mean in float32
    and an extensible file's format from its bit depth, and so differs from
    both C decoders on multichannel 32-bit and float64 PCM, by one ulp,
    and on extensible float files.)"""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{Path(str(path)).name} is not a RIFF/WAVE, FLAC "
                         "or NIST SPHERE file")
    pos, fmt, raw = 12, None, None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            if fmt[0] == 0xFFFE and len(body) >= 26:
                fmt = struct.unpack("<H", body[24:26]) + fmt[1:]
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"malformed wav: {path}")
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == 1:
        if bits == 8:
            x = (np.frombuffer(raw, np.uint8).astype(np.float64) - 128.0) \
                / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, "<i2") / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
            v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            x = np.where(v >= 1 << 23, v - (1 << 24), v) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, "<i4") / float(1 << 31)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}: {path}")
    elif audio_format == 3:
        x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(
            np.float64)
    else:
        raise ValueError(f"unsupported wav format {audio_format}: {path}")
    if n_channels > 1:
        frames = x.reshape(-1, n_channels)
        acc = frames[:, 0].copy()
        for c in range(1, n_channels):
            acc += frames[:, c]
        x = acc / float(n_channels)
    return np.ascontiguousarray(x, np.float32), sample_rate


def write_wav(path, x: np.ndarray, sample_rate: int) -> None:
    """PCM16 mono writer."""
    x16 = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    x16 = (x16 * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(x16.tobytes())


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return x
    g = gcd(orig_sr, target_sr)
    from scipy.signal import resample_poly   # slow to import: at first use
    return resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)


def load_audio(path, target_sr: int = 16000) -> np.ndarray:
    """Decode to mono float32 at `target_sr`."""
    x, sr = read_audio(path)
    return resample(x, sr, target_sr)
