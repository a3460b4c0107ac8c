"""Log-mel spectrogram kernels (`csrc/logmel.cu`) and their plain version.

Counterpart of tpu_asr/ops/pallas_features.py::fused_logmel: pre-emphasised,
reflect-padded audio (B, Lp) fp32 -> unnormalised mel power (B, T, n_mels)
fp32, |DFT|^mag_power of the windowed frames through the mel filterbank,
then log(x + guard) when `take_log`. The windowed [cos | sin] DFT basis and
the mel filterbank are arguments (ops/features.py owns them). Operands are
fp32: the TPU kernel's bf16 `passes` option was a workaround for the v5e
matrix unit.

A power-of-two n_fft in [64, 2048] runs the FFT kernel; any other
n_fft % 4 == 0 (with hop % 4 == 0 and n_freq <= 288) the DFT kernel
(`logmel_route`). The FFT kernel's tables, built here by plain functions
once per constant version (`_kernels.prepared`): the window (the k = 0
column of the windowed basis), the twiddles exp(-2 pi i m / n_fft) and the
radix-16 pass's exp(-2 pi i r j / 256), in float64 rounded to fp32, and
each mel filter's band of nonzero bins with its weights packed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpu_asr_torch.ops import _kernels as K

_ARGS = (K.PTR, K.PTR, K.PTR, K.PTR, K.INT, K.INT, K.INT, K.INT, K.INT,
         K.INT, K.INT, K.FLOAT, K.FLOAT, K.INT, K.PTR)
_FFT_ARGS = (K.PTR,) * 7 + (K.INT,) * 6 + (K.FLOAT, K.FLOAT, K.INT, K.PTR)
FFT_FRAMES, FFT_WARPS = 32, 8     # logmel.cu: kFT, kFW
DFT_MAX_FREQ = 288               # logmel.cu: the DFT kernel's block size


def logmel_plain(x_padded: torch.Tensor, n_frames: int, basis: torch.Tensor,
                 fb_t: torch.Tensor, hop: int, log_guard: float,
                 mag_power: float = 2.0, take_log: bool = True
                 ) -> torch.Tensor:
    """Frames (B, T, n_fft) @ basis (n_fft, 2F) -> |.|^2, raised to
    mag_power / 2 -> @ fb_t (F, M) -> log(x + guard) when take_log, all
    fp32."""
    n_fft = basis.shape[0]
    frames = x_padded.unfold(1, n_fft, hop)[:, :n_frames]
    spec = frames @ basis
    f = basis.shape[1] // 2
    power = spec[..., :f] ** 2 + spec[..., f:] ** 2
    if mag_power != 2.0:
        power = torch.pow(torch.sqrt(torch.clamp(power, min=0.0)), mag_power)
    mel = power @ fb_t
    return torch.log(mel + log_guard) if take_log else mel


def fft_smem(n_fft: int, hop: int) -> int:
    """Shared memory (bytes) of logmel.cu's FFT kernel."""
    span = -(-((FFT_FRAMES - 1) * hop + n_fft) // 4) * 4
    n = n_fft // 2
    # padded buffers (two at N = 256, one frame per half-warp) and powers
    per_warp = (2 if n == 256 else 1) * 2 * (n + n // 16) + n + 4
    tw16 = 2 * 256 if n == 256 else 0
    return 4 * (span + 3 * n_fft + tw16 + FFT_WARPS * per_warp)


def logmel_route(n_fft: int, hop: int, n_freq: int) -> Optional[str]:
    """'fft', 'dft' or None (no kernel takes the shape). The FFT kernel
    computes every bin, n_fft / 2 + 1."""
    if ((n_fft & (n_fft - 1)) == 0 and 64 <= n_fft <= 2048
            and n_freq == n_fft // 2 + 1
            and fft_smem(n_fft, hop) <= K.SMEM_LIMIT):
        return "fft"
    if n_fft % 4 == 0 and hop % 4 == 0 and n_freq <= DFT_MAX_FREQ:
        return "dft"
    return None


def logmel_refusal(n_fft: int, hop: int, n_freq: int) -> Optional[str]:
    """Why the kernels would refuse the shape, or None when one takes it."""
    if logmel_route(n_fft, hop, n_freq) is not None:
        return None
    return (f"fused_logmel: no kernel takes n_fft={n_fft}, hop={hop}, "
            f"{n_freq} bins (the FFT kernel: a power of two in [64, 2048]; "
            f"the DFT kernel: n_fft % 4 == 0, hop % 4 == 0, n_freq <= "
            f"{DFT_MAX_FREQ})")


def twiddles(n_fft: int) -> np.ndarray:
    """(n_fft, 2) float32 [cos, -sin](2 pi m / n_fft): exp(-2 pi i m / n_fft)
    in float64, rounded once."""
    angle = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(angle), -np.sin(angle)], axis=1).astype(
        np.float32)


def twiddles16() -> np.ndarray:
    """(256, 2) float32: exp(-2 pi i r j / 256) at row 16 r + j (r, j < 16),
    the second radix-16 pass's twiddles at n_fft = 512, from float64."""
    r, j = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    angle = 2.0 * np.pi * (r * j).reshape(-1).astype(np.float64) / 256
    return np.stack([np.cos(angle), -np.sin(angle)], axis=1).astype(
        np.float32)


def mel_bands(fb_t: np.ndarray):
    """(band (n_mels, 4) int32, weights float32) of fb_t (n_freq, n_mels):
    per filter its first nonzero bin, the count of bins up to its last
    nonzero one, the offset of those weights in `weights`, and its mel
    index. Rows are in the FFT kernel's lane order, lane l taking rows
    l, l + 32, l + 64, ..: the filters sorted by count, longest first, dealt
    out as a snake (each odd round of 32 rows reversed) so that the lanes'
    multiply-add counts even out."""
    n_freq, n_mels = fb_t.shape
    bands = []
    for m in range(n_mels):
        nz = np.flatnonzero(fb_t[:, m])
        lo, cnt = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        bands.append((lo, cnt, m))
    ranked = sorted(bands, key=lambda x: (-x[1], x[2]))
    band = np.zeros((n_mels, 4), np.int32)
    weights = []
    off = 0
    for q in range(n_mels):
        rnd, lane = divmod(q, 32)
        size = min(32, n_mels - 32 * rnd)
        lo, cnt, m = ranked[32 * rnd + (lane if rnd % 2 == 0
                                        else size - 1 - lane)]
        band[q] = (lo, cnt, off, m)
        weights.append(fb_t[lo:lo + cnt, m])
        off += cnt
    return band, np.concatenate(weights).astype(np.float32)


@K.prepared
def _fft_tables(basis: torch.Tensor, fb_t: torch.Tensor):
    """(window, twiddles, the radix-16 pass's twiddles, band, weights) on
    basis's device."""
    band, weights = mel_bands(fb_t.detach().cpu().numpy())
    tables = (twiddles(basis.shape[0]), twiddles16(), band, weights)
    return (basis[:, 0].contiguous(),
            *(torch.from_numpy(z).to(basis.device) for z in tables))


def fused_logmel(x_padded: torch.Tensor, n_frames: int, basis: torch.Tensor,
                 fb_t: torch.Tensor, hop: int, log_guard: float,
                 mag_power: float = 2.0, take_log: bool = True
                 ) -> torch.Tensor:
    """Same contract as `logmel_plain`. A CPU tensor runs the plain version;
    a CUDA tensor launches the FFT or the DFT kernel (`logmel_route`)."""
    if x_padded.device.type == "cpu":
        return logmel_plain(x_padded, n_frames, basis, fb_t, hop, log_guard,
                            mag_power, take_log)
    if not x_padded.is_cuda:
        raise ValueError(f"fused_logmel: unsupported device {x_padded.device}")
    b, lp = x_padded.shape
    n_fft, two_f = basis.shape
    n_freq, n_mels = fb_t.shape
    if any(t.dtype != torch.float32 for t in (x_padded, basis, fb_t)):
        raise ValueError("fused_logmel: audio, basis and filterbank must be "
                         "float32")
    if two_f != 2 * n_freq:
        raise ValueError(f"fused_logmel: basis {tuple(basis.shape)} and "
                         f"fb_t {tuple(fb_t.shape)} do not match")
    why = logmel_refusal(n_fft, hop, n_freq)
    if why:
        raise ValueError(why)
    if lp < (n_frames - 1) * hop + n_fft:
        raise ValueError(f"fused_logmel: {n_frames} frames need "
                         f"{(n_frames - 1) * hop + n_fft} samples, got {lp}")
    K.check_cuda("fused_logmel", x_padded, basis, fb_t)
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32,
                      device=x_padded.device)
    opts = (float(log_guard), float(mag_power), int(bool(take_log)))
    if logmel_route(n_fft, hop, n_freq) == "fft":
        tables = _fft_tables(basis, fb_t)
        K.call("tat_logmel_fft", _FFT_ARGS, x_padded.device,
               *(z.data_ptr() for z in (x_padded, *tables, out)), b, lp,
               n_frames, n_fft, hop, n_mels, *opts)
    else:
        K.call("tat_logmel", _ARGS, x_padded.device,
               *(z.data_ptr() for z in (x_padded, basis, fb_t, out)), b, lp,
               n_frames, n_fft, hop, n_freq, n_mels, *opts)
    fused_logmel.launches += 1
    return out


fused_logmel.launches = 0
