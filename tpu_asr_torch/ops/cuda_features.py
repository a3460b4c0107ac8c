"""Log-mel spectrogram kernel (`csrc/logmel.cu`) and its plain version.

Counterpart of tpu_asr/ops/pallas_features.py::fused_logmel: pre-emphasised,
reflect-padded audio (B, Lp) fp32 -> unnormalised log-mel (B, T, n_mels)
fp32. The windowed [cos | sin] DFT basis and the mel filterbank are
arguments (ops/features.py owns them). Operands are fp32: the TPU kernel's
bf16 `passes` option was a workaround for the v5e matrix unit.
"""

from __future__ import annotations

import torch

from tpu_asr_torch.ops import _kernels as K

_ARGS = (K.PTR, K.PTR, K.PTR, K.PTR, K.INT, K.INT, K.INT, K.INT, K.INT,
         K.INT, K.INT, K.FLOAT, K.PTR)


def logmel_plain(x_padded: torch.Tensor, n_frames: int, basis: torch.Tensor,
                 fb_t: torch.Tensor, hop: int,
                 log_guard: float) -> torch.Tensor:
    """Frames (B, T, n_fft) @ basis (n_fft, 2F) -> |.|^2 -> @ fb_t (F, M)
    -> log(x + guard), all fp32."""
    n_fft = basis.shape[0]
    frames = x_padded.unfold(1, n_fft, hop)[:, :n_frames]
    spec = frames @ basis
    f = basis.shape[1] // 2
    power = spec[..., :f] ** 2 + spec[..., f:] ** 2
    return torch.log(power @ fb_t + log_guard)


def fused_logmel(x_padded: torch.Tensor, n_frames: int, basis: torch.Tensor,
                 fb_t: torch.Tensor, hop: int,
                 log_guard: float) -> torch.Tensor:
    """Same contract as `logmel_plain`. A CPU tensor runs the plain version;
    a CUDA tensor launches the kernel."""
    if x_padded.device.type == "cpu":
        return logmel_plain(x_padded, n_frames, basis, fb_t, hop, log_guard)
    if not x_padded.is_cuda:
        raise ValueError(f"fused_logmel: unsupported device {x_padded.device}")
    b, lp = x_padded.shape
    n_fft, two_f = basis.shape
    n_freq, n_mels = fb_t.shape
    if any(t.dtype != torch.float32 for t in (x_padded, basis, fb_t)):
        raise ValueError("fused_logmel: audio, basis and filterbank must be "
                         "float32")
    if two_f != 2 * n_freq or n_fft % 4 or hop % 4 or n_freq > 288:
        raise ValueError(
            f"fused_logmel: unsupported shapes basis {tuple(basis.shape)}, "
            f"fb_t {tuple(fb_t.shape)}, hop {hop} (need n_fft % 4 == 0, "
            "hop % 4 == 0, n_freq <= 288)")
    if lp < (n_frames - 1) * hop + n_fft:
        raise ValueError(f"fused_logmel: {n_frames} frames need "
                         f"{(n_frames - 1) * hop + n_fft} samples, got {lp}")
    K.check_cuda("fused_logmel", x_padded, basis, fb_t)
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32,
                      device=x_padded.device)
    K.call("tat_logmel", _ARGS, x_padded.device,
           *(z.data_ptr() for z in (x_padded, basis, fb_t, out)), b, lp,
           n_frames, n_fft, hop, n_freq, n_mels, float(log_guard))
    fused_logmel.launches += 1
    return out


fused_logmel.launches = 0
