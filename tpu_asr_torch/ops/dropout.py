"""Counter-based dropout masks shared by the plain versions and the CUDA
kernels (`csrc/dropout.cuh` holds the same hash as a device function).

The hash is the one tpu_asr/ops/pallas_attention.py::_dropout_keep draws
in interpret mode: a murmur3 finalizer over

    x = idx * 2654435761 + stream * 0x9E3779B9        (uint32 arithmetic)

and an element is kept when its bits are >= min(int(rate * 2^32), 2^32 - 1).
A mask is a pure function of (stream, idx), so the plain versions, the
kernels and the Pallas kernels in interpret mode draw bit-identical masks,
and a recomputation (checkpointed layers, a backward kernel) draws the
forward's mask again without saving it.

Streams and indices, as the JAX kernels lay them out:
  - attention probabilities: stream base + b * H + h, idx t * Tp + s with
    Tp = T rounded up to 128;
  - fused FFN: stream 2 * (base + b) + salt; salt 0 is the post-SiLU mask
    over (t, d_ff), salt 1 the output mask over (t, D); idx row * width + col;
  - the port's plain dropout sites (pre-encoder, attention output, conv
    output): stream base + b, idx t * D + d.
Seeds and streams wrap modulo 2^32 as JAX's int32 arithmetic does.
"""

from __future__ import annotations

import torch

_M = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, without int64
    overflow: the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M


def hash_bits(stream: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """uint32 hash bits (as int64) of broadcastable int64 stream and idx."""
    x = (_mul32(idx & _M, 2654435761) + _mul32(stream & _M, 0x9E3779B9)) & _M
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def keep_mask(stream: torch.Tensor, rows: int, cols: int, rate: float,
              row_stride: int = None) -> torch.Tensor:
    """Bool keep-mask (*stream.shape, rows, cols): element (r, c) of stream
    s is kept iff hash(s, r * row_stride + c) >= threshold(rate)."""
    dev = stream.device
    stride = cols if row_stride is None else row_stride
    idx = (torch.arange(rows, device=dev, dtype=torch.int64)[:, None] * stride
           + torch.arange(cols, device=dev, dtype=torch.int64)[None, :])
    bits = hash_bits(stream.to(torch.int64)[..., None, None], idx)
    return bits >= threshold(rate)


def batch_streams(base: int, batch: int, per_row: int = 1, scale: int = 1,
                  salt: int = 0, device=None) -> torch.Tensor:
    """Streams scale * (base + b * per_row + j) + salt, shape (B, per_row)
    (squeezed to (B,) when per_row == 1)."""
    b = torch.arange(batch, device=device, dtype=torch.int64)[:, None]
    j = torch.arange(per_row, device=device, dtype=torch.int64)[None, :]
    s = (scale * (int(base) + b * per_row + j) + salt) & _M
    return s[:, 0] if per_row == 1 else s


def dropout(x: torch.Tensor, rate: float, seed: int,
            rows: torch.Tensor = None) -> torch.Tensor:
    """The port's plain dropout site on (B, T, D): stream seed + b, idx
    t * D + d (b the row, or `rows[b]` where given, int64 (B,)); kept
    values scaled by 1 / (1 - rate)."""
    if not rate:
        return x
    b, t, d = x.shape
    streams = (batch_streams(seed, b, device=x.device) if rows is None
               else (int(seed) + rows.to(x.device)) & _M)
    keep = keep_mask(streams, t, d, rate)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros_like(x))
