"""Post-training int8 quantization for the serving path: the PyTorch
counterpart of tpu_asr/ops/quant.py.

Scheme (no calibration data; the same checkpoint serves both precisions):
- weights: symmetric per-output-channel int8, s = max(max|w[n, :]| / 127,
  1e-8), w_q = clip(round(w / s), -127, 127), computed from the fp weights
  at use;
- activations: symmetric dynamic per-token int8 over the last axis, the
  same formula;
- products accumulate in int32 and dequantize as acc * s_x * s_w in fp32,
  bias added in fp32.

Weights arrive in PyTorch `Linear` layout (N, K), so the per-output-channel
scale reduces dim 1 (JAX reduces axis 0 of its (K, N) kernels). `round` is
half to even in both frameworks. Only the eval FFN sublayers quantize
(`models/conformer.py`); training never sees the quantizer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-8


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K) float -> (w_q (N, K) int8, scale (N, 1) fp32)."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=1, keepdim=True) / 127.0, min=EPS)
    wq = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return wq, s


def quantize_activation(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K) float -> (x_q int8, scale (..., 1) fp32), per token."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=EPS)
    xq = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return xq, s


def int8_matmul(aq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer product (..., K) int8 x (N, K) int8 -> (..., N) as
    float64: every partial sum is an integer below 2^53 for K <= 2^53 /
    127^2, so the result equals int32 accumulation (fp32 would be exact
    only for K <= 1040). Runs on the CPU and on the card."""
    return aq.double() @ wq.double().t()


def int8_dense(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ w^T (+ b) through int8 operands; w (N, K) in Linear layout.
    Returns (..., N) in `out_dtype` (default x.dtype)."""
    wq, sw = quantize_weight(w)
    xq, sx = quantize_activation(x)
    out = int8_matmul(xq, wq).float() * sx * sw[:, 0]
    if b is not None:
        out = out + b.float()
    return out.to(out_dtype or x.dtype)
