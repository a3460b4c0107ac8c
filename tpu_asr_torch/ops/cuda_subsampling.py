"""Striding x4 subsampling kernel (`csrc/subsampling.cu`) and its plain
version.

Counterpart of tpu_asr/ops/pallas_subsampling.py::fused_subsampling:
Conv2d(1->C, 3x3, s2, p1) + ReLU -> Conv2d(C->C, 3x3, s2, p1) + ReLU ->
channel-major (C, F2) flatten -> Linear(C * F2 -> D) without its bias.
Weights arrive in NeMo's layouts: convs (out, in, 3, 3), the Linear
(D, C * F2). Operands are in the working dtype of `x` (fp32 or bf16),
accumulation is fp32, and the conv activations are rounded to the working
dtype where the TPU kernel rounds them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_asr_torch.ops import _kernels as K

_ARGS = (K.INT,) + (K.PTR,) * 8 + (K.INT,) * 5 + (K.PTR,)


def out_len(n: int) -> int:
    """k=3, s=2, p=1 conv output length."""
    return (n - 1) // 2 + 1


def subsampling_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor,
                      w_out: torch.Tensor) -> torch.Tensor:
    """x (B, T0, F0) -> (B, T2, D) in x's dtype."""
    dt = x.dtype

    def r(z):               # round to the working dtype, compute in fp32
        return z.to(dt).float()

    h = F.conv2d(r(x)[:, None], r(w1), b1.float(), stride=2, padding=1)
    h = r(torch.relu(h))
    h = F.conv2d(h, r(w2), b2.float(), stride=2, padding=1)
    h = r(torch.relu(h))                                   # (B, C, T2, F2)
    b, c, t2, f2 = h.shape
    h = h.transpose(1, 2).reshape(b, t2, c * f2)           # channel-major
    return (h @ r(w_out).t()).to(dt)


def fused_subsampling(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor,
                      w_out: torch.Tensor) -> torch.Tensor:
    """Same contract as `subsampling_plain`. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel (two launches)."""
    if x.device.type == "cpu":
        return subsampling_plain(x, w1, b1, w2, b2, w_out)
    if not x.is_cuda:
        raise ValueError(f"fused_subsampling: unsupported device {x.device}")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_subsampling: unsupported dtype {dt}")
    b, t0, f0 = x.shape
    ch, d = w1.shape[0], w_out.shape[0]
    t1, f1 = out_len(t0), out_len(f0)
    t2, f2 = out_len(t1), out_len(f1)
    if (w1.shape != (ch, 1, 3, 3) or w2.shape != (ch, ch, 3, 3)
            or b1.shape != (ch,) or b2.shape != (ch,)
            or w_out.shape != (d, ch * f2)):
        raise ValueError("fused_subsampling: weight shapes do not match "
                         f"C={ch}, F2={f2}")
    if not 160 < ch <= 176 or f2 > 80:
        raise ValueError(f"fused_subsampling: the kernel is built for "
                         f"160 < C <= 176 (ModelConfig's C=176) and F/4 <= 80 "
                         f"(got C={ch}, F2={f2})")
    w1k = w1.reshape(ch, 9).to(dt).contiguous()
    w2k = w2.permute(2, 3, 1, 0).reshape(9 * ch, ch).to(dt).contiguous()
    wlt = w_out.t().to(dt).contiguous()
    b1f, b2f = b1.float().contiguous(), b2.float().contiguous()
    h1 = torch.empty((b, t1, f1, ch), dtype=dt, device=x.device)
    out = torch.empty((b, t2, d), dtype=dt, device=x.device)
    tensors = (x, w1k, b1f, w2k, b2f, wlt, h1, out)
    K.check_cuda("fused_subsampling", *tensors)
    K.call("tat_subsampling", _ARGS, x.device, int(dt == torch.bfloat16),
           *(z.data_ptr() for z in tensors), b, t0, f0, ch, d)
    fused_subsampling.launches += 1
    return out


fused_subsampling.launches = 0
