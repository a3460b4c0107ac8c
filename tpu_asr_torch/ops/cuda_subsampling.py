"""Striding x4 subsampling kernel (`csrc/subsampling.cu`) and its plain
version.

Counterpart of tpu_asr/ops/pallas_subsampling.py::fused_subsampling:
Conv2d(1->C, 3x3, s2, p1) + ReLU -> Conv2d(C->C, 3x3, s2, p1) + ReLU ->
channel-major (C, F2) flatten -> Linear(C * F2 -> D) without its bias.
Weights arrive in NeMo's layouts: convs (out, in, 3, 3), the Linear
(D, C * F2). Operands are in the working dtype of `x` (fp32 or bf16),
accumulation is fp32, and the conv activations are rounded to the working
dtype where the TPU kernel rounds them. The kernel takes any channel
count C % 8 == 0 up to MAX_CHANNELS and F/4 <= MAX_F2
(`subsampling_refusal`, which the model's 'auto' route also asks). The
kernel-layout weights (w2 in (c_out, tap, c_in) order, the out-Linear with
its K axis in (f, c) order, both in the working dtype) are built once per
weight version (`_kernels.prepared`).

Gradient: as tpu_asr/ops/pallas_subsampling.py's custom VJP, the forward is
the kernel and the backward recomputes through the plain version under
autograd; there is no backward kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tpu_asr_torch.ops import _kernels as K

_ARGS = (K.INT,) + (K.PTR,) * 9 + (K.INT,) * 5 + (K.PTR,)
MAX_CHANNELS = 1024     # the widest C the wrapper takes
MAX_F2 = 80             # the widest F/4, as the Pallas kernel's


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


def subsampling_refusal(dtype: torch.dtype, ch: int,
                        f2: int) -> Optional[str]:
    """Why the kernel would refuse x of `dtype` with C = ch channels and
    F/4 = f2, or None when it takes it."""
    if dtype not in (torch.float32, torch.bfloat16):
        return f"fused_subsampling: unsupported dtype {dtype}"
    if ch % 8 or ch > MAX_CHANNELS or f2 > MAX_F2:
        return (f"fused_subsampling: the kernel takes C % 8 == 0, "
                f"C <= {MAX_CHANNELS} and F/4 <= {MAX_F2} (got C={ch}, "
                f"F2={f2})")
    return None


@K.prepared
def _kernel_weights(w1, b1, w2, b2, w_out, dt):
    """(w1 (C, 9), b1, w2 (C, 9 C) in (c_out, tap, c_in) order, b2, w_out
    (D, F2 C) in (f, c) order), weights in dt, biases fp32."""
    ch, d = w1.shape[0], w_out.shape[0]
    f2 = w_out.shape[1] // ch
    return (w1.reshape(ch, 9).to(dt).contiguous(), b1.float().contiguous(),
            w2.permute(0, 2, 3, 1).reshape(ch, 9 * ch).to(dt).contiguous(),
            b2.float().contiguous(),
            w_out.reshape(d, ch, f2).transpose(1, 2).reshape(d, f2 * ch)
            .to(dt).contiguous())


def _launch(x, w1, b1, w2, b2, w_out):
    dt = x.dtype
    b, t0, f0 = x.shape
    ch, d = w1.shape[0], w_out.shape[0]
    t1, f1 = out_len(t0), out_len(f0)
    t2, f2 = out_len(t1), out_len(f1)
    if (w1.shape != (ch, 1, 3, 3) or w2.shape != (ch, ch, 3, 3)
            or b1.shape != (ch,) or b2.shape != (ch,)
            or w_out.shape != (d, ch * f2)):
        raise ValueError("fused_subsampling: weight shapes do not match "
                         f"C={ch}, F2={f2}")
    why = subsampling_refusal(dt, ch, f2)
    if why:
        raise ValueError(why)
    h1 = torch.empty((b, t1, f1, ch), dtype=dt, device=x.device)
    h2 = torch.empty((b * t2 * f2, ch), dtype=dt, device=x.device)
    out = torch.empty((b, t2, d), dtype=dt, device=x.device)
    w1k, b1f, w2k, b2f, wlp = _kernel_weights(w1, b1, w2, b2, w_out, dt)
    tensors = (x, w1k, b1f, w2k, b2f, wlp, h1, h2, out)
    K.check_cuda("fused_subsampling", *tensors)
    K.call("tat_subsampling", _ARGS, x.device, int(dt == torch.bfloat16),
           *(z.data_ptr() for z in tensors), b, t0, f0, ch, d)
    fused_subsampling.launches += 1
    return out


class _Subsampling(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w_out):
        ctx.save_for_backward(x, w1, b1, w2, b2, w_out)
        return _launch(x, w1, b1, w2, b2, w_out)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        inputs = [z.detach().requires_grad_(n)
                  for z, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = subsampling_plain(*inputs)
        wrt = [z for z, n in zip(inputs, need) if n]
        got = iter(torch.autograd.grad(out, wrt, g))
        return tuple(next(got) if n else None for n in need)


def fused_subsampling(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor,
                      w_out: torch.Tensor) -> torch.Tensor:
    """Same contract as `subsampling_plain`. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel (three launches), and under
    autograd the backward recomputes the plain version."""
    if x.device.type == "cpu":
        return subsampling_plain(x, w1, b1, w2, b2, w_out)
    if not x.is_cuda:
        raise ValueError(f"fused_subsampling: unsupported device {x.device}")
    return _Subsampling.apply(x, w1, b1, w2, b2, w_out)


fused_subsampling.launches = 0
