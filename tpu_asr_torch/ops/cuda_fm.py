"""Fused flow-matching Euler loop (`csrc/fm.cu`), forward and backward, and
its plain version.

Counterpart of tpu_asr/ops/pallas_fm.py::fused_fm_euler: per feature
position, with the `mlp` meta encoder and the time embedding folded into
(a, c) by the caller,

    for j = 0 .. max_steps - 1:            # t = (n - j) / n, n = max(steps, 1)
        h = relu(x W1x + t a + c)
        v = h W2 + b2
        x = x - v / n      while j < n
    last_v = v at j == n - 1

with a step count n per row. Dots take operands in the compute dtype with
fp32 accumulation; h, v and x round to the compute dtype where the TPU
kernel rounds them (`_fm_fwd_kernel`), so for fp32 nothing rounds.

A CPU tensor runs the plain version (autograd differentiates it); a CUDA
tensor launches the forward kernel and, under autograd, the backward (a
forward replay and the backward walk, then the weight-gradient products),
or raises. The kernels take max_steps <= 16; in bf16 (the tensor-core
kernels) any C % 8 == 0 up to 128 features and H % 32 == 0 up to 256
hidden units, in fp32 (the SIMT check kernels) C = 88 and H = 128.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tpu_asr_torch.ops import _kernels as K

MAX_STEPS = 16
FP32_C, FP32_H = 88, 128            # the fp32 kernels' only widths
BF16_MAX_C, BF16_MAX_H = 128, 256   # bf16: C % 8 == 0, H % 32 == 0
DTYPES = (torch.float32, torch.bfloat16)
_FWD_ARGS = (K.INT,) + (K.PTR,) * 9 + (K.INT,) * 5 + (K.PTR,)
_BWD_ARGS = (K.INT,) + (K.PTR,) * 12 + (K.INT,) * 5 + (K.PTR,)
_SCRATCH_ARGS = (K.INT,) * 6 + (K.PTR, K.PTR)


def fm_euler_plain(x0, steps, w1x, a, c, w2, b2, *, max_steps: int,
                   compute_dtype=torch.float32):
    """(x_final, last_v), both (rows, T, C) in x0's dtype, from x0 (rows,
    T, C), steps (rows,), w1x (C, H), a, c (H,), w2 (H, C), b2 (C,): a
    Python loop of `max_steps` masked steps."""
    cdt = compute_dtype

    def rnd(z):                 # round trip through the compute dtype
        return z.to(cdt).float()

    n = steps.float().clamp(min=1.0)[:, None, None]
    w1, w2c = rnd(w1x), rnd(w2)
    a, c, b2 = a.float(), c.float(), b2.float()
    x = rnd(x0)
    last_v = torch.zeros_like(x)
    for j in range(int(max_steps)):
        t = (n - j) / n
        h = rnd(torch.relu(x @ w1 + t * a + c))
        v = rnd(h @ w2c + b2)
        x = torch.where(j < n, rnd(x - v / n), x)
        last_v = torch.where(n - 1.0 == j, v, last_v)
    return x.to(x0.dtype), last_v.to(x0.dtype)


def fm_refusal(c: int, hidden: int, max_steps: int,
               compute_dtype) -> Optional[str]:
    """Why the kernels would refuse C features, `hidden` units, max_steps
    and compute_dtype (naming the limit the call breaks), or None when they
    take them."""
    if compute_dtype not in DTYPES:
        return f"fused_fm_euler: unsupported compute dtype {compute_dtype}"
    if not 1 <= max_steps <= MAX_STEPS:
        return (f"fused_fm_euler: max_steps {max_steps} outside "
                f"1..{MAX_STEPS}")
    if compute_dtype == torch.float32:
        if (c, hidden) != (FP32_C, FP32_H):
            return (f"fused_fm_euler: the fp32 kernel takes C={FP32_C}, "
                    f"H={FP32_H} (got C={c}, H={hidden})")
        return None
    if c % 8 or not 8 <= c <= BF16_MAX_C:
        return (f"fused_fm_euler: the bf16 kernel takes C % 8 == 0 up to "
                f"{BF16_MAX_C} (got C={c})")
    if hidden % 32 or not 32 <= hidden <= BF16_MAX_H:
        return (f"fused_fm_euler: the bf16 kernel takes H % 32 == 0 up to "
                f"{BF16_MAX_H} (got H={hidden})")
    return None


def check_kernel_args(x0, w1x, w2, max_steps: int, compute_dtype) -> None:
    """Raise for what the kernels do not take."""
    c, hidden = w1x.shape[0], w1x.shape[-1]
    if (x0.dim() != 3 or x0.shape[-1] != c or w1x.dim() != 2
            or w2.shape != (hidden, c)):
        raise ValueError(
            f"fused_fm_euler: shapes do not match (x0 {tuple(x0.shape)}, "
            f"w1x {tuple(w1x.shape)}, w2 {tuple(w2.shape)})")
    why = fm_refusal(c, hidden, max_steps, compute_dtype)
    if why:
        raise ValueError(why)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it whose data start on 16 bytes (the kernels read
    the weights in 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _dims(x0, w1x):
    """The C arguments after the flag: rows, T, C, H."""
    rows, t, c = x0.shape
    return rows, t, c, w1x.shape[1]


@functools.lru_cache(maxsize=64)
def _scratch_bytes(device, bf16: int, rows: int, t: int, c: int, h: int,
                   max_steps: int) -> int:
    """Bytes of the backward's scratch (csrc/fm.cu::tat_fm_bwd_scratch)."""
    size = ctypes.c_longlong(0)
    K.call("tat_fm_bwd_scratch", _SCRATCH_ARGS, device, bf16, rows, t, c,
           h, max_steps, ctypes.addressof(size))
    return size.value


class _FM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, n, w1x, a, c, w2, b2, max_steps):
        xo, vo = torch.empty_like(x0), torch.empty_like(x0)
        tensors = (x0, n, w1x, a, c, w2, b2, xo, vo)
        K.check_cuda("fused_fm_euler", *tensors)
        K.call("tat_fm_fwd", _FWD_ARGS, x0.device,
               int(x0.dtype == torch.bfloat16),
               *(z.data_ptr() for z in tensors), *_dims(x0, w1x), max_steps)
        fused_fm_euler.launches += 1
        ctx.max_steps = max_steps
        ctx.save_for_backward(x0, n, w1x, a, c, w2, b2)
        return xo, vo

    @staticmethod
    def backward(ctx, gx, gv):
        x0, n, w1x, a, c, w2, b2 = ctx.saved_tensors
        dx, dw1, da, dc, dw2, db2 = fused_fm_euler_bwd(
            x0, n, w1x, a, c, w2, b2, gx, gv, ctx.max_steps)
        return dx, None, dw1.to(w1x.dtype), da, dc, dw2.to(w2.dtype), db2, \
            None


def fused_fm_euler_bwd(x0, n, w1x, a, c, w2, b2, gx, gv, max_steps: int):
    """(dx, dW1x, da, dc, dW2, db2) for the cotangents gx of x_final and gv
    of last_v (None: zero). x0, w1x, w2 in the compute dtype, n, a, c, b2
    fp32; dx in the compute dtype, the rest fp32 (partials summed in a
    fixed order: bit-equal from call to call)."""
    dev = x0.device
    zero = lambda g: (torch.zeros_like(x0) if g is None
                      else _aligned(g.to(x0.dtype).contiguous()))
    gx, gv = zero(gx), zero(gv)
    bf16 = int(x0.dtype == torch.bfloat16)
    dims = _dims(x0, w1x)
    _, _, cc, hh = dims
    dx = torch.empty_like(x0)
    scratch = torch.empty(_scratch_bytes(dev, bf16, *dims, max_steps),
                          dtype=torch.uint8, device=dev)
    out = torch.empty(2 * cc * hh + 2 * hh + cc, device=dev)
    tensors = (x0, n, w1x, a, c, w2, b2, gx, gv, dx, scratch, out)
    K.check_cuda("fused_fm_euler_bwd", *tensors)
    K.call("tat_fm_bwd", _BWD_ARGS, dev, bf16,
           *(z.data_ptr() for z in tensors), *dims, max_steps)
    fused_fm_euler_bwd.launches += 1
    dw1, dw2, da, dc, db2 = torch.split(out, (cc * hh, hh * cc, hh, hh, cc))
    return dx, dw1.view(cc, hh), da, dc, dw2.view(hh, cc), db2


def fused_fm_euler(x0, steps, w1x, a, c, w2, b2, *, max_steps: int,
                   compute_dtype=torch.float32):
    """Same contract as `fm_euler_plain`; the casts of pallas_fm.py: W1x
    and W2 in the compute dtype, a, c and b2 in fp32."""
    if x0.device.type == "cpu":
        return fm_euler_plain(x0, steps, w1x, a, c, w2, b2,
                              max_steps=max_steps,
                              compute_dtype=compute_dtype)
    if not x0.is_cuda:
        raise ValueError(f"fused_fm_euler: unsupported device {x0.device}")
    max_steps = int(max_steps)
    check_kernel_args(x0, w1x, w2, max_steps, compute_dtype)
    cdt, f32 = compute_dtype, torch.float32
    n = steps.to(f32).clamp(min=1.0).contiguous()
    ready = lambda z, dt: _aligned(z.to(dt).contiguous())
    xo, vo = _FM.apply(ready(x0, cdt), n, ready(w1x, cdt), ready(a, f32),
                       ready(c, f32), ready(w2, cdt), ready(b2, f32),
                       max_steps)
    return xo.to(x0.dtype), vo.to(x0.dtype)


fused_fm_euler.launches = 0
fused_fm_euler_bwd.launches = 0
