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
tensor launches `fm_fwd` and, under autograd, `fm_bwd` (a forward replay
and the backward walk), or raises. The kernels take C = 88 features,
H = 128 hidden units and max_steps <= 16, in fp32 or bf16.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_asr_torch.ops import _kernels as K

KERNEL_C, KERNEL_H, MAX_STEPS = 88, 128, 16
DTYPES = (torch.float32, torch.bfloat16)
N_PART = 2 * KERNEL_C * KERNEL_H + 2 * KERNEL_H + KERNEL_C
_FWD_ARGS = (K.INT,) + (K.PTR,) * 9 + (K.INT,) * 4 + (K.PTR,)
_BWD_ARGS = (K.INT,) + (K.PTR,) * 12 + (K.INT,) * 4 + (K.PTR,)


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
    and compute_dtype, or None when they take them."""
    if c != KERNEL_C or hidden != KERNEL_H:
        return (f"fused_fm_euler: the kernel takes C={KERNEL_C}, "
                f"H={KERNEL_H} (got C={c}, H={hidden})")
    if not 1 <= max_steps <= MAX_STEPS:
        return (f"fused_fm_euler: max_steps {max_steps} outside "
                f"1..{MAX_STEPS}")
    if compute_dtype not in DTYPES:
        return f"fused_fm_euler: unsupported compute dtype {compute_dtype}"
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


def _grid(device) -> int:
    """One persistent block per SM (the backward's partial count)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


class _FM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, n, w1x, a, c, w2, b2, max_steps):
        rows, t, _ = x0.shape
        xo, vo = torch.empty_like(x0), torch.empty_like(x0)
        tensors = (x0, n, w1x, a, c, w2, b2, xo, vo)
        K.check_cuda("fused_fm_euler", *tensors)
        K.call("tat_fm_fwd", _FWD_ARGS, x0.device,
               int(x0.dtype == torch.bfloat16),
               *(z.data_ptr() for z in tensors), rows, t, max_steps,
               _grid(x0.device))
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
    fp32; dx in the compute dtype, the rest fp32 (one partial per block,
    summed in a fixed order: bit-equal from call to call)."""
    rows, t, _ = x0.shape
    dev = x0.device
    zero = lambda g: (torch.zeros_like(x0) if g is None
                      else g.to(x0.dtype).contiguous())
    gx, gv = zero(gx), zero(gv)
    grid = _grid(dev)
    dx = torch.empty_like(x0)
    part = torch.empty(grid, N_PART, device=dev)
    out = torch.empty(N_PART, device=dev)
    tensors = (x0, n, w1x, a, c, w2, b2, gx, gv, dx, part, out)
    K.check_cuda("fused_fm_euler_bwd", *tensors)
    K.call("tat_fm_bwd", _BWD_ARGS, dev, int(x0.dtype == torch.bfloat16),
           *(z.data_ptr() for z in tensors), rows, t, max_steps, grid)
    fused_fm_euler_bwd.launches += 1
    cc, hh = KERNEL_C, KERNEL_H
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
    xo, vo = _FM.apply(x0.to(cdt).contiguous(), n, w1x.to(cdt).contiguous(),
                       a.to(f32).contiguous(), c.to(f32).contiguous(),
                       w2.to(cdt).contiguous(), b2.to(f32).contiguous(),
                       max_steps)
    return xo.to(x0.dtype), vo.to(x0.dtype)


fused_fm_euler.launches = 0
fused_fm_euler_bwd.launches = 0
