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
or raises. The kernels take any max_steps >= 1, C % 8 == 0 up to 512
features and H % 32 == 0 up to 512 hidden units, in fp32 and in bf16
(conformer-LARGE's student is C = 256, XLarge's C = 512). Routes
(csrc/fm.cu `mma_route`): bf16 at C <= 128, H <= 256 on the narrow
tensor-core kernels, every other bf16 shape on the wide tensor-core
kernels, fp32 (the check dtype) at every shape on the SIMT kernels.

`fm_euler_bwd_plain` is the plain version of the backward kernels: the
explicit backward of `_fm_bwd_kernel` (its rounding points, gx carried in
fp32), where autograd through `fm_euler_plain` would round each gradient
to the compute dtype where the forward rounds. Tests and chip_smoke.py
hold the backward kernels to it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tpu_asr_torch.ops import _kernels as K

MAX_C, MAX_H = 512, 512             # C % 8 == 0, H % 32 == 0 (fm.cu takes)
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


def fm_euler_bwd_plain(x0, n, w1x, a, c, w2, b2, gx, gv, max_steps: int):
    """`fused_fm_euler_bwd`'s tuple (dx, dW1x, da, dc, dW2, db2) from its
    arguments, as tpu_asr/ops/pallas_fm.py::_fm_bwd_kernel computes it: a
    replay storing each step's x_j, then for j = max_steps - 1 .. 0, with
    round() a trip through x0's dtype (the compute dtype),
        dv = (j < n ? -gx / n : 0) + (j == n - 1 ? gv : 0)
        dh = round(dv) W2^T,  dp = dh [p > 0]
        gx += round(dp) W1x^T                      (gx in fp32)
        dW1x += x_j^T round(dp),  dW2 += h_j^T round(dv)
        da += t dp,  dc += dp,  db2 += dv          (unrounded)
    dx in x0's dtype, the rest fp32; gx, gv None read zero."""
    cdt = x0.dtype

    def rnd(z):
        return z.to(cdt).float()

    rows, t_len, cc = x0.shape
    hidden = w1x.shape[1]
    n = n.float().clamp(min=1.0).reshape(rows, 1, 1)
    w1, w2f = rnd(w1x), rnd(w2)
    a, c, b2 = a.float(), c.float(), b2.float()
    zero = torch.zeros(rows, t_len, cc, device=x0.device)
    g = zero if gx is None else gx.to(cdt).float()
    gvf = zero if gv is None else gv.to(cdt).float()
    x, xs = rnd(x0), []
    for j in range(int(max_steps)):
        xs.append(x)
        t = (n - j) / n
        h = rnd(torch.relu(x @ w1 + t * a + c))
        v = rnd(h @ w2f + b2)
        x = torch.where(j < n, rnd(x - v / n), x)
    dw1 = torch.zeros(cc, hidden, device=x0.device)
    dw2 = torch.zeros(hidden, cc, device=x0.device)
    da = torch.zeros(hidden, device=x0.device)
    dc, db2 = torch.zeros_like(da), torch.zeros(cc, device=x0.device)
    flat = lambda z: z.reshape(-1, z.shape[-1])
    for j in range(int(max_steps) - 1, -1, -1):
        xj, t = xs[j], (n - j) / n
        p = xj @ w1 + t * a + c
        h = rnd(torch.relu(p))
        dv = (torch.where(j < n, -g / n, 0.0)
              + torch.where(n - 1.0 == j, gvf, 0.0))
        dv16 = rnd(dv)
        dw2 = dw2 + flat(h).T @ flat(dv16)
        db2 = db2 + dv.sum((0, 1))
        dp = torch.where(p > 0.0, dv16 @ w2f.T, 0.0)
        dp16 = rnd(dp)
        dw1 = dw1 + flat(xj).T @ flat(dp16)
        da = da + (t * dp).sum((0, 1))
        dc = dc + dp.sum((0, 1))
        g = g + dp16 @ w1.T
    return g.to(cdt), dw1, da, dc, dw2, db2


def fm_refusal(c: int, hidden: int, max_steps: int,
               compute_dtype) -> Optional[str]:
    """Why the kernels would refuse C features, `hidden` units, max_steps
    and compute_dtype (naming the limit the call breaks), or None when they
    take them."""
    if compute_dtype not in DTYPES:
        return f"fused_fm_euler: unsupported compute dtype {compute_dtype}"
    if max_steps < 1:
        return f"fused_fm_euler: max_steps {max_steps} < 1"
    if c % 8 or not 8 <= c <= MAX_C:
        return (f"fused_fm_euler: the kernels take C % 8 == 0 up to "
                f"{MAX_C} (got C={c})")
    if hidden % 32 or not 32 <= hidden <= MAX_H:
        return (f"fused_fm_euler: the kernels take H % 32 == 0 up to "
                f"{MAX_H} (got H={hidden})")
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
