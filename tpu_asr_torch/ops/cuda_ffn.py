"""Fused feed-forward sublayer kernels (`csrc/ffn.cu`) and their plain
version, for training.

Counterpart of tpu_asr/ops/pallas_ffn.py::fused_ffn_sublayer:

    out = x + 0.5 * drop2( drop1( silu( LN(x) W1^T + b1 ) ) W2^T + b2 )

with flax's LayerNorm (E[x^2] - E[x]^2, eps 1e-6, fp32 statistics). Weights
arrive in PyTorch Linear layout: w1 (d_ff, D), w2 (D, d_ff). Operands are in
x's dtype (fp32 or bf16) with fp32 accumulation, rounded where the TPU kernel
rounds them: the LN output, the dropped SiLU output and, in the backward,
do and dh1. (The TPU kernel rounds to bf16 even for fp32 inputs; the port
keeps fp32 inputs in fp32.)

Dropout (`ops/dropout.py`): stream 2 * (seed + b) + 0 over (t, d_ff) after
the SiLU, 2 * (seed + b) + 1 over (t, D) on the output, kept values scaled by
1 / (1 - rate): the masks of the Pallas kernel in interpret mode.

A CPU tensor runs the plain version (autograd differentiates it); a CUDA
tensor launches the forward kernel and, under autograd, the backward
kernels (`fused_ffn_sublayer_bwd`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_asr_torch.ops import _kernels as K
from tpu_asr_torch.ops.dropout import batch_streams, keep_mask, threshold

EPS = 1e-6
MAX_D = 128
_FWD_ARGS = ((K.INT,) + (K.PTR,) * 8 + (K.INT,) * 4 + (K.UINT,) * 2
             + (K.FLOAT, K.PTR))
_BWD_ARGS = ((K.INT,) + (K.PTR,) * 20 + (K.INT,) * 6 + (K.UINT,) * 2
             + (K.FLOAT, K.PTR))
ROW_CHUNK = 512          # rows per weight-gradient partial in the backward


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm in fp32: (x - E[x]) * rsqrt(E[x^2] - E[x]^2 + eps)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    return (xf - mu) * torch.rsqrt(var + EPS) * weight + bias


def ffn_sublayer_plain(x, ln_w, ln_b, w1, b1, w2, b2, dropout_rate=0.0,
                       dropout_seed: int = 0) -> torch.Tensor:
    """(B, T, D) in x's dtype -> (B, T, D) in x's dtype."""
    dt = x.dtype

    def r(z):               # round to the working dtype, compute in fp32
        return z.to(dt).float()

    b, t, d = x.shape
    y = r(layer_norm(x, ln_w, ln_b))
    h = F.silu(y @ r(w1).t() + b1.float())
    if dropout_rate:
        scale = 1.0 / (1.0 - dropout_rate)
        keep1 = keep_mask(batch_streams(dropout_seed, b, scale=2, salt=0,
                                        device=x.device), t, h.shape[-1],
                          dropout_rate)
        h = torch.where(keep1, h * scale, torch.zeros_like(h))
    o = r(h) @ r(w2).t() + b2.float()
    if dropout_rate:
        keep2 = keep_mask(batch_streams(dropout_seed, b, scale=2, salt=1,
                                        device=x.device), t, d, dropout_rate)
        o = torch.where(keep2, o * scale, torch.zeros_like(o))
    return (x.float() + 0.5 * o).to(dt)


def _check(x, ln_w, w1, w2):
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_ffn_sublayer: unsupported dtype {dt}")
    d, f = x.shape[-1], w1.shape[0]
    if d > MAX_D or w1.shape != (f, d) or w2.shape != (d, f) \
            or ln_w.shape != (d,):
        raise ValueError(f"fused_ffn_sublayer: shapes do not match x "
                         f"{tuple(x.shape)} (D <= {MAX_D}), w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")


def _drop_args(rate: float, seed: int):
    thresh = threshold(rate) if rate else 0
    return int(seed) & 0xFFFFFFFF, thresh, 1.0 / (1.0 - rate) if rate else 1.0


class _FFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, rate, seed):
        _check(x, ln_w, w1, w2)
        dt = x.dtype
        b, t, d = x.shape
        f = w1.shape[0]
        xc = x.contiguous()
        w1c, w2c = w1.to(dt).contiguous(), w2.to(dt).contiguous()
        vec = [z.float().contiguous() for z in (ln_w, ln_b, b1, b2)]
        out = torch.empty_like(xc)
        tensors = (xc, vec[0], vec[1], w1c, vec[2], w2c, vec[3], out)
        K.check_cuda("fused_ffn_sublayer", *tensors)
        K.call("tat_ffn_fwd", _FWD_ARGS, x.device, int(dt == torch.bfloat16),
               *(z.data_ptr() for z in tensors), b * t, t, d, f,
               *_drop_args(rate, seed))
        fused_ffn_sublayer.launches += 1
        ctx.rate, ctx.seed = rate, seed
        ctx.save_for_backward(xc, vec[0], vec[1], w1c, vec[2], w2c)
        return out

    @staticmethod
    def backward(ctx, g):
        xc, ln_w, ln_b, w1c, b1, w2c = ctx.saved_tensors
        grads = fused_ffn_sublayer_bwd(xc, ln_w, ln_b, w1c, b1, w2c, g,
                                       ctx.rate, ctx.seed)
        return grads + (None, None)


def fused_ffn_sublayer_bwd(x, ln_w, ln_b, w1, b1, w2, g, dropout_rate=0.0,
                           dropout_seed: int = 0):
    """(dx, d ln_w, d ln_b, dw1, db1, dw2, db2) of the sublayer at x for the
    cotangent g: two backward kernels and the fixed-order partial sums.
    x, w1, w2 in the working dtype; the weight grads are fp32."""
    dt = x.dtype
    b, t, d = x.shape
    f = w1.shape[0]
    m = b * t
    dev = x.device
    chunks = -(-m // ROW_CHUNK)
    tiles = -(-m // 32)
    f32 = lambda *s: torch.empty(s, device=dev)
    gc = g.to(dt).contiguous()
    dx = torch.empty_like(x)
    scratch = (f32(tiles, d), f32(tiles, d), f32(chunks, f, d),
               f32(chunks, d, f), f32(chunks, f), f32(chunks, d))
    grads = (f32(d), f32(d), f32(f, d), f32(d, f), f32(f), f32(d))
    tensors = (x, gc, ln_w, ln_b, w1, b1, w2, dx) + scratch + grads
    K.check_cuda("fused_ffn_sublayer_bwd", *tensors)
    K.call("tat_ffn_bwd", _BWD_ARGS, dev, int(dt == torch.bfloat16),
           *(z.data_ptr() for z in tensors), m, t, d, f, ROW_CHUNK, chunks,
           *_drop_args(dropout_rate, dropout_seed))
    fused_ffn_sublayer_bwd.launches += 1
    ds, dsb, dw1, dw2, db1, db2 = grads
    return dx, ds, dsb, dw1, db1, dw2, db2


def fused_ffn_sublayer(x: torch.Tensor, ln_w, ln_b, w1, b1, w2, b2,
                       dropout_rate: float = 0.0,
                       dropout_seed: int = 0) -> torch.Tensor:
    """Same contract as `ffn_sublayer_plain`."""
    if x.device.type == "cpu":
        return ffn_sublayer_plain(x, ln_w, ln_b, w1, b1, w2, b2,
                                  dropout_rate, dropout_seed)
    if not x.is_cuda:
        raise ValueError(f"fused_ffn_sublayer: unsupported device {x.device}")
    return _FFN.apply(x, ln_w, ln_b, w1, b1, w2, b2, float(dropout_rate),
                      int(dropout_seed))


fused_ffn_sublayer.launches = 0
fused_ffn_sublayer_bwd.launches = 0
