"""Fused Conformer convolution module for eval (`csrc/conv.cu`) and its
plain version: the counterpart of tpu_asr/ops/pallas_conv.py::
fused_conv_module.

    g = GLU(x W1^T + b1) * mask;  a = depthwise_k(g) + bd  (zero padding
    pad_l frames left, pad_r right);  y = a * nw + nb ('affine', a folded
    BatchNorm) or LayerNorm_D(a) * nw + nb ('layer_norm', eps 1e-6, fast
    variance clipped at 0, as the JAX module computes it);
    out = silu(y) W2^T + b2

No masking after pointwise 2: masked frames carry values there and the
layer masks afterwards. Weights arrive in PyTorch layout: w1 (2D, D), wd
(D, k), w2 (D, D), or as the module's Conv1d weights (2D, D, 1), (D, 1, k),
(D, D, 1). The kernel reads them in its own layout, built once per weight
version (`_kernel_weights`; a model passes its parameters themselves, so
that the copies are found again). The products' operands are in x's dtype
(fp32 or bf16) with fp32 accumulation, rounded where the Pallas kernel
rounds its dot operands (x, the weights, the SiLU output); every other
intermediate stays fp32. (The Pallas kernel rounds its operands to bf16 even for fp32 input;
the port keeps fp32 in fp32.) Unlike the Pallas kernel, any D up to 512
runs: there is no lane to spare.

Eval only: the wrapper raises when autograd would need its gradient. A CPU
tensor runs the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_asr_torch.ops import _kernels as K

EPS = 1e-6
MAX_D, MAX_K = 512, 33
NORMS = ("affine", "layer_norm")
_ARGS = (K.INT,) + (K.PTR,) * 11 + (K.INT,) * 6 + (K.PTR,)


def conv_layer_norm(a: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The conv module's LayerNorm over D, in fp32 (returns fp32): the
    variance E[a^2] - E[a]^2 clipped at 0, eps 1e-6, as the JAX module
    computes it."""
    af = a.float()
    mu = af.mean(dim=-1, keepdim=True)
    var = torch.clamp((af * af).mean(dim=-1, keepdim=True) - mu * mu,
                      min=0.0)
    return (af - mu) * torch.rsqrt(var + EPS) * weight.float() + bias.float()


def conv_module_plain(x, mask, w1, b1, wd, bd, norm_w, norm_b, w2, b2,
                      pad: Tuple[int, int],
                      norm: str = "affine") -> torch.Tensor:
    """(B, T, D) in x's dtype, mask (B, T) bool -> (B, T, D) in x's
    dtype."""
    dt = x.dtype

    def r(z):               # round to the working dtype, compute in fp32
        return z.to(dt).float()

    d, k = x.shape[-1], wd.shape[1]
    t = x.shape[1]
    h = x.float() @ r(w1).t() + b1.float()
    g = h[..., :d] * torch.sigmoid(h[..., d:])
    g = g.masked_fill(~mask[..., None], 0.0)
    g = torch.nn.functional.pad(g, (0, 0) + tuple(pad))
    wdf = wd.float()
    a = torch.zeros_like(g[:, :t])
    for j in range(k):
        a = a + g[:, j:j + t] * wdf[:, j]
    a = a + bd.float()
    y = (conv_layer_norm(a, norm_w, norm_b) if norm == "layer_norm"
         else a * norm_w.float() + norm_b.float())
    h = r(y * torch.sigmoid(y))
    return (h @ r(w2).t() + b2.float()).to(dt)


def _pad(w: torch.Tensor, rows: int, cols: int, dtype) -> torch.Tensor:
    out = torch.zeros(rows, cols, dtype=dtype, device=w.device)
    out[:w.shape[0], :w.shape[1]] = w
    return out


def interleave_glu(w1: torch.Tensor) -> torch.Tensor:
    """Pointwise 1's (2D, D) weight with its rows interleaved by 8 channels
    (the linear rows of channels 8q .. 8q + 7, then their gate rows), each
    half zero-padded to pad8(D) rows: (2 pad8(D), D). The tensor-core
    kernels' layout (conv.cu, layer.cu), so that a thread holds both halves
    of a GLU channel."""
    d = w1.shape[1]
    d8 = -(-d // 8) * 8
    halves = [_pad(w1[:d], d8, d, w1.dtype), _pad(w1[d:], d8, d, w1.dtype)]
    return torch.stack([h.view(d8 // 8, 8, d) for h in halves],
                       1).reshape(2 * d8, d)


@K.prepared
def _kernel_weights(w1, b1, wd, bd, w2, b2, dtype: torch.dtype):
    """(w1, b1, wd, bd, w2, b2) as conv.cu reads them: the vectors fp32,
    wd (k, D) time-major fp32; in fp32 w1 (2D, D) and w2 (D, D); in bf16
    w1 (2 pad8(D), pad16(D)) with its rows interleaved by 8 channels (the
    linear rows of channels 8q.., then their gate rows) and w2 (D,
    pad16(D)), zero past D. Built once per weight version."""
    d = w2.shape[0]
    w1, wd, w2 = w1.reshape(2 * d, d), wd.reshape(d, -1), w2.reshape(d, d)
    vec = lambda z: z.float().contiguous()
    if dtype == torch.float32:
        w1k, w2k = vec(w1), vec(w2)
    else:
        d8, dk = -(-d // 8) * 8, -(-d // 16) * 16
        w1k = _pad(interleave_glu(w1), 2 * d8, dk, dtype)
        w2k = _pad(w2, d, dk, dtype)
    return w1k, vec(b1), vec(wd.t()), vec(bd), w2k, vec(b2)


def fused_conv_module(x: torch.Tensor, mask: torch.Tensor, w1, b1, wd, bd,
                      norm_w, norm_b, w2, b2, pad: Tuple[int, int],
                      norm: str = "affine") -> torch.Tensor:
    """Same contract as `conv_module_plain`; raises when autograd would
    need its gradient."""
    args = (x, mask, w1, b1, wd, bd, norm_w, norm_b, w2, b2)
    K.refuse_grad("fused_conv_module", *args)
    b, t, d = x.shape
    k = wd.shape[-1]
    pad_l, pad_r = (int(p) for p in pad)
    if norm not in NORMS or pad_l < 0 or pad_r < 0 or pad_l + pad_r + 1 != k:
        raise ValueError(f"fused_conv_module: norm {norm!r} (one of "
                         f"{NORMS}), padding {tuple(pad)} for {k} taps")
    if w1.shape not in ((2 * d, d), (2 * d, d, 1)) \
            or wd.shape not in ((d, k), (d, 1, k)) \
            or w2.shape not in ((d, d), (d, d, 1)) or mask.shape != (b, t):
        raise ValueError(f"fused_conv_module: shapes do not match x "
                         f"{tuple(x.shape)} (D <= {MAX_D}), mask "
                         f"{tuple(mask.shape)}, w1 {tuple(w1.shape)}, wd "
                         f"{tuple(wd.shape)} (k <= {MAX_K}), w2 "
                         f"{tuple(w2.shape)}")
    if x.device.type == "cpu":
        return conv_module_plain(x, mask, w1.reshape(2 * d, d), b1,
                                 wd.reshape(d, k), bd, norm_w, norm_b,
                                 w2.reshape(d, d), b2, pad, norm)
    if not x.is_cuda:
        raise ValueError(f"fused_conv_module: unsupported device {x.device}")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_conv_module: unsupported dtype {dt}")
    if not (0 < d <= MAX_D and 0 < k <= MAX_K):
        raise ValueError(f"fused_conv_module: D={d} (<= {MAX_D}), k={k} "
                         f"(<= {MAX_K})")
    w1k, b1k, wdk, bdk, w2k, b2k = _kernel_weights(w1, b1, wd, bd, w2, b2, dt)
    vec = lambda z: z.float().contiguous()
    xc = x.contiguous()
    out = torch.empty_like(xc)
    m8 = mask.contiguous()
    m8 = m8.view(torch.uint8) if m8.dtype == torch.bool else m8.to(torch.uint8)
    tensors = (xc, m8, w1k, b1k, wdk, bdk, vec(norm_w), vec(norm_b), w2k, b2k,
               out)
    K.check_cuda("fused_conv_module", *tensors)
    K.call("tat_conv_module", _ARGS, x.device, int(dt == torch.bfloat16),
           *(z.data_ptr() for z in tensors), b, t, d, k, pad_l,
           int(norm == "layer_norm"))
    fused_conv_module.launches += 1
    return out


fused_conv_module.launches = 0
