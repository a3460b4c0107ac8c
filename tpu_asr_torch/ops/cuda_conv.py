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
(D, k), w2 (D, D). The products' operands are in x's dtype (fp32 or bf16)
with fp32 accumulation, rounded where the Pallas kernel rounds its dot
operands (x, the weights, the SiLU output); every other intermediate stays
fp32. (The Pallas kernel rounds its operands to bf16 even for fp32 input;
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


def fused_conv_module(x: torch.Tensor, mask: torch.Tensor, w1, b1, wd, bd,
                      norm_w, norm_b, w2, b2, pad: Tuple[int, int],
                      norm: str = "affine") -> torch.Tensor:
    """Same contract as `conv_module_plain`; raises when autograd would
    need its gradient."""
    args = (x, mask, w1, b1, wd, bd, norm_w, norm_b, w2, b2)
    K.refuse_grad("fused_conv_module", *args)
    b, t, d = x.shape
    k = wd.shape[1]
    pad_l, pad_r = (int(p) for p in pad)
    if norm not in NORMS or pad_l < 0 or pad_r < 0 or pad_l + pad_r + 1 != k:
        raise ValueError(f"fused_conv_module: norm {norm!r} (one of "
                         f"{NORMS}), padding {tuple(pad)} for {k} taps")
    if x.device.type == "cpu":
        return conv_module_plain(*args, pad, norm)
    if not x.is_cuda:
        raise ValueError(f"fused_conv_module: unsupported device {x.device}")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_conv_module: unsupported dtype {dt}")
    if not (0 < d <= MAX_D and 0 < k <= MAX_K) or mask.shape != (b, t) \
            or w1.shape != (2 * d, d) or wd.shape != (d, k) \
            or w2.shape != (d, d):
        raise ValueError(f"fused_conv_module: shapes do not match x "
                         f"{tuple(x.shape)} (D <= {MAX_D}), mask "
                         f"{tuple(mask.shape)}, w1 {tuple(w1.shape)}, wd "
                         f"{tuple(wd.shape)} (k <= {MAX_K}), w2 "
                         f"{tuple(w2.shape)}")
    vec = lambda z: z.float().contiguous()
    xc = x.contiguous()
    out = torch.empty_like(xc)
    tensors = (xc, mask.to(torch.uint8).contiguous(), w1.to(dt).contiguous(),
               vec(b1), wd.float().t().contiguous(), vec(bd), vec(norm_w),
               vec(norm_b), w2.to(dt).contiguous(), vec(b2), out)
    K.check_cuda("fused_conv_module", *tensors)
    K.call("tat_conv_module", _ARGS, x.device, int(dt == torch.bfloat16),
           *(z.data_ptr() for z in tensors), b, t, d, k, pad_l,
           int(norm == "layer_norm"))
    fused_conv_module.launches += 1
    return out


fused_conv_module.launches = 0
