"""Relative-position self-attention sublayer kernel (`csrc/attention.cu`)
and its plain version.

Counterpart of tpu_asr/ops/pallas_attention.py::fused_relpos_attention_block,
forward only, offline and full-context: (B, T, D) post-LN input -> (B, T, D)
sublayer output WITHOUT the linear_out bias (the caller adds it). Padded
query rows are garbage by contract; ConformerLayer re-masks them.

Weights arrive in PyTorch Linear layout (out, in); `pos_emb` is the
(2T - 1, D) relative sinusoid table (models/conformer.rel_positional_encoding)
and `mask` the (B, T) key validity. Operands are in x's dtype (fp32 or bf16)
with fp32 accumulation, rounded where the TPU kernel rounds them: the
projections, the attention weights and the context. The plain version keeps
JAX's rel_shift construction; the kernel gathers the shifted positions.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_asr_torch.ops import _kernels as K

_ARGS = (K.INT,) + (K.PTR,) * 19 + (K.INT,) * 4 + (K.PTR,)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL shift (B, H, T, 2T-1) -> (B, H, T, T):
    out[..., t, s] = x[..., t, T - 1 - t + s]."""
    b, h, t, p = x.shape
    x = F.pad(x, (1, 0)).view(b, h, p + 1, t)[:, :, 1:].reshape(b, h, t, p)
    return x[..., :t]


def relpos_attention_plain(x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, w_pos,
                           wo, pos_emb, mask, n_heads: int) -> torch.Tensor:
    dt = x.dtype

    def r(z):               # round to the working dtype, compute in fp32
        return z.to(dt).float()

    b, t, d = x.shape
    h, dk = n_heads, d // n_heads

    def heads(z):           # (B, T, D) -> (B, H, T, dk)
        return z.view(b, t, h, dk).transpose(1, 2)

    xf = x.float()
    q = xf @ r(wq).t()
    q_u = heads(r(q + (bq + bias_u.reshape(d))))
    q_v = heads(r(q + (bq + bias_v.reshape(d))))
    k = heads(r(xf @ r(wk).t() + bk))
    v = heads(r(xf @ r(wv).t() + bv))
    p = r(r(pos_emb) @ r(w_pos).t()).view(-1, h, dk)          # (2T-1, H, dk)
    ac = q_u @ k.transpose(-1, -2)
    bd = rel_shift(torch.einsum("bhtd,phd->bhtp", q_v, p))
    key_bias = torch.zeros(mask.shape, device=x.device).masked_fill(
        ~mask, -1e30)
    scores = (ac + bd) / math.sqrt(dk) + key_bias[:, None, None, :]
    attn = r(torch.softmax(scores, dim=-1))
    ctx = r((attn @ v).transpose(1, 2).reshape(b, t, d))
    return (ctx @ r(wo).t()).to(dt)


def fused_relpos_attention_block(
    x: torch.Tensor,            # (B, T, D)
    wq: torch.Tensor, bq: torch.Tensor,
    wk: torch.Tensor, bk: torch.Tensor,
    wv: torch.Tensor, bv: torch.Tensor,
    bias_u: torch.Tensor,       # (H, dk)
    bias_v: torch.Tensor,       # (H, dk)
    w_pos: torch.Tensor,        # (D, D) linear_pos weight
    wo: torch.Tensor,           # (D, D) linear_out weight
    pos_emb: torch.Tensor,      # (2T - 1, D)
    mask: torch.Tensor,         # (B, T) bool, True = valid
    n_heads: int,
    att_context_size: Tuple[int, int] = (-1, -1),
    dropout_rate: float = 0.0,
    seg_id: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Same contract as `relpos_attention_plain`. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel (three launches).
    Limited context, attention dropout and packed segments are outside the
    port's slice and raise."""
    if (tuple(att_context_size) != (-1, -1) or dropout_rate
            or seg_id is not None):
        raise ValueError(
            "fused_relpos_attention_block supports full-context eval "
            "attention only (att_context_size=(-1, -1), no dropout, no "
            "seg_id)")
    args = (x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, w_pos, wo, pos_emb,
            mask)
    if x.device.type == "cpu":
        return relpos_attention_plain(*args, n_heads)
    if not x.is_cuda:
        raise ValueError(f"fused_relpos_attention_block: unsupported device "
                         f"{x.device}")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"fused_relpos_attention_block: unsupported dtype {dt}")
    b, t, d = x.shape
    h = n_heads
    dk = d // h
    if (d % h or dk > 64 or any(w.shape != (d, d) for w in
                                (wq, wk, wv, w_pos, wo))
            or bias_u.shape != (h, dk) or bias_v.shape != (h, dk)
            or pos_emb.shape != (2 * t - 1, d) or mask.shape != (b, t)):
        raise ValueError("fused_relpos_attention_block: shapes do not match "
                         f"x {tuple(x.shape)} with {h} heads (dk <= 64)")
    w = [z.to(dt).contiguous() for z in (wq, wk, wv, w_pos, wo)]
    cu = (bq + bias_u.reshape(d)).float().contiguous()
    cv = (bq + bias_v.reshape(d)).float().contiguous()
    bk_, bv_ = bk.float().contiguous(), bv.float().contiguous()
    pe = pos_emb.float().contiguous()
    key_bias = torch.zeros((b, t), device=x.device).masked_fill(~mask, -1e30)
    new = lambda *shape: torch.empty(shape, dtype=dt, device=x.device)
    qu, qv, k, v = (new(b, h, t, dk) for _ in range(4))
    p = new(h, 2 * t - 1, dk)
    ctx, out = new(b, t, d), new(b, t, d)
    tensors = [x, *w, cu, cv, bk_, bv_, pe, key_bias, qu, qv, k, v, p, ctx,
               out]
    K.check_cuda("fused_relpos_attention_block", *tensors)
    K.call("tat_attention", _ARGS, x.device, int(dt == torch.bfloat16),
           *(z.data_ptr() for z in tensors), b, t, d, h)
    fused_relpos_attention_block.launches += 1
    return out


fused_relpos_attention_block.launches = 0
