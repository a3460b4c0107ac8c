"""Relative-position self-attention sublayer kernels (`csrc/attention.cu`)
and their plain version.

Counterpart of tpu_asr/ops/pallas_attention.py::fused_relpos_attention_block,
offline and full-context, forward and (under autograd) backward: (B, T, D)
post-LN input -> (B, T, D) sublayer output WITHOUT the linear_out bias (the
caller adds it). Padded query rows are garbage by contract; ConformerLayer
re-masks them.

Training: `dropout_rate` > 0 drops attention probabilities with the
counter hash of ops/dropout.py, stream dropout_seed + b * H + h, idx
t * Tp + s (Tp = T rounded up to 128): the Pallas kernel's masks in
interpret mode. The softmax normaliser is the undropped one. The backward
(`fused_relpos_attention_block_bwd`) returns fp32 grads in PyTorch layouts
for every weight, bias and pos_bias_u/v, and dx in x's dtype.

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
from tpu_asr_torch.ops.dropout import batch_streams, keep_mask, threshold

_ARGS = ((K.INT,) + (K.PTR,) * 20 + (K.INT,) * 4 + (K.UINT,) * 2
         + (K.FLOAT, K.INT, K.PTR))
_BWD_ARGS = ((K.INT,) + (K.PTR,) * 23 + (K.INT,) * 4 + (K.UINT,) * 2
             + (K.FLOAT, K.INT, K.PTR))
SPLIT_ROWS = 512             # rows per weight-gradient partial (attention.cu)
SMEM_LIMIT = 227 * 1024


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _row_stride(dk: int) -> int:
    """attention.cu::row_stride: dk rounded up to 4 with an odd float4
    count."""
    s = _round_up(dk, 4)
    return s if (s // 4) % 2 else s + 4


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL shift (B, H, T, 2T-1) -> (B, H, T, T):
    out[..., t, s] = x[..., t, T - 1 - t + s]."""
    b, h, t, p = x.shape
    x = F.pad(x, (1, 0)).view(b, h, p + 1, t)[:, :, 1:].reshape(b, h, t, p)
    return x[..., :t]


def relpos_attention_plain(x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, w_pos,
                           wo, pos_emb, mask, n_heads: int,
                           dropout_rate: float = 0.0,
                           dropout_seed: int = 0) -> torch.Tensor:
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
    attn = torch.softmax(scores, dim=-1)
    if dropout_rate:
        keep = keep_mask(batch_streams(dropout_seed, b, per_row=h,
                                       device=x.device), t, t, dropout_rate,
                         row_stride=_round_up(t, 128)).view(attn.shape)
        attn = torch.where(keep, attn * (1.0 / (1.0 - dropout_rate)),
                           torch.zeros_like(attn))
    attn = r(attn)
    ctx = r((attn @ v).transpose(1, 2).reshape(b, t, d))
    return (ctx @ r(wo).t()).to(dt)


def _drop_args(rate: float, seed: int):
    thresh = threshold(rate) if rate else 0
    return int(seed) & 0xFFFFFFFF, thresh, 1.0 / (1.0 - rate) if rate else 1.0


def _check(x, wq, wk, wv, w_pos, wo, bias_u, bias_v, pos_emb, mask, h):
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"fused_relpos_attention_block: unsupported dtype {dt}")
    b, t, d = x.shape
    dk = d // h
    if (d % h or dk > 64 or any(w.shape != (d, d) for w in
                                (wq, wk, wv, w_pos, wo))
            or bias_u.shape != (h, dk) or bias_v.shape != (h, dk)
            or pos_emb.shape != (2 * t - 1, d) or mask.shape != (b, t)):
        raise ValueError("fused_relpos_attention_block: shapes do not match "
                         f"x {tuple(x.shape)} with {h} heads (dk <= 64)")


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, w_pos, wo,
                pos_emb, mask, n_heads, rate, seed):
        dt = x.dtype
        b, t, d = x.shape
        h = n_heads
        dk = d // h
        train = any(ctx.needs_input_grad)
        x = x.contiguous()
        w = [z.to(dt).contiguous() for z in (wq, wk, wv, w_pos, wo)]
        cu = (bq + bias_u.reshape(d)).float().contiguous()
        cv = (bq + bias_v.reshape(d)).float().contiguous()
        bk_, bv_ = bk.float().contiguous(), bv.float().contiguous()
        pe = pos_emb.float().contiguous()
        key_bias = torch.zeros((b, t), device=x.device).masked_fill(~mask,
                                                                    -1e30)
        new = lambda *shape: torch.empty(shape, dtype=dt, device=x.device)
        qu, qv, k, v = (new(b, h, t, dk) for _ in range(4))
        p = new(h, 2 * t - 1, dk)
        ctx_buf, out = new(b, t, d), new(b, t, d)
        lse = (torch.empty((b, h, t), device=x.device) if train else None)
        tensors = [x, *w, cu, cv, bk_, bv_, pe, key_bias, qu, qv, k, v, p,
                   ctx_buf, out] + ([lse] if train else [])
        K.check_cuda("fused_relpos_attention_block", *tensors)
        K.call("tat_attention", _ARGS, x.device, int(dt == torch.bfloat16),
               *(z.data_ptr() for z in tensors[:19]),
               lse.data_ptr() if train else None, b, t, d, h,
               *_drop_args(rate, seed), _round_up(t, 128))
        fused_relpos_attention_block.launches += 1
        if train:
            ctx.n_heads, ctx.rate, ctx.seed = h, rate, seed
            ctx.save_for_backward(x, *w, qu, qv, k, v, p, ctx_buf, lse,
                                  key_bias, pe)
        return out

    @staticmethod
    def backward(ctx, g):
        grads = fused_relpos_attention_block_bwd(
            g, *ctx.saved_tensors, ctx.n_heads, ctx.rate, ctx.seed)
        return grads + (None,) * 5


def fused_relpos_attention_block_bwd(g, x, wq, wk, wv, w_pos, wo, qu, qv, k,
                                     v, p, ctx_buf, lse, key_bias, pe,
                                     n_heads: int, dropout_rate: float = 0.0,
                                     dropout_seed: int = 0):
    """Grads (dx, dwq, dbq, dwk, dbk, dwv, dbv, d bias_u, d bias_v, dw_pos,
    dwo) of the sublayer from its saved forward (weights in x's dtype,
    PyTorch layouts) for the cotangent g."""
    dt = x.dtype
    b, t, d = x.shape
    h = n_heads
    dk = d // h
    dev = x.device
    n_qt = -(-t // 32)
    win = n_qt * 32 + 31
    ks = _row_stride(dk)
    smem = 4 * (ks * (3 * 32 + 2 * 32 + 63) + 32 * 33 + win * dk)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_relpos_attention_block_bwd: T={t} needs "
                         f"{smem} B of shared memory (> {SMEM_LIMIT})")
    f32 = lambda *s: torch.empty(s, device=dev)
    gc = g.to(dt).contiguous()
    wo_t = wo.t().contiguous()
    wcat = torch.cat([wq, wq, wk, wv], dim=0).t().contiguous()
    pe_t = pe.to(dt).contiguous()
    dctx = torch.empty((b, h, t, dk), dtype=dt, device=dev)
    grads = torch.empty((b, t, 4 * d), dtype=dt, device=dev)
    splits = -(-(b * t) // SPLIT_ROWS)
    dx = torch.empty_like(x)
    dpos, dw_all = f32(2 * t - 1, d), f32(4 * d, d + 1)
    dwo, dwpos = f32(d, d), f32(d, d)
    tensors = (gc, x, wo_t, wcat, qu, qv, k, v, p, key_bias, lse, ctx_buf,
               pe_t, dctx, grads, f32(b, h, t), f32(b, h, n_qt, win, dk),
               dpos, dx, f32(splits * 4 * d * (d + 1)), dw_all, dwo, dwpos)
    K.check_cuda("fused_relpos_attention_block_bwd", *tensors)
    K.call("tat_attention_bwd", _BWD_ARGS, dev, int(dt == torch.bfloat16),
           *(z.data_ptr() for z in tensors), b, t, d, h,
           *_drop_args(dropout_rate, dropout_seed), _round_up(t, 128))
    fused_relpos_attention_block_bwd.launches += 1
    dw, cols = dw_all[:, :d], dw_all[:, d]
    dcu, dcv = cols[:d], cols[d:2 * d]
    return (dx, dw[:d] + dw[d:2 * d], dcu + dcv, dw[2 * d:3 * d],
            cols[2 * d:3 * d], dw[3 * d:], cols[3 * d:], dcu.reshape(h, dk),
            dcv.reshape(h, dk), dwpos, dwo)


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
    dropout_seed: int = 0,
) -> torch.Tensor:
    """Same contract as `relpos_attention_plain`. A CPU tensor runs the
    plain version; a CUDA tensor launches the forward kernel (three
    launches) and, under autograd, the backward. Limited context and packed
    segments are outside the port's slice and raise."""
    if tuple(att_context_size) != (-1, -1) or seg_id is not None:
        raise ValueError(
            "fused_relpos_attention_block supports full-context attention "
            "only (att_context_size=(-1, -1), no seg_id)")
    args = (x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, w_pos, wo, pos_emb,
            mask)
    if x.device.type == "cpu":
        return relpos_attention_plain(*args, n_heads, dropout_rate,
                                      dropout_seed)
    if not x.is_cuda:
        raise ValueError(f"fused_relpos_attention_block: unsupported device "
                         f"{x.device}")
    _check(x, wq, wk, wv, w_pos, wo, bias_u, bias_v, pos_emb, mask, n_heads)
    return _Attention.apply(*args, n_heads, float(dropout_rate),
                            int(dropout_seed))


fused_relpos_attention_block.launches = 0
fused_relpos_attention_block_bwd.launches = 0
