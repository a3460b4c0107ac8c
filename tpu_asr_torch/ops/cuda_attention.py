"""Relative-position self-attention kernels (`csrc/attention.cu`) and their
plain versions: the whole sublayer (`fused_relpos_attention_block`) and,
at the end of the module, the per-head attention (`fused_relpos_attention`).

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
(2T - 1, D) relative sinusoid table (ops/positions.rel_positional_encoding)
and `mask` the (B, T) key validity. Operands are in x's dtype (fp32 or bf16)
with fp32 accumulation, rounded where the TPU kernel rounds them: the
projections, the attention weights and the context. The plain version keeps
JAX's rel_shift construction; the kernel gathers the shifted positions.

Limited context (`att_context_size` (left, right), NeMo's
rel_pos_local_attn; -1 on a side is unlimited): key s is visible from
query t only where -left <= s - t <= right (`local_window`, the rule of
tpu_asr/ops/pallas_attention.py::_local_mask), forward and backward, with
or without `seg_id` (both masks apply). The bf16 kernels visit only the
key tiles the window reaches (the backward only the tile pairs its forward
visited), so a window of W keys costs about T (W + 128) score pairs a head
instead of T^2; fp32 masks every tile. A padded query whose window holds
only padded keys averages over the visited tiles' keys, not the row's:
garbage by contract, like every padded row.

Packed segments (`seg_id`, (B, T) int, data/packing.py): key s is visible
from query t only where seg_id[t] == seg_id[s], on top of the key bias of
`mask` (= seg_id > 0): the other scores become -1e30, the rule of
tpu_asr/ops/pallas_attention.py::_block_scores. The block wrapper runs it
in the forward (packed serving) and, under autograd, in the backward
(packed training: the kernels' segment mode, which recomputes exactly the
key set each query's forward summed); a row that saw no key saves
lse = +1e30, so its backward probabilities are 0. The kernels' gradients
hold for a cotangent that is zero on guard rows (id 0), which the encoder
gives: its layers zero them.
Both functions take dk = D / heads <= 128 (MAX_DK; conformer-XLarge's
d1024 / 8 heads is dk 128). In bf16 the projections, the forward's core,
the backward's score gradients and its weight gradients run on the tensor
cores, which take D % 8 == 0 and dk % 4 == 0 (`attention_refusal`, which
the model's 'auto' route also asks), with a head row padded to 16, 32, 48,
64 or 128 columns; fp32 keeps the SIMT kernels, whose backward keeps a
T-long position window in shared memory (T <= 1024 at dk 44, T <= 160 at
dk 128: `bwd_refusal`). The weight matrices in
the working dtype and the folded biases cu = bq + u, cv = bq + v are built
once per weight version (`_kernels.prepared`); the key bias depends on the
mask and is built per call.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_asr_torch.ops import _kernels as K
from tpu_asr_torch.ops.dropout import batch_streams, keep_mask, threshold
from tpu_asr_torch.ops.positions import (position_table,
                                         rel_positional_encoding)

_ARGS = ((K.INT,) + (K.PTR,) * 21 + (K.INT,) * 6 + (K.UINT,) * 2
         + (K.FLOAT, K.INT, K.PTR))
_BWD_ARGS = ((K.INT,) + (K.PTR,) * 24 + (K.INT,) * 6 + (K.UINT,) * 2
             + (K.FLOAT, K.INT, K.PTR))
_HEADS_ARGS = ((K.INT,) + (K.PTR,) * 10 + (K.INT,) * 6 + (K.UINT,) * 3
               + (K.FLOAT, K.INT, K.PTR))
_HEADS_BWD_ARGS = ((K.INT,) + (K.PTR,) * 16 + (K.INT,) * 6 + (K.UINT,) * 3
                   + (K.FLOAT, K.INT, K.PTR))
SPLIT_ROWS = 512             # rows per weight-gradient partial (attention.cu)
MAX_DK = 128                 # the widest tiles: 4 lane slots, DKP = 128


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _row_stride(dk: int) -> int:
    """attention.cu::row_stride: dk rounded up to 4 with an odd float4
    count."""
    s = _round_up(dk, 4)
    return s if (s // 4) % 2 else s + 4


def _bwd_smem(t: int, dk: int) -> int:
    """Shared memory (bytes) of attention.cu's fp32 dq_kernel at T: it
    keeps the block's whole relative-position window."""
    win = -(-t // 32) * 32 + 31
    ks = _row_stride(dk)
    return 4 * (ks * (3 * 32 + 2 * 32 + 63) + 32 * 33 + win * dk)


def bwd_refusal(dtype: torch.dtype, t: int, dk: int) -> Optional[str]:
    """Why the backward would refuse T, or None. fp32 (dq_kernel, SIMT)
    keeps a T-long position window per block in shared memory, so it takes
    T <= 1024 at dk 44, T <= 608 at dk 64 and T <= 160 at dk 128
    (conformer-XLarge's T' = 376 runs its backward in bf16); bf16
    (dq_mma_kernel) streams the window through a 128-row ring, so its
    shared memory does not grow with T."""
    if dtype == torch.float32 and _bwd_smem(t, dk) > K.SMEM_LIMIT:
        return (f"the fp32 backward at T={t} needs {_bwd_smem(t, dk)} B of "
                f"shared memory (> {K.SMEM_LIMIT})")
    return None


def _part_size(dtype: torch.dtype, b: int, t: int, d: int,
               wgrad: int) -> int:
    """fp32 scratch `part`: the weight-gradient partials (`wgrad` floats)
    and, in bf16, dpos_kernel's per-group sums of dP: ceil(B / ceil(B / 8))
    groups of (2T - 1) x D."""
    if dtype != torch.bfloat16:
        return wgrad
    groups = -(-b // -(-b // 8))
    return max(wgrad, groups * (2 * t - 1) * d)


def _dpart_shape(dtype: torch.dtype, b: int, h: int, t: int, dk: int):
    """The dq kernels' position-window partials: per (batch row, head,
    query block) a window of relative positions. bf16 (dq_mma_kernel):
    64-query blocks, 64 (ceil(T / 64) + 1) rows; fp32 (dq_kernel):
    32-query blocks, 32 ceil(T / 32) + 31 rows. O(T^2) fp32 whatever the
    window: with one, the rows no visited tile reaches are written as
    zeros."""
    if dtype == torch.bfloat16:
        n = -(-t // 64)
        return (b, h, n, 64 * (n + 1), dk)
    n = -(-t // 32)
    return (b, h, n, 32 * n + 31, dk)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL shift (B, H, T, 2T-1) -> (B, H, T, T):
    out[..., t, s] = x[..., t, T - 1 - t + s]."""
    b, h, t, p = x.shape
    x = F.pad(x, (1, 0)).view(b, h, p + 1, t)[:, :, 1:].reshape(b, h, t, p)
    return x[..., :t]


def local_window(t: int, left: int, right: int, device=None) -> torch.Tensor:
    """(T, T) bool: key s visible from query t iff s - t >= -left (left >= 0)
    and s - t <= right (right >= 0); tpu_asr/ops/pallas_attention.py::
    _local_mask."""
    rel = (torch.arange(t, device=device)[None, :]
           - torch.arange(t, device=device)[:, None])
    ok = torch.ones((t, t), dtype=torch.bool, device=device)
    if left >= 0:
        ok &= rel >= -left
    if right >= 0:
        ok &= rel <= right
    return ok


def head_streams(dropout_seed: Optional[int], b: int, h: int,
                 device=None) -> torch.Tensor:
    """(B, H) dropout streams dropout_seed + b * H + h; stream h in every
    batch row when dropout_seed is None, as fused_relpos_attention draws
    them: its seed_rows are zeros then, and head l of a program holding all
    H heads draws stream seed_rows[b, 0] + l (pallas_attention.py
    _dropout_keep)."""
    if dropout_seed is None:
        return torch.arange(h, dtype=torch.int64, device=device).expand(b, h)
    return batch_streams(dropout_seed, b, per_row=h,
                         device=device).reshape(b, h)


def attention_context(q_u, q_v, k, v, p, mask, r,
                      att_context_size: Tuple[int, int] = (-1, -1),
                      dropout_rate: float = 0.0,
                      streams: Optional[torch.Tensor] = None,
                      seg_id: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """fp32 (B, H, T, dk) context of per-head q_u, q_v, k, v (B, H, T, dk)
    and the projected position table p (2T - 1, H, dk), all fp32 holding
    working-dtype values: the rel_shift construction, key bias -1e30, the
    window's and other segments' (seg_id (B, T)) scores replaced by -1e30,
    softmax, dropout (streams (B, H), idx t * Tp + s) after the undropped
    normaliser, and the attention weights rounded by r before the value
    product."""
    b, h, t, dk = q_u.shape
    ac = q_u @ k.transpose(-1, -2)
    bd = rel_shift(torch.einsum("bhtd,phd->bhtp", q_v, p))
    key_bias = torch.zeros(mask.shape, device=q_u.device).masked_fill(
        ~mask, -1e30)
    scores = (ac + bd) / math.sqrt(dk) + key_bias[:, None, None, :]
    left, right = att_context_size
    if left >= 0 or right >= 0:
        scores = scores.masked_fill(
            ~local_window(t, left, right, q_u.device), -1e30)
    if seg_id is not None:
        same = seg_id[:, :, None] == seg_id[:, None, :]          # (B, T, T)
        scores = scores.masked_fill(~same[:, None], -1e30)
    attn = torch.softmax(scores, dim=-1)
    if dropout_rate:
        keep = keep_mask(streams, t, t, dropout_rate,
                         row_stride=_round_up(t, 128)).view(attn.shape)
        attn = torch.where(keep, attn * (1.0 / (1.0 - dropout_rate)),
                           torch.zeros_like(attn))
    return r(attn) @ v


def project_heads(x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, w_pos,
                  pos_emb, n_heads: int):
    """The block sublayer's per-head operands of x (B, T, D): q_u = q + u,
    q_v = q + v, k, v (B, H, T, dk) and the projected position table p
    (2T - 1, H, dk), fp32 holding values rounded to x's dtype where the
    kernel rounds them."""
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
    return q_u, q_v, k, v, p


def relpos_attention_plain(x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, w_pos,
                           wo, pos_emb, mask, n_heads: int,
                           dropout_rate: float = 0.0,
                           dropout_seed: int = 0,
                           seg_id: Optional[torch.Tensor] = None,
                           att_context_size: Tuple[int, int] = (-1, -1)
                           ) -> torch.Tensor:
    """The block sublayer (without the linear_out bias) in plain
    PyTorch: `attention_context` on the projected heads, with the window
    `att_context_size` and the segment map `seg_id` (both optional)."""
    dt = x.dtype

    def r(z):               # round to the working dtype, compute in fp32
        return z.to(dt).float()

    b, t, d = x.shape
    h = n_heads
    q_u, q_v, k, v, p = project_heads(x, wq, bq, wk, bk, wv, bv, bias_u,
                                      bias_v, w_pos, pos_emb, h)
    ctx = attention_context(q_u, q_v, k, v, p, mask, r,
                            tuple(att_context_size), dropout_rate,
                            head_streams(dropout_seed, b, h, x.device),
                            seg_id)
    ctx = r(ctx.transpose(1, 2).reshape(b, t, d))
    return (ctx @ r(wo).t()).to(dt)


def _drop_args(rate: float, seed: int):
    thresh = threshold(rate) if rate else 0
    return int(seed) & 0xFFFFFFFF, thresh, 1.0 / (1.0 - rate) if rate else 1.0


def attention_refusal(dtype: torch.dtype, d: int, h: int, t: int,
                      train: bool) -> Optional[str]:
    """Why the block kernels would refuse x (B, T, D) of `dtype` with h
    heads (and, when `train`, the backward), or None when they take it:
    dk = D / h <= MAX_DK (128); in bf16 the tensor-core tiles copy rows in
    16- (D) and 8-byte (dk) pieces, so D % 8 == 0 and dk % 4 == 0; the fp32
    backward's shared memory grows with T (`bwd_refusal`)."""
    name = "fused_relpos_attention_block"
    if dtype not in (torch.float32, torch.bfloat16):
        return f"{name}: unsupported dtype {dtype}"
    if d % h or d // h > MAX_DK:
        return (f"{name}: the kernel takes dk = D / heads <= {MAX_DK} "
                f"(got D={d}, {h} heads)")
    if dtype == torch.bfloat16 and (d % 8 or (d // h) % 4):
        return (f"{name}: in bf16 the kernel takes D % 8 == 0 and "
                f"dk % 4 == 0 (got D={d}, dk={d // h})")
    why = bwd_refusal(dtype, t, d // h) if train else None
    return f"{name}: {why}" if why else None


def _check(x, wq, wk, wv, w_pos, wo, bias_u, bias_v, pos_emb, mask, h,
           train: bool, seg=None):
    b, t, d = x.shape
    dk = d // h
    if (any(w.shape != (d, d) for w in (wq, wk, wv, w_pos, wo))
            or bias_u.shape != (h, dk) or bias_v.shape != (h, dk)
            or pos_emb.shape != (2 * t - 1, d) or mask.shape != (b, t)
            or (seg is not None and seg.shape != (b, t))):
        raise ValueError("fused_relpos_attention_block: shapes do not match "
                         f"x {tuple(x.shape)} with {h} heads")
    why = attention_refusal(x.dtype, d, h, t, train)
    if why:
        raise ValueError(why)


@K.prepared
def _block_weights(wq, wk, wv, w_pos, wo, bq, bias_u, bias_v, bk, bv, dt):
    """The five weight matrices in dt and the fp32 biases of the kernel:
    cu = bq + u, cv = bq + v, bk, bv."""
    d = wq.shape[0]
    w = [z.to(dt).contiguous() for z in (wq, wk, wv, w_pos, wo)]
    return w + [(bq + bias_u.reshape(d)).float().contiguous(),
                (bq + bias_v.reshape(d)).float().contiguous(),
                bk.float().contiguous(), bv.float().contiguous()]


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, w_pos, wo,
                pos_emb, mask, n_heads, rate, seed, seg, window):
        dt = x.dtype
        b, t, d = x.shape
        h = n_heads
        dk = d // h
        train = any(ctx.needs_input_grad)
        x = x.contiguous()
        *w, cu, cv, bk_, bv_ = _block_weights(wq, wk, wv, w_pos, wo, bq,
                                              bias_u, bias_v, bk, bv, dt)
        pe = pos_emb.to(dt).contiguous()
        key_bias = torch.zeros((b, t), device=x.device).masked_fill(~mask,
                                                                    -1e30)
        new = lambda *shape: torch.empty(shape, dtype=dt, device=x.device)
        qu, qv, k, v = (new(b, h, t, dk) for _ in range(4))
        p = new(h, 2 * t - 1, dk)
        ctx_buf, out = new(b, t, d), new(b, t, d)
        lse = (torch.empty((b, h, t), device=x.device) if train else None)
        tensors = [x, *w, cu, cv, bk_, bv_, pe, key_bias, qu, qv, k, v, p,
                   ctx_buf, out]
        K.check_cuda("fused_relpos_attention_block", *tensors,
                     *(z for z in (lse, seg) if z is not None))
        K.call("tat_attention", _ARGS, x.device, int(dt == torch.bfloat16),
               *(z.data_ptr() for z in tensors),
               *(None if z is None else z.data_ptr() for z in (lse, seg)),
               b, t, d, h, *window, *_drop_args(rate, seed),
               _round_up(t, 128))
        fused_relpos_attention_block.launches += 1
        if window != (-1, -1):
            fused_relpos_attention_block.window_launches += 1
        if train:
            # seg is an int map without gradient, kept beside the saved
            # tensors: the backward's segment mode reads the same map, and
            # its window the same window
            ctx.n_heads, ctx.rate, ctx.seed, ctx.seg = h, rate, seed, seg
            ctx.window = window
            ctx.save_for_backward(x, *w, qu, qv, k, v, p, ctx_buf, lse,
                                  key_bias, pe)
        return out

    @staticmethod
    def backward(ctx, g):
        grads = fused_relpos_attention_block_bwd(
            g, *ctx.saved_tensors, ctx.n_heads, ctx.rate, ctx.seed, ctx.seg,
            ctx.window)
        return grads + (None,) * 7


def fused_relpos_attention_block_bwd(g, x, wq, wk, wv, w_pos, wo, qu, qv, k,
                                     v, p, ctx_buf, lse, key_bias, pe,
                                     n_heads: int, dropout_rate: float = 0.0,
                                     dropout_seed: int = 0,
                                     seg: Optional[torch.Tensor] = None,
                                     att_context_size: Tuple[int, int] = (
                                         -1, -1)):
    """Grads (dx, dwq, dbq, dwk, dbk, dwv, dbv, d bias_u, d bias_v, dw_pos,
    dwo) of the sublayer from its saved forward (weights in x's dtype,
    PyTorch layouts) for the cotangent g. `seg`: the forward's (B, T) int32
    segment map, or None; with it the segment mode launches, and
    `seg_launches` counts it beside `launches`. `att_context_size`: the
    forward's window; a limited one is counted in `window_launches`."""
    dt = x.dtype
    b, t, d = x.shape
    h = n_heads
    dk = d // h
    dev = x.device
    why = bwd_refusal(dt, t, dk)
    if why:
        raise ValueError(f"fused_relpos_attention_block_bwd: {why}")
    if seg is not None and (seg.shape != (b, t) or seg.dtype != torch.int32
                            or not seg.is_contiguous()):
        raise ValueError("fused_relpos_attention_block_bwd: seg must be a "
                         f"contiguous ({b}, {t}) int32 map")
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
               pe_t, dctx, grads, f32(b, h, t),
               f32(*_dpart_shape(dt, b, h, t, dk)), dpos, dx,
               f32(_part_size(dt, b, t, d, splits * 4 * d * (d + 1))),
               dw_all, dwo, dwpos)
    K.check_cuda("fused_relpos_attention_block_bwd", *tensors,
                 *(() if seg is None else (seg,)))
    window = tuple(int(c) for c in att_context_size)
    K.call("tat_attention_bwd", _BWD_ARGS, dev, int(dt == torch.bfloat16),
           *(z.data_ptr() for z in tensors),
           None if seg is None else seg.data_ptr(), b, t, d, h, *window,
           *_drop_args(dropout_rate, dropout_seed), _round_up(t, 128))
    fused_relpos_attention_block_bwd.launches += 1
    if seg is not None:
        fused_relpos_attention_block_bwd.seg_launches += 1
    if window != (-1, -1):
        fused_relpos_attention_block_bwd.window_launches += 1
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
    launches) and, under autograd, the backward. `seg_id` (B, T) int, the
    packed-segment map, runs the kernels' segment mode, forward and
    backward; `att_context_size` (left, right) their window, alone or with
    the segments. `window_launches` counts the launches with a limited
    window beside `launches`."""
    window = tuple(int(c) for c in att_context_size)
    args = (x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, w_pos, wo, pos_emb,
            mask)
    train = torch.is_grad_enabled() and any(
        z.requires_grad for z in args if isinstance(z, torch.Tensor))
    if x.device.type == "cpu":
        return relpos_attention_plain(*args, n_heads, dropout_rate,
                                      dropout_seed, seg_id, window)
    if not x.is_cuda:
        raise ValueError(f"fused_relpos_attention_block: unsupported device "
                         f"{x.device}")
    seg = None if seg_id is None else seg_id.to(torch.int32).contiguous()
    _check(x, wq, wk, wv, w_pos, wo, bias_u, bias_v, pos_emb, mask, n_heads,
           train, seg)
    return _Attention.apply(*args, n_heads, float(dropout_rate),
                            int(dropout_seed), seg, window)


fused_relpos_attention_block.launches = 0
fused_relpos_attention_block.window_launches = 0
fused_relpos_attention_block_bwd.launches = 0
fused_relpos_attention_block_bwd.seg_launches = 0
fused_relpos_attention_block_bwd.window_launches = 0


# ---------------------------------------------------------------------------
# Per-head attention: the counterpart of tpu_asr/ops/pallas_attention.py::
# fused_relpos_attention, on q_u = q + u, q_v = q + v, k, v that the caller
# supplies per head.
# ---------------------------------------------------------------------------


def relpos_attention_heads_plain(q_u, q_v, k, v, w_pos, mask,
                                 att_context_size: Tuple[int, int] = (-1, -1),
                                 dropout_rate: float = 0.0,
                                 dropout_seed: Optional[int] = None
                                 ) -> torch.Tensor:
    """q_u, q_v, k, v (B, H, T, dk), w_pos the (D, D) linear_pos weight in
    Linear layout (D = H dk), mask (B, T) bool (True = valid key) ->
    (B, H, T, dk) context in q_u's dtype. Scores (q_u k + q_v P[t - s]) /
    sqrt(dk) with P = PE w_pos^T by the rel_shift construction, key bias
    -1e30, the window (att_context_size) as fused_relpos_attention's, and
    dropout on the probabilities with stream dropout_seed + b * H + h
    (stream h in every batch row when dropout_seed is None), idx t * Tp + s,
    after the undropped normaliser. Operands in q_u's dtype with fp32
    accumulation, rounded where the kernel rounds them (P, the attention
    weights). Padded query rows are garbage by contract. Autograd
    differentiates it. Any dk."""
    dt = q_u.dtype

    def r(z):               # round to the working dtype, compute in fp32
        return z.to(dt).float()

    b, h, t, dk = q_u.shape
    pe = rel_positional_encoding(t, h * dk, q_u.device)
    p = r(r(pe) @ r(w_pos).t()).view(-1, h, dk)               # (2T-1, H, dk)
    ctx = attention_context(r(q_u), r(q_v), r(k), r(v), p, mask, r,
                            tuple(att_context_size), dropout_rate,
                            head_streams(dropout_seed, b, h, q_u.device))
    return ctx.to(dt)


def _heads_seed(rate: float, dropout_seed: Optional[int], h: int):
    """(seed, b_stride, thresh, dscale): head h of batch row b draws stream
    seed + b_stride * b + h (head_streams)."""
    seed, thresh, dscale = _drop_args(rate, dropout_seed or 0)
    return seed, 0 if dropout_seed is None else h, thresh, dscale


class _HeadsAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_u, q_v, k, v, w_pos, mask, window, rate, dropout_seed):
        dt = q_u.dtype
        b, h, t, dk = q_u.shape
        d = h * dk
        dev = q_u.device
        train = any(ctx.needs_input_grad[:5])
        ins = [z.contiguous() for z in (q_u, q_v, k, v)]
        w = w_pos.to(dt).contiguous()
        pe = position_table(t, d, dev, dt)
        key_bias = torch.zeros((b, t), device=dev).masked_fill(~mask, -1e30)
        p = torch.empty((h, 2 * t - 1, dk), dtype=dt, device=dev)
        out = torch.empty((b, h, t, dk), dtype=dt, device=dev)
        lse = torch.empty((b, h, t), device=dev) if train else None
        tensors = [*ins, w, pe, key_bias, p, out] + ([lse] if train else [])
        K.check_cuda("fused_relpos_attention", *tensors)
        K.call("tat_relpos_attention", _HEADS_ARGS, dev,
               int(dt == torch.bfloat16), *(z.data_ptr() for z in tensors[:9]),
               lse.data_ptr() if train else None, b, t, d, h, *window,
               *_heads_seed(rate, dropout_seed, h), _round_up(t, 128))
        fused_relpos_attention.launches += 1
        if train:
            ctx.window, ctx.rate, ctx.seed = window, rate, dropout_seed
            ctx.w_dtype = w_pos.dtype
            ctx.save_for_backward(*ins, p, out, lse, key_bias, pe)
        return out

    @staticmethod
    def backward(ctx, g):
        q_u, q_v, k, v, p, out, lse, key_bias, pe = ctx.saved_tensors
        dq_u, dq_v, dk, dv, dw = fused_relpos_attention_bwd(
            g, q_u, q_v, k, v, p, out, lse, key_bias, pe, ctx.window,
            ctx.rate, ctx.seed)
        return dq_u, dq_v, dk, dv, dw.to(ctx.w_dtype), None, None, None, None


def fused_relpos_attention_bwd(g, q_u, q_v, k, v, p, ctx_out, lse, key_bias,
                               pe, att_context_size=(-1, -1),
                               dropout_rate: float = 0.0,
                               dropout_seed: Optional[int] = None):
    """(dq_u, dq_v, dk, dv) in q_u's dtype and dW_pos (D, D) in fp32 of the
    per-head attention from its saved forward (q_u, q_v, k, v, p, the
    context, lse, key_bias, pe) for the cotangent g (B, H, T, dk)."""
    dt = q_u.dtype
    b, h, t, dk = q_u.shape
    d = h * dk
    dev = q_u.device
    n_pos = 2 * t - 1
    why = bwd_refusal(dt, t, dk)
    if why:
        raise ValueError(f"fused_relpos_attention_bwd: {why}")
    f32 = lambda *s: torch.empty(s, device=dev)
    grads = torch.empty((4, b, h, t, dk), dtype=dt, device=dev)
    dwpos = f32(d, d)
    tensors = (g.to(dt).contiguous(), q_u, q_v, k, v, p, key_bias, lse,
               ctx_out, pe.to(dt).contiguous(), grads, f32(b, h, t),
               f32(*_dpart_shape(dt, b, h, t, dk)), f32(n_pos, d),
               f32(_part_size(dt, b, t, d, -(-n_pos // SPLIT_ROWS) * d * d)),
               dwpos)
    K.check_cuda("fused_relpos_attention_bwd", *tensors)
    K.call("tat_relpos_attention_bwd", _HEADS_BWD_ARGS, dev,
           int(dt == torch.bfloat16), *(z.data_ptr() for z in tensors),
           b, t, d, h, *att_context_size,
           *_heads_seed(dropout_rate, dropout_seed, h), _round_up(t, 128))
    fused_relpos_attention_bwd.launches += 1
    return grads[0], grads[1], grads[2], grads[3], dwpos


def _check_heads(q_u, q_v, k, v, w_pos, mask, train: bool):
    dt = q_u.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_relpos_attention: unsupported dtype {dt}")
    b, h, t, dk = q_u.shape
    d = h * dk
    if (any(z.shape != q_u.shape or z.dtype != dt for z in (q_v, k, v))
            or w_pos.shape != (d, d) or mask.shape != (b, t)):
        raise ValueError(f"fused_relpos_attention: shapes do not match q_u "
                         f"{tuple(q_u.shape)}: w_pos {tuple(w_pos.shape)}, "
                         f"mask {tuple(mask.shape)}")
    if dk > MAX_DK:
        raise ValueError(f"fused_relpos_attention: the kernel takes dk <= "
                         f"{MAX_DK} (got {dk})")
    if dt == torch.bfloat16 and (d % 8 or dk % 4):
        raise ValueError(f"fused_relpos_attention: in bf16 the kernel takes "
                         f"D % 8 == 0 and dk % 4 == 0 (got D={d}, dk={dk})")
    why = bwd_refusal(dt, t, dk) if train else None
    if why:
        raise ValueError(f"fused_relpos_attention: {why}")


def fused_relpos_attention(q_u: torch.Tensor, q_v: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor,
                           w_pos: torch.Tensor, mask: torch.Tensor,
                           att_context_size: Tuple[int, int] = (-1, -1),
                           dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None
                           ) -> torch.Tensor:
    """Same contract as `relpos_attention_heads_plain`. A CPU tensor runs
    the plain version; a CUDA tensor launches the forward (P = PE w_pos^T,
    then the scores, softmax and value product: two launches) and, under
    autograd, the backward (`fused_relpos_attention_bwd`: the gradients of
    q_u, q_v, k, v and w_pos, cast to w_pos's dtype). dk <= MAX_DK (128).
    """
    if q_u.device.type == "cpu":
        return relpos_attention_heads_plain(q_u, q_v, k, v, w_pos, mask,
                                            att_context_size, dropout_rate,
                                            dropout_seed)
    if not q_u.is_cuda:
        raise ValueError(f"fused_relpos_attention: unsupported device "
                         f"{q_u.device}")
    args = (q_u, q_v, k, v, w_pos)
    train = torch.is_grad_enabled() and any(z.requires_grad for z in args)
    _check_heads(q_u, q_v, k, v, w_pos, mask, train)
    window = tuple(int(c) for c in att_context_size)
    return _HeadsAttention.apply(q_u, q_v, k, v, w_pos, mask, window,
                                 float(dropout_rate), dropout_seed)


fused_relpos_attention.launches = 0
fused_relpos_attention_bwd.launches = 0
