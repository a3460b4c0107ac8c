"""The whole deterministic (eval) Conformer layer as one kernel
(`csrc/layer.cu`) and its plain version: the counterpart of
tpu_asr/ops/pallas_layer.py::fused_conformer_layer.

    x1 = x + 0.5 (silu(LN(x) W11^T + bb11) W12^T + bb12)
    x2 = x1 + rel-pos MHSA(LN(x1)) Wo^T + bo       (window att_context_size)
    g  = GLU(LN(x2) W1^T + b1) * mask;  a = depthwise_k(g) + bd, taps at
         j - conv_pad_l, zeros outside the sequence
    x3 = x2 + silu(norm(a)) W2c^T + b2c            norm: 'affine' (folded
                                                   BatchNorm) or 'layer_norm'
    x4 = x3 + 0.5 FFN2(LN(x3));  out = LN(x4) * mask

with flax's LayerNorm (E[x^2] - E[x]^2, eps 1e-6, no clip) everywhere, as
the Pallas kernel computes it. Input rows past a length are zero by
contract. `params` holds the Pallas kernel's keys in PyTorch layouts
(`layer_params` builds it from a port ConformerLayer): s1, sb1, w11 (F, D),
bb11, w12 (D, F), bb12; sa, sab, wq_full, bq, wk_full, bk, wv_full, bv,
wo_full, bo (Linear layout), bias_u, bias_v (H, dk), pos_kernel (the
linear_pos weight, (D, D) Linear layout); sc, scb, w1 (2D, D), b1 (2D), wd
(D, k), bd, nw, nb, w2c (D, D), b2c; s2, sb2, w21, bb21, w22, bb22; sf, sfb.

The residual stream stays fp32 inside the layer; the products' operands
are in x's dtype with fp32 accumulation, rounded where the TPU kernel
rounds them to bf16 (the LN outputs, the SiLU outputs, q_u, q_v, k, v, the
projected position table, the attention weights, the context). (The TPU
kernel rounds them to bf16 even for fp32 input; the port keeps fp32 in
fp32.) There is no gradient: the wrapper raises under autograd, as JAX's
has no VJP. A CPU tensor runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from tpu_asr_torch.ops import _kernels as K
from tpu_asr_torch.ops.cuda_attention import (MAX_DK, _row_stride,
                                              attention_context)
from tpu_asr_torch.ops.cuda_ffn import layer_norm
from tpu_asr_torch.ops.positions import (position_table,
                                         rel_positional_encoding)

NORMS = ("affine", "layer_norm")
KEYS = ("s1", "sb1", "w11", "bb11", "w12", "bb12", "sa", "sab", "wq_full",
        "bq", "wk_full", "bk", "wv_full", "bv", "bias_u", "bias_v",
        "pos_kernel", "wo_full", "bo", "sc", "scb", "w1", "b1", "wd", "bd",
        "nw", "nb", "w2c", "b2c", "s2", "sb2", "w21", "bb21", "w22", "bb22",
        "sf", "sfb")
_N_PTRS = 49                 # layer.cu LayerArgs
_ARGS = (K.INT, K.PTR, K.INT) + (K.INT,) * 10 + (K.PTR,)


def layer_params(layer) -> Dict[str, torch.Tensor]:
    """The kernel's weight dict of a port ConformerLayer (NeMo keys), in
    PyTorch layouts, detached; a BatchNorm conv norm folded from its
    running statistics in fp32 (MaskedBatchNorm.folded, eps 1e-5)."""
    att, conv = layer.self_attn, layer.conv
    ff1, ff2 = layer.feed_forward1, layer.feed_forward2
    norm = conv.batch_norm
    nw, nb = (norm.folded() if hasattr(norm, "folded")
              else (norm.weight, norm.bias))
    ln = lambda m: (m.weight, m.bias)
    p = {}
    p["s1"], p["sb1"] = ln(layer.norm_feed_forward1)
    p["w11"], p["bb11"] = ln(ff1.linear1)
    p["w12"], p["bb12"] = ln(ff1.linear2)
    p["sa"], p["sab"] = ln(layer.norm_self_att)
    p["wq_full"], p["bq"] = ln(att.linear_q)
    p["wk_full"], p["bk"] = ln(att.linear_k)
    p["wv_full"], p["bv"] = ln(att.linear_v)
    p["bias_u"], p["bias_v"] = att.pos_bias_u, att.pos_bias_v
    p["pos_kernel"] = att.linear_pos.weight
    p["wo_full"], p["bo"] = ln(att.linear_out)
    p["sc"], p["scb"] = ln(layer.norm_conv)
    p["w1"], p["b1"] = conv.pointwise_conv1.weight[..., 0], \
        conv.pointwise_conv1.bias
    p["wd"], p["bd"] = conv.depthwise_conv.weight[:, 0], \
        conv.depthwise_conv.bias
    p["nw"], p["nb"] = nw, nb
    p["w2c"], p["b2c"] = conv.pointwise_conv2.weight[..., 0], \
        conv.pointwise_conv2.bias
    p["s2"], p["sb2"] = ln(layer.norm_feed_forward2)
    p["w21"], p["bb21"] = ln(ff2.linear1)
    p["w22"], p["bb22"] = ln(ff2.linear2)
    p["sf"], p["sfb"] = ln(layer.norm_out)
    return {k: p[k].detach() for k in KEYS}


def conformer_layer_plain(x, mask, params, n_heads: int,
                          conv_kernel_size: int, conv_pad_l: int,
                          conv_norm: str,
                          att_context_size: Tuple[int, int] = (-1, -1)
                          ) -> torch.Tensor:
    """(B, T, D) in x's dtype, mask (B, T) bool -> (B, T, D) in x's
    dtype."""
    dt = x.dtype

    def r(z):               # round to the working dtype, compute in fp32
        return z.to(dt).float()

    p = {k: v.float() for k, v in params.items()}
    b, t, d = x.shape
    h, dk = n_heads, d // n_heads
    keep = mask[..., None].float()

    def ffn(xf, s, sb, w1, b1, w2, b2):
        y = r(layer_norm(xf, p[s], p[sb]))
        hid = r(F.silu(y @ r(p[w1]).t() + p[b1]))
        return xf + 0.5 * (hid @ r(p[w2]).t() + p[b2])

    def heads(z):           # (B, T, D) -> (B, H, T, dk)
        return z.view(b, t, h, dk).transpose(1, 2)

    x1 = ffn(x.float(), "s1", "sb1", "w11", "bb11", "w12", "bb12")
    xa = r(layer_norm(x1, p["sa"], p["sab"]))
    q = xa @ r(p["wq_full"]).t()
    q_u = heads(r(q + (p["bq"] + p["bias_u"].reshape(d))))
    q_v = heads(r(q + (p["bq"] + p["bias_v"].reshape(d))))
    k = heads(r(xa @ r(p["wk_full"]).t() + p["bk"]))
    v = heads(r(xa @ r(p["wv_full"]).t() + p["bv"]))
    pe = rel_positional_encoding(t, d, x.device)
    pos = r(r(pe) @ r(p["pos_kernel"]).t()).view(-1, h, dk)
    ctx = attention_context(q_u, q_v, k, v, pos, mask, r,
                            tuple(att_context_size))
    ctx = r(ctx.transpose(1, 2).reshape(b, t, d))
    x2 = x1 + ctx @ r(p["wo_full"]).t() + p["bo"]

    xc = r(layer_norm(x2, p["sc"], p["scb"]))
    w1, b1 = p["w1"], p["b1"]
    glu = ((xc @ r(w1[:d]).t() + b1[:d])
           * torch.sigmoid(xc @ r(w1[d:]).t() + b1[d:]) * keep)
    kk = conv_kernel_size
    g = F.pad(glu, (0, 0, conv_pad_l, kk - 1 - conv_pad_l))
    a = torch.zeros_like(glu)
    for j in range(kk):
        a = a + g[:, j:j + t] * p["wd"][:, j]
    a = a + p["bd"]
    y = (layer_norm(a, p["nw"], p["nb"]) if conv_norm == "layer_norm"
         else a * p["nw"] + p["nb"])
    x3 = x2 + r(F.silu(y)) @ r(p["w2c"]).t() + p["b2c"]

    x4 = ffn(x3, "s2", "sb2", "w21", "bb21", "w22", "bb22")
    return (layer_norm(x4, p["sf"], p["sfb"]) * keep).to(dt)


def layer_smem(d: int, dff: int, k: int, dk: int) -> int:
    """Shared memory (bytes) of layer.cu's launch: the row phases' X, Y and
    H tiles and a staged weight chunk, or the attention core."""
    h = max(32 * dff, (32 + k - 1) * d, 32 * d)
    rows = 4 * (2 * 32 * d + h + 32 * 129)
    return max(rows, 4 * _row_stride(dk) * (2 * 32 + 2 * 32 + 63))


def _check(x, mask, params, n_heads, k, pad_l, conv_norm):
    missing = [key for key in KEYS if key not in params]
    if missing:
        raise ValueError(f"fused_conformer_layer: params lack {missing}")
    if conv_norm not in NORMS or not 0 <= pad_l < k:
        raise ValueError(f"fused_conformer_layer: conv_norm {conv_norm!r} "
                         f"(one of {NORMS}), conv_pad_l {pad_l} for {k} "
                         f"taps")
    b, t, d = x.shape
    dff = params["w11"].shape[0]
    want = {"w11": (dff, d), "w12": (d, dff), "w21": (dff, d),
            "w22": (d, dff), "w1": (2 * d, d), "wd": (d, k),
            "bias_u": (n_heads, d // n_heads),
            "bias_v": (n_heads, d // n_heads)}
    want.update({key: (d, d) for key in ("wq_full", "wk_full", "wv_full",
                                         "wo_full", "pos_kernel", "w2c")})
    bad = {key: tuple(params[key].shape) for key, shape in want.items()
           if tuple(params[key].shape) != shape}
    if d % n_heads or bad or mask.shape != (b, t):
        raise ValueError(f"fused_conformer_layer: shapes do not match x "
                         f"{tuple(x.shape)} with {n_heads} heads and {k} "
                         f"taps: {bad}, mask {tuple(mask.shape)}")


def fused_conformer_layer(x: torch.Tensor, mask: torch.Tensor,
                          params: Dict[str, torch.Tensor], n_heads: int,
                          conv_kernel_size: int, conv_pad_l: int,
                          conv_norm: str,
                          att_context_size: Tuple[int, int] = (-1, -1)
                          ) -> torch.Tensor:
    """Same contract as `conformer_layer_plain`; raises when autograd would
    need its gradient. On the card one cooperative launch (dk <= 64, shared
    memory `layer_smem` <= 227 KB)."""
    K.refuse_grad("fused_conformer_layer", x, *params.values())
    k, pad_l = int(conv_kernel_size), int(conv_pad_l)
    _check(x, mask, params, n_heads, k, pad_l, conv_norm)
    window = tuple(int(c) for c in att_context_size)
    if x.device.type == "cpu":
        return conformer_layer_plain(x, mask, params, n_heads, k, pad_l,
                                     conv_norm, window)
    if not x.is_cuda:
        raise ValueError(f"fused_conformer_layer: unsupported device "
                         f"{x.device}")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_conformer_layer: unsupported dtype {dt}")
    b, t, d = x.shape
    h = n_heads
    dk = d // h
    dff = params["w11"].shape[0]
    smem = layer_smem(d, dff, k, dk)
    if dk > MAX_DK or smem > K.SMEM_LIMIT:
        raise ValueError(f"fused_conformer_layer: dk={dk} (<= {MAX_DK}), "
                         f"D={d}, d_ff={dff}, k={k} need {smem} B of shared "
                         f"memory (<= {K.SMEM_LIMIT})")
    dev = x.device
    p = params
    mat = lambda key: p[key].to(dt).contiguous()
    vec = lambda z: z.float().reshape(-1).contiguous()
    cu = vec(p["bq"].float() + p["bias_u"].float().reshape(d))
    cv = vec(p["bq"].float() + p["bias_v"].float().reshape(d))
    new = lambda *shape: torch.empty(shape, dtype=dt, device=dev)
    f32 = lambda *shape: torch.empty(shape, device=dev)
    xc = x.contiguous()
    out = torch.empty_like(xc)
    key_bias = torch.zeros((b, t), device=dev).masked_fill(~mask, -1e30)
    tensors = (
        xc, out, key_bias, position_table(t, d, dev),
        vec(p["s1"]), vec(p["sb1"]), mat("w11"), vec(p["bb11"]), mat("w12"),
        vec(p["bb12"]), vec(p["sa"]), vec(p["sab"]), mat("wq_full"),
        mat("wk_full"), mat("wv_full"), mat("pos_kernel"), mat("wo_full"),
        cu, cv, vec(p["bk"]), vec(p["bv"]), vec(p["bo"]), vec(p["sc"]),
        vec(p["scb"]), mat("w1"), vec(p["b1"]),
        p["wd"].float().t().contiguous(), vec(p["bd"]), vec(p["nw"]),
        vec(p["nb"]), mat("w2c"), vec(p["b2c"]), vec(p["s2"]),
        vec(p["sb2"]), mat("w21"), vec(p["bb21"]), mat("w22"),
        vec(p["bb22"]), vec(p["sf"]), vec(p["sfb"]),
        f32(b * t, d), f32(b * t, d), new(b, h, t, dk), new(b, h, t, dk),
        new(b, h, t, dk), new(b, h, t, dk), new(h, 2 * t - 1, dk),
        new(b, t, d), torch.zeros(2, dtype=torch.int32, device=dev))
    assert len(tensors) == _N_PTRS
    K.check_cuda("fused_conformer_layer", *tensors)
    ptrs = (ctypes.c_void_p * _N_PTRS)(*(z.data_ptr() for z in tensors))
    K.call("tat_conformer_layer", _ARGS, dev, int(dt == torch.bfloat16),
           ctypes.cast(ptrs, ctypes.c_void_p), _N_PTRS, b, t, d, h, dff, k,
           pad_l, int(conv_norm == "layer_norm"), *window)
    fused_conformer_layer.launches += 1
    return out


fused_conformer_layer.launches = 0
