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

On the card one cooperative launch of one of two kernels, chosen by shape
before the launch (`layer_route`): bf16 that `mma_refusal` takes (D % 8 ==
0, D <= 176, dk % 4 == 0 in (32, 48], k <= 33: the repository's widths)
runs layer_mma_kernel on the tensor cores; fp32 (the check dtype) and the
other bf16 shapes run layer_kernel, plain SIMT, for what `layer_refusal`
takes. The weights in the kernel's layout (`_kernel_weights`) are built
once per weight version; the kernel reads the bool mask itself.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_asr_torch.ops import _kernels as K
from tpu_asr_torch.ops.cuda_attention import _row_stride, attention_context
from tpu_asr_torch.ops.cuda_conv import interleave_glu
from tpu_asr_torch.ops.cuda_ffn import layer_norm
from tpu_asr_torch.ops.positions import (position_table,
                                         rel_positional_encoding)

NORMS = ("affine", "layer_norm")
KEYS = ("s1", "sb1", "w11", "bb11", "w12", "bb12", "sa", "sab", "wq_full",
        "bq", "wk_full", "bk", "wv_full", "bv", "bias_u", "bias_v",
        "pos_kernel", "wo_full", "bo", "sc", "scb", "w1", "b1", "wd", "bd",
        "nw", "nb", "w2c", "b2c", "s2", "sb2", "w21", "bb21", "w22", "bb22",
        "sf", "sfb")
MMA_MAX_D, MMA_MAX_K, MMA_DK = 176, 33, (32, 48)  # layer_mma_kernel
# layer_kernel's attention phase (core_tile with two column slots a lane):
# its own limit, not the attention kernels' MAX_DK
LAYER_MAX_DK = 64
_ARGS = ((K.INT, K.PTR, K.INT) + (K.PTR,) * 5 + (ctypes.c_size_t,)
         + (K.INT,) * 10 + (K.PTR, K.PTR))


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
    """Shared memory (bytes) of layer_kernel's launch (the SIMT route): the
    row phases' X, Y and H tiles and a staged weight chunk, or the
    attention core."""
    h = max(32 * dff, (32 + k - 1) * d, 32 * d)
    rows = 4 * (2 * 32 * d + h + 32 * 129)
    return max(rows, 4 * _row_stride(dk) * (2 * 32 + 2 * 32 + 63))


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=None)
def mma_refusal(d: int, n_heads: int, k: int) -> Optional[str]:
    """Why layer_mma_kernel (bf16, tensor cores) would not take D, the
    heads and k taps, or None: a warp holds 16 rows x D in fp32
    accumulators (D <= MMA_MAX_D), rows move in 16-byte pieces (D % 8 ==
    0), the attention core copies head rows in 8-byte pieces (dk % 4 == 0)
    and is built for dk in (32, 48] (MMA_DK, the dk of every configuration
    of the repository), and the depthwise taps sit in registers (k <=
    MMA_MAX_K)."""
    dk = d // n_heads
    lo, hi = MMA_DK
    if (d % n_heads or d % 8 or d > MMA_MAX_D or dk % 4
            or not lo < dk <= hi or not 1 <= k <= MMA_MAX_K):
        return (f"layer_mma_kernel takes D % 8 == 0, D <= {MMA_MAX_D}, "
                f"dk % 4 == 0, {lo} < dk <= {hi}, k <= {MMA_MAX_K} (got "
                f"D={d}, {n_heads} heads, k={k})")
    return None


@functools.lru_cache(maxsize=None)
def layer_refusal(dtype: torch.dtype, d: int, n_heads: int, dff: int,
                  k: int) -> Optional[str]:
    """Why no layer kernel takes x (.., D) of `dtype` with these heads,
    d_ff and k taps, or None: bf16 runs layer_mma_kernel where
    `mma_refusal` takes the shape; fp32, and bf16 elsewhere, run
    layer_kernel, which takes dk <= 64 with `layer_smem` <= 227 KB."""
    name = "fused_conformer_layer"
    if dtype not in (torch.float32, torch.bfloat16):
        return f"{name}: unsupported dtype {dtype}"
    if d % n_heads:
        return f"{name}: D={d} is not a multiple of {n_heads} heads"
    if dtype == torch.bfloat16 and mma_refusal(d, n_heads, k) is None:
        return None
    dk = d // n_heads
    smem = layer_smem(d, dff, k, dk)
    if dk > LAYER_MAX_DK or smem > K.SMEM_LIMIT:
        return (f"{name}: dk={dk} (<= {LAYER_MAX_DK}), D={d}, d_ff={dff}, "
                f"k={k} need {smem} B of shared memory (<= {K.SMEM_LIMIT})")
    return None


def layer_route(dtype: torch.dtype, d: int, n_heads: int, k: int) -> int:
    """The kernel of a shape `layer_refusal` takes, as layer.cu numbers its
    routes: 0 layer_kernel<float>, 1 layer_kernel<bf16>, 2
    layer_mma_kernel."""
    if dtype == torch.float32:
        return 0
    return 2 if mma_refusal(d, n_heads, k) is None else 1


def workspace_bytes(route: int, b: int, t: int, d: int) -> int:
    """Bytes of layer.cu's Workspace: the barrier, key_bias (B T) and xs,
    glu (B T, D) in fp32, q_u, q_v, k, v, ctx (B T, D) and P (2T - 1, D) in
    the route's dtype, each piece rounded up to 256 bytes."""
    es = 4 if route == 0 else 2
    up = lambda n: _pad(n, 256)
    m = b * t
    return (256 + up(4 * m) + 2 * up(4 * m * d) + 5 * up(es * m * d)
            + up(es * (2 * t - 1) * d))


def frag_pack(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """W (N, K) as layer.cu's tensor-core B operand, in bf16: zero-padded to
    (rows, cols) (multiples of 8 and 16), then tiles (j, s) of 8 rows and
    16 columns in k-step-major order, each the 32 lanes' m16n8k16
    fragments: lane 4 g + t holds W[8 j + g][16 s + 2 t, + 1, + 8, + 9].
    Returns (cols / 16, rows / 8, 8, 4, 2, 2)."""
    n, k = w.shape
    z = torch.zeros(rows, cols, dtype=torch.bfloat16, device=w.device)
    z[:n, :k] = w
    # n = 8 j + g, k = 16 s + 8 h + 2 t + e -> [s, j, g, t, h, e]
    return z.view(rows // 8, 8, cols // 16, 2, 4, 2).permute(
        2, 0, 1, 4, 3, 5).contiguous()


def frag_unpack(f: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The (n, k) matrix that `frag_pack` stored in f."""
    rows, cols = f.shape[1] * 8, f.shape[0] * 16
    return f.permute(1, 2, 0, 4, 3, 5).reshape(rows, cols)[:n, :k]


def frag_pack_chunks(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """W (N, K) zero-padded to (rows, cols) (rows a multiple of 64) as
    rows / 64 chunks of 64 rows, each `frag_pack`ed, one after another: the
    FFN's W1, whose 64 hidden units a chunk the kernel streams two k-steps
    at a time. Returns (rows / 64 * cols / 16, 8, 8, 4, 2, 2)."""
    z = torch.zeros(rows, cols, dtype=w.dtype, device=w.device)
    z[:w.shape[0], :w.shape[1]] = w
    return torch.cat([frag_pack(z[c:c + 64], 64, cols)
                      for c in range(0, rows, 64)])


def frag_unpack_chunks(f: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The (n, k) matrix that `frag_pack_chunks` stored in f, cols = the
    padded K."""
    cols = _pad(k, 16)
    return torch.cat([frag_unpack(c, 64, cols)
                      for c in f.split(cols // 16)])[:n, :k]


# the kernels' weights, in layer.cu's LayerArgs / MmaArgs order
_SIMT_KEYS = ("s1", "sb1", "w11", "bb11", "w12", "bb12", "sa", "sab",
              "wq_full", "wk_full", "wv_full", "pos_kernel", "wo_full", "cu",
              "cv", "bk", "bv", "bo", "sc", "scb", "w1", "b1", "wd", "bd",
              "nw", "nb", "w2c", "b2c", "s2", "sb2", "w21", "bb21", "w22",
              "bb22", "sf", "sfb")
_MMA_KEYS = ("s1", "sb1", "w11", "bb11", "w12", "bb12", "sa", "sab", "wqkv",
             "pos_kernel", "wo_full", "cu", "cv", "bk", "bv", "bo", "sc",
             "scb", "w1", "b1", "wd", "bd", "nw", "nb", "w2c", "b2c", "s2",
             "sb2", "w21", "bb21", "w22", "bb22", "sf", "sfb")


@K.prepared
def _kernel_weights(route: int, *values):
    """The route's weights as layer.cu reads them, from `params` values in
    KEYS order: ({key: tensor} in _SIMT_KEYS or _MMA_KEYS order, the ctypes
    array of their pointers). The vectors in fp32 with cu = bq + u and cv =
    bq + v, wd (k, D) time-major fp32. Routes 0 and 1: the matrices in the
    route's dtype, PyTorch layouts. Route 2: the matrices fragment-packed
    (`frag_pack`, K padded to 16; the FFNs' W1 `frag_pack_chunks`), q/k/v
    stacked (each padded to pad8(D) rows), pointwise 1 interleaved
    (`interleave_glu`), d_ff padded to 64 with zero rows, columns and bias.
    Built once per weight version."""
    p = dict(zip(KEYS, values))
    d = p["wq_full"].shape[0]
    vec = lambda z: z.float().reshape(-1).contiguous()
    out = {k: vec(p[k]) for k in ("s1", "sb1", "bb12", "sa", "sab", "bk",
                                  "bv", "bo", "sc", "scb", "b1", "bd", "nw",
                                  "nb", "b2c", "s2", "sb2", "bb22", "sf",
                                  "sfb")}
    out["cu"] = vec(p["bq"].float() + p["bias_u"].float().reshape(d))
    out["cv"] = vec(p["bq"].float() + p["bias_v"].float().reshape(d))
    out["wd"] = p["wd"].float().t().contiguous()
    if route < 2:
        dt = torch.float32 if route == 0 else torch.bfloat16
        for key in ("w11", "w12", "wq_full", "wk_full", "wv_full",
                    "pos_kernel", "wo_full", "w1", "w2c", "w21", "w22"):
            out[key] = p[key].to(dt).contiguous()
        out["bb11"], out["bb21"] = vec(p["bb11"]), vec(p["bb21"])
        keys = _SIMT_KEYS
    else:
        f = p["w11"].shape[0]
        dp, d8, fp = _pad(d, 16), _pad(d, 8), _pad(f, 64)
        pad_rows = lambda w: F.pad(w, (0, 0, 0, d8 - d))
        out["wqkv"] = frag_pack(torch.cat([pad_rows(p[k]) for k in
                                           ("wq_full", "wk_full",
                                            "wv_full")]), 3 * d8, dp)
        for key in ("pos_kernel", "wo_full", "w2c"):
            out[key] = frag_pack(p[key], d8, dp)
        out["w1"] = frag_pack(interleave_glu(p["w1"]), 2 * d8, dp)
        for w_in, w_out, bias in (("w11", "w12", "bb11"),
                                  ("w21", "w22", "bb21")):
            out[w_in] = frag_pack_chunks(p[w_in], fp, dp)
            out[w_out] = frag_pack(p[w_out], d8, fp)
            out[bias] = torch.zeros(fp, device=p[bias].device)
            out[bias][:f] = p[bias].float()
        keys = _MMA_KEYS
    out = {k: out[k] for k in keys}
    ptrs = (ctypes.c_void_p * len(keys))(*(z.data_ptr()
                                           for z in out.values()))
    return out, ptrs


_VALUES = operator.itemgetter(*KEYS)
_VERSION = operator.attrgetter("_version")
_recent = {}


def _weights(route: int, params, d: int, n_heads: int, k: int):
    """`_kernel_weights(route, *params values)` after `_check_params`,
    found again for the same tensors at the same versions and data pointers
    (and the same D, heads and taps) with a few C-level passes over them:
    the wrapper's host work has a tenth of a millisecond, and
    `_kernels.prepared`'s key and the shape checks cost 2-3 us a tensor for
    the 37 of a layer. An entry holds its tensors, so their ids stay
    theirs; the newest 16 are kept. A miss checks and asks
    `_kernel_weights`; inference tensors (no version counter) are not
    kept."""
    vals = _VALUES(params)
    key = (route, d, n_heads, k, *map(id, vals))
    hit = _recent.get(key)
    if hit is not None and hit[1] == (*map(_VERSION, vals),
                                      *map(torch.Tensor.data_ptr, vals)):
        return hit[2]
    _check_params(params, d, n_heads, k)
    value = _kernel_weights(route, *vals)
    if not any(map(torch.Tensor.is_inference, vals)):
        _recent[key] = (vals, (*map(_VERSION, vals),
                               *map(torch.Tensor.data_ptr, vals)), value)
        if len(_recent) > 16:
            _recent.pop(next(iter(_recent)))
    return value


def _check_params(params, d: int, n_heads: int, k: int) -> None:
    """Raise unless params holds every key at the shapes of D, the heads
    and k taps."""
    missing = [key for key in KEYS if key not in params]
    if missing:
        raise ValueError(f"fused_conformer_layer: params lack {missing}")
    dff = params["w11"].shape[0]
    want = {"w11": (dff, d), "w12": (d, dff), "w21": (dff, d),
            "w22": (d, dff), "w1": (2 * d, d), "wd": (d, k),
            "bias_u": (n_heads, d // n_heads),
            "bias_v": (n_heads, d // n_heads)}
    want.update({key: (d, d) for key in ("wq_full", "wk_full", "wv_full",
                                         "wo_full", "pos_kernel", "w2c")})
    bad = {key: tuple(params[key].shape) for key, shape in want.items()
           if tuple(params[key].shape) != shape}
    if bad:
        raise ValueError(f"fused_conformer_layer: shapes do not match D={d} "
                         f"with {n_heads} heads and {k} taps: {bad}")


def _check(x, mask, n_heads, k, pad_l, conv_norm):
    """Raise for the call's arguments that do not match: the norm, the
    padding, the heads and the mask."""
    if conv_norm not in NORMS or not 0 <= pad_l < k:
        raise ValueError(f"fused_conformer_layer: conv_norm {conv_norm!r} "
                         f"(one of {NORMS}), conv_pad_l {pad_l} for {k} "
                         f"taps")
    b, t, d = x.shape
    if d % n_heads or mask.shape != (b, t):
        raise ValueError(f"fused_conformer_layer: shapes do not match x "
                         f"{tuple(x.shape)} with {n_heads} heads: mask "
                         f"{tuple(mask.shape)}")


def fused_conformer_layer(x: torch.Tensor, mask: torch.Tensor,
                          params: Dict[str, torch.Tensor], n_heads: int,
                          conv_kernel_size: int, conv_pad_l: int,
                          conv_norm: str,
                          att_context_size: Tuple[int, int] = (-1, -1)
                          ) -> torch.Tensor:
    """Same contract as `conformer_layer_plain`; raises when autograd would
    need its gradient. On the card one cooperative launch of the kernel
    `layer_route` names, for what `layer_refusal` takes; the weights in
    its layout are built once per weight version."""
    K.refuse_grad("fused_conformer_layer", x, *params.values())
    k, pad_l = int(conv_kernel_size), int(conv_pad_l)
    _check(x, mask, n_heads, k, pad_l, conv_norm)
    window = tuple(int(c) for c in att_context_size)
    b, t, d = x.shape
    if x.device.type == "cpu":
        _check_params(params, d, n_heads, k)
        return conformer_layer_plain(x, mask, params, n_heads, k, pad_l,
                                     conv_norm, window)
    if not x.is_cuda:
        raise ValueError(f"fused_conformer_layer: unsupported device "
                         f"{x.device}")
    dff = params["w11"].shape[0]
    why = layer_refusal(x.dtype, d, n_heads, dff, k)
    if why:
        raise ValueError(why)
    route = layer_route(x.dtype, d, n_heads, k)
    dev = x.device
    _, ptrs = _weights(route, params, d, n_heads, k)
    xc = x.contiguous()
    m8 = mask.contiguous()
    m8 = m8.view(torch.uint8) if m8.dtype == torch.bool else m8.to(torch.uint8)
    K.check_cuda("fused_conformer_layer", xc, m8)
    out = torch.empty_like(xc)
    ws = torch.empty(workspace_bytes(route, b, t, d), dtype=torch.uint8,
                     device=dev)
    K.call("tat_conformer_layer", _ARGS, dev, route, ptrs, len(ptrs),
           xc.data_ptr(), m8.data_ptr(), position_table(t, d, dev).data_ptr(),
           out.data_ptr(), ws.data_ptr(), ws.numel(), b, t, d, n_heads, dff,
           k, pad_l, int(conv_norm == "layer_norm"), *window, None)
    fused_conformer_layer.launches += 1
    return out


fused_conformer_layer.launches = 0


def layer_blocks_per_sm(dtype: torch.dtype, d: int, n_heads: int, dff: int,
                        k: int) -> int:
    """Blocks an SM of the launch `layer_route` picks for this shape (the
    CUDA occupancy calculator over the kernel's registers and shared
    memory), on the current card."""
    route = layer_route(dtype, d, n_heads, k)
    blocks = ctypes.c_int(0)
    rc = K.entry("tat_conformer_layer", _ARGS)(
        route, None, 34 if route == 2 else 36, None, None, None, None, None,
        0, 1, 1, d, n_heads, dff, k, 0, 0, -1, -1, ctypes.byref(blocks),
        None)
    if rc != 0:
        raise RuntimeError(f"tat_conformer_layer: CUDA error {rc}")
    return blocks.value
