"""Conformer encoder, offline eval and training paths: the PyTorch
counterpart of tpu_asr/models/conformer.py.

Module and parameter names follow NeMo's `state_dict` keys (the layout of
tests/nemo_oracle.py), so a `.nemo` teacher's weights load as they are.
Parameters stay fp32; activations run in the model's compute dtype, with
each weight cast to it at use, as the JAX modules do. LayerNorm is flax's
(eps 1e-6, statistics in fp32). BatchNorm uses its running statistics in
eval and the batch statistics over (B, T), padded frames included, in
training (momentum 0.9 in flax terms, unbiased running variance, eps 1e-5).

In scope: every offline option of JAX's ConformerEncoder. The pre-encode:
`striding` and `dw_striding` at factors 2 to 16 (powers of two), with
`causal_downsampling`'s left-only time pad, `stacking` and `stacking_norm`,
and the plain Linear at factor 1 (`make_pre_encode`). The attention:
rel-pos ('rel_pos', or 'rel_pos_local_attn', the same semantics) with full
context or a limited window (`att_context_size`) in the 'regular'
(sliding) or 'chunked_limited' style, longformer global tokens (with
`global_attn_separate`'s own projections). Mid-stack or final time
reduction (pooling or striding), `feat_out`'s projection, stochastic depth
in training; batch-norm or layer-norm conv modules with any conv context,
int8 serving (`quantization='int8'`). Any other EncoderConfig value raises
(`check_supported`) instead of running a different path. Backends:
`subsampling_backend` and `attention_backend`
'pallas' call the kernel wrappers (the CUDA kernels for CUDA tensors, the
plain versions for CPU tensors) and raise where the kernel refuses the
shape; 'auto' calls them where the kernel takes the shape and the plain
versions elsewhere, as JAX's 'auto' falls back to XLA (`use_kernel`, asking
each wrapper's own refusal predicate); 'xla' calls the plain versions.
As in JAX, the subsampling kernel takes only striding x4 without the causal
pad, and the attention kernel only the 'regular' style without global
tokens, window or not; the chunked and global routes are plain PyTorch
where JAX runs XLA, and 'pallas' refuses them. The
FFN sublayers, as JAX routes them: in training the fused kernel ('pallas',
or 'auto' where its forward and backward fit shared memory: d88 to d256,
as JAX's `ffn_train_kernel_fits` at B=32 x 15 s, not d512) or its plain
version, whatever `quantization` says; in eval with
`quantization='int8'` the int8 kernel (its plain version under 'xla'); in
eval with `ffn_backend='pallas'` the fused kernel at dropout 0; otherwise
plain PyTorch. The conv module runs the eval kernel with
`conv_backend='pallas'` in eval and plain PyTorch otherwise.
`set_backend('xla')` (profile_forward.py) points every route at its plain
version and `set_backend('auto')` back at the config's choice.

Packed segments (data/packing.py), serving and training:
`ConformerEncoder.subsample` returns the raw subsampled frames, and
`encode_frames` with `seg_id` (R, T) takes packed rows of them; every
attention then sees only keys of its query's segment (the attention
kernel's segment mode, forward and backward) and every layer zeroes the
guard frames. In training BatchNorm's statistics run over the packed
(R, T) frames, guards included, as JAX's do over the packed layout.

Cache-aware streaming (`ConformerEncoder.stream_step`, JAX's encoder with
`cache`): per-layer caches of the last C post-LN attention inputs and of
the last `pad_l` post-GLU conv inputs, both rolled by each sample's own
valid count; keys and values over [cache; chunk], queries over the chunk;
the causal pre-encode's recomputed leading frames dropped. As in JAX, the
attention, conv and subsampling of a cached step run plain PyTorch (their
kernels take no cache) and the float FFN sublayers run unfused; with
`quantization='int8'` the FFN sublayers take the eval route of
`_eval_ffn` (the int8 kernel on a CUDA tensor, which takes any rows), the
function of JAX's unfused int8_dense FFN.

Training (`train=True` with a `torch.Generator`): every dropout site draws
its mask from the counter hash of ops/dropout.py with a seed drawn per step
from the generator before the layers run, so a checkpointed layer
(`remat`, torch.utils.checkpoint) recomputes the same masks. BatchNorm
commits its running statistics once per forward, after the layers, so the
recomputation does not update them a second time. Stochastic depth draws
its keep decisions from the same generator after the seeds, one per layer,
and applies them outside the checkpointed layer: a dropped layer still
runs (its BatchNorm statistics and zero gradients are JAX's), and its
output is its input.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_asr_torch.config import EncoderConfig
from tpu_asr_torch.ops._kernels import prepared, use_kernel
from tpu_asr_torch.ops.cuda_attention import (attention_refusal,
                                              fused_relpos_attention_block,
                                              head_streams, local_window,
                                              project_heads, rel_shift,
                                              relpos_attention_plain)
from tpu_asr_torch.ops.cuda_conv import conv_layer_norm, fused_conv_module
from tpu_asr_torch.ops.cuda_ffn import (ffn_refusal, ffn_sublayer_int8_plain,
                                        ffn_sublayer_plain,
                                        fused_ffn_sublayer,
                                        fused_ffn_sublayer_int8)
from tpu_asr_torch.ops.cuda_subsampling import (fused_subsampling, out_len,
                                                subsampling_plain,
                                                subsampling_refusal)
from tpu_asr_torch.ops.dropout import dropout, keep_mask
from tpu_asr_torch.ops.positions import (position_table,
                                         rel_positional_encoding)
from tpu_asr_torch.parallel.mesh import (global_mean, global_rows,
                                         model_gather, model_input,
                                         model_sum, row_offset)

SEEDS_PER_LAYER = 5      # ffn1, attention probabilities, attention out,
#                          conv out, ffn2

BACKENDS = ("auto", "pallas", "xla")
SUBSAMPLINGS = ("striding", "dw_striding", "stacking", "stacking_norm")
ATTENTION_MODELS = ("rel_pos", "rel_pos_local_attn")
REDUCTIONS = ("pooling", "striding")


def shift_seeds(seeds: List[int], offset: int, n_heads: int) -> List[int]:
    """The encoder's dropout seeds (the pre-encoder's, then SEEDS_PER_LAYER
    a layer) for rows that begin at `offset` of the global batch: each
    site's streams are affine in the row (ops/dropout.py), so the base moves
    by the streams a row takes there (n_heads for the attention
    probabilities, 1 elsewhere), modulo 2^32, and the rows draw the masks of
    the same rows in the single-rank run."""
    if not offset:
        return seeds
    per_row = [1] + [1, n_heads, 1, 1, 1] * ((len(seeds) - 1)
                                              // SEEDS_PER_LAYER)
    return [(s + offset * k) & 0xFFFFFFFF for s, k in zip(seeds, per_row)]


def _power_of_two(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


def check_supported(c: EncoderConfig) -> None:
    """Raise for every EncoderConfig value that the port does not
    implement. Non-power-of-two subsampling factors are refused: JAX's
    striding would silently take int(log2(f)) stages."""
    window = tuple(c.att_context_size)
    unsupported = {
        "subsampling": (c.subsampling_factor > 1 and bool(c.subsampling)
                        and c.subsampling not in SUBSAMPLINGS),
        "subsampling_factor": not _power_of_two(c.subsampling_factor),
        "self_attention_model": (c.self_attention_model
                                 not in ATTENTION_MODELS),
        "att_context_size": len(window) != 2 or min(window) < -1,
        "att_context_style": c.att_context_style not in ("regular",
                                                         "chunked_limited"),
        "global_tokens": c.global_tokens < 0 or c.global_tokens_spacing < 1,
        "reduction": (c.reduction is not None and c.reduction_factor > 1
                      and c.reduction not in REDUCTIONS),
        "reduction_factor": c.reduction_factor < 1,
        "conv_norm_type": c.conv_norm_type not in ("batch_norm",
                                                   "layer_norm"),
        "untie_biases": not c.untie_biases,
        "quantization": c.quantization not in ("none", "int8"),
        "conv_backend": c.conv_backend not in BACKENDS,
        "ffn_backend": c.ffn_backend not in BACKENDS,
        "subsampling_backend": c.subsampling_backend not in BACKENDS,
        "attention_backend": c.attention_backend not in BACKENDS,
        "stochastic_depth_drop_prob": not 0.0 <= c.stochastic_depth_drop_prob
        < 1.0,
        "stochastic_depth_mode": c.stochastic_depth_mode not in ("linear",
                                                                 "uniform"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"tpu_asr_torch does not implement EncoderConfig "
                         f"options {bad}")


def subsampled_length(length: torch.Tensor, factor: int = 4,
                      subsampling: str = "striding") -> torch.Tensor:
    """Frames after the pre-encode: striding / dw_striding (k=3, s=2,
    p=1 a stage) L -> (L - 1) // 2 + 1, log2(factor) times; stacking
    ceil(L / factor); factor 1 (the Linear pre-encode) unchanged."""
    if factor <= 1 or not subsampling:
        return length
    if subsampling in ("stacking", "stacking_norm"):
        return -(-length // factor)
    for _ in range(int(math.log2(factor))):
        length = (length - 1) // 2 + 1
    return length


def _linear(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """Linear (or 1x1 Conv1d) applied in x's dtype."""
    w = layer.weight
    w = w[..., 0] if w.dim() == 3 else w
    return F.linear(x, w.to(x.dtype), layer.bias.to(x.dtype))


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return norm(x.float()).to(x.dtype)


class ConvSubsampling(nn.Module):
    """`striding` / `dw_striding` pre-encode at factor 2 to 16 with NeMo's
    `state_dict` keys: `conv.{i}` of one nn.Sequential and `out`. striding:
    a Conv2d (3x3, stride 2) and a ReLU a stage (`conv.0`, `conv.2`, ..);
    dw_striding: a regular first stage, then a depthwise 3x3 stride-2
    Conv2d and a pointwise 1x1 before each ReLU (`conv.0`, `conv.2`,
    `conv.3`, `conv.5`, `conv.6`, .. at x8). Frequency is padded (1, 1),
    time (1, 1) or with `causal_downsampling` (2, 0). The kernel takes
    striding x4 without the causal pad (JAX's fused_ok); every other case
    runs the convolutions in x's dtype, as JAX's XLA path does."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        ch = cfg.conv_channels
        self.backend = cfg.subsampling_backend
        self.causal = cfg.causal_downsampling
        self.stages = int(math.log2(cfg.subsampling_factor))
        self.depthwise = cfg.subsampling == "dw_striding"
        mods = [nn.Conv2d(1, ch, 3, 2, 1), nn.ReLU()]
        for _ in range(self.stages - 1):
            if self.depthwise:
                mods += [nn.Conv2d(ch, ch, 3, 2, 1, groups=ch),
                         nn.Conv2d(ch, ch, 1)]
            else:
                mods.append(nn.Conv2d(ch, ch, 3, 2, 1))
            mods.append(nn.ReLU())
        self.conv = nn.Sequential(*mods)
        f = cfg.feat_in
        for _ in range(self.stages):
            f = out_len(f)
        self.out = nn.Linear(ch * f, cfg.d_model)

    def refusal(self, x: torch.Tensor) -> Optional[str]:
        """Why the subsampling kernel would not take x (B, T, F), or
        None."""
        if self.depthwise or self.stages != 2 or self.causal:
            return ("fused_subsampling takes striding x4 subsampling with "
                    "symmetric padding only")
        return subsampling_refusal(x.dtype, self.conv[0].out_channels,
                                   out_len(out_len(x.shape[-1])))

    def uses_kernel(self, x: torch.Tensor) -> bool:
        """Whether the route takes the kernel wrapper for x (B, T, F)."""
        return use_kernel(self.backend, self.refusal(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) contiguous, working dtype -> (B, T', D)."""
        if self.stages == 2 and not (self.depthwise or self.causal):
            run = (fused_subsampling if self.uses_kernel(x)
                   else subsampling_plain)
            h = run(x, self.conv[0].weight, self.conv[0].bias,
                    self.conv[2].weight, self.conv[2].bias, self.out.weight)
            return h + self.out.bias.to(h.dtype)
        use_kernel(self.backend, self.refusal(x))   # 'pallas' raises
        dt = x.dtype
        pad = (1, 1, 2, 0) if self.causal else (1, 1, 1, 1)
        h = x[:, None]                                     # (B, 1, T, F)
        for m in self.conv:
            if isinstance(m, nn.ReLU):
                h = torch.relu(h)
            elif m.kernel_size == (1, 1):
                h = F.conv2d(h, m.weight.to(dt), m.bias.to(dt))
            else:
                h = F.conv2d(F.pad(h, pad), m.weight.to(dt), m.bias.to(dt),
                             stride=2, groups=m.groups)
        b, c, t, f = h.shape
        return _linear(h.transpose(1, 2).reshape(b, t, c * f), self.out)


class StackingSubsampling(nn.Module):
    """`stacking` / `stacking_norm` pre-encode (NeMo StackingSubsampling's
    keys `pre_norm`, `proj_out`): T zero-padded to a multiple of the
    factor, `factor` frames stacked, (LayerNorm,) Linear."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.factor = cfg.subsampling_factor
        width = self.factor * cfg.feat_in
        self.pre_norm = (nn.LayerNorm(width, eps=1e-6)
                         if cfg.subsampling == "stacking_norm" else None)
        self.proj_out = nn.Linear(width, cfg.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, f = x.shape
        pad = (-t) % self.factor
        h = F.pad(x, (0, 0, 0, pad)).reshape(b, (t + pad) // self.factor,
                                             self.factor * f)
        if self.pre_norm is not None:
            h = _layer_norm(self.pre_norm, h)
        return _linear(h, self.proj_out)


class LinearPreEncode(nn.Linear):
    """The factor-1 pre-encode, NeMo's bare Linear (`pre_encode.weight`,
    `pre_encode.bias`), in x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(x, self)


def make_pre_encode(cfg: EncoderConfig) -> nn.Module:
    """The pre-encode module of cfg's subsampling (JAX's ConvSubsampling
    dispatch)."""
    if cfg.subsampling_factor <= 1 or not cfg.subsampling:
        return LinearPreEncode(cfg.feat_in, cfg.d_model)
    if cfg.subsampling in ("stacking", "stacking_norm"):
        return StackingSubsampling(cfg)
    return ConvSubsampling(cfg)


class RelPositionMultiHeadAttention(nn.Module):
    """Rel-pos multi-head attention with NeMo's keys. `att_context_size`
    (left, right) limits the context, in the 'regular' (sliding) or
    'chunked_limited' style; `global_tokens` positions i * spacing escape
    a sliding window (longformer), scored by their own projections
    (`linear_{q,k,v}_global`) with `global_attn_separate`. As JAX routes
    it: 'regular' without global tokens goes to the block kernel ('auto'
    where it takes the shape, 'pallas'), window or not, or its plain
    version ('xla'); chunked windows and global tokens run plain PyTorch,
    and 'pallas' refuses them."""

    def __init__(self, d_model: int, n_heads: int, backend: str = "auto",
                 att_context_size: Tuple[int, int] = (-1, -1),
                 att_context_style: str = "regular", global_tokens: int = 0,
                 global_tokens_spacing: int = 1,
                 global_attn_separate: bool = False):
        super().__init__()
        dk = d_model // n_heads
        self.n_heads, self.backend = n_heads, backend
        self.window = tuple(int(c) for c in att_context_size)
        left, right = self.window
        self.chunked = att_context_style == "chunked_limited" and right >= 0
        # JAX's 'auto' takes the kernel for the 'regular' style without
        # global tokens; they act only on a sliding window
        self.kernel_route = (att_context_style == "regular"
                             and global_tokens == 0)
        self.global_tokens = (global_tokens if not self.chunked
                              and (left >= 0 or right >= 0) else 0)
        self.global_spacing = global_tokens_spacing
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_heads, dk))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_heads, dk))
        self.separate = bool(self.global_tokens and global_attn_separate)
        if self.separate:
            self.linear_q_global = nn.Linear(d_model, d_model)
            self.linear_k_global = nn.Linear(d_model, d_model)
            self.linear_v_global = nn.Linear(d_model, d_model)
        # (tp, index): this module holds model rank index's heads of tp
        # slices (parallel/sharding.shard_module)
        self.tp = None

    def local_heads(self) -> Tuple[int, int]:
        """(heads this module runs, the first of them among n_heads)."""
        if self.tp is None:
            return self.n_heads, 0
        tp, index = self.tp
        return self.n_heads // tp, index * (self.n_heads // tp)

    def uses_kernel(self, x: torch.Tensor) -> bool:
        """Whether the route takes the kernel wrapper for x (B, T, D); the
        backward's limits count when autograd will need it. 'pallas' with
        a chunked window or global tokens raises, as in JAX."""
        if not self.kernel_route:
            return use_kernel(self.backend, (
                "attention_backend='pallas' supports only "
                "att_context_style='regular' with global_tokens=0; use "
                "attention_backend='xla' for chunked/global attention"))
        train = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        b, t, _ = x.shape
        return use_kernel(self.backend, attention_refusal(
            x.dtype, self.linear_q.weight.shape[0], self.local_heads()[0], t,
            train))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: torch.Tensor, dropout_rate: float = 0.0,
                dropout_seed: int = 0,
                seg_id: Optional[torch.Tensor] = None,
                kv_cache: Optional[torch.Tensor] = None,
                kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`seg_id` (B, T) int: the packed-segment map ('regular' style
        without global tokens only, as in JAX). `kv_cache` (B, C, D): the
        right-aligned history of post-LN inputs of cache-aware streaming,
        `kv_valid` (B,) its valid frames; `pos_emb` then has C + 2T - 1
        rows. With a cache neither 'auto' nor 'pallas' takes the kernel, as
        in JAX: it scores square problems only."""
        if self.tp is not None and (kv_cache is not None
                                    or not self.kernel_route):
            raise ValueError("tensor-parallel attention runs the 'regular' "
                             "offline style without global tokens only")
        if kv_cache is not None:
            if seg_id is not None:
                raise ValueError(
                    "packed-segment attention (seg_id) supports only the "
                    "offline 'regular' attention style without global tokens")
            out = self._cached_plain(x, pos_emb, mask, kv_cache, kv_valid)
            return out + self.linear_out.bias.to(out.dtype)
        if seg_id is not None and not self.kernel_route:
            raise ValueError(
                "packed-segment attention (seg_id) supports only the "
                "offline 'regular' attention style without global tokens")
        h_local, first = self.local_heads()
        heads = None if self.tp is None else (first, self.n_heads)
        # a tensor-parallel rank: the local heads' partial sum, summed over
        # the model group (x's cotangents too), linear_out's bias once
        xin = x if self.tp is None else model_input(x)
        args = (xin, self.linear_q.weight, self.linear_q.bias,
                self.linear_k.weight, self.linear_k.bias,
                self.linear_v.weight, self.linear_v.bias, self.pos_bias_u,
                self.pos_bias_v, self.linear_pos.weight,
                self.linear_out.weight, pos_emb, mask, h_local)
        if self.uses_kernel(x):
            out = fused_relpos_attention_block(
                *args, att_context_size=self.window,
                dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                seg_id=seg_id, heads=heads)
        elif self.kernel_route:
            out = relpos_attention_plain(*args, dropout_rate, dropout_seed,
                                         seg_id, self.window, heads)
        else:
            out = self._masked_plain(x, pos_emb, mask, dropout_rate,
                                     dropout_seed)
        if self.tp is not None:
            out = model_sum(out)
        return out + self.linear_out.bias.to(out.dtype)

    def _cached_plain(self, x, pos_emb, mask, kv_cache, kv_valid
                      ) -> torch.Tensor:
        """JAX's kv-cache branch (tpu_asr/models/conformer.py
        RelPositionMultiHeadAttention with `kv_cache`) at its rounding
        points: projections in x's dtype, content and position scores
        accumulated in fp32 and rounded to it, their scaled sum and the
        key mask (-30000 in bf16, -1e30 otherwise) added in it, the softmax
        in fp32. Key s of [cache; x] is valid when s >= C - kv_valid (the
        cache) or its frame is (the chunk). As in JAX, no window mask
        applies: the cache's length bounds the left context. Without the
        linear_out bias."""
        dt = x.dtype
        b, t, d = x.shape
        h, dk = self.n_heads, d // self.n_heads
        c_len = kv_cache.shape[1]
        kv_in = torch.cat([kv_cache.to(dt), x], dim=1)
        t_kv = kv_in.shape[1]
        heads = lambda z, n: z.view(b, n, h, dk).transpose(1, 2)
        q = _linear(x, self.linear_q)
        k = heads(_linear(kv_in, self.linear_k), t_kv)
        v = heads(_linear(kv_in, self.linear_v), t_kv)
        p = F.linear(pos_emb.to(dt), self.linear_pos.weight.to(dt))
        p = p.view(-1, h, dk)
        q_u = heads(q + self.pos_bias_u.to(dt).reshape(d), t)
        q_v = heads(q + self.pos_bias_v.to(dt).reshape(d), t)
        ac = (q_u.float() @ k.float().transpose(-1, -2)).to(dt)
        bd = rel_shift(torch.einsum("bhtd,phd->bhtp", q_v.float(),
                                    p.float()).to(dt), t_kv)
        cache_ok = (torch.arange(c_len, device=x.device)[None, :]
                    >= c_len - kv_valid[:, None])
        kv_mask = torch.cat([cache_ok, mask], dim=1)
        neg = -30000.0 if dt == torch.bfloat16 else -1.0e30
        key_bias = torch.zeros(kv_mask.shape, dtype=dt, device=x.device)
        key_bias = key_bias.masked_fill(~kv_mask, neg)[:, None, None, :]
        scores = (ac + bd) / math.sqrt(dk) + key_bias
        attn = torch.softmax(scores.float(), dim=-1)
        ctx = (attn.to(dt).float() @ v.float()).transpose(1, 2)
        ctx = ctx.reshape(b, t, d).to(dt)
        return F.linear(ctx, self.linear_out.weight.to(dt))

    def _masked_plain(self, x, pos_emb, mask, dropout_rate: float,
                      dropout_seed: int) -> torch.Tensor:
        """The chunked window and the global tokens: JAX's XLA path
        (tpu_asr/models/conformer.py RelPositionMultiHeadAttention) with
        relpos_attention_plain's rounding. chunked_limited: query chunk i
        (chunk = right + 1 frames) sees key chunks i - left // chunk .. i.
        Global tokens: pairs with a global query or key escape the sliding
        window; with `separate` they score (q_g + u) . k_g / sqrt(dk) + key
        bias from their own projections, and a global key's value is its
        v_g. Without the linear_out bias."""
        dt = x.dtype

        def r(z):           # round to the working dtype, compute in fp32
            return z.to(dt).float()

        b, t, d = x.shape
        h, dk = self.n_heads, d // self.n_heads
        q_u, q_v, k, v, p = project_heads(
            x, self.linear_q.weight, self.linear_q.bias, self.linear_k.weight,
            self.linear_k.bias, self.linear_v.weight, self.linear_v.bias,
            self.pos_bias_u, self.pos_bias_v, self.linear_pos.weight,
            pos_emb, h)
        ac = q_u @ k.transpose(-1, -2)
        bd = rel_shift(torch.einsum("bhtd,phd->bhtp", q_v, p))
        key_bias = torch.zeros(mask.shape, device=x.device).masked_fill(
            ~mask, -1e30)[:, None, None, :]
        scores = (r(ac) + r(bd)) / math.sqrt(dk) + key_bias
        left, right = self.window
        dev = x.device
        if self.chunked:
            chunk = right + 1
            cidx = torch.arange(t, device=dev) // chunk
            diff = cidx[:, None] - cidx[None, :]
            ok = (diff >= 0) & (diff <= (left // chunk if left >= 0 else t))
        elif left >= 0 or right >= 0:
            ok = local_window(t, left, right, dev)
            if self.global_tokens:
                pos = torch.arange(t, device=dev)
                glob = ((pos % self.global_spacing == 0)
                        & (pos < self.global_tokens * self.global_spacing))
                pair = glob[:, None] | glob[None, :]
                ok = ok | pair
                if self.separate:
                    heads = lambda z: z.view(b, t, h, dk).transpose(1, 2)
                    proj = lambda layer: r(x.float() @ r(layer.weight).t()
                                           + layer.bias)
                    qg = r(heads(proj(self.linear_q_global))
                           + self.pos_bias_u[None, :, None].float())
                    kg = heads(proj(self.linear_k_global))
                    vg = heads(proj(self.linear_v_global))
                    g_scores = r(qg @ kg.transpose(-1, -2)) / math.sqrt(dk)
                    scores = torch.where(pair, g_scores + key_bias, scores)
                    v = torch.where(glob[:, None], vg, v)
        else:
            ok = None
        if ok is not None:
            scores = scores.masked_fill(~ok, -1e30)
        attn = torch.softmax(scores, dim=-1)
        if dropout_rate:
            keep = keep_mask(head_streams(dropout_seed, b, h, dev), t, t,
                             dropout_rate,
                             row_stride=-(-t // 128) * 128).view(attn.shape)
            attn = torch.where(keep, attn * (1.0 / (1.0 - dropout_rate)),
                               torch.zeros_like(attn))
        ctx = r((r(attn) @ v).transpose(1, 2).reshape(b, t, d))
        return (ctx @ r(self.linear_out.weight).t()).to(dt)


class FeedForward(nn.Module):
    """linear1 -> SiLU -> linear2. Under tensor parallelism
    (parallel/sharding.shard_module) it holds the model rank's slices of
    linear1's outputs and linear2's inputs, and `weights()` gathers them
    whole over the model group: the FFN kernels, which JAX partitions over
    the batch only (GSPMD gives them whole weights), run on the whole
    weights, and each slice's gradient is its part of the whole one."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.tp = None

    def weights(self):
        """(w1 (d_ff, D), b1, w2 (D, d_ff), b2), whole."""
        w1, b1 = self.linear1.weight, self.linear1.bias
        w2 = self.linear2.weight
        if self.tp is not None:
            w1, b1, w2 = (model_gather(w1, 0), model_gather(b1, 0),
                          model_gather(w2, 1))
        return w1, b1, w2, self.linear2.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w1, b1, w2, b2 = (z.to(x.dtype) for z in self.weights())
        return F.linear(F.silu(F.linear(x, w1, b1)), w2, b2)


def fold_batch_norm(weight, bias, mean, var, eps: float):
    """BatchNorm's running statistics as one per-channel affine (w, b)."""
    w = weight * torch.rsqrt(var + eps)
    return w, bias - mean * w


# the fold for the eval kernel, built once per version of the BatchNorm's
# parameters and statistics (rebuilt after `commit()` or a training step)
_prepared_fold = prepared(fold_batch_norm)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over channels with NeMo's keys (weight, bias,
    running_mean, running_var, num_batches_tracked). Eval: the running
    statistics folded into one per-channel affine in fp32, applied in x's
    dtype. Training: the batch statistics over (B, T), padded frames
    included, in fp32; `commit()` then moves the running statistics once
    (momentum 0.9 in flax terms, unbiased variance). Under data
    parallelism (parallel/mesh.py) the statistics are the global batch's,
    reduced across the ranks in the forward and the backward (the
    reference's sync_batchnorm), and the unbiased factor takes the global
    count."""

    MOMENTUM = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self._batch_stats = None

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The running statistics as one per-channel fp32 affine (w, b)."""
        return fold_batch_norm(self.weight, self.bias, self.running_mean,
                               self.running_var, self.eps)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            w, b = self.folded()
            return x * w.to(x.dtype) + b.to(x.dtype)
        xf = x.float()
        mean = global_mean(xf, (0, 1))
        var = global_mean((xf - mean).square(), (0, 1))
        n = global_rows(x.shape[0]) * x.shape[1]
        self._batch_stats = (mean.detach(), var.detach(), n)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)

    @torch.no_grad()
    def commit(self) -> None:
        """Fold the last training forward's batch statistics into the
        running statistics."""
        if self._batch_stats is None:
            return
        mean, var, n = self._batch_stats
        self._batch_stats = None
        m = self.MOMENTUM
        self.running_mean.mul_(m).add_((1 - m) * mean)
        self.running_var.mul_(m).add_((1 - m) * var * n / max(n - 1, 1))
        self.num_batches_tracked += 1


class ConvLayerNorm(nn.Module):
    """The conv module's `conv_norm_type='layer_norm'` (NeMo key
    `conv.batch_norm`): fp32 statistics with the variance E[x^2] - E[x]^2
    clipped at 0, eps 1e-6, as the JAX module computes them."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return conv_layer_norm(x, self.weight, self.bias).to(x.dtype)


class ConformerConvolution(nn.Module):
    """pointwise (d -> 2d) + GLU -> zero padded frames -> depthwise (k) ->
    BatchNorm or LayerNorm -> SiLU -> pointwise (d -> d); NeMo's Conv1d
    keys. `backend` 'pallas' runs the eval kernel in eval (BatchNorm folded
    in fp32), anything else plain PyTorch; a streaming step
    (`time_cache`) runs plain, as in JAX."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        d, k = cfg.d_model, cfg.conv_kernel_size
        self.pad = cfg.conv_context
        self.backend = cfg.conv_backend
        self.pointwise_conv1 = nn.Conv1d(d, 2 * d, 1)
        self.depthwise_conv = nn.Conv1d(d, d, k, groups=d)
        self.batch_norm = (MaskedBatchNorm(d)
                           if cfg.conv_norm_type == "batch_norm"
                           else ConvLayerNorm(d))
        self.pointwise_conv2 = nn.Conv1d(d, d, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                train: bool = False,
                time_cache: Optional[torch.Tensor] = None):
        """`time_cache` (B, pad_l, D), streaming only (a causal context):
        the last `pad_l` post-GLU inputs of the stream take the place of
        the left zero pad; returns (out, new_cache), the new cache being
        the `pad_l` frames that end at each sample's last valid frame."""
        if self.backend == "pallas" and not train and time_cache is None:
            return self._fused(x, mask)
        dt = x.dtype
        h = F.glu(_linear(x, self.pointwise_conv1), dim=-1)
        h = h.masked_fill(~mask[..., None], 0.0)
        pad, new_cache = self.pad, None
        if time_cache is not None:
            pad_l, pad_r = pad
            if pad_r != 0:
                raise ValueError("streaming conv requires "
                                 "conv_context_size='causal'")
            h = torch.cat([time_cache.to(dt), h], dim=1)
            j = (mask.sum(1)[:, None]
                 + torch.arange(pad_l, device=h.device)[None, :])
            new_cache = torch.gather(
                h, 1, j[..., None].expand(-1, -1, h.shape[-1]))
            pad = (0, 0)
        dw = self.depthwise_conv
        h = F.conv1d(F.pad(h.transpose(1, 2), pad), dw.weight.to(dt),
                     dw.bias.to(dt), groups=dw.groups).transpose(1, 2)
        h = F.silu(self.batch_norm(h, train))
        out = _linear(h, self.pointwise_conv2)
        return out if time_cache is None else (out, new_cache)

    def _fused(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        norm = self.batch_norm
        if isinstance(norm, MaskedBatchNorm):
            nw, nb = _prepared_fold(norm.weight, norm.bias, norm.running_mean,
                                    norm.running_var, norm.eps)
            kind = "affine"
        else:
            nw, nb, kind = norm.weight, norm.bias, "layer_norm"
        pw1, dw, pw2 = (self.pointwise_conv1, self.depthwise_conv,
                        self.pointwise_conv2)
        return fused_conv_module(x, mask, pw1.weight, pw1.bias, dw.weight,
                                 dw.bias, nw, nb, pw2.weight, pw2.bias,
                                 self.pad, kind)


class ConformerLayer(nn.Module):
    """FF/2 -> rel-pos MHSA -> conv module -> FF/2 -> LayerNorm, then padded
    frames zeroed."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.ffn_backend = cfg.ffn_backend
        d = cfg.d_model
        ln = lambda: nn.LayerNorm(d, eps=1e-6)
        self.norm_feed_forward1 = ln()
        self.feed_forward1 = FeedForward(d, cfg.d_ff)
        self.norm_self_att = ln()
        self.self_attn = RelPositionMultiHeadAttention(
            d, cfg.n_heads, cfg.attention_backend,
            tuple(cfg.att_context_size), cfg.att_context_style,
            cfg.global_tokens, cfg.global_tokens_spacing,
            cfg.global_attn_separate)
        self.norm_conv = ln()
        self.conv = ConformerConvolution(cfg)
        self.norm_feed_forward2 = ln()
        self.feed_forward2 = FeedForward(d, cfg.d_ff)
        self.norm_out = ln()

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: torch.Tensor,
                seeds: Optional[List[int]] = None,
                seg_id: Optional[torch.Tensor] = None,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]] = None):
        """`seeds` (SEEDS_PER_LAYER ints) selects the training path;
        `seg_id` (B, T) int is the packed-segment map; `cache`
        (last_channel (B, C, D), last_channel_len (B,), last_time
        (B, pad_l, D)) the streaming step, which returns (x, new
        last_channel, new last_time)."""
        if seeds is not None:
            return self._train_forward(x, pos_emb, mask, seeds, seg_id)
        if cache is not None:
            return self._cached_forward(x, pos_emb, mask, *cache)
        x = self._eval_ffn(self.norm_feed_forward1, self.feed_forward1, x)
        x = x + self.self_attn(_layer_norm(self.norm_self_att, x), pos_emb,
                               mask, seg_id=seg_id)
        x = x + self.conv(_layer_norm(self.norm_conv, x), mask)
        x = self._eval_ffn(self.norm_feed_forward2, self.feed_forward2, x)
        return _layer_norm(self.norm_out, x).masked_fill(~mask[..., None], 0.0)

    def _cached_forward(self, x, pos_emb, mask, lc, lc_len, lt):
        """The eval layer of a streaming step (JAX's ConformerLayer with
        `cache`): the FFN sublayers unfused, or with quantization='int8'
        through `_eval_ffn` (the int8 kernel, its plain version under
        'xla'), which computes JAX's int8_dense FFN; the channel cache
        takes the chunk's post-LN attention inputs, rolled by each
        sample's valid count so that validity stays right-aligned (a
        partial final chunk's pad frames never enter it). The conv module
        and the attention run in float, as in JAX."""
        if self.cfg.quantization == "int8":
            ffn = self._eval_ffn
        else:
            def ffn(norm, ff, z):
                return z + 0.5 * ff(_layer_norm(norm, z))

        x = ffn(self.norm_feed_forward1, self.feed_forward1, x)
        h = _layer_norm(self.norm_self_att, x)
        tot = torch.cat([lc, h.to(lc.dtype)], dim=1)
        j = (mask.sum(1)[:, None]
             + torch.arange(lc.shape[1], device=x.device)[None, :])
        new_lc = torch.gather(tot, 1, j[..., None].expand(-1, -1,
                                                          tot.shape[-1]))
        x = x + self.self_attn(h, pos_emb, mask, kv_cache=lc, kv_valid=lc_len)
        h, new_lt = self.conv(_layer_norm(self.norm_conv, x), mask,
                              time_cache=lt)
        x = x + h
        x = ffn(self.norm_feed_forward2, self.feed_forward2, x)
        x = _layer_norm(self.norm_out, x).masked_fill(~mask[..., None], 0.0)
        return x, new_lc, new_lt

    def _eval_ffn(self, norm: nn.LayerNorm, ff: FeedForward,
                  x: torch.Tensor) -> torch.Tensor:
        """x + 0.5 * FFN(LN(x)) in eval: the int8 kernel (its plain version
        under 'xla') with quantization='int8', the fused kernel with
        'pallas', else plain PyTorch."""
        args = (x, norm.weight, norm.bias, *ff.weights())
        if self.cfg.quantization == "int8":
            run = (ffn_sublayer_int8_plain if self.ffn_backend == "xla"
                   else fused_ffn_sublayer_int8)
            return run(*args)
        if self.ffn_backend == "pallas":
            return fused_ffn_sublayer(*args)
        return x + 0.5 * ff(_layer_norm(norm, x))

    def _ffn(self, norm: nn.LayerNorm, ff: FeedForward, x: torch.Tensor,
             seed: int) -> torch.Tensor:
        """x + 0.5 * drop(FFN(LN(x))), both dropout masks inside: the fused
        kernel ('pallas', or 'auto' where it takes the shape) or its plain
        version."""
        run = (fused_ffn_sublayer if self.ffn_train_uses_kernel(x, ff)
               else ffn_sublayer_plain)
        return run(x, norm.weight, norm.bias, *ff.weights(),
                   self.cfg.dropout, seed)

    def ffn_train_uses_kernel(self, x: torch.Tensor,
                              ff: FeedForward) -> bool:
        """Whether the training FFN route takes the kernel wrapper for x
        (B, T, D); its backward's limit counts when autograd will need
        it."""
        train = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in ff.parameters()))
        return use_kernel(self.ffn_backend, ffn_refusal(
            x.dtype, x.shape[-1], ff.linear2.in_features, train))

    def _train_forward(self, x, pos_emb, mask, seeds, seg_id=None):
        c = self.cfg
        x = self._ffn(self.norm_feed_forward1, self.feed_forward1, x,
                      seeds[0])
        h = self.self_attn(_layer_norm(self.norm_self_att, x), pos_emb, mask,
                           c.dropout_att, seeds[1], seg_id)
        x = x + dropout(h, c.dropout, seeds[2])
        h = self.conv(_layer_norm(self.norm_conv, x), mask, train=True)
        x = x + dropout(h, c.dropout, seeds[3])
        x = self._ffn(self.norm_feed_forward2, self.feed_forward2, x,
                      seeds[4])
        return _layer_norm(self.norm_out, x).masked_fill(~mask[..., None], 0.0)


class SubsamplingReductionModule(nn.Module):
    """Time reduction by `factor` (JAX's reconstruction of NeMo's module):
    'pooling' averages each group of `factor` frames, T zero-padded to a
    multiple of it; 'striding' is a Conv1d (kernel = stride = factor, key
    `conv`) over the zero-padded frames. Lengths become ceil(len /
    factor)."""

    def __init__(self, reduction: str, d_model: int, factor: int):
        super().__init__()
        self.reduction, self.factor = reduction, factor
        if reduction == "striding":
            self.conv = nn.Conv1d(d_model, d_model, factor, factor)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        b, t, d = x.shape
        f = self.factor
        xp = F.pad(x, (0, 0, 0, (-t) % f))
        if self.reduction == "pooling":
            y = xp.view(b, -1, f, d).mean(dim=2)
        else:
            c = self.conv
            y = F.conv1d(xp.transpose(1, 2), c.weight.to(x.dtype),
                         c.bias.to(x.dtype), stride=f).transpose(1, 2)
        return y, (lengths + f - 1) // f


def drop_probs(c: EncoderConfig) -> List[float]:
    """Stochastic depth's drop probability of each layer: 0 before
    `stochastic_depth_start_layer`, then p (uniform) or rising linearly to
    p at the last layer (linear)."""
    probs = [0.0] * c.n_layers
    p, start = c.stochastic_depth_drop_prob, c.stochastic_depth_start_layer
    if p > 0.0:
        for i in range(start, c.n_layers):
            probs[i] = (p * (i + 1 - start) / (c.n_layers - start)
                        if c.stochastic_depth_mode == "linear" else p)
    return probs


class ConformerEncoder(nn.Module):
    """(B, F, T) log-mel + (B,) frames -> (encoded (B, T', D'), lengths
    (B,), layer_feats (L', B, T', D)); activations in `dtype`. `forward` is
    `subsample` then `encode_frames`; packed serving calls them apart,
    packing between them (tpu_asr/models/conformer.py's `pre_encode_only`
    and `bypass_pre_encode` with `seg_id`). With mid-stack reduction
    (`reduction_position` before the last layer) the layers after it are
    `layers_post`, at the reduced rate, and layer_feats holds theirs;
    `feat_out` projects the final output only (D' = feat_out)."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        check_supported(cfg)
        self.cfg, self.dtype = cfg, dtype
        self.pre_encode = make_pre_encode(cfg)
        reduce_on = cfg.reduction is not None and cfg.reduction_factor > 1
        mid = reduce_on and 0 <= cfg.reduction_position < cfg.n_layers - 1
        n1 = cfg.reduction_position + 1 if mid else cfg.n_layers
        self.layers = nn.ModuleList(ConformerLayer(cfg) for _ in range(n1))
        if reduce_on:
            self.reduction_subsampling = SubsamplingReductionModule(
                cfg.reduction, cfg.d_model, cfg.reduction_factor)
        self.layers_post = nn.ModuleList(
            ConformerLayer(cfg) for _ in range(cfg.n_layers - n1))
        self.reduces = reduce_on
        fo = cfg.feat_out
        self.out_proj = (nn.Linear(cfg.d_model, fo)
                         if fo and fo > 0 and fo != cfg.d_model else None)

    def forward(self, features: torch.Tensor, lengths: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """`train` needs a CPU `generator`, from which every dropout seed of
        this forward is drawn before the layers run."""
        return self.encode_frames(*self.subsample(features, lengths), train,
                                  generator)

    def subsample(self, features: torch.Tensor, lengths: torch.Tensor):
        """(B, F, T) log-mel + (B,) frames -> raw subsampled frames
        (B, T', D) before xscale and masking, and their (B,) lengths."""
        x = self.pre_encode(features.transpose(1, 2).to(self.dtype)
                            .contiguous())
        return x, subsampled_length(lengths, self.cfg.subsampling_factor,
                                    self.cfg.subsampling)

    def encode_frames(self, x: torch.Tensor,
                      lengths: Optional[torch.Tensor], train: bool = False,
                      generator: Optional[torch.Generator] = None,
                      seg_id: Optional[torch.Tensor] = None):
        """Subsampled frames (B, T', D) (`subsample`) + (B,) lengths ->
        (encoded, lengths, layer_feats). `seg_id` (B, T') int: the
        packed-segment map (0 = guard/pad); it replaces `lengths`, sets the
        mask (seg_id > 0) and the lengths (valid frames a row), and each
        attention sees only its query's segment, in eval and in training
        (JAX's `bypass_pre_encode` with `seg_id`: xscale and the
        pre-encoder dropout as for unpacked frames; a checkpointed layer
        recomputes with the same map and dropout seeds). Time reduction
        refuses a segment map, as in JAX: pooling would merge segments."""
        c = self.cfg
        if x.shape[-1] != c.d_model:
            raise ValueError(f"encode_frames expects (B, T, d_model="
                             f"{c.d_model}) frames, got feature dim "
                             f"{x.shape[-1]}")
        if seg_id is not None and self.reduces:
            raise ValueError("packed-segment encoding is incompatible with "
                             "time reduction (pooling would merge frames "
                             "across segments)")
        x, out_len = x.to(self.dtype), lengths
        t = x.shape[1]
        if c.xscaling:
            x = x * math.sqrt(c.d_model)
        seeds, keep = None, None
        if train:
            seeds = shift_seeds(torch.randint(
                0, 2 ** 31 - 1, (1 + SEEDS_PER_LAYER * c.n_layers,),
                generator=generator).tolist(), row_offset(x.shape[0]),
                c.n_heads)
            x = dropout(x, c.dropout_pre_encoder, seeds[0])
            if c.stochastic_depth_drop_prob > 0.0:
                u = torch.rand(c.n_layers, generator=generator).tolist()
                keep = [float(ui >= p) for ui, p in zip(u, drop_probs(c))]
        seg = None
        if seg_id is not None:
            # the attention kernel's segment operand, built once for every
            # layer, as pos_emb is
            seg = seg_id.to(device=x.device, dtype=torch.int32).contiguous()
            mask = seg > 0
            out_len = mask.sum(1)
        else:
            mask = (torch.arange(t, device=x.device)[None, :]
                    < out_len[:, None])
        x = x.masked_fill(~mask[..., None], 0.0)
        pos_emb = rel_positional_encoding(t, c.d_model, x.device)
        x, feats = self._run(self.layers, 0, x, pos_emb, mask, seeds, keep,
                             seg)
        if self.reduces:
            x, out_len = self.reduction_subsampling(x, out_len)
            if len(self.layers_post):
                t = x.shape[1]
                mask = (torch.arange(t, device=x.device)[None, :]
                        < out_len[:, None])
                x = x.masked_fill(~mask[..., None], 0.0)
                x, feats = self._run(
                    self.layers_post, len(self.layers), x,
                    rel_positional_encoding(t, c.d_model, x.device), mask,
                    seeds, keep, None)
        if train:
            for layer in (*self.layers, *self.layers_post):
                if isinstance(layer.conv.batch_norm, MaskedBatchNorm):
                    layer.conv.batch_norm.commit()
        if self.out_proj is not None:
            x = _linear(x, self.out_proj)
        return x, out_len, torch.stack(feats)

    def stream_step(self, features: torch.Tensor, lengths: torch.Tensor,
                    cache: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                    drop_extra_pre_encoded: int = 0):
        """One cache-aware streaming step (JAX's encoder with `cache`):
        (B, F, T) log-mel of a chunk prefixed with its pre-encode context
        and (B,) frames counting it; `cache` the stacked (last_channel
        (L, B, C, D), last_channel_len (B,), last_time (L, B, pad_l, D)).
        The first `drop_extra_pre_encoded` subsampled frames, recomputed
        context, are dropped. Returns (encoded, lengths, new cache); the
        new valid count is min(old + lengths, C). Time reduction is
        refused: JAX's cached path has no reduction stage."""
        c = self.cfg
        if self.reduces:
            raise ValueError("cache-aware streaming is incompatible with "
                             "time reduction")
        lc, lc_len, lt = cache
        x, out_len = self.subsample(features, lengths)
        if drop_extra_pre_encoded > 0:
            x = x[:, drop_extra_pre_encoded:]
            out_len = (out_len - drop_extra_pre_encoded).clamp(min=0)
        t = x.shape[1]
        if c.xscaling:
            x = x * math.sqrt(c.d_model)
        pos_emb = position_table(t, c.d_model, x.device,
                                 cache_len=lc.shape[2])
        mask = torch.arange(t, device=x.device)[None, :] < out_len[:, None]
        x = x.masked_fill(~mask[..., None], 0.0)
        new_lc, new_lt = [], []
        for i, layer in enumerate(self.layers):
            x, lc_i, lt_i = layer(x, pos_emb, mask,
                                  cache=(lc[i], lc_len, lt[i]))
            new_lc.append(lc_i)
            new_lt.append(lt_i)
        new_len = torch.minimum(lc_len + out_len,
                                torch.full_like(lc_len, lc.shape[2]))
        if self.out_proj is not None:
            x = _linear(x, self.out_proj)
        return x, out_len, (torch.stack(new_lc), new_len,
                            torch.stack(new_lt))

    def _run(self, layers, first: int, x, pos_emb, mask, seeds, keep, seg):
        """The layers (global indices first ..) on x: (x, [each layer's
        output]). In training layer i takes its SEEDS_PER_LAYER seeds and,
        with stochastic depth, y = x + keep_i (y - x) / (1 - p_i)."""
        c = self.cfg
        probs = drop_probs(c)
        feats = []
        for j, layer in enumerate(layers):
            i = first + j
            if seeds is None:
                x = layer(x, pos_emb, mask, seg_id=seg)
            else:
                lseeds = seeds[1 + SEEDS_PER_LAYER * i:
                               1 + SEEDS_PER_LAYER * (i + 1)]
                if c.remat:
                    y = checkpoint(layer, x, pos_emb, mask, lseeds, seg,
                                   use_reentrant=False)
                else:
                    y = layer(x, pos_emb, mask, lseeds, seg)
                if keep is not None:
                    y = x + keep[i] * (y - x) / max(1.0 - probs[i], 1e-6)
                x = y
            feats.append(x)
        return x, feats
