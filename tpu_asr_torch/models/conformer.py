"""Conformer encoder, offline eval and training paths: the PyTorch
counterpart of tpu_asr/models/conformer.py.

Module and parameter names follow NeMo's `state_dict` keys (the layout of
tests/nemo_oracle.py), so a `.nemo` teacher's weights load as they are.
Parameters stay fp32; activations run in the model's compute dtype, with
each weight cast to it at use, as the JAX modules do. LayerNorm is flax's
(eps 1e-6, statistics in fp32). BatchNorm uses its running statistics in
eval and the batch statistics over (B, T), padded frames included, in
training (momentum 0.9 in flax terms, unbiased running variance, eps 1e-5).

In scope: `striding` x4 subsampling, full-context 'regular' rel-pos
attention, batch-norm or layer-norm conv modules with any conv context,
int8 serving (`quantization='int8'`), no caches, no stochastic depth. Any
other EncoderConfig option raises (`check_supported`) instead of running a
different path. Backends: `subsampling_backend` and `attention_backend`
'auto'/'pallas' call the kernel wrappers (the CUDA kernels for CUDA
tensors, the plain versions for CPU tensors), 'xla' calls the plain
versions. The FFN sublayers, as JAX routes them: in training the fused
kernel ('auto'/'pallas') or its plain version ('xla'), whatever
`quantization` says; in eval with `quantization='int8'` the int8 kernel
(its plain version under 'xla'); in eval with `ffn_backend='pallas'` the
fused kernel at dropout 0; otherwise plain PyTorch. The conv module runs
the eval kernel with `conv_backend='pallas'` in eval and plain PyTorch
otherwise. `set_backend('xla')` (profile_forward.py) points every route at
its plain version and `set_backend('auto')` back at the config's choice.

Training (`train=True` with a `torch.Generator`): every dropout site draws
its mask from the counter hash of ops/dropout.py with a seed drawn per step
from the generator before the layers run, so a checkpointed layer
(`remat`, torch.utils.checkpoint) recomputes the same masks. BatchNorm
commits its running statistics once per forward, after the layers, so the
recomputation does not update them a second time.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_asr_torch.config import EncoderConfig
from tpu_asr_torch.ops.cuda_attention import (fused_relpos_attention_block,
                                              relpos_attention_plain)
from tpu_asr_torch.ops.cuda_conv import conv_layer_norm, fused_conv_module
from tpu_asr_torch.ops.cuda_ffn import (ffn_sublayer_int8_plain,
                                        ffn_sublayer_plain,
                                        fused_ffn_sublayer,
                                        fused_ffn_sublayer_int8)
from tpu_asr_torch.ops.cuda_subsampling import (fused_subsampling, out_len,
                                                subsampling_plain)
from tpu_asr_torch.ops.dropout import dropout

SEEDS_PER_LAYER = 5      # ffn1, attention probabilities, attention out,
#                          conv out, ffn2

BACKENDS = ("auto", "pallas", "xla")


def check_supported(c: EncoderConfig) -> None:
    """Raise for every EncoderConfig option outside the port's slice."""
    unsupported = {
        "subsampling": c.subsampling != "striding",
        "subsampling_factor": c.subsampling_factor != 4,
        "causal_downsampling": c.causal_downsampling,
        "self_attention_model": c.self_attention_model != "rel_pos",
        "att_context_size": tuple(c.att_context_size) != (-1, -1),
        "att_context_style": c.att_context_style != "regular",
        "global_tokens": c.global_tokens != 0,
        "reduction": c.reduction is not None and c.reduction_factor > 1,
        "feat_out": c.feat_out not in (-1, 0, c.d_model),
        "conv_norm_type": c.conv_norm_type not in ("batch_norm",
                                                   "layer_norm"),
        "untie_biases": not c.untie_biases,
        "quantization": c.quantization not in ("none", "int8"),
        "conv_backend": c.conv_backend not in BACKENDS,
        "ffn_backend": c.ffn_backend not in BACKENDS,
        "subsampling_backend": c.subsampling_backend not in BACKENDS,
        "attention_backend": c.attention_backend not in BACKENDS,
        "stochastic_depth_drop_prob": c.stochastic_depth_drop_prob > 0.0,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"tpu_asr_torch does not implement EncoderConfig "
                         f"options {bad}")


def subsampled_length(length: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """Frames after striding subsampling: L -> (L - 1) // 2 + 1 per x2."""
    for _ in range(int(math.log2(factor))):
        length = (length - 1) // 2 + 1
    return length


def rel_positional_encoding(t: int, d_model: int,
                            device=None) -> torch.Tensor:
    """Relative sinusoid table (2t - 1, d_model) fp32 for positions
    t-1 .. -(t-1): sin on even columns, cos on odd (NeMo
    RelPositionalEncoding), computed in numpy float32 as the JAX
    package computes it."""
    positions = np.arange(t - 1, -t, -1, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * -(math.log(10000.0) / d_model))
    pe = np.zeros((2 * t - 1, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(positions * div)
    pe[:, 1::2] = np.cos(positions * div)
    return torch.from_numpy(pe).to(device)


def _linear(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """Linear (or 1x1 Conv1d) applied in x's dtype."""
    w = layer.weight
    w = w[..., 0] if w.dim() == 3 else w
    return F.linear(x, w.to(x.dtype), layer.bias.to(x.dtype))


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return norm(x.float()).to(x.dtype)


class ConvSubsampling(nn.Module):
    """`striding` x4 pre-encode: keys `conv.0`, `conv.2` and `out`."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        ch = cfg.conv_channels
        self.backend = cfg.subsampling_backend
        self.conv = nn.Sequential(nn.Conv2d(1, ch, 3, 2, 1), nn.ReLU(),
                                  nn.Conv2d(ch, ch, 3, 2, 1), nn.ReLU())
        self.out = nn.Linear(ch * out_len(out_len(cfg.feat_in)), cfg.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) contiguous, working dtype -> (B, T', D)."""
        run = subsampling_plain if self.backend == "xla" else fused_subsampling
        h = run(x, self.conv[0].weight, self.conv[0].bias, self.conv[2].weight,
                self.conv[2].bias, self.out.weight)
        return h + self.out.bias.to(h.dtype)


class RelPositionMultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, backend: str = "auto"):
        super().__init__()
        dk = d_model // n_heads
        self.n_heads, self.backend = n_heads, backend
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_heads, dk))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_heads, dk))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: torch.Tensor, dropout_rate: float = 0.0,
                dropout_seed: int = 0) -> torch.Tensor:
        args = (x, self.linear_q.weight, self.linear_q.bias,
                self.linear_k.weight, self.linear_k.bias,
                self.linear_v.weight, self.linear_v.bias, self.pos_bias_u,
                self.pos_bias_v, self.linear_pos.weight,
                self.linear_out.weight, pos_emb, mask, self.n_heads)
        if self.backend == "xla":
            out = relpos_attention_plain(*args, dropout_rate, dropout_seed)
        else:
            out = fused_relpos_attention_block(
                *args, dropout_rate=dropout_rate, dropout_seed=dropout_seed)
        return out + self.linear_out.bias.to(out.dtype)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(F.silu(_linear(x, self.linear1)), self.linear2)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over channels with NeMo's keys (weight, bias,
    running_mean, running_var, num_batches_tracked). Eval: the running
    statistics folded into one per-channel affine in fp32, applied in x's
    dtype. Training: the batch statistics over (B, T), padded frames
    included, in fp32; `commit()` then moves the running statistics once
    (momentum 0.9 in flax terms, unbiased variance)."""

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
        w = self.weight * torch.rsqrt(self.running_var + self.eps)
        return w, self.bias - self.running_mean * w

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            w, b = self.folded()
            return x * w.to(x.dtype) + b.to(x.dtype)
        xf = x.float()
        mean = xf.mean(dim=(0, 1))
        var = (xf - mean).square().mean(dim=(0, 1))
        n = x.shape[0] * x.shape[1]
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
    in fp32), anything else plain PyTorch."""

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
                train: bool = False) -> torch.Tensor:
        if self.backend == "pallas" and not train:
            return self._fused(x, mask)
        dt = x.dtype
        h = F.glu(_linear(x, self.pointwise_conv1), dim=-1)
        h = h.masked_fill(~mask[..., None], 0.0)
        dw = self.depthwise_conv
        h = F.conv1d(F.pad(h.transpose(1, 2), self.pad), dw.weight.to(dt),
                     dw.bias.to(dt), groups=dw.groups).transpose(1, 2)
        h = F.silu(self.batch_norm(h, train))
        return _linear(h, self.pointwise_conv2)

    def _fused(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        norm = self.batch_norm
        if isinstance(norm, MaskedBatchNorm):
            (nw, nb), kind = norm.folded(), "affine"
        else:
            nw, nb, kind = norm.weight, norm.bias, "layer_norm"
        pw1, dw, pw2 = (self.pointwise_conv1, self.depthwise_conv,
                        self.pointwise_conv2)
        return fused_conv_module(x, mask, pw1.weight[..., 0], pw1.bias,
                                 dw.weight[:, 0], dw.bias, nw, nb,
                                 pw2.weight[..., 0], pw2.bias, self.pad, kind)


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
            d, cfg.n_heads, cfg.attention_backend)
        self.norm_conv = ln()
        self.conv = ConformerConvolution(cfg)
        self.norm_feed_forward2 = ln()
        self.feed_forward2 = FeedForward(d, cfg.d_ff)
        self.norm_out = ln()

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: torch.Tensor,
                seeds: Optional[List[int]] = None) -> torch.Tensor:
        """`seeds` (SEEDS_PER_LAYER ints) selects the training path."""
        if seeds is not None:
            return self._train_forward(x, pos_emb, mask, seeds)
        x = self._eval_ffn(self.norm_feed_forward1, self.feed_forward1, x)
        x = x + self.self_attn(_layer_norm(self.norm_self_att, x), pos_emb,
                               mask)
        x = x + self.conv(_layer_norm(self.norm_conv, x), mask)
        x = self._eval_ffn(self.norm_feed_forward2, self.feed_forward2, x)
        return _layer_norm(self.norm_out, x).masked_fill(~mask[..., None], 0.0)

    def _eval_ffn(self, norm: nn.LayerNorm, ff: FeedForward,
                  x: torch.Tensor) -> torch.Tensor:
        """x + 0.5 * FFN(LN(x)) in eval: the int8 kernel (its plain version
        under 'xla') with quantization='int8', the fused kernel with
        'pallas', else plain PyTorch."""
        args = (x, norm.weight, norm.bias, ff.linear1.weight,
                ff.linear1.bias, ff.linear2.weight, ff.linear2.bias)
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
        kernel ('auto'/'pallas') or its plain version ('xla')."""
        run = (ffn_sublayer_plain if self.ffn_backend == "xla"
               else fused_ffn_sublayer)
        return run(x, norm.weight, norm.bias, ff.linear1.weight,
                   ff.linear1.bias, ff.linear2.weight, ff.linear2.bias,
                   self.cfg.dropout, seed)

    def _train_forward(self, x, pos_emb, mask, seeds):
        c = self.cfg
        x = self._ffn(self.norm_feed_forward1, self.feed_forward1, x,
                      seeds[0])
        h = self.self_attn(_layer_norm(self.norm_self_att, x), pos_emb, mask,
                           c.dropout_att, seeds[1])
        x = x + dropout(h, c.dropout, seeds[2])
        h = self.conv(_layer_norm(self.norm_conv, x), mask, train=True)
        x = x + dropout(h, c.dropout, seeds[3])
        x = self._ffn(self.norm_feed_forward2, self.feed_forward2, x,
                      seeds[4])
        return _layer_norm(self.norm_out, x).masked_fill(~mask[..., None], 0.0)


class ConformerEncoder(nn.Module):
    """(B, F, T) log-mel + (B,) frames -> (encoded (B, T', D), lengths (B,),
    layer_feats (L, B, T', D)); activations in `dtype`."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        check_supported(cfg)
        self.cfg, self.dtype = cfg, dtype
        self.pre_encode = ConvSubsampling(cfg)
        self.layers = nn.ModuleList(ConformerLayer(cfg)
                                    for _ in range(cfg.n_layers))

    def forward(self, features: torch.Tensor, lengths: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """`train` needs a CPU `generator`, from which every dropout seed of
        this forward is drawn before the layers run."""
        c = self.cfg
        x = self.pre_encode(features.transpose(1, 2).to(self.dtype)
                            .contiguous())
        out_len = subsampled_length(lengths, c.subsampling_factor)
        t = x.shape[1]
        if c.xscaling:
            x = x * math.sqrt(c.d_model)
        pos_emb = rel_positional_encoding(t, c.d_model, x.device)
        seeds = None
        if train:
            seeds = torch.randint(0, 2 ** 31 - 1,
                                  (1 + SEEDS_PER_LAYER * c.n_layers,),
                                  generator=generator).tolist()
            x = dropout(x, c.dropout_pre_encoder, seeds[0])
        mask = torch.arange(t, device=x.device)[None, :] < out_len[:, None]
        x = x.masked_fill(~mask[..., None], 0.0)
        feats = []
        for i, layer in enumerate(self.layers):
            if not train:
                x = layer(x, pos_emb, mask)
            else:
                lseeds = seeds[1 + SEEDS_PER_LAYER * i:
                               1 + SEEDS_PER_LAYER * (i + 1)]
                if c.remat:
                    x = checkpoint(layer, x, pos_emb, mask, lseeds,
                                   use_reentrant=False)
                else:
                    x = layer(x, pos_emb, mask, lseeds)
            feats.append(x)
        if train:
            for layer in self.layers:
                if isinstance(layer.conv.batch_norm, MaskedBatchNorm):
                    layer.conv.batch_norm.commit()
        return x, out_len, torch.stack(feats)
