"""Velocity-field ("meta encoder") networks for flow-matching KD: the
PyTorch counterpart of tpu_asr/kd/meta_encoders.py (reference
asr_train.py:825-1019, 1244-1279). Each maps a time-embedded student
feature (B, T, C_in) to a velocity (B, T, C_out), feature-last, in x's
dtype (weights cast to it).

- `mlp`: fc1 -> ReLU -> fc2. The fused Euler kernel (ops/cuda_fm.py)
  implements this one; FlowMatchingModule folds it there.
- `cnn`: conv1 (k=3, pad 1) -> ReLU -> conv2 (k=1).
- `swin`: unmasked multi-head attention over time (every frame, padding
  included, as flax's MultiHeadDotProductAttention without a mask), then
  linear1 -> ReLU -> linear2. Despite its name it has no windows.
- `conformer`: input_proj (when C_in != C_out) and 4 mini conformer blocks:
  LN -> FF/2 (whose own LN follows: the reference's double LayerNorm) ->
  LN -> MHA -> conv module (LN -> pointwise 2x -> depthwise k=31 ->
  batch-statistics norm -> SiLU -> pointwise) -> LN -> FF/2 -> LN. The
  norm (`_BatchStatNorm`) uses the statistics of the (B, T) frames it is
  given, in training and eval alike, so a caller holding several encoder
  layers must call it per layer (models/distil_model.py does).
- `unet`: 4 strided downs (k=4, s=2, p=1), a k=3 bottleneck, 4 transposed
  ups (torch ConvTranspose1d(k=4, s=2, p=1), which is flax's
  ConvTranspose with padding (2, 2) and the kernel flipped in time) with
  skip concatenation (the up path padded or cropped to the skip's length),
  a final 1x1, the output cropped or padded to the input length.

Dropout: the conformer's feed-forward and conv modules drop at rate 0.1 in
training (META_DROPOUT), their masks from the port's
counter-based hash (ops/dropout.py) with one seed a site drawn from the
`dropout` generator; flax's nn.Dropout bits are not reproduced. LayerNorm's
epsilon is flax's 1e-6, the batch-statistics norm's 1e-5.

Under data parallelism (parallel/mesh.py) the batch-statistics norm reduces
its statistics over the global batch, and a dropout site's stream is that
of the row's place in the global batch (parallel/mesh.row_index), so both
equal the single-rank run's.

Parameter names follow the JAX paths, with flax's automatic names given
words: a feed-forward's LayerNorm_0 / Dense_0 / Dense_1 are `norm`,
`linear1`, `linear2`, the conv module's LayerNorm_0 is `norm`, and the
attention's query / key / value / out DenseGeneral kernels are Linear layers
of those names (convert/from_jax.py reshapes them).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_asr_torch.ops.dropout import dropout as hash_dropout
from tpu_asr_torch.parallel.mesh import global_mean, row_index

LN_EPS = 1e-6           # flax nn.LayerNorm
BN_EPS = 1e-5           # _BatchStatNorm
META_DROPOUT = 0.1      # _MetaFeedForward, _MetaConvModule


def _cast(layer: nn.Module, dt: torch.dtype):
    return layer.weight.to(dt), layer.bias.to(dt)


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A Linear in x's dtype (flax nn.Dense(dtype=...))."""
    return F.linear(x, *_cast(layer, x.dtype))


def conv_btc(layer: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d on feature-last (B, T, C)."""
    w, b = _cast(layer, x.dtype)
    return F.conv1d(x.transpose(1, 2), w, b, layer.stride, layer.padding,
                    groups=layer.groups).transpose(1, 2)


def _layer_norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, layer.normalized_shape, *_cast(layer, x.dtype),
                        LN_EPS)


def _drop(x: torch.Tensor, rate: float, train: bool,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    if not train or not rate:
        return x
    if generator is None:
        raise ValueError("meta encoder dropout in training needs the "
                         "'dropout' generator")
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))
    return hash_dropout(x, rate, seed, row_index(x.shape[0], x.device))


class MLPMetaEncoder(nn.Module):
    """fc1 (in_dim -> hidden_dim) -> ReLU -> fc2 (hidden_dim -> out_dim)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dense(self.fc2, F.relu(dense(self.fc1, x)))


class CNNMetaEncoder(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.conv1 = nn.Conv1d(in_dim, out_dim, 3, padding=1)
        self.conv2 = nn.Conv1d(out_dim, out_dim, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return conv_btc(self.conv2, F.relu(conv_btc(self.conv1, x)))


class MultiHeadAttention(nn.Module):
    """flax MultiHeadDotProductAttention(num_heads) of x with itself, no
    mask: query, key, value (dim -> dim) split into heads, softmax(q k^T /
    sqrt(dim / heads)) v, out (dim -> out_dim)."""

    def __init__(self, dim: int, n_heads: int, out_dim: Optional[int] = None):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"attention width {dim} not divisible by "
                             f"{n_heads} heads")
        self.n_heads = n_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, out_dim or dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        heads = lambda z: z.reshape(b, t, self.n_heads, -1).transpose(1, 2)
        q, k, v = (heads(dense(m, x)) for m in
                   (self.query, self.key, self.value))
        q = q / (q.shape[-1] ** 0.5)
        p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return dense(self.out, (p @ v).transpose(1, 2).reshape(b, t, d))


class SwinMetaEncoder(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, n_heads: int = 4):
        super().__init__()
        self.attn = MultiHeadAttention(in_dim, n_heads)
        self.linear1 = nn.Linear(in_dim, out_dim)
        self.linear2 = nn.Linear(out_dim, out_dim)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.relu(dense(self.linear1, self.attn(x)))
        return dense(self.linear2, h)


class _MetaFeedForward(nn.Module):
    """LN -> Linear(4x) -> SiLU -> dropout -> Linear -> dropout."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.linear1 = nn.Linear(dim, dim * mult)
        self.linear2 = nn.Linear(dim * mult, dim)

    def forward(self, x, train=False, generator=None):
        h = F.silu(dense(self.linear1, _layer_norm(self.norm, x)))
        h = dense(self.linear2, _drop(h, META_DROPOUT, train, generator))
        return _drop(h, META_DROPOUT, train, generator)


class _BatchStatNorm(nn.Module):
    """Normalisation over (B, T) with the batch's own statistics (fp32,
    biased variance), then the affine `scale`, `bias` (weight, bias)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = global_mean(xf, (0, 1))
        var = global_mean(torch.square(xf - mean), (0, 1))
        y = (xf - mean) * torch.rsqrt(var + BN_EPS)
        return (y * self.weight + self.bias).to(x.dtype)


class _MetaConvModule(nn.Module):
    """LN -> pointwise (2x) -> depthwise k=31 -> batch-statistics norm ->
    SiLU -> pointwise -> dropout (no GLU, as the reference)."""

    def __init__(self, dim: int, expansion: int = 2, kernel_size: int = 31):
        super().__init__()
        d = dim * expansion
        self.norm = nn.LayerNorm(dim)
        self.pointwise1 = nn.Conv1d(dim, d, 1)
        self.depthwise = nn.Conv1d(d, d, kernel_size,
                                   padding=kernel_size // 2, groups=d)
        self.batch_norm = _BatchStatNorm(d)
        self.pointwise2 = nn.Conv1d(d, dim, 1)

    def forward(self, x, train=False, generator=None):
        h = conv_btc(self.pointwise1, _layer_norm(self.norm, x))
        h = F.silu(self.batch_norm(conv_btc(self.depthwise, h)))
        return _drop(conv_btc(self.pointwise2, h), META_DROPOUT, train,
                     generator)


class _MetaConformerBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        self.norm_ff1 = nn.LayerNorm(dim)
        self.ff1 = _MetaFeedForward(dim)
        self.mha_norm = nn.LayerNorm(dim)
        self.mha = MultiHeadAttention(dim, n_heads)
        self.conv = _MetaConvModule(dim)
        self.norm_ff2 = nn.LayerNorm(dim)
        self.ff2 = _MetaFeedForward(dim)
        self.final_norm = nn.LayerNorm(dim)

    def forward(self, x, train=False, generator=None):
        x = x + 0.5 * self.ff1(_layer_norm(self.norm_ff1, x), train,
                               generator)
        x = x + self.mha(_layer_norm(self.mha_norm, x))
        x = x + self.conv(x, train, generator)
        x = x + 0.5 * self.ff2(_layer_norm(self.norm_ff2, x), train,
                               generator)
        return _layer_norm(self.final_norm, x)


class ConformerMetaEncoder(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, n_heads: int,
                 n_layers: int = 4):
        super().__init__()
        if in_dim != out_dim:
            self.input_proj = nn.Linear(in_dim, out_dim)
        self.blocks = nn.ModuleList(_MetaConformerBlock(out_dim, n_heads)
                                    for _ in range(n_layers))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if hasattr(self, "input_proj"):
            x = dense(self.input_proj, x)
        for block in self.blocks:
            x = block(x, train, generator)
        return x


class UNet1DMetaEncoder(nn.Module):
    def __init__(self, in_dim: int, base_ch: int, out_dim: int,
                 n_layers: int = 4):
        super().__init__()
        chans, ch = [], in_dim
        self.downs = nn.ModuleList()
        for i in range(n_layers):
            self.downs.append(nn.Conv1d(ch, base_ch * 2 ** i, 4, 2, 1))
            ch = base_ch * 2 ** i
            chans.append(ch)
        self.bottleneck = nn.Conv1d(ch, ch, 3, padding=1)
        self.ups = nn.ModuleList()
        for skip_c in reversed(chans):
            self.ups.append(nn.ConvTranspose1d(ch + skip_c, skip_c, 4, 2, 1))
            ch = skip_c
        self.final = nn.Conv1d(ch, out_dim, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt, t_in = x.dtype, x.shape[1]
        fit = lambda z, n: (z[:, :n] if z.shape[1] >= n
                            else F.pad(z, (0, 0, 0, n - z.shape[1])))
        skips, h = [], x
        for down in self.downs:
            h = conv_btc(down, h)
            skips.append(h)
        h = conv_btc(self.bottleneck, h)
        for up in self.ups:
            skip = skips.pop()
            h = torch.cat([fit(h, skip.shape[1]), skip], dim=-1)
            h = F.conv_transpose1d(h.transpose(1, 2), *_cast(up, dt),
                                   stride=2, padding=1).transpose(1, 2)
        return fit(conv_btc(self.final, h), t_in)


def build_meta_encoder(meta_encoder_type: str, in_dim: int, out_dim: int,
                       hidden_dim: int, n_heads: int = 2) -> nn.Module:
    """The dispatch of FlowMatchingModule (asr_train.py:1242-1279):
    `hidden_dim` is the mlp's hidden width and the unet's base channels,
    `n_heads` the swin's and the conformer's heads."""
    if meta_encoder_type == "mlp":
        return MLPMetaEncoder(in_dim, hidden_dim, out_dim)
    if meta_encoder_type == "cnn":
        return CNNMetaEncoder(in_dim, out_dim)
    if meta_encoder_type == "swin":
        return SwinMetaEncoder(in_dim, out_dim, n_heads)
    if meta_encoder_type == "conformer":
        return ConformerMetaEncoder(in_dim, out_dim, n_heads, 4)
    if meta_encoder_type == "unet":
        return UNet1DMetaEncoder(in_dim, hidden_dim, out_dim, 4)
    raise ValueError(f"Unknown meta_encoder type: {meta_encoder_type}")
