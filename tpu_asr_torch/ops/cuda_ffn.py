"""Fused feed-forward sublayer kernels and their plain versions: training
(`csrc/ffn.cu`) and int8 serving (`csrc/ffn_int8.cu`).

Counterpart of tpu_asr/ops/pallas_ffn.py::fused_ffn_sublayer:

    out = x + 0.5 * drop2( drop1( silu( LN(x) W1^T + b1 ) ) W2^T + b2 )

with flax's LayerNorm (E[x^2] - E[x]^2, eps 1e-6, fp32 statistics). Weights
arrive in PyTorch Linear layout: w1 (d_ff, D), w2 (D, d_ff). Operands are in
x's dtype (fp32 or bf16) with fp32 accumulation, rounded where the TPU kernel
rounds them: the LN output, the dropped SiLU output and, in the backward,
do and dh1. (The TPU kernel rounds to bf16 even for fp32 inputs; the port
keeps fp32 inputs in fp32.)

Dropout (`ops/dropout.py`): stream 2 * (seed + b) + 0 over (t, d_ff) after
the SiLU, 2 * (seed + b) + 1 over (t, D) on the output, kept values scaled by
1 / (1 - rate): the masks of the Pallas kernel in interpret mode.

A CPU tensor runs the plain version (autograd differentiates it); a CUDA
tensor launches the forward kernel and, under autograd, the backward
kernels (`fused_ffn_sublayer_bwd`: three launches, one workspace). The
kernels take W1, W2, W1^T and W2^T in the working dtype, zero-padded to
multiples of 16, built once per weight version (`_kernel_weights`). Both
take any D and d_ff whose row tiles fit shared memory (`fwd_smem`,
`bwd_smem`): in training the student's d88/352, the teacher's d176/704
and d256/1024, every width that JAX's `ffn_train_kernel_fits` admits at
B=32 x 15 s; not d512/2048, which JAX refuses too. A call whose backward
autograd would need beyond that raises before the forward launches.

int8 serving, counterpart of tpu_asr/ops/pallas_ffn.py::
fused_ffn_sublayer_int8 (eval only: it has no gradient and raises when
asked for one):

    out = x + 0.5 * int8_dense(silu(int8_dense(LN(x), W1, b1)), W2, b2)

with the LN output kept in fp32, per-token activation scales
s = max(max|y|, 1e-8 * 127) * (1 / 127) and y_q = clip(round(y * (1 / s)),
+-127) (a reciprocal, as the Pallas kernel writes it; ops/quant.py divides),
and per-output-channel weights quantized by ops/quant.py outside the
kernel, as the JAX wrapper does, but once per weight version
(`_int8_weights`) and not on every call. In bf16 only x and the output
round.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tpu_asr_torch.ops import _kernels as K
from tpu_asr_torch.ops.dropout import batch_streams, keep_mask, threshold
from tpu_asr_torch.ops.quant import int8_matmul, quantize_weight

EPS = 1e-6
INT8_MAX_D, INT8_MAX_F = 512, 2048
_INT8_ARGS = (K.INT,) + (K.PTR,) * 10 + (K.INT,) * 3 + (K.PTR,)
_FWD_ARGS = ((K.INT,) + (K.PTR,) * 8 + (K.INT,) * 4 + (K.UINT,) * 2
             + (K.FLOAT, K.PTR))
_BWD_ARGS = ((K.INT,) + (K.PTR,) * 11 + (K.INT,) * 5 + (K.UINT,) * 2
             + (K.FLOAT, K.PTR))
ROW_CHUNK = 512          # rows per weight-gradient partial in the backward
# ffn.cu's row tiles per working dtype: (rows, padding elements per row)
_TILE = {torch.bfloat16: (64, 8), torch.float32: (32, 4)}
_RING = 2 * 64 * 80      # the least weight ring (ffn.cu Small): 2 x 64 x 80 B
_RED = 8 * 64            # column-sum slots (fp32) of the backward


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _tile_bytes(dtype: torch.dtype, cols: int) -> int:
    rows, pad = _TILE[dtype]
    return rows * (_pad16(cols) + pad) * dtype.itemsize


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm in fp32: (x - E[x]) * rsqrt(E[x^2] - E[x]^2 + eps)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    return (xf - mu) * torch.rsqrt(var + EPS) * weight + bias


def ffn_sublayer_plain(x, ln_w, ln_b, w1, b1, w2, b2, dropout_rate=0.0,
                       dropout_seed: int = 0) -> torch.Tensor:
    """(B, T, D) in x's dtype -> (B, T, D) in x's dtype."""
    dt = x.dtype

    def r(z):               # round to the working dtype, compute in fp32
        return z.to(dt).float()

    b, t, d = x.shape
    y = r(layer_norm(x, ln_w, ln_b))
    h = F.silu(y @ r(w1).t() + b1.float())
    if dropout_rate:
        scale = 1.0 / (1.0 - dropout_rate)
        keep1 = keep_mask(batch_streams(dropout_seed, b, scale=2, salt=0,
                                        device=x.device), t, h.shape[-1],
                          dropout_rate)
        h = torch.where(keep1, h * scale, torch.zeros_like(h))
    o = r(h) @ r(w2).t() + b2.float()
    if dropout_rate:
        keep2 = keep_mask(batch_streams(dropout_seed, b, scale=2, salt=1,
                                        device=x.device), t, d, dropout_rate)
        o = torch.where(keep2, o * scale, torch.zeros_like(o))
    return (x.float() + 0.5 * o).to(dt)


def fwd_smem(d: int, f: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory (bytes) of the forward kernel (ffn.cu fwd_smem): the
    LN and hidden row tiles and the least weight ring."""
    return _tile_bytes(dtype, d) + _tile_bytes(dtype, f) + _RING


def bwd_smem(d: int, f: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory (bytes) of the backward's row-tile kernel (ffn.cu
    bwd_smem): the y, do and dh1 tiles, the ring, the column-sum slots, the
    rows' LN statistics and output-mask streams."""
    return (2 * _tile_bytes(dtype, d) + _tile_bytes(dtype, f) + _RING
            + 4 * (_RED + 4 * _TILE[dtype][0]))


def bwd_workspace(dtype: torch.dtype, m: int, d: int, f: int) -> int:
    """Bytes of the backward's one workspace (ffn.cu bwd): y, do, hd and dh1
    in the working dtype, then the fp32 per-tile and per-row-chunk
    partials."""
    tiles = -(-m // _TILE[dtype][0])
    chunks = -(-m // ROW_CHUNK)
    return (2 * m * (_pad16(d) + _pad16(f)) * dtype.itemsize
            + 4 * (tiles * (3 * d + f) + chunks * 2 * f * d))


def ffn_refusal(dtype: torch.dtype, d: int, f: int,
                train: bool) -> Optional[str]:
    """Why the kernels would refuse D, d_ff and dtype: the forward's row
    tiles, and when `train` the backward's, must fit shared memory; None
    when they take it."""
    if dtype not in (torch.float32, torch.bfloat16):
        return f"fused_ffn_sublayer: unsupported dtype {dtype}"
    need = [("forward", fwd_smem(d, f, dtype), "use the plain version")]
    if train:
        need.append(("backward", bwd_smem(d, f, dtype),
                     "call it without gradients (eval) or use the plain "
                     "version"))
    for what, nbytes, hint in need:
        if nbytes > K.SMEM_LIMIT:
            return (f"fused_ffn_sublayer: D={d}, d_ff={f} needs {nbytes} B "
                    f"of shared memory in the {what} kernel "
                    f"(> {K.SMEM_LIMIT}); {hint}")
    return None


def _check(x, ln_w, w1, w2, train: bool):
    """Raise for shapes that do not match and for what the kernels do not
    take (`ffn_refusal`)."""
    d, f = x.shape[-1], w1.shape[0]
    if w1.shape != (f, d) or w2.shape != (d, f) or ln_w.shape != (d,):
        raise ValueError(f"fused_ffn_sublayer: shapes do not match x "
                         f"{tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}")
    why = ffn_refusal(x.dtype, d, f, train)
    if why:
        raise ValueError(why)


def _drop_args(rate: float, seed: int):
    thresh = threshold(rate) if rate else 0
    return int(seed) & 0xFFFFFFFF, thresh, 1.0 / (1.0 - rate) if rate else 1.0


@K.prepared
def _kernel_weights(w1: torch.Tensor, w2: torch.Tensor, dtype: torch.dtype):
    """(W1, W2, W1^T, W2^T) in `dtype`, zero-padded to multiples of 16:
    (Fp, Dp), (Dp, Fp), (Dp, Fp), (Fp, Dp), as ffn.cu reads them. Built
    once per weight version."""
    f, d = w1.shape
    fp, dp = _pad16(f), _pad16(d)

    def pad(w, rows, cols):
        out = torch.zeros(rows, cols, dtype=dtype, device=w.device)
        out[:w.shape[0], :w.shape[1]] = w
        return out

    w1p, w2p = pad(w1, fp, dp), pad(w2, dp, fp)
    return w1p, w2p, w1p.t().contiguous(), w2p.t().contiguous()


def _launch(x, ln_w, ln_b, w1, b1, w2, b2, rate, seed):
    """The forward kernel: (out, the tensors its backward reads)."""
    dt = x.dtype
    b, t, d = x.shape
    f = w1.shape[0]
    xc = x.contiguous()
    w1p, w2p = _kernel_weights(w1, w2, dt)[:2]
    vec = [z.float().contiguous() for z in (ln_w, ln_b, b1, b2)]
    out = torch.empty_like(xc)
    tensors = (xc, vec[0], vec[1], w1p, vec[2], w2p, vec[3], out)
    K.check_cuda("fused_ffn_sublayer", *tensors)
    K.call("tat_ffn_fwd", _FWD_ARGS, x.device, int(dt == torch.bfloat16),
           *(z.data_ptr() for z in tensors), b * t, t, d, f,
           *_drop_args(rate, seed))
    fused_ffn_sublayer.launches += 1
    return out, (xc, vec[0], vec[1], w1, vec[2], w2)


class _FFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, rate, seed):
        out, saved = _launch(x, ln_w, ln_b, w1, b1, w2, b2, rate, seed)
        ctx.rate, ctx.seed = rate, seed
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, g):
        xc, ln_w, ln_b, w1, b1, w2 = ctx.saved_tensors
        grads = fused_ffn_sublayer_bwd(xc, ln_w, ln_b, w1, b1, w2, g,
                                       ctx.rate, ctx.seed)
        return grads + (None, None)


def fused_ffn_sublayer_bwd(x, ln_w, ln_b, w1, b1, w2, g, dropout_rate=0.0,
                           dropout_seed: int = 0):
    """(dx, d ln_w, d ln_b, dw1, db1, dw2, db2) of the sublayer at x for the
    cotangent g: the row-tile kernel, the weight-gradient kernel and the
    fixed-order partial sums, one workspace. x in the working dtype, the
    vectors fp32; the gradients are fp32 views of one buffer."""
    dt = x.dtype
    b, t, d = x.shape
    f = w1.shape[0]
    m = b * t
    dev = x.device
    w1p, _, w1t, w2t = _kernel_weights(w1, w2, dt)
    gc = g.to(dt).contiguous()
    dx = torch.empty_like(x)
    work = torch.empty(bwd_workspace(dt, m, d, f), dtype=torch.uint8,
                       device=dev)
    grads = torch.empty(3 * d + f + 2 * f * d, device=dev)
    tensors = (x, gc, ln_w, ln_b, w1p, b1, w2t, w1t, dx, work, grads)
    K.check_cuda("fused_ffn_sublayer_bwd", *tensors)
    K.call("tat_ffn_bwd", _BWD_ARGS, dev, int(dt == torch.bfloat16),
           *(z.data_ptr() for z in tensors), m, t, d, f, ROW_CHUNK,
           *_drop_args(dropout_rate, dropout_seed))
    fused_ffn_sublayer_bwd.launches += 1
    ds, dsb, db2, db1, dw1, dw2 = grads.split((d, d, d, f, f * d, f * d))
    return dx, ds, dsb, dw1.view(f, d), db1, dw2.view(d, f), db2


def fused_ffn_sublayer(x: torch.Tensor, ln_w, ln_b, w1, b1, w2, b2,
                       dropout_rate: float = 0.0,
                       dropout_seed: int = 0) -> torch.Tensor:
    """Same contract as `ffn_sublayer_plain`. On the card, a shape the
    forward kernel does not take raises, and so does one whose backward
    autograd would need and the backward kernel does not take
    (`ffn_refusal`), before anything launches. Traced without gradients or
    dropout, it records the custom op `tpu_asr_torch::ffn_sublayer`."""
    if K.plain_on_cpu(x):
        return ffn_sublayer_plain(x, ln_w, ln_b, w1, b1, w2, b2,
                                  dropout_rate, dropout_seed)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_ffn_sublayer: unsupported device {x.device}")
    args = (x, ln_w, ln_b, w1, b1, w2, b2)
    train = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    _check(x, ln_w, w1, w2, train)
    if K.tracing(x) and not train and not dropout_rate:
        return ffn_op(*args)
    return _FFN.apply(x, ln_w, ln_b, w1, b1, w2, b2, float(dropout_rate),
                      int(dropout_seed))


_FFN_SCHEMA = ("(Tensor x, Tensor ln_w, Tensor ln_b, Tensor w1, Tensor b1, "
               "Tensor w2, Tensor b2) -> Tensor")


@K.custom_op("ffn_sublayer", _FFN_SCHEMA, lambda x, *_: torch.empty_like(x))
def ffn_op(x, ln_w, ln_b, w1, b1, w2, b2):
    """`tpu_asr_torch::ffn_sublayer`, the eval forward (no dropout): the
    kernel on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return ffn_sublayer_plain(x, ln_w, ln_b, w1, b1, w2, b2)
    return _launch(x, ln_w, ln_b, w1, b1, w2, b2, 0.0, 0)[0]


fused_ffn_sublayer.launches = 0
fused_ffn_sublayer_bwd.launches = 0


def _act_quant(y: torch.Tensor):
    """The kernel's per-token quantization: (y_q as float, scale (..., 1))."""
    s = torch.clamp(y.abs().amax(dim=-1, keepdim=True),
                    min=1e-8 * 127.0) * (1.0 / 127.0)
    return torch.clamp(torch.round(y * (1.0 / s)), -127, 127), s


def ffn_sublayer_int8_plain(x, ln_w, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """(B, T, D) in x's dtype -> (B, T, D) in x's dtype, int8 products."""
    w1q, s1 = quantize_weight(w1)
    w2q, s2 = quantize_weight(w2)
    yq, sx = _act_quant(layer_norm(x, ln_w, ln_b))
    h = int8_matmul(yq, w1q).float() * sx * s1[:, 0] + b1.float()
    h = h * torch.sigmoid(h)
    hq, sh = _act_quant(h)
    o = int8_matmul(hq, w2q).float() * sh * s2[:, 0] + b2.float()
    return (x.float() + 0.5 * o).to(x.dtype)


@K.prepared
def _int8_weights(ln_w, ln_b, w1, b1, w2, b2):
    """What ffn_int8.cu reads besides x: the LN scale and bias, W1q
    (d_ff, pad32(D)) int8 zero past D, s1, b1, W2q (D, pad32(d_ff)) int8
    zero past d_ff, s2 and b2 (the vectors fp32). Built once per weight
    version."""
    pad = lambda q: F.pad(q, (0, -q.shape[1] % 32)).contiguous()
    vec = lambda z: z.float().contiguous()
    w1q, s1 = quantize_weight(w1)
    w2q, s2 = quantize_weight(w2)
    return (vec(ln_w), vec(ln_b), pad(w1q), vec(s1[:, 0]), vec(b1), pad(w2q),
            vec(s2[:, 0]), vec(b2))


def fused_ffn_sublayer_int8(x: torch.Tensor, ln_w, ln_b, w1, b1, w2,
                            b2) -> torch.Tensor:
    """Same contract as `ffn_sublayer_int8_plain`; raises when autograd
    would need its gradient. The kernel takes any number of rows (B x T),
    a streaming chunk's few frames too. Traced, it records the custom op
    `tpu_asr_torch::ffn_sublayer_int8`."""
    args = (x, ln_w, ln_b, w1, b1, w2, b2)
    K.refuse_grad("fused_ffn_sublayer_int8", *args)
    if K.plain_on_cpu(x):
        return ffn_sublayer_int8_plain(*args)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_ffn_sublayer_int8: unsupported device "
                         f"{x.device}")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_ffn_sublayer_int8: unsupported dtype {dt}")
    d, f = x.shape[-1], w1.shape[0]
    if not (0 < d <= INT8_MAX_D and 0 < f <= INT8_MAX_F) \
            or w1.shape != (f, d) or w2.shape != (d, f) \
            or ln_w.shape != (d,) or b1.shape != (f,) or b2.shape != (d,):
        raise ValueError(
            f"fused_ffn_sublayer_int8: shapes do not match x "
            f"{tuple(x.shape)} (D <= {INT8_MAX_D}), w1 {tuple(w1.shape)} "
            f"(d_ff <= {INT8_MAX_F}), w2 {tuple(w2.shape)}")
    return ffn_int8_op(*args) if K.tracing(x) else _launch_int8(*args)


def _launch_int8(x, ln_w, ln_b, w1, b1, w2, b2):
    d, f = x.shape[-1], w1.shape[0]
    xc = x.contiguous()
    out = torch.empty_like(xc)
    tensors = (xc, *_int8_weights(ln_w, ln_b, w1, b1, w2, b2), out)
    K.check_cuda("fused_ffn_sublayer_int8", *tensors)
    K.call("tat_ffn_int8", _INT8_ARGS, x.device,
           int(x.dtype == torch.bfloat16),
           *(z.data_ptr() for z in tensors), xc.numel() // d, d, f)
    fused_ffn_sublayer_int8.launches += 1
    return out


@K.custom_op("ffn_sublayer_int8", _FFN_SCHEMA,
             lambda x, *_: torch.empty_like(x))
def ffn_int8_op(x, ln_w, ln_b, w1, b1, w2, b2):
    """`tpu_asr_torch::ffn_sublayer_int8`: the kernel on CUDA tensors, the
    plain version on CPU ones."""
    if x.device.type == "cpu":
        return ffn_sublayer_int8_plain(x, ln_w, ln_b, w1, b1, w2, b2)
    return _launch_int8(x, ln_w, ln_b, w1, b1, w2, b2)


fused_ffn_sublayer_int8.launches = 0
