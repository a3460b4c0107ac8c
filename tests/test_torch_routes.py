"""The port's kernel routes resolve as the JAX package's do, on the CPU.

- 'auto' takes the kernel wrapper only where the kernel's own pre-launch
  check (the wrapper's refusal predicate) takes the shape, and the plain
  version elsewhere, as JAX's 'auto' falls back to XLA (`fused_ok`,
  `ffn_train_kernel_fits`, `resolve_euler_backend`); 'pallas' raises on a
  refused shape; 'xla' is always plain. Cases: subsampling (C % 8, C above
  its limit), the block attention (dk 132, past its dk <= 128; and in
  training T = 1100, past
  the fp32 backward's shared memory, which the bf16 backward takes), the
  training FFN (d320/1280, whose forward fits shared memory and whose
  backward does not: refused only under autograd; d512/2048, where the
  forward does not fit either and JAX's `ffn_train_kernel_fits` refuses
  too; d88 to d256 agree with it),
  the FM loop (C=520, past the kernels' 512; max_steps 0; hidden_dim 48,
  not H % 32 == 0, in fp32: the kernels take any C % 8 == 0 and H % 32
  == 0 up to 512 and any step count, in fp32 and bf16 alike)
  and the log-mel frontend (n_fft 402 and 4096 refused; 512 takes the FFT
  kernel, 400 the DFT kernel), each beside a shape the kernel takes.
- The forward passes follow the resolution: with the kernel wrapper
  replaced by one that records its calls, a refused shape under 'auto'
  runs the plain version and a flagship shape calls the wrapper.
- The kernel-layout weight copies (`_kernels.prepared`) are built once per
  weight version: reused while the weights stand, rebuilt after an
  in-place update and after a dtype change (subsampling, block attention,
  FFN, the int8 FFN, the conv module and its folded BatchNorm, which is
  rebuilt after a change of its running statistics).
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import pytest
import torch

from tpu_asr_torch.config import (EncoderConfig, FlowMatchingConfig,
                                  PreprocessorConfig)
from tpu_asr_torch.kd import flow_matching
from tpu_asr_torch.kd.flow_matching import FlowMatchingModule
from tpu_asr_torch.models import conformer
from tpu_asr_torch.models.conformer import (ConformerLayer, ConvSubsampling,
                                            RelPositionMultiHeadAttention)
from tpu_asr_torch.ops import (cuda_attention, cuda_features,
                               cuda_subsampling, features)
from tpu_asr_torch.ops.features import FilterbankFeatures


def _subsampling(backend, c):
    return ConvSubsampling(EncoderConfig(
        feat_in=80, d_model=16, subsampling_conv_channels=c,
        subsampling_backend=backend))


def _attention(backend, d, h):
    return RelPositionMultiHeadAttention(d, h, backend)


def _layer(backend, d):
    return ConformerLayer(EncoderConfig(d_model=d, n_heads=2,
                                        ffn_backend=backend))


def _fm(backend, c, hidden=128, dtype=torch.float32):
    return FlowMatchingModule(FlowMatchingConfig(student_dim=c,
                                                 hidden_dim=hidden,
                                                 euler_backend=backend),
                              dtype)


def _route(kind, backend, shape):
    """Whether the route takes the kernel wrapper for `shape`."""
    if kind == "logmel":
        return FilterbankFeatures(PreprocessorConfig(n_fft=shape),
                                  backend).uses_kernel()
    if kind == "attention_train":
        dt, t = shape
        return _attention(backend, 88, 2).to(dt).uses_kernel(
            torch.zeros(2, t, 88, dtype=dt))
    if kind == "subsampling":
        return _subsampling(backend, shape).uses_kernel(torch.zeros(1, 9, 80))
    if kind == "attention":
        d, h = shape
        with torch.no_grad():
            return _attention(backend, d, h).uses_kernel(
                torch.zeros(2, 5, d))
    if kind == "ffn_train":
        layer = _layer(backend, shape)
        x = torch.zeros(2, 5, shape, requires_grad=True)
        return layer.ffn_train_uses_kernel(x, layer.feed_forward1)
    c, max_steps, *hidden_dtype = shape
    fm = _fm(backend, c, *hidden_dtype)
    return fm.uses_kernel(fm.euler_weights()[0], max_steps)


# (route, a shape its kernel refuses, the flagship shape it takes)
CASES = [
    ("subsampling", 12, 176),
    ("subsampling", 1032, 88),
    ("attention", (264, 2), (176, 4)),       # dk 132 / 44
    ("ffn_train", 320, 176),                 # backward's tiles > 227 KB
    ("ffn_train", 512, 176),                 # forward's tiles > 227 KB
    ("fm", (520, 8), (88, 8)),
    ("fm", (88, 0), (88, 16)),
    ("attention_train", (torch.float32, 1100), (torch.bfloat16, 1100)),
    ("logmel", 402, 512),
    ("logmel", 4096, 400),
    ("fm", (64, 8, 48, torch.float32), (64, 8, 64, torch.float32)),
]


def test_logmel_routes_name_their_kernel():
    route = cuda_features.logmel_route
    assert route(512, 160, 257) == "fft" and route(2048, 160, 1025) == "fft"
    assert route(400, 160, 201) == "dft" and route(128, 160, 64) == "dft"
    assert route(402, 160, 202) is None and route(4096, 160, 2049) is None


@pytest.mark.parametrize("kind,refused,flagship", CASES)
def test_auto_takes_the_kernel_only_where_it_fits(kind, refused, flagship):
    assert _route(kind, "auto", flagship) is True
    assert _route(kind, "auto", refused) is False
    assert _route(kind, "xla", flagship) is False


@pytest.mark.parametrize("kind,refused,flagship", CASES)
def test_pallas_raises_where_the_kernel_refuses(kind, refused, flagship):
    assert _route(kind, "pallas", flagship) is True
    with pytest.raises(ValueError):
        _route(kind, "pallas", refused)


def test_ffn_route_takes_the_kernel_without_gradients():
    """Without autograd the FFN backward's limit does not count: d320/1280
    is refused under autograd (the backward's tiles), taken without."""
    layer = _layer("auto", 320)
    x = torch.zeros(2, 5, 320, requires_grad=True)
    assert not layer.ffn_train_uses_kernel(x, layer.feed_forward1)
    with torch.no_grad():
        assert layer.ffn_train_uses_kernel(x, layer.feed_forward1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,f", [(88, 352), (176, 704), (256, 1024),
                                 (512, 2048)])
def test_ffn_train_gate_agrees_with_jax(d, f, dtype):
    """The training FFN kernels take a width exactly where JAX's 'auto'
    gate `ffn_train_kernel_fits` does at B=32 x 15 s (T'=376)."""
    from tpu_asr.ops.pallas_ffn import ffn_train_kernel_fits
    from tpu_asr_torch.ops.cuda_ffn import ffn_refusal
    assert (ffn_refusal(dtype, d, f, train=True) is None) == \
        ffn_train_kernel_fits(32, 376, d, f)


class _Recorder:
    def __init__(self, plain):
        self.plain, self.calls = plain, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.plain(*args, **kw)


@pytest.mark.parametrize("kind", ["subsampling", "attention", "ffn_train",
                                  "fm", "logmel"])
def test_forward_follows_the_route(kind, monkeypatch):
    torch.manual_seed(0)
    if kind == "subsampling":
        rec = _Recorder(cuda_subsampling.subsampling_plain)
        monkeypatch.setattr(conformer, "fused_subsampling", rec)
        run = lambda c: _subsampling("auto", c)(torch.randn(1, 9, 80))
        shapes = (12, 16)
    elif kind == "attention":
        rec = _Recorder(
            lambda *a, dropout_rate, dropout_seed, seg_id, att_context_size,
            heads: cuda_attention.relpos_attention_plain(
                *a, dropout_rate, dropout_seed, seg_id, att_context_size,
                heads))
        monkeypatch.setattr(conformer, "fused_relpos_attention_block", rec)

        def run(dh):
            d, h = dh
            t = 5
            with torch.no_grad():
                return _attention("auto", d, h)(
                    torch.randn(2, t, d),
                    conformer.rel_positional_encoding(t, d),
                    torch.ones(2, t, dtype=torch.bool))
        shapes = ((264, 2), (176, 4))
    elif kind == "ffn_train":
        rec = _Recorder(conformer.ffn_sublayer_plain)
        monkeypatch.setattr(conformer, "fused_ffn_sublayer", rec)

        def run(d):
            layer = _layer("auto", d)
            x = torch.randn(2, 5, d, requires_grad=True)
            return layer._ffn(layer.norm_feed_forward1, layer.feed_forward1,
                              x, 3)
        shapes = (320, 176)
    elif kind == "logmel":
        rec = _Recorder(cuda_features.logmel_plain)
        monkeypatch.setattr(features, "fused_logmel", rec)

        def run(n_fft):
            return FilterbankFeatures(PreprocessorConfig(n_fft=n_fft))(
                torch.randn(1, 4000), torch.tensor([4000]))
        shapes = (402, 512)
    else:
        rec = _Recorder(flow_matching.fm_euler_plain)
        monkeypatch.setattr(flow_matching, "fused_fm_euler", rec)

        def run(c):
            with torch.no_grad():
                return _fm("auto", c)(torch.randn(2, 5, c))
        shapes = (520, 88)
    run(shapes[0])
    assert rec.calls == 0
    run(shapes[1])
    assert rec.calls == 1


def test_prepared_weights_rebuild_on_update_and_dtype():
    torch.manual_seed(1)
    mod = _subsampling("auto", 16)
    ws = lambda dt: cuda_subsampling._kernel_weights(
        mod.conv[0].weight, mod.conv[0].bias, mod.conv[2].weight,
        mod.conv[2].bias, mod.out.weight, dt)
    first = ws(torch.bfloat16)
    assert all(a is b for a, b in zip(first, ws(torch.bfloat16)))
    with torch.inference_mode():
        again = ws(torch.bfloat16)
    assert all(a is b for a, b in zip(first, again))
    # the out-Linear weight in (f, c) order: column f * C + c holds c F2 + f
    f2 = mod.out.weight.shape[1] // 16
    want = mod.out.weight.view(-1, 16, f2).transpose(1, 2).reshape(
        -1, 16 * f2).to(torch.bfloat16)
    assert torch.equal(first[4], want)

    with torch.no_grad():                       # an optimizer step
        mod.conv[2].weight.add_(1.0)
    updated = ws(torch.bfloat16)
    assert updated[2] is not first[2]
    assert torch.equal(updated[2].float(), mod.conv[2].weight.permute(
        0, 2, 3, 1).reshape(16, -1).to(torch.bfloat16).float())

    mod.to(torch.float64)                       # the parameters' dtype
    moved = ws(torch.bfloat16)
    assert moved[2] is not updated[2] and moved[2].dtype == torch.bfloat16
    assert torch.equal(moved[2], updated[2])
    assert not moved[2].is_inference()


def test_prepared_attention_weights_rebuild_on_update():
    torch.manual_seed(2)
    att = _attention("auto", 16, 2)
    args = lambda: (att.linear_q.weight, att.linear_k.weight,
                    att.linear_v.weight, att.linear_pos.weight,
                    att.linear_out.weight, att.linear_q.bias, att.pos_bias_u,
                    att.pos_bias_v, att.linear_k.bias, att.linear_v.bias,
                    torch.bfloat16)
    first = cuda_attention._block_weights(*args())
    assert all(a is b for a, b in
               zip(first, cuda_attention._block_weights(*args())))
    torch.testing.assert_close(
        first[5], att.linear_q.bias + att.pos_bias_u.reshape(16))
    with torch.no_grad():
        att.pos_bias_u.add_(0.5)
    again = cuda_attention._block_weights(*args())
    assert again[5] is not first[5]
    torch.testing.assert_close(
        again[5], att.linear_q.bias + att.pos_bias_u.reshape(16))


def test_prepared_ffn_weights_rebuild_on_update():
    """The FFN kernels' padded W1, W2, W1^T, W2^T in the working dtype:
    built once per weight version, anew after an in-place update."""
    from tpu_asr_torch.ops import cuda_ffn
    torch.manual_seed(3)
    ff = conformer.FeedForward(20, 72)
    w1, w2 = ff.linear1.weight, ff.linear2.weight
    first = cuda_ffn._kernel_weights(w1, w2, torch.bfloat16)
    assert all(a is b for a, b in zip(
        first, cuda_ffn._kernel_weights(w1, w2, torch.bfloat16)))
    assert [tuple(a.shape) for a in first] == [(80, 32), (32, 80), (32, 80),
                                               (80, 32)]
    w1p, w2p, w1t, w2t = first
    assert torch.equal(w1p[:72, :20], w1.to(torch.bfloat16))
    assert torch.equal(w2t[:72, :20], w2.t().to(torch.bfloat16))
    assert torch.equal(w1t[:20, :72], w1.t().to(torch.bfloat16))
    assert w1p[72:].abs().sum() == 0 and w1p[:, 20:].abs().sum() == 0
    with torch.no_grad():                       # an optimizer step
        w2.add_(0.5)
    again = cuda_ffn._kernel_weights(w1, w2, torch.bfloat16)
    assert again[1] is not first[1]
    assert torch.equal(again[1][:20, :72], w2.to(torch.bfloat16))
    assert torch.equal(again[3][:72, :20], w2.t().to(torch.bfloat16))
    fp32 = cuda_ffn._kernel_weights(w1, w2, torch.float32)
    assert fp32[0].dtype == torch.float32 and fp32[0] is not again[0]


def test_prepared_int8_weights_rebuild_on_update():
    """The int8 FFN kernel's quantized, padded weights and fp32 vectors:
    built once per weight version, anew after an in-place update."""
    from tpu_asr_torch.ops import cuda_ffn
    from tpu_asr_torch.ops.quant import quantize_weight
    torch.manual_seed(4)
    ff, ln = conformer.FeedForward(20, 72), torch.nn.LayerNorm(20)
    args = (ln.weight, ln.bias, ff.linear1.weight, ff.linear1.bias,
            ff.linear2.weight, ff.linear2.bias)
    first = cuda_ffn._int8_weights(*args)
    assert all(a is b for a, b in zip(first, cuda_ffn._int8_weights(*args)))
    with torch.inference_mode():
        again = cuda_ffn._int8_weights(*args)
    assert all(a is b for a, b in zip(first, again))
    w1q, s1 = quantize_weight(ff.linear1.weight)
    assert [tuple(a.shape) for a in first] == [(20,), (20,), (72, 32), (72,),
                                               (72,), (20, 96), (20,), (20,)]
    assert first[2].dtype == torch.int8 and all(
        first[i].dtype == torch.float32 for i in (0, 1, 3, 4, 6, 7))
    assert torch.equal(first[2][:, :20], w1q) and first[2][:, 20:].eq(0).all()
    assert torch.equal(first[3], s1[:, 0])
    with torch.no_grad():                       # an optimizer step
        ff.linear2.weight.mul_(2.0)
    updated = cuda_ffn._int8_weights(*args)
    assert updated[5] is not first[5] and updated[2] is not first[2]
    w2q, s2 = quantize_weight(ff.linear2.weight)
    assert torch.equal(updated[5][:, :72], w2q)
    assert torch.equal(updated[6], s2[:, 0])


def test_prepared_conv_weights_rebuild_on_update():
    """The conv kernel's weights in its layout (bf16: W1's rows interleaved
    by 8 channels, linear then gate, zero-padded) and the folded
    BatchNorm: built once per version, anew after an in-place update of a
    weight and of the running variance."""
    from tpu_asr_torch.ops import cuda_conv
    torch.manual_seed(5)
    mod = conformer.ConformerConvolution(EncoderConfig(
        d_model=20, conv_kernel_size=5, conv_backend="pallas")).eval()
    pw1, dw, pw2 = mod.pointwise_conv1, mod.depthwise_conv, mod.pointwise_conv2
    ws = lambda dt: cuda_conv._kernel_weights(
        pw1.weight, pw1.bias, dw.weight, dw.bias, pw2.weight, pw2.bias, dt)
    first = ws(torch.bfloat16)
    assert all(a is b for a, b in zip(first, ws(torch.bfloat16)))
    w1i, b1, wd, bd, w2p, b2 = first
    assert tuple(w1i.shape) == (48, 32) and tuple(w2p.shape) == (20, 32)
    w1 = pw1.weight[..., 0].to(torch.bfloat16)
    for q in range(3):                          # channels 8q .. 8q + 7
        n = min(8, 20 - 8 * q)
        assert torch.equal(w1i[16 * q:16 * q + n, :20], w1[8 * q:8 * q + n])
        assert torch.equal(w1i[16 * q + 8:16 * q + 8 + n, :20],
                           w1[20 + 8 * q:20 + 8 * q + n])
    assert w1i[:, 20:].eq(0).all() and w1i[36:40].eq(0).all()
    assert torch.equal(w2p[:, :20], pw2.weight[..., 0].to(torch.bfloat16))
    assert torch.equal(wd, dw.weight[:, 0].t())
    fp32 = ws(torch.float32)
    assert torch.equal(fp32[0], pw1.weight[..., 0]) and fp32[0] is not w1i
    with torch.no_grad():
        pw2.weight.add_(0.5)
    updated = ws(torch.bfloat16)
    assert updated[4] is not w2p
    assert torch.equal(updated[4][:, :20],
                       pw2.weight[..., 0].to(torch.bfloat16))

    bn = mod.batch_norm
    fold = lambda: conformer._prepared_fold(bn.weight, bn.bias,
                                            bn.running_mean, bn.running_var,
                                            bn.eps)
    nw, nb = fold()
    assert all(a is b for a, b in zip((nw, nb), fold()))
    with torch.no_grad():                       # commit() of new statistics
        bn.running_var.mul_(2.0)
    nw2, nb2 = fold()
    assert nw2 is not nw
    torch.testing.assert_close(nw2, bn.weight * torch.rsqrt(
        bn.running_var + bn.eps), rtol=0, atol=0)
    torch.testing.assert_close((nw2, nb2), tuple(bn.folded()), rtol=0,
                               atol=0)


@pytest.mark.parametrize("t", [1024, 1025, 4000])
def test_attention_backward_limit_follows_the_dtype(t):
    """The fp32 backward keeps a T-long window in shared memory (T <= 1024
    at dk 44); the bf16 backward streams it, so no T is refused."""
    refusal = cuda_attention.attention_refusal
    assert (refusal(torch.float32, 88, 2, t, True) is None) == (t <= 1024)
    assert refusal(torch.float32, 88, 2, t, False) is None
    assert refusal(torch.bfloat16, 88, 2, t, True) is None
