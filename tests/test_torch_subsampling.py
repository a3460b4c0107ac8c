"""Port parity: striding x4 ConvSubsampling of tpu_asr_torch against the JAX
package on the CPU, inputs made with numpy from a seed.

- the module (plain version of the CUDA kernel) against JAX ConvSubsampling
  under subsampling_backend='xla', fp32, rtol/atol 1e-4;
- the plain version in bf16 against the Pallas kernel in interpret mode,
  rtol 0.05 and atol 0.03 * max(1, |ref|max) (the precedent of
  tests/test_pallas_subsampling.py);
- at the student's C = 88: the wrapper's gradients (its backward
  recomputes the plain version) against jax.vjp of the JAX module, fp32,
  1e-4 x max(1, |ref|max), and the wrapper refuses what the kernel does
  not take (C % 8 != 0, C above its limit, F/4 above 80).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.config import EncoderConfig
from tpu_asr.models.conformer import ConvSubsampling as JaxSubsampling
from tpu_asr.models.conformer import \
    subsampled_length as jax_subsampled_length
from tpu_asr.ops.pallas_subsampling import \
    fused_subsampling as pallas_subsampling
from tpu_asr_torch.models.conformer import ConvSubsampling, subsampled_length
from tpu_asr_torch.ops import cuda_subsampling
from tpu_asr_torch.ops.cuda_subsampling import (fused_subsampling, out_len,
                                                subsampling_plain)


def _jax_params(rng, c, d, f2):
    mk = lambda s, sc: rng.normal(size=s).astype(np.float32) * sc
    return {"conv0": {"kernel": mk((3, 3, 1, c), 0.3), "bias": mk((c,), 0.1)},
            "conv1": {"kernel": mk((3, 3, c, c), 0.08), "bias": mk((c,), 0.1)},
            "out": {"kernel": mk((c * f2, d), 0.05), "bias": mk((d,), 0.1)}}


def _torch_weights(p):
    """JAX HWIO convs and (in, out) Dense -> NeMo (out, in, kh, kw) and
    (out, in)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(p["conv0"]["kernel"].transpose(3, 2, 0, 1)),
            t(p["conv0"]["bias"]),
            t(p["conv1"]["kernel"].transpose(3, 2, 0, 1)),
            t(p["conv1"]["bias"]), t(p["out"]["kernel"].T))


@pytest.mark.parametrize("b,t0,f0,c,d", [
    (2, 61, 80, 16, 24),      # ragged T, C != D
    (1, 150, 80, 176, 176),   # flagship widths
    (2, 37, 64, 8, 16),       # other mel count
    (1, 21, 80, 512, 512),    # conformer-LARGE widths
])
def test_module_matches_jax_xla(b, t0, f0, c, d):
    rng = np.random.default_rng(0)
    cfg = EncoderConfig(feat_in=f0, d_model=d, subsampling_conv_channels=c,
                        subsampling_backend="xla")
    p = _jax_params(rng, c, d, out_len(out_len(f0)))
    x = rng.normal(size=(b, t0, f0)).astype(np.float32)
    want = np.asarray(JaxSubsampling(cfg).apply({"params": p},
                                                jnp.asarray(x)))
    mod = ConvSubsampling(dataclasses.replace(cfg, subsampling_backend="auto"))
    w1, b1, w2, b2, w_out = _torch_weights(p)
    mod.load_state_dict({"conv.0.weight": w1, "conv.0.bias": b1,
                         "conv.2.weight": w2, "conv.2.bias": b2,
                         "out.weight": w_out,
                         "out.bias": torch.from_numpy(p["out"]["bias"])})
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (b, out_len(out_len(t0)), d)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,t0,c,d", [(2, 61, 16, 24), (1, 125, 8, 8)])
def test_plain_bf16_matches_pallas_interpret(b, t0, c, d):
    rng = np.random.default_rng(1)
    f2 = 20
    p = _jax_params(rng, c, d, f2)
    p["conv0"]["bias"] = p["conv0"]["bias"] + 2.0    # ReLU(b1) pad-leak probe
    x = (rng.normal(size=(b, t0, 80)) * 0.5).astype(np.float32)
    # the kernel takes the out-Linear rows f-major: (F2 * C, D)
    w_fc = p["out"]["kernel"].reshape(c, f2, d).transpose(1, 0, 2).reshape(
        f2 * c, d)
    want = np.asarray(pallas_subsampling(
        jnp.asarray(x), jnp.asarray(p["conv0"]["kernel"]),
        jnp.asarray(p["conv0"]["bias"]), jnp.asarray(p["conv1"]["kernel"]),
        jnp.asarray(p["conv1"]["bias"]), jnp.asarray(w_fc), interpret=True),
        np.float32)
    got = subsampling_plain(torch.from_numpy(x).to(torch.bfloat16),
                            *_torch_weights(p))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0.05,
                               atol=0.03 * max(1.0, np.abs(want).max()))


def test_subsampled_length_matches_jax():
    n = np.arange(0, 400, dtype=np.int32)
    want = np.asarray(jax_subsampled_length(jnp.asarray(n), 4, "striding"))
    np.testing.assert_array_equal(subsampled_length(torch.from_numpy(n)),
                                  want)
    assert [out_len(out_len(int(v))) for v in n[1:]] == list(want[1:])


def test_wrapper_runs_plain_on_cpu_and_checks_device():
    rng = np.random.default_rng(2)
    w = _torch_weights(_jax_params(rng, 8, 8, 20))
    x = torch.from_numpy(rng.normal(size=(1, 40, 80)).astype(np.float32))
    torch.testing.assert_close(fused_subsampling(x, *w),
                               subsampling_plain(x, *w), rtol=0, atol=0)
    assert fused_subsampling.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        fused_subsampling(x.to("meta"), *w)


def test_student_width_gradients_match_jax():
    """C = D = 88 (make_student_config): values and VJP in fp32."""
    rng = np.random.default_rng(4)
    c = d = 88
    cfg = EncoderConfig(feat_in=80, d_model=d, subsampling_conv_channels=c,
                        subsampling_backend="xla")
    p = _jax_params(rng, c, d, 20)
    x = rng.normal(size=(2, 45, 80)).astype(np.float32)
    g = rng.normal(size=(2, 12, d)).astype(np.float32)
    want, vjp = jax.vjp(lambda pp, xx: JaxSubsampling(cfg).apply(
        {"params": pp}, xx), jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(g))
    mod = ConvSubsampling(dataclasses.replace(cfg, subsampling_backend="auto"))
    w1, b1, w2, b2, w_out = _torch_weights(p)
    mod.load_state_dict({"conv.0.weight": w1, "conv.0.bias": b1,
                         "conv.2.weight": w2, "conv.2.bias": b2,
                         "out.weight": w_out,
                         "out.bias": torch.from_numpy(p["out"]["bias"])})
    xt = torch.tensor(x, requires_grad=True)
    got = mod(xt)
    got.backward(torch.from_numpy(g))
    close = lambda a, w: np.testing.assert_allclose(
        a, w, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(w).max()))
    close(got.detach().numpy(), np.asarray(want))
    close(xt.grad.numpy(), np.asarray(want_x))
    close(mod.conv[0].weight.grad.numpy(),
          np.asarray(want_p["conv0"]["kernel"]).transpose(3, 2, 0, 1))
    close(mod.conv[2].weight.grad.numpy(),
          np.asarray(want_p["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    close(mod.conv[0].bias.grad.numpy(), np.asarray(want_p["conv0"]["bias"]))
    close(mod.conv[2].bias.grad.numpy(), np.asarray(want_p["conv1"]["bias"]))
    close(mod.out.weight.grad.numpy(), np.asarray(want_p["out"]["kernel"]).T)
    close(mod.out.bias.grad.numpy(), np.asarray(want_p["out"]["bias"]))


@pytest.mark.parametrize("c,f0", [
    (12, 80),                 # C % 8 != 0
    (1032, 80),               # C above MAX_CHANNELS
    (16, 328),                # F/4 = 82 > MAX_F2
])
def test_wrapper_refuses_other_channel_counts(c, f0):
    f2 = out_len(out_len(f0))
    meta = lambda *s: torch.empty(s, device="meta")
    w = (meta(c, 1, 3, 3), meta(c), meta(c, c, 3, 3), meta(c),
         meta(16, c * f2))
    x = meta(1, 9, f0)
    assert cuda_subsampling.subsampling_refusal(torch.float32, c, f2)
    # the check the wrapper makes for a CUDA tensor, before any launch
    with pytest.raises(ValueError, match="the kernel takes C % 8 == 0"):
        cuda_subsampling._launch(x, *w)
