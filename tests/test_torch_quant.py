"""Port parity for int8 serving: tpu_asr_torch/ops/quant.py, the plain
version of the int8 FFN kernel and the int8 CTCModel against the JAX
package on the CPU, inputs made with numpy from a seed.

- quantize_weight / quantize_activation: int8 values equal to JAX's, scales
  within 1 ulp; int8_dense at 1e-6 (the same exact integer sums);
- ffn_sublayer_int8_plain against fused_ffn_sublayer_int8 in interpret
  mode: fp32 at D=176 / d_ff=704 and at D=64 within 2e-4 (the kernel and
  the plain version take the same quantization decisions; only the order
  of the LN sums differs, about 1e-6), bf16 with odd T within 2e-2;
- a 2-layer d64 CTCModel with quantization='int8' in eval against the JAX
  model of the same config (whose CPU path is the XLA int8_dense chain):
  max |delta log-prob| < 1e-3 and under a tenth of the int8-vs-fp drift of
  the same weights, which must be > 0;
- training never sees the quantizer: the training forward with
  quantization='int8' is bit-identical to 'none';
- the wrapper runs the plain version on the CPU, launches nothing and
  refuses to run under autograd.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.config import DecoderConfig, EncoderConfig, ModelConfig
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr.ops.pallas_ffn import fused_ffn_sublayer_int8 as pallas_int8
from tpu_asr.ops.quant import int8_dense as jax_int8_dense
from tpu_asr.ops.quant import quantize_activation as jax_quantize_activation
from tpu_asr.ops.quant import quantize_weight as jax_quantize_weight
from tpu_asr_torch.convert.from_jax import jax_to_state_dict
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.ops.cuda_ffn import (ffn_sublayer_int8_plain,
                                        fused_ffn_sublayer_int8)
from tpu_asr_torch.ops.quant import (int8_dense, quantize_activation,
                                     quantize_weight)
from tpu_asr_torch.train.trainer import step_rngs


def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 48)).astype(np.float32)      # JAX (K, N)
    w[:, 5] = 0.0                                          # the 1e-8 floor
    wq_j, s_j = jax_quantize_weight(jnp.asarray(w))
    wq, s = quantize_weight(torch.from_numpy(w.T.copy()))  # port (N, K)
    assert wq.dtype == torch.int8 and s.shape == (48, 1)
    np.testing.assert_array_equal(wq.numpy().T, np.asarray(wq_j))
    np.testing.assert_array_max_ulp(s.numpy()[:, 0], np.asarray(s_j)[0],
                                    maxulp=1)


def test_quantize_activation_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 37, 96)).astype(np.float32)
    x[1, 3] *= 1e3
    xq_j, s_j = jax_quantize_activation(jnp.asarray(x))
    xq, s = quantize_activation(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_j))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(s_j), maxulp=1)


@pytest.mark.parametrize("bias", [True, False])
def test_int8_dense_matches_jax(bias):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 37, 96)).astype(np.float32)
    w = (rng.normal(size=(96, 64)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(64,)) * 0.1).astype(np.float32) if bias else None
    want = jax_int8_dense(jnp.asarray(x), jnp.asarray(w),
                          None if b is None else jnp.asarray(b))
    got = int8_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                     None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _ffn_params(rng, d, f):
    mk = lambda *s, sc=0.1: rng.normal(size=s).astype(np.float32) * sc
    return dict(s=1.0 + mk(d), sb=mk(d), w1=mk(d, f), b1=mk(f), w2=mk(f, d),
                b2=mk(d))


def _port_args(p):
    """JAX (in, out) kernels -> PyTorch Linear (out, in) weights."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return [t(p["s"]), t(p["sb"]), t(p["w1"].T), t(p["b1"]), t(p["w2"].T),
            t(p["b2"])]


def _pallas(x, p):
    j = jnp.asarray
    return pallas_int8(x, j(p["s"]), j(p["sb"]), j(p["w1"]), j(p["b1"]),
                       j(p["w2"]), j(p["b2"]), interpret=True)


@pytest.mark.parametrize("b,t,d,f", [(2, 61, 176, 704), (3, 50, 64, 256)])
def test_plain_fp32_matches_pallas_interpret(b, t, d, f):
    rng = np.random.default_rng(3)
    p = _ffn_params(rng, d, f)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    want = np.asarray(_pallas(jnp.asarray(x), p))
    got = ffn_sublayer_int8_plain(torch.from_numpy(x), *_port_args(p))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_plain_bf16_odd_t_matches_pallas_interpret():
    rng = np.random.default_rng(4)
    b, t, d, f = 2, 37, 88, 352
    p = _ffn_params(rng, d, f)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    want = _pallas(jnp.asarray(x).astype(jnp.bfloat16), p)
    assert want.dtype == jnp.bfloat16
    got = ffn_sublayer_int8_plain(torch.from_numpy(x).to(torch.bfloat16),
                                  *_port_args(p))
    assert got.dtype == torch.bfloat16 and got.shape == (b, t, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_wrapper_runs_plain_on_cpu_and_refuses_grad():
    rng = np.random.default_rng(5)
    p = _ffn_params(rng, 32, 128)
    x = torch.from_numpy(rng.normal(size=(2, 9, 32)).astype(np.float32))
    args = _port_args(p)
    torch.testing.assert_close(fused_ffn_sublayer_int8(x, *args),
                               ffn_sublayer_int8_plain(x, *args), rtol=0,
                               atol=0)
    assert fused_ffn_sublayer_int8.launches == 0
    leaf = args[2].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        fused_ffn_sublayer_int8(x, args[0], args[1], leaf, *args[3:])
    with torch.no_grad():
        fused_ffn_sublayer_int8(x, args[0], args[1], leaf, *args[3:])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ffn_sublayer_int8(x.to("meta"), *args)


def _cfgs():
    enc = EncoderConfig(n_layers=2, d_model=64, n_heads=4, conv_kernel_size=7)
    cfg = ModelConfig(spec_augment=None, encoder=enc,
                      decoder=DecoderConfig(feat_in=64, num_classes=24),
                      compute_dtype="float32")
    cfg_q = dataclasses.replace(
        cfg, encoder=dataclasses.replace(enc, quantization="int8"))
    return cfg, cfg_q


def _variables(cfg, seed):
    v = JaxCTCModel(cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8000)),
                              jnp.asarray([8000], jnp.int32))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(
        size=a.shape).astype(np.float32), v["params"])
    stats = jax.tree.map(lambda a: np.asarray(a), v["batch_stats"])
    bn = stats["encoder"]["layers"]["conv"]["batch_norm"]
    bn["mean"] = rng.uniform(-0.3, 0.3, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.7, 1.5, bn["var"].shape).astype(np.float32)
    return params, stats


def _signal(seed=6):
    rng = np.random.default_rng(seed)
    sig = (rng.normal(size=(2, 24000)) * 0.1).astype(np.float32)
    sig[1, 17000:] = 0.0
    return sig, np.asarray([24000, 17000], np.int32)


def test_int8_ctc_model_matches_jax():
    cfg, cfg_q = _cfgs()
    params, stats = _variables(cfg_q, 7)
    sig, lens = _signal()
    variables = {"params": params, "batch_stats": stats}
    want_q = JaxCTCModel(cfg_q).apply(variables, jnp.asarray(sig),
                                      jnp.asarray(lens), train=False)
    want_fp = JaxCTCModel(cfg).apply(variables, jnp.asarray(sig),
                                     jnp.asarray(lens), train=False)
    model = CTCModel(cfg_q).eval()
    model.load_state_dict(jax_to_state_dict(params, stats, cfg_q),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(sig), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.encoded_len.numpy(),
                                  np.asarray(want_q.encoded_len))
    delta = np.abs(got.log_probs.numpy() - np.asarray(want_q.log_probs)).max()
    drift = np.abs(np.asarray(want_q.log_probs)
                   - np.asarray(want_fp.log_probs)).max()
    assert drift > 0
    assert delta < 1e-3 and delta < 0.1 * drift, (delta, drift)


def test_training_forward_ignores_quantization():
    cfg, cfg_q = _cfgs()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, dropout=0.1, dropout_att=0.1))
    cfg_q = dataclasses.replace(cfg_q, encoder=dataclasses.replace(
        cfg_q.encoder, dropout=0.1, dropout_att=0.1))
    params, stats = _variables(cfg, 8)
    sig, lens = _signal(9)
    outs = []
    for c in (cfg, cfg_q):
        model = CTCModel(c)
        model.load_state_dict(jax_to_state_dict(params, stats, c))
        out = model(torch.from_numpy(sig), torch.from_numpy(lens), train=True,
                    rngs=step_rngs(3, 0, "cpu"))
        outs.append(out.log_probs)
    assert torch.equal(outs[0], outs[1])
