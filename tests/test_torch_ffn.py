"""Port parity: the fused FFN sublayer of tpu_asr_torch (plain version of
the CUDA kernels) against the JAX package on the CPU, inputs made with
numpy from a seed.

- the plain version in bf16 against fused_ffn_sublayer in interpret mode,
  values and VJP, at dropout 0 and at 0.1 with the same seed (the masks are
  the same counter hash), at d88/352 and d176/704: values rtol/atol 2e-2,
  gradients atol 2e-2 * max(1, |ref|max) (bf16 operands, sums of up to
  T * B products);
- the plain version in fp32 against JAX's XLA LayerNorm + FeedForward
  modules, values and gradients at 1e-4;
- the wrapper runs the plain version on the CPU and launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.models.conformer import FeedForward as JaxFeedForward
from tpu_asr.ops.pallas_ffn import fused_ffn_sublayer as pallas_ffn
from tpu_asr_torch.ops.cuda_ffn import (ffn_sublayer_plain,
                                        fused_ffn_sublayer,
                                        fused_ffn_sublayer_bwd)


def _params(rng, d, f):
    mk = lambda *s, sc=0.1: rng.normal(size=s).astype(np.float32) * sc
    return dict(s=1.0 + mk(d), sb=mk(d), w1=mk(d, f, sc=d ** -0.5), b1=mk(f),
                w2=mk(f, d, sc=f ** -0.5), b2=mk(d))


def _torch_args(p):
    """JAX (in, out) kernels -> PyTorch Linear (out, in) weights."""
    t = lambda a: torch.tensor(np.ascontiguousarray(a), requires_grad=True)
    return [t(p["s"]), t(p["sb"]), t(p["w1"].T), t(p["b1"]), t(p["w2"].T),
            t(p["b2"])]


def _torch_grads(args):
    ds, dsb, dw1, db1, dw2, db2 = (a.grad.numpy() for a in args)
    return [ds, dsb, dw1.T, db1, dw2.T, db2]


@pytest.mark.parametrize("rate,seed,d,f", [
    pytest.param(0.0, 0, 88, 352, id="0.0-0"),
    pytest.param(0.1, 12345, 88, 352, id="0.1-12345"),
    pytest.param(0.1, 2 ** 31 - 3, 88, 352, id="0.1-2147483645"),
    pytest.param(0.0, 0, 176, 704, id="0.0-0-d176"),
    pytest.param(0.1, 12345, 176, 704, id="0.1-12345-d176"),
])
def test_plain_bf16_matches_pallas_interpret(rate, seed, d, f):
    """At the student's width and the teacher's (d176/704, which the
    backward kernel now takes in training)."""
    rng = np.random.default_rng(0)
    b, t = (3, 21) if d == 88 else (2, 13)
    p = _params(rng, d, f)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    g = rng.normal(size=(b, t, d)).astype(np.float32)
    j = lambda a: jnp.asarray(a)
    x16 = j(x).astype(jnp.bfloat16)

    def run(x_, s, sb, w1, b1, w2, b2):
        return pallas_ffn(x_, s, sb, w1, b1, w2, b2, dropout_rate=rate,
                          dropout_seed=jnp.asarray([seed], jnp.int32),
                          interpret=True)

    want, vjp = jax.vjp(run, x16, j(p["s"]), j(p["sb"]), j(p["w1"]),
                        j(p["b1"]), j(p["w2"]), j(p["b2"]))
    want_g = vjp(j(g).astype(jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    args = _torch_args(p)
    got = ffn_sublayer_plain(xt, *args, rate, seed)
    got.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
    got_g = [xt.grad.float().numpy()] + _torch_grads(args)
    for name, a, w in zip(["dx", "ds", "dsb", "dw1", "db1", "dw2", "db2"],
                          got_g, want_g):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(a, w, rtol=2e-2,
                                   atol=2e-2 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def test_dropout_changes_the_output_and_is_reproducible():
    rng = np.random.default_rng(3)
    p = _params(rng, 16, 64)
    x = torch.from_numpy(rng.normal(size=(2, 9, 16)).astype(np.float32))
    args = [a.detach() for a in _torch_args(p)]
    a = ffn_sublayer_plain(x, *args, 0.1, 7)
    assert torch.equal(a, ffn_sublayer_plain(x, *args, 0.1, 7))
    assert not torch.equal(a, ffn_sublayer_plain(x, *args, 0.1, 8))
    assert not torch.equal(a, ffn_sublayer_plain(x, *args, 0.0, 7))


@pytest.mark.parametrize("d,f", [(88, 352), (32, 128)])
def test_plain_fp32_matches_jax_xla(d, f):
    rng = np.random.default_rng(1)
    p = _params(rng, d, f)
    x = rng.normal(size=(2, 17, d)).astype(np.float32)
    g = rng.normal(size=(2, 17, d)).astype(np.float32)
    import flax.linen as nn
    ffn = JaxFeedForward(d, f, 0.0)
    ln = nn.LayerNorm()

    def run(x_, s, sb, w1, b1, w2, b2):
        h = ln.apply({"params": {"scale": s, "bias": sb}}, x_)
        h = ffn.apply({"params": {"linear1": {"kernel": w1, "bias": b1},
                                  "linear2": {"kernel": w2, "bias": b2}}}, h)
        return x_ + 0.5 * h

    j = jnp.asarray
    want, vjp = jax.vjp(run, j(x), j(p["s"]), j(p["sb"]), j(p["w1"]),
                        j(p["b1"]), j(p["w2"]), j(p["b2"]))
    want_g = vjp(j(g))
    xt = torch.tensor(x, requires_grad=True)
    args = _torch_args(p)
    got = ffn_sublayer_plain(xt, *args)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    for a, w in zip([xt.grad.numpy()] + _torch_grads(args), want_g):
        np.testing.assert_allclose(a, np.asarray(w), rtol=1e-4, atol=1e-4)


def test_wrapper_runs_plain_on_cpu_and_checks_device():
    rng = np.random.default_rng(2)
    p = _params(rng, 16, 64)
    x = torch.from_numpy(rng.normal(size=(2, 5, 16)).astype(np.float32))
    args = [a.detach() for a in _torch_args(p)]
    torch.testing.assert_close(fused_ffn_sublayer(x, *args, 0.1, 3),
                               ffn_sublayer_plain(x, *args, 0.1, 3),
                               rtol=0, atol=0)
    assert fused_ffn_sublayer.launches == 0
    assert fused_ffn_sublayer_bwd.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ffn_sublayer(x.to("meta"), *args)


def test_eval_pallas_route_matches_jax(monkeypatch):
    """ffn_backend='pallas' in eval runs the fused FFN at dropout 0 in both
    frameworks (JAX's through the Pallas kernel in interpret mode, which
    rounds its dot operands to bf16 even for fp32 input: its encoder
    tolerance of tests/test_pallas_ffn.py)."""
    import dataclasses

    import tpu_asr.ops.pallas_ffn as pf
    import tpu_asr_torch.models.conformer as port_conformer
    from tpu_asr.config import DecoderConfig, EncoderConfig, ModelConfig
    from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
    from tpu_asr_torch.convert.from_jax import jax_to_state_dict
    from tpu_asr_torch.models.ctc_model import CTCModel

    orig = pf.fused_ffn_sublayer
    monkeypatch.setattr(pf, "fused_ffn_sublayer",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    calls = []
    port_fused = port_conformer.fused_ffn_sublayer
    monkeypatch.setattr(port_conformer, "fused_ffn_sublayer",
                        lambda *a, **kw: calls.append(1) or port_fused(*a,
                                                                       **kw))
    cfg = ModelConfig(spec_augment=None,
                      encoder=EncoderConfig(n_layers=2, d_model=32, n_heads=4,
                                            conv_kernel_size=7),
                      decoder=DecoderConfig(feat_in=32, num_classes=16),
                      compute_dtype="float32")
    cfg_p = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, ffn_backend="pallas"))
    v = JaxCTCModel(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8000)),
                              jnp.asarray([8000], jnp.int32))
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(
        size=a.shape).astype(np.float32), v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    sig = (rng.normal(size=(2, 16000)) * 0.1).astype(np.float32)
    lens = np.asarray([16000, 10000], np.int32)
    want = JaxCTCModel(cfg_p).apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(sig), jnp.asarray(lens),
                                    train=False)
    model = CTCModel(cfg_p).eval()
    model.load_state_dict(jax_to_state_dict(params, stats, cfg_p))
    with torch.no_grad():
        got = model(torch.from_numpy(sig), torch.from_numpy(lens))
    assert len(calls) == 2 * cfg.encoder.n_layers
    np.testing.assert_allclose(got.encoded.numpy(), np.asarray(want.encoded),
                               rtol=1e-2, atol=5e-3)
