"""Port parity: the fused FFN sublayer of tpu_asr_torch (plain version of
the CUDA kernels) against the JAX package on the CPU, inputs made with
numpy from a seed.

- the plain version in bf16 against fused_ffn_sublayer in interpret mode,
  values and VJP, at dropout 0 and at 0.1 with the same seed (the masks are
  the same counter hash): values rtol/atol 2e-2, gradients atol
  2e-2 * max(1, |ref|max) (bf16 operands, sums of up to T * B products);
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


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 12345),
                                       (0.1, 2 ** 31 - 3)])
def test_plain_bf16_matches_pallas_interpret(rate, seed):
    rng = np.random.default_rng(0)
    b, t, d, f = 3, 21, 88, 352
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
