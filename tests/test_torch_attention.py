"""Port parity: rel-pos self-attention of tpu_asr_torch against the JAX
package on the CPU, inputs made with numpy from a seed, ragged lengths,
valid query rows only (padded rows are garbage by contract).

- the module (plain version of the CUDA kernel) against JAX
  RelPositionMultiHeadAttention under attention_backend='xla', fp32,
  rtol/atol 1e-4;
- the plain version in bf16 against the Pallas block kernel in interpret
  mode, rtol 1e-2 and atol 3e-3 (the precedent of
  tests/test_pallas_attention.py);
- gradients of the plain version (autograd) against jax.vjp of the Pallas
  block in interpret mode, bf16, at dropout 0 and 0.1 with the same seed
  (the same counter-hash masks): atol 3e-2 * max(1, |ref|max) (bf16
  operands rounded at different points of two different backwards);
- one head with dropout 0.1 against the Pallas block in interpret mode,
  bf16 forward, rtol 2e-2, atol 1e-2 (the tolerance of the test above);
- gradients of the module in fp32 against jax.vjp of the XLA module, 1e-4;
- the kernel wrapper takes packed segments (seg_id) under autograd: on CPU
  tensors the plain version's gradients (the window: test_torch_window.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.models.conformer import RelPositionMultiHeadAttention as JaxMHA
from tpu_asr.models.conformer import \
    rel_positional_encoding as jax_rel_positional_encoding
from tpu_asr.ops.pallas_attention import fused_relpos_attention_block as \
    pallas_block
from tpu_asr_torch.models.conformer import (RelPositionMultiHeadAttention,
                                            rel_positional_encoding)
from tpu_asr_torch.ops.cuda_attention import (fused_relpos_attention_block,
                                              relpos_attention_plain)


def _jax_params(rng, d, h):
    mk = lambda *s, sc=1.0: rng.normal(size=s).astype(np.float32) * sc
    dense = lambda: {"kernel": mk(d, d, sc=d ** -0.5), "bias": mk(d, sc=0.1)}
    return {"linear_q": dense(), "linear_k": dense(), "linear_v": dense(),
            "linear_out": dense(),
            "linear_pos": {"kernel": mk(d, d, sc=d ** -0.5)},
            "pos_bias_u": mk(h, d // h, sc=0.1),
            "pos_bias_v": mk(h, d // h, sc=0.1)}


def _torch_module(p, d, h):
    mod = RelPositionMultiHeadAttention(d, h)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    sd = {"pos_bias_u": t(p["pos_bias_u"]), "pos_bias_v": t(p["pos_bias_v"]),
          "linear_pos.weight": t(p["linear_pos"]["kernel"].T)}
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        sd[f"{name}.weight"] = t(p[name]["kernel"].T)
        sd[f"{name}.bias"] = t(p[name]["bias"])
    mod.load_state_dict(sd)
    return mod


def _inputs(rng, b, t, d, lengths):
    x = (rng.normal(size=(b, t, d)) * 0.5).astype(np.float32)
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    return x, mask


def test_rel_positional_encoding_matches_jax():
    np.testing.assert_array_equal(
        rel_positional_encoding(37, 88).numpy(),
        np.asarray(jax_rel_positional_encoding(37, 88)))


@pytest.mark.parametrize("t,d,h,lengths", [
    (50, 88, 2, [50, 37]),       # dk = 44, ragged
    (33, 176, 4, [33, 1, 20]),   # flagship width, a single-frame row
    (40, 32, 2, [40, 29]),       # tiny
])
def test_module_matches_jax_xla(t, d, h, lengths):
    rng = np.random.default_rng(0)
    p = _jax_params(rng, d, h)
    x, mask = _inputs(rng, len(lengths), t, d, lengths)
    pe = np.asarray(jax_rel_positional_encoding(t, d))
    want = np.asarray(JaxMHA(d, h, attention_backend="xla").apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(pe), jnp.asarray(mask)))
    with torch.no_grad():
        got = _torch_module(p, d, h)(torch.from_numpy(x),
                                     rel_positional_encoding(t, d),
                                     torch.from_numpy(mask)).numpy()
    m = mask[..., None]
    np.testing.assert_allclose(got * m, want * m, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,d,h,lengths", [(50, 88, 2, [50, 41]),
                                           (36, 64, 4, [36, 20])])
def test_plain_bf16_matches_pallas_interpret(t, d, h, lengths):
    rng = np.random.default_rng(1)
    p = _jax_params(rng, d, h)
    x, mask = _inputs(rng, len(lengths), t, d, lengths)
    j = lambda a: jnp.asarray(a)
    want = np.asarray(pallas_block(
        j(x), j(p["linear_q"]["kernel"]), j(p["linear_q"]["bias"]),
        j(p["linear_k"]["kernel"]), j(p["linear_k"]["bias"]),
        j(p["linear_v"]["kernel"]), j(p["linear_v"]["bias"]),
        j(p["pos_bias_u"]), j(p["pos_bias_v"]),
        j(p["linear_pos"]["kernel"].reshape(d, h, d // h)),
        j(p["linear_out"]["kernel"]), j(mask), n_heads=h, interpret=True),
        np.float32)
    mod = _torch_module(p, d, h)
    with torch.no_grad():
        got = relpos_attention_plain(
            torch.from_numpy(x).to(torch.bfloat16), mod.linear_q.weight,
            mod.linear_q.bias, mod.linear_k.weight, mod.linear_k.bias,
            mod.linear_v.weight, mod.linear_v.bias, mod.pos_bias_u,
            mod.pos_bias_v, mod.linear_pos.weight, mod.linear_out.weight,
            rel_positional_encoding(t, d), torch.from_numpy(mask), h)
    assert got.dtype == torch.bfloat16
    m = mask[..., None]
    np.testing.assert_allclose(got.float().numpy() * m, want * m,
                               rtol=1e-2, atol=3e-3)


def _wrapper_args(t=12, d=16, h=2):
    rng = np.random.default_rng(2)
    mod = _torch_module(_jax_params(rng, d, h), d, h)
    x, mask = _inputs(rng, 2, t, d, [t, 7])
    return (torch.from_numpy(x), mod.linear_q.weight, mod.linear_q.bias,
            mod.linear_k.weight, mod.linear_k.bias, mod.linear_v.weight,
            mod.linear_v.bias, mod.pos_bias_u, mod.pos_bias_v,
            mod.linear_pos.weight, mod.linear_out.weight,
            rel_positional_encoding(t, d), torch.from_numpy(mask), h)


def test_wrapper_takes_seg_id_under_autograd():
    """The weights require grad and grad mode is on: with seg_id (packed
    training) the wrapper on CPU tensors is the plain version, gradients
    included, and the segments change them."""
    args = _wrapper_args()
    seg = torch.ones(2, 12, dtype=torch.int32)
    seg[0, 7:] = 2
    seg[1, 7:] = 0
    weights = [a for a in args if isinstance(a, torch.Tensor)
               and a.requires_grad]
    assert weights
    runs = []
    for fn, kw in ((fused_relpos_attention_block, {"seg_id": seg}),
                   (relpos_attention_plain, {"seg_id": seg}),
                   (fused_relpos_attention_block, {})):
        out = fn(*args, **kw)
        runs.append(torch.autograd.grad(out.square().sum(), weights))
    for a, b in zip(runs[0], runs[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert any(not torch.allclose(a, c) for a, c in zip(runs[0], runs[2]))
    assert fused_relpos_attention_block.launches == 0


def test_wrapper_dropout_draws_seeded_masks():
    """Dropout on the attention probabilities: reproducible per seed,
    different across seeds, and the identity at rate 0."""
    args = _wrapper_args()
    with torch.no_grad():
        base = fused_relpos_attention_block(*args)
        a = fused_relpos_attention_block(*args, dropout_rate=0.1,
                                         dropout_seed=5)
        b = fused_relpos_attention_block(*args, dropout_rate=0.1,
                                         dropout_seed=5)
        c = fused_relpos_attention_block(*args, dropout_rate=0.1,
                                         dropout_seed=6)
        z = fused_relpos_attention_block(*args, dropout_rate=0.0,
                                         dropout_seed=6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, base) and torch.equal(z, base)


def _pallas_run(p, d, h, mask, rate, seed):
    def run(x, wq, bq, wk, bk, wv, bv, u, v, wpos, wo):
        return pallas_block(x, wq, bq, wk, bk, wv, bv, u, v,
                            wpos.reshape(d, h, d // h), wo, jnp.asarray(mask),
                            n_heads=h, dropout_rate=rate,
                            dropout_seed=jnp.asarray([seed], jnp.int32),
                            interpret=True)
    return run


_PARAM_ORDER = [("linear_q", "kernel"), ("linear_q", "bias"),
                ("linear_k", "kernel"), ("linear_k", "bias"),
                ("linear_v", "kernel"), ("linear_v", "bias"),
                ("pos_bias_u", None), ("pos_bias_v", None),
                ("linear_pos", "kernel"), ("linear_out", "kernel")]


def _torch_params(p):
    """Leaf tensors in the plain version's argument order; Dense kernels
    transposed to Linear (out, in)."""
    out = []
    for name, leaf in _PARAM_ORDER:
        a = p[name] if leaf is None else p[name][leaf]
        a = a.T if leaf == "kernel" else a
        out.append(torch.tensor(np.ascontiguousarray(a), requires_grad=True))
    return out


def _as_jax_layout(grads):
    return [g.T if leaf == "kernel" else g
            for g, (_, leaf) in zip(grads, _PARAM_ORDER)]


def test_plain_one_head_dropout_matches_pallas_interpret():
    """One head with dropout: the mask has one stream per batch row."""
    t, d, h, rate, seed = 24, 44, 1, 0.1, 9
    rng = np.random.default_rng(4)
    p = _jax_params(rng, d, h)
    x, mask = _inputs(rng, 2, t, d, [t, 17])
    leaves = [p[n] if leaf is None else p[n][leaf] for n, leaf in _PARAM_ORDER]
    want = _pallas_run(p, d, h, mask, rate, seed)(
        jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray, leaves))
    got = relpos_attention_plain(
        torch.from_numpy(x).to(torch.bfloat16), *_torch_params(p),
        rel_positional_encoding(t, d), torch.from_numpy(mask), h, rate, seed)
    m = mask[..., None]
    np.testing.assert_allclose(got.float().detach().numpy() * m,
                               np.asarray(want, np.float32) * m, rtol=2e-2,
                               atol=1e-2)


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 77),
                                       (0.1, 2 ** 31 - 2)])
def test_plain_grads_bf16_match_pallas_interpret(rate, seed):
    t, d, h = 40, 88, 2
    rng = np.random.default_rng(3)
    p = _jax_params(rng, d, h)
    x, mask = _inputs(rng, 2, t, d, [t, 29])
    g = rng.normal(size=(2, t, d)).astype(np.float32) * mask[..., None]
    j = jnp.asarray
    leaves = [p[n] if leaf is None else p[n][leaf] for n, leaf in _PARAM_ORDER]
    want, vjp = jax.vjp(_pallas_run(p, d, h, mask, rate, seed),
                        j(x).astype(jnp.bfloat16), *map(j, leaves))
    want_g = vjp(j(g).astype(jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    params = _torch_params(p)
    got = relpos_attention_plain(xt, *params, rel_positional_encoding(t, d),
                                 torch.from_numpy(mask), h, rate, seed)
    got.backward(torch.from_numpy(g).to(torch.bfloat16))
    m = mask[..., None]
    np.testing.assert_allclose(got.float().detach().numpy() * m,
                               np.asarray(want, np.float32) * m, rtol=2e-2,
                               atol=1e-2)
    got_g = [xt.grad.float().numpy()] + _as_jax_layout(
        [q.grad.numpy() for q in params])
    names = ["x"] + [f"{n}.{leaf}" for n, leaf in _PARAM_ORDER]
    for name, a, w in zip(names, got_g, want_g):
        w = np.asarray(w, np.float32).reshape(a.shape)
        np.testing.assert_allclose(a, w, rtol=3e-2,
                                   atol=3e-2 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("t,d,h,lengths", [(30, 88, 2, [30, 19]),
                                           (24, 32, 2, [24, 24])])
def test_module_grads_fp32_match_jax_xla(t, d, h, lengths):
    rng = np.random.default_rng(4)
    p = _jax_params(rng, d, h)
    x, mask = _inputs(rng, len(lengths), t, d, lengths)
    g = rng.normal(size=x.shape).astype(np.float32) * mask[..., None]
    pe = np.asarray(jax_rel_positional_encoding(t, d))
    mha = JaxMHA(d, h, attention_backend="xla")
    want, vjp = jax.vjp(lambda pp, xx: mha.apply({"params": pp}, xx,
                                                 jnp.asarray(pe),
                                                 jnp.asarray(mask)),
                        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(g))
    mod = _torch_module(p, d, h)
    xt = torch.tensor(x, requires_grad=True)
    got = mod(xt, rel_positional_encoding(t, d), torch.from_numpy(mask))
    got.backward(torch.from_numpy(g))
    m = mask[..., None]
    np.testing.assert_allclose(got.detach().numpy() * m, np.asarray(want) * m,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                               rtol=1e-4, atol=1e-4)
    tg = lambda name: getattr(mod, name)
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        np.testing.assert_allclose(tg(name).weight.grad.numpy().T,
                                   np.asarray(want_p[name]["kernel"]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(tg(name).bias.grad.numpy(),
                                   np.asarray(want_p[name]["bias"]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(mod.linear_pos.weight.grad.numpy().T,
                               np.asarray(want_p["linear_pos"]["kernel"]),
                               rtol=1e-4, atol=1e-4)
    for name in ("pos_bias_u", "pos_bias_v"):
        np.testing.assert_allclose(tg(name).grad.numpy(),
                                   np.asarray(want_p[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_wrapper_runs_plain_on_cpu_and_checks_device():
    args = _wrapper_args()
    with torch.no_grad():
        torch.testing.assert_close(fused_relpos_attention_block(*args),
                                   relpos_attention_plain(*args),
                                   rtol=0, atol=0)
    assert fused_relpos_attention_block.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        fused_relpos_attention_block(args[0].to("meta"), *args[1:])
