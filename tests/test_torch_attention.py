"""Port parity: rel-pos self-attention of tpu_asr_torch against the JAX
package on the CPU, inputs made with numpy from a seed, ragged lengths,
valid query rows only (padded rows are garbage by contract).

- the module (plain version of the CUDA kernel) against JAX
  RelPositionMultiHeadAttention under attention_backend='xla', fp32,
  rtol/atol 1e-4;
- the plain version in bf16 against the Pallas block kernel in interpret
  mode, rtol 1e-2 and atol 3e-3 (the precedent of
  tests/test_pallas_attention.py);
- the kernel wrapper refuses what the port's slice does not run.
"""

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


@pytest.mark.parametrize("option", [{"att_context_size": (8, 0)},
                                    {"att_context_size": (-1, 4)},
                                    {"dropout_rate": 0.1},
                                    {"seg_id": torch.ones(2, 12,
                                                          dtype=torch.int32)}])
def test_wrapper_refuses_options_outside_the_slice(option):
    with pytest.raises(ValueError, match="full-context eval attention"):
        fused_relpos_attention_block(*_wrapper_args(), **option)


def test_wrapper_runs_plain_on_cpu_and_checks_device():
    args = _wrapper_args()
    with torch.no_grad():
        torch.testing.assert_close(fused_relpos_attention_block(*args),
                                   relpos_attention_plain(*args),
                                   rtol=0, atol=0)
    assert fused_relpos_attention_block.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        fused_relpos_attention_block(args[0].to("meta"), *args[1:])
