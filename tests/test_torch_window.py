"""Port parity of the block attention's limited context window (NeMo's
rel_pos_local_attn, `att_context_size` (left, right)) against the JAX
package on the CPU, inputs and weights made with numpy from a seed,
ragged lengths.

- the plain version (what the wrapper runs on CPU tensors) in bf16
  against tpu_asr.ops.pallas_attention.fused_relpos_attention_block with
  the same window in interpret mode: windows (40, 40), (8, 0), (-1, 4) and
  (0, 0) at T = 150 (not a multiple of 64, above two of the CUDA kernels'
  64-key tiles), dropout 0 and 0.1 with the same seed (the same
  counter-hash masks, tests/test_torch_dropout.py), with and without a
  segment map (the two masks together): the forward on valid rows and
  every gradient (cotangent zero on padded and guard rows) at
  tests/test_torch_attention.py's bf16 tolerances (rtol 2e-2 / atol 1e-2,
  gradients 3e-2 of max(1, |ref|)). Not in fp32: the Pallas block's fp32
  interpret path itself lies 1.2e-3 from JAX's XLA module at this shape,
  window or not;
- in fp32 at 1e-4 (of max(1, |ref|)): the model's attention module with
  each window, with and without the segment map, against JAX's
  RelPositionMultiHeadAttention under attention_backend='xla', forward on
  valid rows and every gradient, in the 'regular' style, which the port's
  'auto' sends to the block wrapper;
- fastconformer_local cut to 2 layers at d64 (tests/
  test_torch_encoder_options.py's shape: dw_striding x8, window (8, 8) over
  T' = 32): log-probs against JAX's CTCModel within 1e-4, greedy ids and
  encoded_len equal;
- `local_window` against JAX's mask rule, and the wrapper on CPU tensors
  equal to the plain version with no launch counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tests.test_torch_attention import (_PARAM_ORDER, _as_jax_layout,
                                        _jax_params, _torch_module,
                                        _torch_params)
from tests.test_torch_encoder_options import (_fastconformer, _port_model,
                                              _signal, _variables)
from tpu_asr.models.conformer import RelPositionMultiHeadAttention as JaxMHA
from tpu_asr.models.conformer import \
    rel_positional_encoding as jax_rel_positional_encoding
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr.ops.pallas_attention import fused_relpos_attention_block as \
    pallas_block
from tpu_asr_torch.models.conformer import rel_positional_encoding
from tpu_asr_torch.ops.cuda_attention import (fused_relpos_attention_block,
                                              local_window,
                                              relpos_attention_plain)

T, D, H = 150, 32, 2


def _segments():
    """(2, T) packed map: three segments with guard frames and a padded
    tail in row 0, two segments in row 1."""
    seg = np.zeros((2, T), np.int32)
    seg[0, :40], seg[0, 44:101], seg[0, 105:140] = 1, 2, 3
    seg[1, :70], seg[1, 73:121] = 1, 2
    return seg


def _close(got, want, name, tol=1e-4):
    want = np.asarray(want, np.float32).reshape(got.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=name)


# each window with and without segments, dropout 0 and 0.1 across them
@pytest.mark.parametrize("window,rate,with_seg", [
    ((40, 40), 0.0, False), ((40, 40), 0.1, True),
    ((8, 0), 0.1, False), ((8, 0), 0.0, True),
    ((-1, 4), 0.0, False), ((-1, 4), 0.1, True),
    ((0, 0), 0.1, False), ((0, 0), 0.0, True)])
def test_plain_matches_pallas_window_interpret(window, rate, with_seg):
    rng = np.random.default_rng(30)
    seed = 4242
    p = _jax_params(rng, D, H)
    x = (rng.normal(size=(2, T, D)) * 0.5).astype(np.float32)
    if with_seg:
        seg = _segments()
        mask = seg > 0
    else:
        seg = None
        mask = np.arange(T)[None, :] < np.asarray([T, 97])[:, None]
    g = rng.normal(size=x.shape).astype(np.float32) * mask[..., None]
    j = jnp.asarray

    def run(xx, wq, bq, wk, bk, wv, bv, u, v, wpos, wo):
        return pallas_block(
            xx, wq, bq, wk, bk, wv, bv, u, v, wpos.reshape(D, H, D // H), wo,
            j(mask), n_heads=H, att_context_size=window, dropout_rate=rate,
            dropout_seed=j([seed], jnp.int32), interpret=True,
            seg_id=None if seg is None else j(seg))

    leaves = [p[n] if leaf is None else p[n][leaf] for n, leaf in _PARAM_ORDER]
    want, vjp = jax.vjp(run, j(x).astype(jnp.bfloat16), *map(j, leaves))
    want_g = vjp(j(g).astype(jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    params = _torch_params(p)
    got = relpos_attention_plain(
        xt, *params, rel_positional_encoding(T, D), torch.from_numpy(mask), H,
        rate, seed, None if seg is None else torch.from_numpy(seg), window)
    got.backward(torch.from_numpy(g).to(torch.bfloat16))
    m = mask[..., None]
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().detach().numpy() * m,
                               np.asarray(want, np.float32) * m, rtol=2e-2,
                               atol=1e-2)
    got_g = [xt.grad.float().numpy()] + _as_jax_layout(
        [q.grad.numpy() for q in params])
    names = ["x"] + [f"{n}.{leaf}" for n, leaf in _PARAM_ORDER]
    for name, a, w in zip(names, got_g, want_g):
        assert np.isfinite(a).all(), name
        _close(a, w, name, 3e-2)


@pytest.mark.parametrize("with_seg", [False, True])
@pytest.mark.parametrize("window", [(40, 40), (8, 0), (-1, 4), (0, 0)])
def test_module_window_matches_jax_xla(window, with_seg):
    rng = np.random.default_rng(31)
    t = T
    p = _jax_params(rng, D, H)
    x = (rng.normal(size=(2, t, D)) * 0.5).astype(np.float32)
    seg = _segments() if with_seg else None
    mask = (seg > 0 if with_seg
            else np.arange(t)[None, :] < np.asarray([t, 61])[:, None])
    g = rng.normal(size=x.shape).astype(np.float32) * mask[..., None]
    pe = jnp.asarray(jax_rel_positional_encoding(t, D))
    mha = JaxMHA(D, H, att_context_size=window, attention_backend="xla")
    want, vjp = jax.vjp(lambda pp, xx: mha.apply(
        {"params": pp}, xx, pe, jnp.asarray(mask),
        seg_id=None if seg is None else jnp.asarray(seg)),
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(g))
    mod = _torch_module(p, D, H)
    mod.window = window                  # as ConformerLayer builds it
    xt = torch.tensor(x, requires_grad=True)
    got = mod(xt, rel_positional_encoding(t, D), torch.from_numpy(mask),
              seg_id=None if seg is None else torch.from_numpy(seg))
    got.backward(torch.from_numpy(g))
    m = mask[..., None]
    _close(got.detach().numpy() * m, np.asarray(want) * m, "forward")
    _close(xt.grad.numpy(), want_x, "x")
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        lin = getattr(mod, name)
        _close(lin.weight.grad.numpy().T, want_p[name]["kernel"], name)
        _close(lin.bias.grad.numpy(), want_p[name]["bias"], name)
    _close(mod.linear_pos.weight.grad.numpy().T,
           want_p["linear_pos"]["kernel"], "linear_pos")
    _close(mod.pos_bias_u.grad.numpy(), want_p["pos_bias_u"], "u")
    _close(mod.pos_bias_v.grad.numpy(), want_p["pos_bias_v"], "v")


@pytest.mark.parametrize("window", [(3, 5), (0, -1), (-1, 0), (-1, -1)])
def test_local_window_is_jax_rule(window):
    t = 11
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]        # s - t
    left, right = window
    want = ((rel >= -left) | (left < 0)) & ((rel <= right) | (right < 0))
    np.testing.assert_array_equal(local_window(t, *window).numpy(), want)


def test_wrapper_takes_a_window_on_cpu():
    """On CPU tensors the wrapper runs the plain version, window and
    segments included, and counts no launch; the window changes the
    result."""
    rng = np.random.default_rng(32)
    p = _jax_params(rng, D, H)
    x = torch.from_numpy((rng.normal(size=(2, 70, D)) * 0.5)
                         .astype(np.float32))
    mask = torch.ones(2, 70, dtype=torch.bool)
    args = (x, *_torch_params(p), rel_positional_encoding(70, D), mask, H)
    seg = torch.ones(2, 70, dtype=torch.int32)
    seg[:, 35:] = 2
    before = (fused_relpos_attention_block.launches,
              fused_relpos_attention_block.window_launches)
    with torch.no_grad():
        got = fused_relpos_attention_block(*args, att_context_size=(6, 2),
                                           seg_id=seg)
        want = relpos_attention_plain(*args, 0.0, 0, seg, (6, 2))
        full = fused_relpos_attention_block(*args, seg_id=seg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.allclose(got, full)
    assert (fused_relpos_attention_block.launches,
            fused_relpos_attention_block.window_launches) == before


def test_fastconformer_local_log_probs_match_jax():
    cfg_j, cfg_p = _fastconformer(JC), _fastconformer(PC)
    params, stats = _variables(cfg_j, 47)
    sig, lens = _signal(48, (2.5, 1.5))
    want = JaxCTCModel(cfg_j).apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(sig), jnp.asarray(lens),
                                    train=False)
    with torch.no_grad():
        got = _port_model(cfg_p, params, stats)(torch.from_numpy(sig),
                                                torch.from_numpy(lens))
    assert got.log_probs.shape[1] > 2 * 8 + 1         # the window masks
    np.testing.assert_array_equal(got.encoded_len.numpy(),
                                  np.asarray(want.encoded_len))
    np.testing.assert_allclose(got.log_probs.numpy(),
                               np.asarray(want.log_probs), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got.greedy.numpy(), np.asarray(want.greedy))
