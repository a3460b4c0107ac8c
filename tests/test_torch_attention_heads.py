"""Port parity for the per-head rel-pos attention
(tpu_asr_torch/ops/cuda_attention.py::fused_relpos_attention, the
counterpart of tpu_asr/ops/pallas_attention.py::fused_relpos_attention)
against the JAX package on the CPU, inputs made with numpy from a seed,
valid query rows only (padded rows are garbage by contract):

- the plain version in fp32 against the XLA oracle of
  tests/test_pallas_attention.py (the rel_shift construction), forward and
  the gradients of q_u, q_v, k, v and the linear_pos weight, within 1e-5 of
  each tensor's scale: full context and a (3, 3) window, T = 100 and 130;
- the plain version against the Pallas kernel in interpret mode and its
  jax.grad at that file's tolerances (forward rtol 5e-3, atol 4e-3;
  gradients 2e-2 of scale): the kernel rounds every product operand to
  bf16, the plain version keeps fp32 in fp32. Also dropout 0.3 with a seed
  and with dropout_seed=None (the same counter-hash masks), and (3, 3);
- the semantics the kernel keeps: padded keys take no weight (key bias
  -1e30), the normaliser is the undropped one, dropout_seed=None gives head
  h stream h in every batch row (the Pallas kernel's seed_rows are zeros
  then, and head l of its program draws seed_rows[b, 0] + l);
- the wrapper runs the plain version on the CPU (no launch) and refuses
  other devices.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pallas_attention import _xla_reference
from tpu_asr.models.conformer import rel_positional_encoding as jax_pe
from tpu_asr.ops.pallas_attention import fused_relpos_attention as pallas_att
from tpu_asr_torch.ops.cuda_attention import (fused_relpos_attention,
                                              relpos_attention_heads_plain)
from tpu_asr_torch.ops.dropout import keep_mask


def _inputs(seed, b, h, t, dk, lengths):
    """q_u, q_v, k, v (B, H, T, dk), the JAX linear_pos kernel w (D, D)
    (in, out), the mask and a cotangent, as numpy."""
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=0.5: (rng.normal(size=s) * sc).astype(np.float32)
    d = h * dk
    qkv = [mk(b, h, t, dk) for _ in range(4)]
    w = mk(d, d, sc=0.3)
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    return qkv, w, mask, mk(b, h, t, dk)


def _torch_grads(qkv, w, mask, cot, window=(-1, -1), rate=0.0, seed=None):
    """Output and grads (q_u, q_v, k, v, w_pos) of the plain version, with
    w_pos = w^T (Linear layout) and the loss sum(valid * out * cot)."""
    ts = [torch.from_numpy(a).requires_grad_() for a in qkv]
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    m = torch.from_numpy(mask)
    out = relpos_attention_heads_plain(*ts, wt, m, window, rate, seed)
    loss = (out * m[:, None, :, None] * torch.from_numpy(cot)).sum()
    grads = torch.autograd.grad(loss, ts + [wt])
    return out.detach().numpy(), [g.numpy() for g in grads[:4]] + [
        grads[4].numpy().T]


def _close_to_scale(got, want, tol, name):
    scale = max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol,
                               err_msg=name)


CASES = [((100, 44), (-1, -1)), ((130, 22), (-1, -1)), ((100, 44), (3, 3))]


@pytest.mark.parametrize("shape,window", CASES)
def test_plain_matches_xla_oracle(shape, window):
    t, dk = shape
    b, h = 2, 2
    lengths = [t, t - 13]
    qkv, w, mask, cot = _inputs(0, b, h, t, dk, lengths)
    d = h * dk
    pe = jax_pe(t, d)
    valid = jnp.asarray(mask)[:, None, :, None]

    def loss(q_u, q_v, k, v, w):
        p = (pe @ w).reshape(2 * t - 1, h, dk)
        out = _xla_reference(q_u, q_v, k, v, p, jnp.asarray(mask), window)
        return jnp.sum(jnp.where(valid, out, 0.0) * cot), out

    (_, want), jgrads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*map(jnp.asarray,
                                                          qkv + [w]))
    got, tgrads = _torch_grads(qkv, w, mask, cot, window)
    for i, ln in enumerate(lengths):
        _close_to_scale(got[i, :, :ln], np.asarray(want)[i, :, :ln], 1e-5,
                        "context")
    for name, g, jg in zip(["dq_u", "dq_v", "dk", "dv", "dw_pos"], tgrads,
                           jgrads):
        _close_to_scale(g, np.asarray(jg), 1e-5, name)


PALLAS = [((100, 44), (-1, -1), 0.0, None), ((130, 64), (-1, -1), 0.0, None),
          ((64, 32), (3, 3), 0.0, None), ((100, 44), (-1, -1), 0.3, 7),
          ((100, 44), (-1, -1), 0.3, None)]


@pytest.mark.parametrize("shape,window,rate,seed", PALLAS)
def test_plain_matches_pallas_interpret(shape, window, rate, seed):
    t, dk = shape
    b, h = 2, 2
    lengths = [t, t - 7]
    qkv, w, mask, cot = _inputs(1, b, h, t, dk, lengths)
    d = h * dk
    valid = jnp.asarray(mask)[:, None, :, None]
    jseed = None if seed is None else jnp.asarray([seed], jnp.int32)

    def loss(q_u, q_v, k, v, w):
        out = pallas_att(q_u, q_v, k, v, w.reshape(d, h, dk),
                         jnp.asarray(mask), att_context_size=window,
                         dropout_rate=rate, dropout_seed=jseed,
                         interpret=True)
        return jnp.sum(jnp.where(valid, out, 0.0) * cot), out

    (_, want), jgrads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*map(jnp.asarray,
                                                          qkv + [w]))
    got, tgrads = _torch_grads(qkv, w, mask, cot, window, rate, seed)
    for i, ln in enumerate(lengths):
        np.testing.assert_allclose(got[i, :, :ln], np.asarray(want)[i, :, :ln],
                                   rtol=5e-3, atol=4e-3)
    for name, g, jg in zip(["dq_u", "dq_v", "dk", "dv", "dw_pos"], tgrads,
                           jgrads):
        _close_to_scale(g, np.asarray(jg), 2e-2, name)


def test_padded_keys_take_no_weight():
    """Changing k and v at padded key positions leaves every valid output
    row as it was (key bias -1e30)."""
    qkv, w, mask, _ = _inputs(2, 2, 2, 40, 16, [40, 25])
    args = [torch.from_numpy(a) for a in qkv]
    wt, m = torch.from_numpy(w.T.copy()), torch.from_numpy(mask)
    want = relpos_attention_heads_plain(*args, wt, m)
    pad = ~m[:, None, :, None]
    args[2] = torch.where(pad, args[2] + 5.0, args[2])
    args[3] = torch.where(pad, args[3] * -3.0, args[3])
    got = relpos_attention_heads_plain(*args, wt, m)
    valid = m[:, None, :, None]
    torch.testing.assert_close(got * valid, want * valid, rtol=0, atol=0)


def test_dropout_uses_the_undropped_normaliser():
    """out = where(keep, softmax / (1 - rate), 0) @ v with the undropped
    softmax, keep the counter hash of stream seed + b * H + h at
    idx t * Tp + s."""
    b, h, t, dk, rate, seed = 1, 2, 24, 8, 0.25, 11
    qkv, w, mask, _ = _inputs(3, b, h, t, dk, [t])
    args = [torch.from_numpy(a) for a in qkv]
    wt, m = torch.from_numpy(w.T.copy()), torch.from_numpy(mask)
    got = relpos_attention_heads_plain(*args, wt, m, dropout_rate=rate,
                                       dropout_seed=seed)
    # the undropped probabilities: the attention weights of v = identity
    eye = torch.eye(t)[None, None].expand(b, h, t, t)
    q_u, q_v, k = args[:3]
    attn = relpos_attention_heads_plain(q_u, q_v, k, eye.contiguous(), wt, m)
    streams = seed + torch.arange(b * h).reshape(b, h)
    keep = keep_mask(streams, t, t, rate, row_stride=128)
    want = torch.where(keep, attn / (1.0 - rate), 0.0) @ args[3]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_no_seed_gives_head_h_stream_h_in_every_batch_row():
    """With dropout_seed=None head h draws stream h in every batch row: with
    the same inputs in every batch row and head (and the same linear_pos
    rows for every head) batch rows agree head by head and heads differ;
    with a seed batch rows differ too."""
    b, h, t, dk = 2, 2, 32, 8
    qkv, _, _, _ = _inputs(4, 1, 1, t, dk, [t])
    args = [torch.from_numpy(a).expand(b, h, t, dk).contiguous()
            for a in qkv]
    rows = np.random.default_rng(4).normal(size=(dk, h * dk)) * 0.3
    wt = torch.from_numpy(np.tile(rows, (h, 1)).astype(np.float32))
    m = torch.ones(b, t, dtype=torch.bool)
    plain = relpos_attention_heads_plain(*args, wt, m)
    torch.testing.assert_close(plain[1, 1], plain[0, 0], rtol=0, atol=0)
    got = relpos_attention_heads_plain(*args, wt, m, dropout_rate=0.3,
                                       dropout_seed=None)
    for j in range(h):
        torch.testing.assert_close(got[1, j], got[0, j], rtol=0, atol=0)
    assert not torch.equal(got[0, 0], got[0, 1])
    seeded = relpos_attention_heads_plain(*args, wt, m, dropout_rate=0.3,
                                          dropout_seed=0)
    torch.testing.assert_close(seeded[0], got[0], rtol=0, atol=0)
    assert not torch.equal(seeded[1, 0], got[1, 0])


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    qkv, w, mask, _ = _inputs(5, 2, 2, 20, 8, [20, 9])
    args = [torch.from_numpy(a) for a in qkv]
    wt, m = torch.from_numpy(w.T.copy()), torch.from_numpy(mask)
    before = fused_relpos_attention.launches
    got = fused_relpos_attention(*args, wt, m, (4, 2), 0.1, 3)
    want = relpos_attention_heads_plain(*args, wt, m, (4, 2), 0.1, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fused_relpos_attention.launches == before
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_relpos_attention(*meta, wt.to("meta"), m.to("meta"))
