"""int8 cache-aware streaming: the port's CacheAwareStreamer and
CTCModel.stream_step with quantization='int8' (the FFN sublayers through
the int8 route, the plain version on the CPU) against the JAX package's
cached encoder in int8 (its unfused int8_dense FFN), on the same weights
carried by the bridge (convert/from_jax.py), on tests/test_torch_streaming's
model: 3 layers, d32, 2 heads, chunked_limited (8, 3) attention.

Tolerance, the per-layer int8 rule of the port's offline int8 tests: one
value on an int8 rounding tie can round the other way in the other
package and move its whole token row, so each step's log-probs and
caches agree within INT8_TOL = 1e-3 (the float steps agree within 1e-4)
and that difference stays below a tenth of what int8 itself moves them
(int8 against the float model). Lengths are exact."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_streaming import (CFG, SC, STREAM_ENC, _step_inputs,
                                        _t, seeded_params)
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr.models.streaming import \
    get_initial_cache_state as jax_initial_cache
from tpu_asr_torch.convert.from_jax import jax_to_state_dict
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.models.streaming import (CacheAwareStreamer,
                                            get_initial_cache_state)
from tpu_asr_torch.ops import cuda_ffn

INT8_TOL = 1e-3
ENC_Q = dataclasses.replace(STREAM_ENC, quantization="int8")
CFG_Q = dataclasses.replace(CFG, encoder=ENC_Q)


@pytest.fixture(scope="module")
def models():
    """(JAX int8 stream step, JAX float stream step, the port's int8 model)
    on one set of seeded weights and batch-norm statistics."""
    jq, jf = JaxCTCModel(CFG_Q), JaxCTCModel(CFG)
    v = jax.eval_shape(lambda: jq.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8000)),
        jnp.asarray([8000], jnp.int32)))
    params = seeded_params(v["params"], np.random.default_rng(10))
    rng = np.random.default_rng(11)
    bn = v["batch_stats"]["encoder"]["layers"]["conv"]["batch_norm"]
    stats = {"encoder": {"layers": {"conv": {"batch_norm": {
        "mean": rng.uniform(-0.3, 0.3, bn["mean"].shape).astype(np.float32),
        "var": rng.uniform(0.7, 1.5, bn["var"].shape).astype(np.float32)}}}}}
    variables = {"params": params, "batch_stats": stats}
    port = CTCModel(CFG_Q).eval()
    port.load_state_dict(jax_to_state_dict(params, stats, CFG_Q), strict=True)

    def step(model):
        return jax.jit(lambda f, n, c, drop: model.apply(
            variables, f, n, c, drop, method=JaxCTCModel.stream_step),
            static_argnums=3)
    return step(jq), step(jf), port


def _close(got, want, drift, what):
    delta = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert delta < INT8_TOL and delta <= 0.1 * drift, (what, delta, drift)


@pytest.mark.parametrize("schedule", [
    [[16], [16], [16], [5]],
    [[16, 16, 16], [16, 9, 16], [16, 0, 3], [7, 0, 0]]],
    ids=["b1", "b3_unequal"])
def test_int8_stream_steps_match_jax(models, schedule):
    """Each step of the port's int8 CacheAwareStreamer against JAX's int8
    stream_step on the same inputs (B = 1, and B = 3 with unequal streams
    that end mid-chunk and ride along at chunk_len 0): log-probs and
    caches by the int8 rule, lengths exact; then the port's streamed
    frames against its offline int8 forward on the same features."""
    jq, jf, port = models
    b = len(schedule[0])
    totals = np.sum(schedule, axis=0)
    rng = np.random.default_rng(b)
    feats = np.zeros((b, 16, int(totals.max())), np.float32)
    for i, n in enumerate(totals):
        feats[i, :, :n] = rng.normal(size=(16, n))
    streamer = CacheAwareStreamer(port, device="cpu")
    state = streamer.init_state(b)
    jcq = jcf = jax_initial_cache(STREAM_ENC, b)
    tail, pos, got = None, [0] * b, [[] for _ in range(b)]
    for takes in schedule:
        step_in, n, drop, tail = _step_inputs(feats, pos, takes, tail)
        want, want_len, jcq = jq(jnp.asarray(step_in), jnp.asarray(n), jcq,
                                 drop)
        flt, _, jcf = jf(jnp.asarray(step_in), jnp.asarray(n), jcf, drop)
        chunk = np.zeros((b, 16, SC.chunk_size), np.float32)
        for i, (p, tk) in enumerate(zip(pos, takes)):
            chunk[i, :, :tk] = feats[i, :, p:p + tk]
        with torch.no_grad():
            lp, enc_len, state = streamer.step(state, _t(chunk), _t(takes))
        np.testing.assert_array_equal(enc_len.numpy(), np.asarray(want_len))
        drift = np.abs(np.asarray(want) - np.asarray(flt)).max()
        assert drift > 0
        _close(lp.numpy(), want, drift, "log_probs")
        for g, w, f in zip(state[0], jcq, jcf, strict=True):
            _close(g.numpy(), w, max(drift, np.abs(
                np.asarray(w) - np.asarray(f)).max()), "cache")
        for i in range(b):
            got[i].append(lp[i, :int(enc_len[i])])
            pos[i] += takes[i]
    with torch.no_grad():
        off = port.forward_features(_t(feats), _t(totals))
    for i in range(b):
        n = int(off.encoded_len[i])
        streamed = torch.cat(got[i])
        assert streamed.shape[0] == n
        np.testing.assert_allclose(streamed.numpy(),
                                   off.log_probs[i, :n].numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_int8_step_takes_the_int8_route(models, monkeypatch):
    """The cached int8 layer runs both FFN sublayers through the int8
    wrapper (the kernel on a CUDA tensor), and 'xla' through its plain
    version: two calls a layer a step either way, and the same output."""
    _, _, port = models
    calls = {"wrapper": 0, "plain": 0}
    real_plain = cuda_ffn.ffn_sublayer_int8_plain

    def plain(*a):
        calls["plain"] += 1
        return real_plain(*a)
    import tpu_asr_torch.models.conformer as conformer
    monkeypatch.setattr(conformer, "ffn_sublayer_int8_plain", plain)
    real_fused = conformer.fused_ffn_sublayer_int8

    def fused(*a):
        calls["wrapper"] += 1
        return real_fused(*a)
    monkeypatch.setattr(conformer, "fused_ffn_sublayer_int8", fused)
    feats = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 16, SC.chunk_size)).astype(np.float32))
    outs = []
    for backend in ("auto", "xla"):
        for layer in port.encoder.layers:
            layer.ffn_backend = backend
        with torch.no_grad():
            outs.append(port.stream_step(
                feats, torch.tensor([16, 11]),
                get_initial_cache_state(STREAM_ENC, 2), 0)[0])
    for layer in port.encoder.layers:
        layer.ffn_backend = ENC_Q.ffn_backend
    n = 2 * STREAM_ENC.n_layers
    assert calls == {"wrapper": n, "plain": n}
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
