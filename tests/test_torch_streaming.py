"""Port parity for cache-aware streaming: tpu_asr_torch's stream path
(ops/positions.py cache_len, the rectangular rel_shift, the kv-cache
attention, the conv time cache, ConformerEncoder.stream_step,
CTCModel.stream_step, models/streaming.py) against the JAX package's on
the CPU, fp32, with the JAX model's weights carried by the bridge
(convert/from_jax.py) and inputs made with numpy from a seed.

The model is tests/test_streaming.py's: 3 layers, d32, 2 heads, conv k=9,
causal subsampling, chunked_limited (8, 3) attention, 16 mels, 8 tokens.
Tolerances: positions and rel_shift exact; each step's log-probs and
caches within 1e-4; frame ids equal."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.config import (DecoderConfig, EncoderConfig, ModelConfig,
                            PreprocessorConfig)
from tpu_asr.models.conformer import rel_positional_encoding as jax_pe
from tpu_asr.models.conformer import rel_shift as jax_rel_shift
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr.models.streaming import CacheAwareStreamer as JaxStreamer
from tpu_asr.models.streaming import \
    get_initial_cache_state as jax_initial_cache
from tpu_asr.models.streaming import \
    setup_streaming_params as jax_setup_streaming_params
from tpu_asr_torch.convert.from_jax import jax_to_state_dict
from tpu_asr_torch.models.conformer import subsampled_length
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.models.streaming import (CacheAwareStreamer,
                                            get_initial_cache_state,
                                            setup_streaming_params)
from tpu_asr_torch.ops.cuda_attention import rel_shift
from tpu_asr_torch.ops.positions import rel_positional_encoding

STREAM_ENC = EncoderConfig(
    feat_in=16, n_layers=3, d_model=32, n_heads=2, conv_kernel_size=9,
    dropout=0.0, dropout_att=0.0, dropout_pre_encoder=0.0,
    causal_downsampling=True, conv_context_size="causal",
    att_context_style="chunked_limited", att_context_size=(8, 3))
CFG = ModelConfig(preprocessor=PreprocessorConfig(features=16),
                  spec_augment=None, encoder=STREAM_ENC,
                  decoder=DecoderConfig(feat_in=32, num_classes=8),
                  compute_dtype="float32")
SC = jax_setup_streaming_params(STREAM_ENC)
TOL = 1e-4


def seeded_params(shapes, rng):
    """Numpy weights for a tree of JAX parameter shapes (jax.eval_shape of
    an init, which an eager init takes seconds to draw): scales near 1,
    small biases, matrices scaled by fan-in."""
    def draw(path, a):
        name = str(path[-1])
        if "scale" in name:
            return (1.0 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if len(a.shape) < 2 or "pos_bias" in name:
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1]))
        return (rng.normal(size=a.shape) / fan_in ** 0.5).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _build(conv0_bias_sign: float):
    """(JAX model, its variables perturbed off every identity, the port's
    model with the same weights, a jitted JAX stream step taking the
    number of frames to drop). The first subsampling conv's biases get
    the sign given: JAX's first streaming step matches the offline
    forward only where they are <= 0 (models/streaming.py)."""
    jmodel = JaxCTCModel(CFG)
    v = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8000)),
        jnp.asarray([8000], jnp.int32)))
    params = seeded_params(v["params"], np.random.default_rng(0))
    conv0 = params["encoder"]["pre_encode"]["conv0"]
    conv0["bias"] = conv0_bias_sign * np.abs(conv0["bias"])
    rng = np.random.default_rng(1)
    bn = v["batch_stats"]["encoder"]["layers"]["conv"]["batch_norm"]
    stats = {"encoder": {"layers": {"conv": {"batch_norm": {
        "mean": rng.uniform(-0.3, 0.3, bn["mean"].shape).astype(np.float32),
        "var": rng.uniform(0.7, 1.5, bn["var"].shape).astype(np.float32)}}}}}
    variables = {"params": params, "batch_stats": stats}
    port = CTCModel(CFG).eval()
    port.load_state_dict(jax_to_state_dict(params, stats, CFG), strict=True)
    step = jax.jit(lambda f, n, c, drop: jmodel.apply(
        variables, f, n, c, drop, method=JaxCTCModel.stream_step),
        static_argnums=3)
    return jmodel, variables, port, step


@pytest.fixture(scope="module")
def models():
    return _build(1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rel_shift_rectangular_matches_jax():
    rng = np.random.default_rng(1)
    for tq, c in ((5, 4), (4, 108), (6, 0)):
        t_kv = tq + c
        x = rng.normal(size=(2, 3, tq, tq + t_kv - 1)).astype(np.float32)
        np.testing.assert_array_equal(
            rel_shift(torch.from_numpy(x), t_kv).numpy(),
            np.asarray(jax_rel_shift(jnp.asarray(x), t_kv=t_kv)))


@pytest.mark.parametrize("t,d,cache_len", [(4, 32, 8), (4, 176, 108),
                                           (7, 16, 0)])
def test_cache_len_positions_match_jax(t, d, cache_len):
    got = rel_positional_encoding(t, d, cache_len=cache_len).numpy()
    assert got.shape == (cache_len + 2 * t - 1, d)
    np.testing.assert_array_equal(got, np.asarray(jax_pe(
        t, d, cache_len=cache_len)))


def test_causal_subsampling_length_contract(models):
    """Causal subsampling keeps the standard length formula and is
    translation covariant (frame j depends only on inputs <= 4j); its
    frames are JAX's."""
    jmodel, variables, port, _ = models
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(1, 16, 40)).astype(np.float32)
    lens = np.asarray([40], np.int32)
    with torch.no_grad():
        out, out_len, _ = port.encoder(_t(feats), _t(lens))
        feats2 = feats.copy()
        feats2[:, :, 30:] += 3.0
        out2, _, _ = port.encoder(_t(feats2), _t(lens))
    assert int(out_len[0]) == int(subsampled_length(_t(lens), 4)[0]) == 10
    np.testing.assert_allclose(out[:, :5].numpy(), out2[:, :5].numpy(),
                               atol=1e-5)
    want = jmodel.apply(variables, jnp.asarray(feats), jnp.asarray(lens),
                        method=JaxCTCModel.forward_features)
    np.testing.assert_allclose(out.numpy(), np.asarray(want.encoded),
                               rtol=TOL, atol=TOL)


def _step_inputs(feats, pos, takes, tail):
    """The streamer's step inputs: [tail; zero-padded chunk] (the chunk
    alone at the first step, `tail` None), the frames to drop, and the
    next per-sample tails (the pre-encode frames that end at each
    sample's last valid frame)."""
    b, f = feats.shape[:2]
    pre = SC.pre_encode_cache_size
    chunk = np.zeros((b, f, SC.chunk_size), np.float32)
    for i, (p, tk) in enumerate(zip(pos, takes)):
        chunk[i, :, :tk] = feats[i, :, p:p + tk]
    held = 0 if tail is None else pre
    step_in = chunk if tail is None else np.concatenate([tail, chunk], 2)
    padded = np.concatenate([np.zeros((b, f, pre), np.float32), step_in], 2)
    new_tail = np.stack([padded[i][:, held + tk + np.arange(pre)]
                         for i, tk in enumerate(takes)])
    n = np.asarray(takes, np.int32) + held
    return step_in, n, SC.drop_extra_pre_encoded if held else 0, new_tail


def _stream_both(port, jstep, feats, schedule):
    """Step the port's and JAX's stream_step over `schedule` (a list of
    per-sample frame counts a step) on the same inputs; every step's
    log-probs, lengths and caches must agree. Returns each sample's
    streamed log-probs."""
    b = feats.shape[0]
    jcache = jax_initial_cache(STREAM_ENC, b)
    cache = get_initial_cache_state(STREAM_ENC, b)
    tail, pos, got = None, [0] * b, [[] for _ in range(b)]
    for takes in schedule:
        step_in, n, drop, tail = _step_inputs(feats, pos, takes, tail)
        want_lp, want_len, jcache = jstep(jnp.asarray(step_in),
                                          jnp.asarray(n), jcache, drop)
        lp, enc_len, cache = port.stream_step(_t(step_in), _t(n), cache,
                                              drop)
        np.testing.assert_array_equal(enc_len.numpy(), np.asarray(want_len))
        np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp),
                                   rtol=TOL, atol=TOL)
        for g, w in zip(cache, jcache, strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL)
        for i in range(b):
            got[i].append(lp[i, :int(enc_len[i])])
            pos[i] += takes[i]
    return [torch.cat(g) for g in got]


def _assert_offline(port, feats, lens, streamed):
    with torch.no_grad():
        off = port.forward_features(_t(feats), _t(lens))
    for i, got in enumerate(streamed):
        n = int(off.encoded_len[i])
        assert got.shape[0] == n
        np.testing.assert_allclose(got.numpy(), off.log_probs[i, :n].numpy(),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t_raw", [48, 53, 61])
def test_stream_step_matches_jax(models, t_raw):
    """Each step's log-probs, encoded lengths and caches against JAX's on
    the streamer's inputs (the first chunk alone, then [tail; chunk]
    dropping the recomputed frames); the streamed frames against the
    port's offline forward."""
    _, _, port, jstep = models
    feats = np.random.default_rng(t_raw).normal(
        size=(1, 16, t_raw)).astype(np.float32)
    schedule = [[min(SC.chunk_size, t_raw - p)]
                for p in range(0, t_raw, SC.chunk_size)]
    _assert_offline(port, feats, [t_raw],
                    _stream_both(port, jstep, feats, schedule))


def test_batched_unequal_streams_match_jax(models):
    """Two streams in one batch: B ends with a partial chunk and then rides
    along with chunk_len 0 while A keeps streaming; each step's outputs
    and caches are JAX's, and each stream's frames its offline ones."""
    _, _, port, jstep = models
    rng = np.random.default_rng(5)
    t_a, t_b = 61, 37
    feats = np.zeros((2, 16, t_a), np.float32)
    feats[0] = rng.normal(size=(16, t_a))
    feats[1, :, :t_b] = rng.normal(size=(16, t_b))
    schedule = list(map(list, zip([16, 16, 16, 13], [16, 16, 5, 0])))
    _assert_offline(port, feats, [t_a, t_b],
                    _stream_both(port, jstep, feats, schedule))


def test_streamer_step_matches_jax_with_tails(models):
    """CacheAwareStreamer.step on a batch of unequal chunks: log-probs,
    lengths and caches are JAX's stream_step's on the same inputs, and the
    per-sample feature tails are the frames that end each chunk."""
    _, _, port, jstep = models
    rng = np.random.default_rng(6)
    streamer = CacheAwareStreamer(port, device="cpu")
    state = streamer.init_state(3)
    jcache, tail = jax_initial_cache(STREAM_ENC, 3), None
    for lens in ([16, 16, 16], [16, 9, 0], [3, 0, 0]):
        feats = rng.normal(size=(3, 16, SC.chunk_size)).astype(np.float32)
        step_in, n, drop, tail = _step_inputs(feats, [0, 0, 0], lens, tail)
        want_lp, want_len, jcache = jstep(jnp.asarray(step_in),
                                          jnp.asarray(n), jcache, drop)
        chunk = step_in[:, :, -SC.chunk_size:]
        with torch.no_grad():
            lp, enc_len, state = streamer.step(state, _t(chunk), _t(lens))
        np.testing.assert_array_equal(enc_len.numpy(), np.asarray(want_len))
        np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp),
                                   rtol=TOL, atol=TOL)
        for g, w in zip(state[0], jcache, strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL)
        np.testing.assert_array_equal(state[1].numpy(), tail)


def test_streamer_matches_jax_and_offline_greedy(models):
    """CacheAwareStreamer.stream (featurizer, tails, caches, per-chunk
    argmax) gives the port's offline greedy ids; with the first
    subsampling conv's biases <= 0, where JAX's first step is exact too,
    JAX's streamer's ids."""
    sig = (np.random.default_rng(4).normal(size=16000) * 0.1).astype(
        np.float32)
    for jmodel, variables, port, _ in (models, _build(-1.0)):
        ids = CacheAwareStreamer(port, device="cpu").stream(sig,
                                                            return_ids=True)
        with torch.no_grad():
            out = port(_t(sig[None]), _t([len(sig)]))
        assert ids == out.greedy[0, :int(out.encoded_len[0])].tolist()
    assert ids == JaxStreamer(jmodel, variables).stream(sig, return_ids=True)


def test_jax_first_step_with_positive_bias_leaves_offline(models):
    """The reference's fault that the port's first step repairs: JAX's
    streamer feeds its first chunk after a zero tail and drops two frames,
    and the first conv's positive biases make relu(bias) of the zeros
    where the offline forward pads with zeros."""
    jmodel, variables, port, jstep = models
    feats = np.random.default_rng(7).normal(size=(1, 16, 16)).astype(
        np.float32)
    pre = SC.pre_encode_cache_size
    zero_tail = np.concatenate([np.zeros((1, 16, pre), np.float32), feats],
                               2)
    lp_jax, _, _ = jstep(jnp.asarray(zero_tail), jnp.asarray([16 + pre]),
                         jax_initial_cache(STREAM_ENC, 1),
                         SC.drop_extra_pre_encoded)
    with torch.no_grad():
        off = port.forward_features(_t(feats), _t([16])).log_probs[0]
    assert np.abs(np.asarray(lp_jax[0]) - off.numpy()).max() > 1e-2
    streamer = CacheAwareStreamer(port, device="cpu")
    with torch.no_grad():
        lp, _, _ = streamer.step(streamer.init_state(1), _t(feats), _t([16]))
    np.testing.assert_allclose(lp[0].numpy(), off.numpy(), rtol=TOL,
                               atol=TOL)


def test_setup_streaming_params_matches_jax_and_refuses():
    flagship = dataclasses.replace(
        EncoderConfig(), causal_downsampling=True,
        conv_context_size="causal", att_context_style="chunked_limited",
        att_context_size=(108, 3))
    for enc in (STREAM_ENC, flagship,
                dataclasses.replace(STREAM_ENC, att_context_size=(-1, 1))):
        assert dataclasses.asdict(setup_streaming_params(enc)) == \
            dataclasses.asdict(jax_setup_streaming_params(enc))
    sc = setup_streaming_params(flagship)
    assert (sc.chunk_size, sc.valid_out_len, sc.last_channel_cache_size,
            sc.last_time_cache_size) == (16, 4, 108, 30)
    for change, what in (({"causal_downsampling": False},
                          "causal_downsampling"),
                         ({"conv_context_size": None}, "conv_context_size"),
                         ({"att_context_style": "regular"},
                          "att_context_style"),
                         ({"att_context_size": (8, -1)}, "right att")):
        bad = dataclasses.replace(STREAM_ENC, **change)
        with pytest.raises(ValueError, match=what):
            setup_streaming_params(bad)
        with pytest.raises(ValueError, match=what):
            jax_setup_streaming_params(bad)
    for change, what in (({"reduction": "pooling", "reduction_factor": 2},
                          "time reduction"),):
        model = CTCModel(dataclasses.replace(CFG, encoder=dataclasses.replace(
            STREAM_ENC, **change))).eval()
        with pytest.raises(ValueError, match=what):
            model.stream_step(torch.zeros(1, 16, 16), torch.tensor([16]),
                              get_initial_cache_state(STREAM_ENC, 1), 0)
    lc, lc_len, lt = get_initial_cache_state(STREAM_ENC, 2)
    want = jax_initial_cache(STREAM_ENC, 2)
    assert lc.shape == want[0].shape and lt.shape == want[2].shape
    assert lc_len.shape == want[1].shape
