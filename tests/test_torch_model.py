"""Port parity for the whole serving slice: JAX CTCModel (XLA backends on
the CPU) against tpu_asr_torch's CTCModel with the same weights carried by
the weight bridge (tpu_asr_torch.convert.from_jax), fp32, waveforms made
with numpy from a seed.

- 2 layers, tiny (d 32, 2 heads) and at flagship widths (d 176, 4 heads,
  C 176, 128 tokens + blank): log-probs within 1e-4 / 2e-3 (the
  tests/test_nemo_key_layout.py bound at teacher dims), equal greedy ids and
  encoded_len;
- the bridge is the exact inverse of convert_state_dict;
- greedy CTC decoding of the model's argmax ids equals JAX's decode;
- the port's Transcriber gives JAX's Transcriber's texts.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.config import DecoderConfig, EncoderConfig, ModelConfig
from tpu_asr.convert.nemo_import import convert_state_dict
from tpu_asr.data.tokenizer import train_bpe
from tpu_asr.models.conformer import ConformerLayer as JaxConformerLayer
from tpu_asr.models.conformer import rel_positional_encoding
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr.models.transcribe import Transcriber as JaxTranscriber
from tpu_asr.ops.ctc import ctc_greedy_decode as jax_ctc_greedy_decode
from tpu_asr_torch.convert.from_jax import jax_to_state_dict
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.models.transcribe import Transcriber
from tpu_asr_torch.ops.ctc import ctc_greedy_decode_ids

CONFIGS = {
    "tiny": (ModelConfig(
        spec_augment=None,
        encoder=EncoderConfig(n_layers=2, d_model=32, n_heads=2,
                              conv_kernel_size=7),
        decoder=DecoderConfig(feat_in=32, num_classes=16),
        compute_dtype="float32"), 1e-4),
    "flagship_widths": (ModelConfig(
        spec_augment=None, encoder=EncoderConfig(n_layers=2),
        compute_dtype="float32"), 2e-3),
}


def _variables(cfg, seed):
    """JAX init, then every leaf perturbed so that no identity (unit scale,
    zero bias, zero-mean unit-variance BN statistics) hides a mapping."""
    model = JaxCTCModel(cfg)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8000)),
                   jnp.asarray([8000], jnp.int32))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(
            np.float32), v["params"])
    stats = v["batch_stats"]
    stats = {"encoder": {"layers": {"conv": {"batch_norm": {
        "mean": rng.uniform(-0.3, 0.3, size=stats["encoder"]["layers"]["conv"]
                            ["batch_norm"]["mean"].shape).astype(np.float32),
        "var": rng.uniform(0.7, 1.5, size=stats["encoder"]["layers"]["conv"]
                           ["batch_norm"]["var"].shape).astype(np.float32),
    }}}}}
    return model, params, stats


def _port(cfg, params, stats):
    model = CTCModel(cfg).eval()
    model.load_state_dict(jax_to_state_dict(params, stats, cfg), strict=True)
    return model


def _waves(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=n) * 0.1).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ctc_model_matches_jax(name):
    cfg, tol = CONFIGS[name]
    jmodel, params, stats = _variables(cfg, seed=0)
    waves = _waves(1, [16000, 11000])
    sig = np.zeros((2, 16000), np.float32)
    for i, w in enumerate(waves):
        sig[i, :len(w)] = w
    lens = np.asarray([len(w) for w in waves], np.int32)
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(sig), jnp.asarray(lens), train=False)
    with torch.no_grad():
        got = _port(cfg, params, stats)(torch.from_numpy(sig),
                                        torch.from_numpy(lens))
    np.testing.assert_array_equal(got.encoded_len.numpy(),
                                  np.asarray(want.encoded_len))
    np.testing.assert_allclose(got.log_probs.numpy(),
                               np.asarray(want.log_probs), rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.greedy.numpy(), np.asarray(want.greedy))
    assert got.layer_feats.shape == want.layer_feats.shape


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_conformer_layer_matches_jax(scale):
    """One layer on its own; at input scale 1e-3 the LayerNorm variance is
    ~1e-6, where flax's eps 1e-6 and torch's default 1e-5 part ways."""
    cfg, tol = CONFIGS["tiny"]
    _, params, stats = _variables(cfg, seed=5)
    layer0 = lambda tree: jax.tree.map(lambda a: np.asarray(a)[0], tree)
    rng = np.random.default_rng(6)
    b, t, d = 2, 24, cfg.encoder.d_model
    x = (rng.normal(size=(b, t, d)) * scale).astype(np.float32)
    mask = np.arange(t)[None, :] < np.asarray([t, 17])[:, None]
    pe = np.array(rel_positional_encoding(t, d))
    want = JaxConformerLayer(cfg.encoder).apply(
        {"params": layer0(params["encoder"]["layers"]),
         "batch_stats": layer0(stats["encoder"]["layers"])},
        jnp.asarray(x), jnp.asarray(pe), jnp.asarray(mask), train=False)
    layer = _port(cfg, params, stats).encoder.layers[0]
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(pe),
                    torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bridge_is_the_inverse_of_convert_state_dict(name):
    cfg, _ = CONFIGS[name]
    _, params, stats = _variables(cfg, seed=2)
    back_params, back_stats = convert_state_dict(
        jax_to_state_dict(params, stats, cfg), cfg)
    leaves = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    for (pa, a), (pb, b) in zip(leaves((params, stats)),
                                leaves((back_params, back_stats)),
                                strict=True):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("v", [5, 129])
def test_greedy_decode_of_model_ids_matches_jax(v):
    """The port collapses the model's argmax ids; JAX takes the argmax of
    the log-probs itself. Few classes make repeats and blanks frequent."""
    rng = np.random.default_rng(v)
    log_probs = rng.normal(size=(3, 40, v)).astype(np.float32)
    lens = np.asarray([40, 23, 1], np.int32)
    want_tokens, want_n = jax_ctc_greedy_decode(jnp.asarray(log_probs),
                                                jnp.asarray(lens))
    ids = torch.from_numpy(log_probs).argmax(dim=-1)
    tokens, n = ctc_greedy_decode_ids(ids, torch.from_numpy(lens),
                                      blank=v - 1)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_array_equal(n.numpy(), np.asarray(want_n))


def test_transcriber_matches_jax():
    cfg, _ = CONFIGS["tiny"]
    jmodel, params, stats = _variables(cfg, seed=3)
    tok = train_bpe(["a b c d e f g h"], vocab_size=16)
    waves = _waves(4, [8000, 24000, 12000, 16000, 9000])
    want = JaxTranscriber(jmodel, {"params": params, "batch_stats": stats},
                          tok, batch_size=2).transcribe(waves)
    got = Transcriber(_port(cfg, params, stats), tok,
                      batch_size=2, device="cpu").transcribe(waves)
    assert got == want
    assert any(got)
