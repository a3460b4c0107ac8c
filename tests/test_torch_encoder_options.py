"""Port parity of the encoder options beyond the flagship against the JAX
package on the CPU (attention_backend='xla', the XLA convolutions), fp32,
inputs and weights made with numpy from a seed, weights carried over by
convert/from_jax.py.

- every pre-encode: striding at x2, x8, x16 and with the causal time pad at
  x4 and x8; dw_striding at x2 to x16 and causal at x8; stacking x4,
  stacking_norm x2; the factor-1 Linear: outputs within 1e-4 and lengths
  equal to JAX's subsampled_length over 0..299 frames;
- a 3-layer CTCModel with each of: chunked_limited windows (left limited
  and unlimited), global tokens with and without global_attn_separate,
  pooling and striding reduction after the last layer and mid-stack,
  feat_out, and the rel_pos_local_attn sliding window: log-probs and
  layer_feats within 1e-4, greedy ids and encoded_len equal;
- stochastic depth: at p = 0 the training forward equals JAX's (batch
  statistics, dropout 0) within 1e-4; at p > 0 every layer the port drops
  returns its input exactly and every layer it keeps returns input + (JAX
  ConformerLayer(input) - input) / (1 - p_l), JAX's formula on the port's
  own decisions, within 1e-4 (JAX's layerdrop draws come from another
  generator); a dropped layer's parameters get zero gradients;
- fastconformer_local (profile_forward.model_config) cut to 2 layers at
  d64 (32 subsampling channels, window (8, 8) over T' = 32): one CTC train
  step (DistilCTCModel, CTC loss alone, dropout 0) with the loss within
  1e-4 relative and every gradient within 1e-5 + 1e-4 x its tensor's
  max|ref| (tests/test_torch_train.py's rule); its log-probs:
  tests/test_torch_window.py.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tpu_asr.models.conformer import ConformerLayer as JaxLayer
from tpu_asr.models.conformer import ConvSubsampling as JaxSubsampling
from tpu_asr.models.conformer import rel_positional_encoding as jax_pe
from tpu_asr.models.conformer import subsampled_length as jax_length
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil
from tpu_asr_torch.convert.from_jax import (distil_to_state_dict,
                                           jax_to_state_dict,
                                           pre_encode_to_state_dict)
from tpu_asr_torch.models.conformer import (drop_probs, make_pre_encode,
                                            subsampled_length)
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.profile_forward import model_config
from tpu_asr_torch.train.trainer import DistilTrainState, make_distil_train_step


def _perturbed(tree, rng):
    """JAX's initialisation plus noise at a tenth of each tensor's spread
    (0.02 where it has none), so no zero bias hides a mapping."""
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * max(
        float(np.std(a)), 0.02) * rng.normal(size=a.shape).astype(
            np.float32), tree)


def _stats(tree, rng):
    """BatchNorm running statistics drawn away from (0, 1)."""
    if isinstance(tree, dict):
        return {k: (rng.uniform(-0.3, 0.3, np.shape(v)).astype(np.float32)
                    if k == "mean" else
                    rng.uniform(0.7, 1.5, np.shape(v)).astype(np.float32)
                    if k == "var" else _stats(v, rng))
                for k, v in tree.items()}
    return np.asarray(tree)


# -- the pre-encode --------------------------------------------------------

PRE_ENCODES = [("striding", 2, False), ("striding", 8, False),
               ("striding", 16, False), ("striding", 4, True),
               ("striding", 8, True), ("dw_striding", 2, False),
               ("dw_striding", 4, False), ("dw_striding", 8, False),
               ("dw_striding", 16, False), ("dw_striding", 8, True),
               ("stacking", 4, False), ("stacking_norm", 2, False),
               ("striding", 1, False)]


@pytest.mark.parametrize("sub,factor,causal", PRE_ENCODES)
def test_pre_encode_matches_jax(sub, factor, causal):
    make = lambda m: m.EncoderConfig(
        feat_in=80, d_model=24, subsampling=sub, subsampling_factor=factor,
        subsampling_conv_channels=8, causal_downsampling=causal,
        subsampling_backend="xla" if m is JC else "auto")
    cj, cp = make(JC), make(PC)
    rng = np.random.default_rng(40)
    t = 101
    x = rng.normal(size=(2, t, 80)).astype(np.float32)
    mod = JaxSubsampling(cj)
    params = _perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))[
        "params"], rng)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    port = make_pre_encode(cp)
    port.load_state_dict(pre_encode_to_state_dict(params, cp), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    t_out = int(subsampled_length(torch.tensor(t), factor, sub))
    assert got.shape == want.shape == (2, t_out, 24)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    n = np.arange(300, dtype=np.int32)
    np.testing.assert_array_equal(
        subsampled_length(torch.from_numpy(n), factor, sub).numpy(),
        np.asarray(jax_length(jnp.asarray(n), factor, sub)))


# -- the encoder's options through the CTC model -----------------------------

def _configs(n_layers=3, d=32, heads=2, classes=16, **enc):
    """(JAX, port) ModelConfigs: fp32, no SpecAugment, no dither, every
    dropout 0 (the frameworks draw other random numbers)."""
    def make(m):
        return m.ModelConfig(
            spec_augment=None, preprocessor=m.PreprocessorConfig(dither=0.0),
            encoder=m.EncoderConfig(
                n_layers=n_layers, d_model=d, n_heads=heads,
                conv_kernel_size=7, dropout=0.0, dropout_pre_encoder=0.0,
                dropout_att=0.0, **enc,
                **({"attention_backend": "xla"} if m is JC else {})),
            decoder=m.DecoderConfig(feat_in=enc.get("feat_out", d),
                                    num_classes=classes),
            compute_dtype="float32")
    return make(JC), make(PC)


def _variables(cfg_j, seed):
    v = JaxCTCModel(cfg_j).init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 8000)),
                                jnp.asarray([8000], jnp.int32))
    rng = np.random.default_rng(seed)
    return _perturbed(v["params"], rng), _stats(v["batch_stats"], rng)


def _signal(seed, seconds=(1.5, 1.0)):
    rng = np.random.default_rng(seed)
    n = [int(s * 16000) for s in seconds]
    sig = np.zeros((len(n), max(n)), np.float32)
    for i, k in enumerate(n):
        sig[i, :k] = rng.normal(size=k) * 0.1
    return sig, np.asarray(n, np.int32)


def _port_model(cfg_p, params, stats):
    model = CTCModel(cfg_p).eval()
    model.load_state_dict(jax_to_state_dict(params, stats, cfg_p),
                          strict=True)
    return model


OPTIONS = {
    "chunked": {"att_context_style": "chunked_limited",
                "att_context_size": (8, 3)},
    "chunked_unlimited_left": {"att_context_style": "chunked_limited",
                               "att_context_size": (-1, 5)},
    "global_tokens": {"att_context_size": (4, 4), "global_tokens": 2,
                      "global_tokens_spacing": 5},
    "global_separate": {"att_context_size": (4, 4), "global_tokens": 3,
                        "global_attn_separate": True},
    "pooling_last": {"reduction": "pooling", "reduction_factor": 2},
    "striding_last": {"reduction": "striding", "reduction_factor": 2},
    "pooling_mid": {"reduction": "pooling", "reduction_factor": 2,
                    "reduction_position": 0},
    "striding_mid": {"reduction": "striding", "reduction_factor": 2,
                     "reduction_position": 1},
    "feat_out": {"feat_out": 24},
    "local_attn": {"self_attention_model": "rel_pos_local_attn",
                   "att_context_size": (6, 6)},
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_encoder_option_matches_jax(name):
    cfg_j, cfg_p = _configs(**OPTIONS[name])
    params, stats = _variables(cfg_j, 41)
    sig, lens = _signal(42)
    want = JaxCTCModel(cfg_j).apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(sig), jnp.asarray(lens),
                                    train=False)
    with torch.no_grad():
        got = _port_model(cfg_p, params, stats)(torch.from_numpy(sig),
                                                torch.from_numpy(lens))
    np.testing.assert_array_equal(got.encoded_len.numpy(),
                                  np.asarray(want.encoded_len))
    np.testing.assert_allclose(got.log_probs.numpy(),
                               np.asarray(want.log_probs), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got.greedy.numpy(), np.asarray(want.greedy))
    assert got.layer_feats.shape == want.layer_feats.shape
    np.testing.assert_allclose(got.layer_feats.numpy(),
                               np.asarray(want.layer_feats), rtol=1e-4,
                               atol=1e-4)


# -- stochastic depth ---------------------------------------------------------

def _features(model, sig, lens):
    with torch.no_grad():
        return model.featurizer(torch.from_numpy(sig), torch.from_numpy(lens))


def test_stochastic_depth_off_matches_jax_training_forward():
    """p = 0: the training forward (batch statistics) equals JAX's."""
    cfg_j, cfg_p = _configs(stochastic_depth_drop_prob=0.0,
                            att_context_size=(6, 6))
    params, stats = _variables(cfg_j, 43)
    sig, lens = _signal(44)
    key = jax.random.PRNGKey(0)
    want, _ = JaxCTCModel(cfg_j).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(sig),
        jnp.asarray(lens), train=True, rngs={"dropout": key,
                                             "specaug": key},
        mutable=["batch_stats"])
    model = _port_model(cfg_p, params, stats).train()
    with torch.no_grad():
        got = model(torch.from_numpy(sig), torch.from_numpy(lens), train=True,
                    rngs={"dropout": torch.Generator().manual_seed(1),
                          "specaug": torch.Generator().manual_seed(2)})
    np.testing.assert_allclose(got.log_probs.numpy(),
                               np.asarray(want.log_probs), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["linear", "uniform"])
def test_stochastic_depth_drops_and_rescales(mode):
    n_layers = 4
    cfg_j, cfg_p = _configs(n_layers=n_layers, stochastic_depth_drop_prob=0.6,
                            stochastic_depth_mode=mode,
                            stochastic_depth_start_layer=1)
    params, stats = _variables(cfg_j, 45)
    sig, lens = _signal(46)
    model = _port_model(cfg_p, params, stats).train()
    enc = model.encoder
    feats, feat_len = _features(model, sig, lens)
    probs = drop_probs(cfg_p.encoder)
    assert probs[0] == 0.0 and all(p > 0 for p in probs[1:])
    stacked = params["encoder"]["layers"]
    layer = lambda tree, i: jax.tree.map(lambda a: np.asarray(a)[i], tree)
    seen = set()
    for gen_seed in range(4):
        gen = torch.Generator().manual_seed(gen_seed)
        twin = torch.Generator().manual_seed(gen_seed)
        torch.randint(0, 2 ** 31 - 1, (1 + 5 * n_layers,), generator=twin)
        keep = [u >= p for u, p in zip(
            torch.rand(n_layers, generator=twin).tolist(), probs)]
        x0, x_len = enc.subsample(feats, feat_len)
        out, _, layer_feats = enc.encode_frames(x0, x_len, train=True,
                                                generator=gen)
        t = x0.shape[1]
        mask = np.arange(t)[None, :] < x_len.numpy()[:, None]
        prev = (x0 * cfg_p.encoder.d_model ** 0.5).masked_fill(
            ~torch.from_numpy(mask)[..., None], 0.0).detach().numpy()
        for i in range(n_layers):
            got = layer_feats[i].detach().numpy()
            if not keep[i]:
                np.testing.assert_array_equal(got, prev)
            else:
                y, _ = JaxLayer(cfg_j.encoder).apply(
                    {"params": layer(stacked, i),
                     "batch_stats": layer(stats["encoder"]["layers"], i)},
                    jnp.asarray(prev), jax_pe(t, cfg_j.encoder.d_model),
                    jnp.asarray(mask), train=True, mutable=["batch_stats"])
                y = np.asarray(y)
                want = prev + (y - prev) / max(1.0 - probs[i], 1e-6)
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            seen.add(bool(keep[i]))
            prev = got
        # a dropped layer still runs (its BatchNorm statistics, as JAX's)
        # but adds nothing: zero gradients under remat
        model.zero_grad()
        out.square().sum().backward()
        for i in range(n_layers):
            grads = [p.grad for p in enc.layers[i].parameters()]
            assert all(g is not None for g in grads)
            assert all(bool((g == 0).all()) for g in grads) == (not keep[i])
    assert seen == {True, False}


# -- fastconformer_local at 2 layers, d64 ------------------------------------

def _fastconformer(m):
    enc = dataclasses.asdict(model_config("fastconformer_local").encoder)
    enc.update(n_layers=2, d_model=64, subsampling_conv_channels=32,
               att_context_size=(8, 8), dropout=0.0,
               dropout_pre_encoder=0.0, dropout_att=0.0)
    if m is JC:
        enc["attention_backend"] = "xla"
    return m.ModelConfig(
        spec_augment=None, preprocessor=m.PreprocessorConfig(dither=0.0),
        encoder=m.EncoderConfig(**enc),
        decoder=m.DecoderConfig(feat_in=64, num_classes=1024),
        compute_dtype="float32")


def test_fastconformer_local_ctc_step_matches_jax():
    cfg_j, cfg_p = _fastconformer(JC), _fastconformer(PC)
    jmodel = JaxDistil(cfg_j, cfg_j, JC.DistillationConfig())
    sig, lens = _signal(49, (2.5, 1.5))
    rng = np.random.default_rng(50)
    batch = {"signal": sig, "signal_len": lens,
             "tokens": rng.integers(0, 1024, size=(2, 6)).astype(np.int32),
             "token_len": np.array([6, 4], np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(51)
    v = jmodel.init({"params": key, "specaug": key, "dropout": key,
                     "gumbel": key, "noise": key}, jb["signal"],
                    jb["signal_len"], jb["tokens"], jb["token_len"],
                    train=True)
    params = _perturbed(v["params"], rng)
    stats = jax.tree.map(np.asarray, v["batch_stats"])

    def loss_fn(p):
        out, _ = jmodel.apply(
            {"params": p, "batch_stats": stats}, jb["signal"],
            jb["signal_len"], jb["tokens"], jb["token_len"], train=True,
            rngs={"specaug": key, "dropout": key}, mutable=["batch_stats"])
        return out.losses["total"]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    model = DistilCTCModel(cfg_p, cfg_p, PC.DistillationConfig())
    model.load_state_dict(distil_to_state_dict(params, stats, cfg_p),
                          strict=True)
    state = DistilTrainState.create(
        model, PC.OptimConfig(gradient_clip_val=0.0))
    state, metrics = make_distil_train_step(model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    np.testing.assert_allclose(metrics["loss/total"].item(), float(want_loss),
                               rtol=1e-4)
    grads = distil_to_state_dict(want_grads, stats, cfg_p)
    for name, p in model.named_parameters():
        w = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=name)
