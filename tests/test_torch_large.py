"""Port parity at conformer-LARGE's and conformer-XLarge's widths (d512 /
8 heads / d_ff 2048 / k=31, dk 64; d1024 / 8 heads / k=5, dk 128) against
the JAX package on the CPU, inputs and weights made with numpy from a seed.

- the block attention's plain version in bf16 against the Pallas block
  kernel in interpret mode at dk 128 (t=40, d=256, 2 heads, ragged), the
  forward and the gradients at dropout 0 and 0.1 with the same seed, at
  tests/test_torch_attention.py's bf16 tolerances;
- the per-head attention's plain version against the Pallas per-head
  kernel in interpret mode at dk 128, forward and gradients, at
  tests/test_torch_attention_heads.py's tolerances;
- attention_refusal takes bf16 D=1024 with 8 heads (dk 128) and refuses dk
  132 and dk % 4 != 0 in bf16; the fp32 backward takes T <= 160 at dk 128
  (its shared-memory window), the bf16 one any T; the model's 'auto' route
  at d1024 / 8 heads takes the kernel in eval and under autograd (fp32
  under autograd only up to T = 160);
- a LARGE-shaped CTCModel (2 layers) and an XLarge-shaped one (1 layer) in
  fp32, weights through convert/from_jax.py: log-probs within 1e-4 of
  JAX's, equal greedy ids and encoded_len;
- the LARGE-shaped model (1 layer) with quantization='int8' against JAX's
  int8 route: max |delta log-prob| < 1e-3 (tests/test_torch_quant.py's
  bound), and frame by frame chip_smoke.py phase 11's rule: at most 10% of
  the frames beyond 1e-4 and none beyond half the int8-vs-fp drift. At
  D=512 a quantization step flips where the two chains' LN sums and scales
  round apart (5 of 76 frames here), so the end-to-end tenth of the drift
  that holds at d64 does not;
- the CTC train step (DistilCTCModel with the CTC loss alone, every
  dropout 0, no SpecAugment, no dither) of the LARGE shape (2 layers) and
  the XLarge shape (1 layer, the plain dk-128 backward inside the model),
  B=2 x 1-1.5 s: the loss within 1e-4 relative, every gradient by
  tests/test_torch_train.py's rule (1e-5 + 1e-4 x its tensor's max|ref|),
  but for the first subsampling conv's channels whose pre-activation comes
  within 1e-6 of its largest magnitude of zero: the two frameworks' log-mel
  features and convolutions round apart by about that much, so the ReLU
  after such a channel may flip, and with it the channel's weight and bias
  gradients (3 channels of XLarge's 1024 here, at |z| 7e-9 to 2.3e-6 of
  7.8). At most 5% of the channels are such ties, and the other channels
  are held to the rule.
Weights are JAX's initialisation plus noise at a tenth of each tensor's
spread (0.02 where it has none), so no identity hides a mapping and the
activations keep the scale of a trained model at these widths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tests.test_torch_attention import (_PARAM_ORDER, _as_jax_layout,
                                        _inputs, _jax_params, _pallas_run,
                                        _torch_params)
from tests.test_torch_attention_heads import _close_to_scale
from tests.test_torch_attention_heads import _inputs as _head_inputs
from tests.test_torch_attention_heads import _torch_grads
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil
from tpu_asr.ops.pallas_attention import fused_relpos_attention as pallas_att
from tpu_asr_torch.convert.from_jax import (distil_to_state_dict,
                                           jax_to_state_dict)
from tpu_asr_torch.models.conformer import (RelPositionMultiHeadAttention,
                                            rel_positional_encoding)
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.ops.cuda_attention import (MAX_DK, attention_refusal,
                                              bwd_refusal,
                                              relpos_attention_plain)
from tpu_asr_torch.train.trainer import DistilTrainState, make_distil_train_step


def _config(mod, shape: str, n_layers: int, quantization: str = "none"):
    """LARGE's or XLarge's encoder at `n_layers`, fp32, no SpecAugment, no
    dither, every dropout 0 (the two frameworks draw other random
    numbers)."""
    d, k = (512, 31) if shape == "large" else (1024, 5)
    enc = mod.EncoderConfig(n_layers=n_layers, d_model=d, n_heads=8,
                            conv_kernel_size=k, dropout=0.0,
                            dropout_pre_encoder=0.0, dropout_att=0.0,
                            quantization=quantization)
    return mod.ModelConfig(spec_augment=None,
                           preprocessor=mod.PreprocessorConfig(dither=0.0),
                           encoder=enc,
                           decoder=mod.DecoderConfig(feat_in=d,
                                                     num_classes=128),
                           compute_dtype="float32")


def _perturbed(tree, rng):
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * max(
        float(np.std(a)), 0.02) * rng.normal(size=a.shape).astype(
            np.float32), tree)


def _stats(stats, rng):
    stats = jax.tree.map(np.asarray, stats)
    bn = stats["encoder"]["layers"]["conv"]["batch_norm"]
    bn["mean"] = rng.uniform(-0.3, 0.3, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.7, 1.5, bn["var"].shape).astype(np.float32)
    return stats


def _signal(seed):
    rng = np.random.default_rng(seed)
    sig = (rng.normal(size=(2, 24000)) * 0.1).astype(np.float32)
    sig[1, 16000:] = 0.0
    return sig, np.asarray([24000, 16000], np.int32)


# -- the attention kernels' arithmetic at dk 128 -----------------------------


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 77)])
def test_block_plain_bf16_dk128_matches_pallas_interpret(rate, seed):
    t, d, h = 40, 256, 2
    rng = np.random.default_rng(30)
    p = _jax_params(rng, d, h)
    x, mask = _inputs(rng, 2, t, d, [t, 27])
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


@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.3, 7)])
def test_heads_plain_dk128_matches_pallas_interpret(rate, seed):
    t, dk, b, h = 40, 128, 2, 2
    lengths = [t, t - 9]
    qkv, w, mask, cot = _head_inputs(31, b, h, t, dk, lengths)
    d = h * dk
    valid = jnp.asarray(mask)[:, None, :, None]
    jseed = None if seed is None else jnp.asarray([seed], jnp.int32)

    def loss(q_u, q_v, k, v, w):
        out = pallas_att(q_u, q_v, k, v, w.reshape(d, h, dk),
                         jnp.asarray(mask), dropout_rate=rate,
                         dropout_seed=jseed, interpret=True)
        return jnp.sum(jnp.where(valid, out, 0.0) * cot), out

    (_, want), jgrads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*map(jnp.asarray,
                                                          qkv + [w]))
    got, tgrads = _torch_grads(qkv, w, mask, cot, (-1, -1), rate, seed)
    for i, ln in enumerate(lengths):
        np.testing.assert_allclose(got[i, :, :ln], np.asarray(want)[i, :, :ln],
                                   rtol=5e-3, atol=4e-3)
    for name, g, jg in zip(["dq_u", "dq_v", "dk", "dv", "dw_pos"], tgrads,
                           jgrads):
        _close_to_scale(g, np.asarray(jg), 2e-2, name)


@pytest.mark.parametrize("dtype,d,h,takes", [
    (torch.bfloat16, 1024, 8, True),     # conformer-XLarge: dk 128
    (torch.float32, 1024, 8, True),
    (torch.bfloat16, 512, 8, True),      # conformer-LARGE: dk 64
    (torch.bfloat16, 1056, 8, False),    # dk 132 > MAX_DK
    (torch.float32, 1056, 8, False),
    (torch.bfloat16, 1000, 8, False),    # dk 125: not a multiple of 4
    (torch.float32, 1000, 8, True),      # the SIMT kernels take any dk
])
def test_attention_refusal_up_to_dk_128(dtype, d, h, takes):
    assert MAX_DK == 128
    assert (attention_refusal(dtype, d, h, 376, False) is None) == takes


@pytest.mark.parametrize("t", [160, 161, 376])
def test_fp32_backward_takes_t_up_to_160_at_dk_128(t):
    """The fp32 backward keeps a T-long position window in shared memory:
    at dk 128 it takes T <= 160, so XLarge's T' = 376 trains its attention
    in bf16; the bf16 backward streams the window through a ring."""
    assert (bwd_refusal(torch.float32, t, 128) is None) == (t <= 160)
    assert (attention_refusal(torch.float32, 1024, 8, t, True)
            is None) == (t <= 160)
    assert attention_refusal(torch.bfloat16, 1024, 8, t, True) is None


@pytest.mark.parametrize("dtype,t,grad,takes", [
    (torch.bfloat16, 376, False, True), (torch.bfloat16, 376, True, True),
    (torch.float32, 376, False, True), (torch.float32, 376, True, False),
    (torch.float32, 160, True, True)])
def test_auto_route_takes_the_kernel_at_xlarge(dtype, t, grad, takes):
    """'auto' at conformer-XLarge's d1024 / 8 heads takes the block kernel
    in eval and under autograd, but for the fp32 backward past T = 160,
    whose refusal sends it to the plain version."""
    att = RelPositionMultiHeadAttention(1024, 8).to(dtype)
    x = torch.zeros(1, t, 1024, dtype=dtype)
    with torch.set_grad_enabled(grad):
        assert att.uses_kernel(x) == takes


# -- the models ----------------------------------------------------------------


def _model_variables(cfg, seed):
    v = JaxCTCModel(cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8000)),
                              jnp.asarray([8000], jnp.int32))
    rng = np.random.default_rng(seed)
    return _perturbed(v["params"], rng), _stats(v["batch_stats"], rng)


def _jax_and_port(cfg_j, cfg_p, params, stats, sig, lens):
    want = JaxCTCModel(cfg_j).apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(sig), jnp.asarray(lens),
                                    train=False)
    model = CTCModel(cfg_p).eval()
    model.load_state_dict(jax_to_state_dict(params, stats, cfg_p),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(sig), torch.from_numpy(lens))
    return got, want


@pytest.mark.parametrize("shape,n_layers", [("large", 2), ("xlarge", 1)])
def test_ctc_model_matches_jax(shape, n_layers):
    cfg_j, cfg_p = (_config(m, shape, n_layers) for m in (JC, PC))
    params, stats = _model_variables(cfg_j, 32)
    sig, lens = _signal(33)
    got, want = _jax_and_port(cfg_j, cfg_p, params, stats, sig, lens)
    np.testing.assert_array_equal(got.encoded_len.numpy(),
                                  np.asarray(want.encoded_len))
    np.testing.assert_allclose(got.log_probs.numpy(),
                               np.asarray(want.log_probs), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got.greedy.numpy(), np.asarray(want.greedy))


def test_large_int8_model_matches_jax():
    cfg_j, cfg_p = (_config(m, "large", 1, "int8") for m in (JC, PC))
    params, stats = _model_variables(cfg_j, 34)
    sig, lens = _signal(35)
    got, want_q = _jax_and_port(cfg_j, cfg_p, params, stats, sig, lens)
    fp = dataclasses.replace(cfg_j, encoder=dataclasses.replace(
        cfg_j.encoder, quantization="none"))
    want_fp = JaxCTCModel(fp).apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(sig), jnp.asarray(lens),
                                    train=False)
    np.testing.assert_array_equal(got.encoded_len.numpy(),
                                  np.asarray(want_q.encoded_len))
    delta = np.abs(got.log_probs.numpy()
                   - np.asarray(want_q.log_probs)).max(-1)
    drift = np.abs(np.asarray(want_q.log_probs)
                   - np.asarray(want_fp.log_probs)).max()
    assert drift > 0
    assert delta.max() < 1e-3 and delta.max() <= 0.5 * drift, (delta, drift)
    assert (delta > 1e-4).sum() <= 0.1 * delta.size, delta


# -- the CTC train step --------------------------------------------------------


def _batch():
    rng = np.random.default_rng(36)
    return {"signal": (rng.normal(size=(2, 24000)) * 0.1).astype(np.float32),
            "signal_len": np.array([24000, 16000], np.int32),
            "tokens": rng.integers(0, 128, size=(2, 6)).astype(np.int32),
            "token_len": np.array([6, 4], np.int32)}


@pytest.mark.parametrize("shape,n_layers", [("large", 2), ("xlarge", 1)])
def test_ctc_train_step_matches_jax(shape, n_layers):
    cfg_j, cfg_p = (_config(m, shape, n_layers) for m in (JC, PC))
    jmodel = JaxDistil(cfg_j, cfg_j, JC.DistillationConfig())
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    key = jax.random.PRNGKey(37)
    v = jmodel.init({"params": key, "specaug": key, "dropout": key,
                     "gumbel": key, "noise": key}, jb["signal"],
                    jb["signal_len"], jb["tokens"], jb["token_len"],
                    train=True)
    rng = np.random.default_rng(37)
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
        state, {k: torch.from_numpy(v) for k, v in _batch().items()}, 0)
    np.testing.assert_allclose(metrics["loss/total"].item(), float(want_loss),
                               rtol=1e-4)
    grads = distil_to_state_dict(want_grads, stats, cfg_p)
    ties = _relu_tie_channels(model)
    assert ties.mean() <= 0.05, ties.sum()
    for name, p in model.named_parameters():
        got, w = p.grad.numpy(), grads[name].numpy()
        if "pre_encode.conv.0." in name:
            got, w = got[~ties], w[~ties]
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=name)


def _relu_tie_channels(model):
    """(C,) bool: the first subsampling conv's channels whose pre-activation
    on _batch() comes within 1e-6 x its largest magnitude of zero."""
    b = _batch()
    with torch.no_grad():
        feats, _ = model.student.featurizer(torch.from_numpy(b["signal"]),
                                            torch.from_numpy(b["signal_len"]))
        z = model.student.encoder.pre_encode.conv[0](
            feats.transpose(1, 2)[:, None])
    near = z.abs() < 1e-6 * z.abs().max()
    return near.any(-1).any(-1).any(0).numpy()
