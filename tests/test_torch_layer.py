"""Port parity for the whole eval Conformer layer
(tpu_asr_torch/ops/cuda_layer.py, the counterpart of
tpu_asr/ops/pallas_layer.py::fused_conformer_layer) against the JAX package
on the CPU, inputs made with numpy from a seed, weights from a perturbed JAX
CTCModel through the weight bridge (jax_to_state_dict) into a port
ConformerLayer, then `layer_params`:

- conformer_layer_plain in fp32 against the JAX ConformerLayer in eval
  (XLA attention) within 1e-5 of the output's scale: folded batch norm with
  randomised statistics, layer norm, a causal conv context, a local
  attention window, unequal lengths, T = 50 and 130 (not a multiple of
  128);
- the same against fused_conformer_layer in interpret mode at
  tests/test_pallas_layer.py's tolerance (rtol 0.05, atol 0.03 max|ref|):
  the Pallas kernel rounds every product operand to bf16, the plain
  version keeps fp32 in fp32;
- layer_params equals tests/test_pallas_layer.py's _extract dict (in
  PyTorch layouts; the folded batch norm to fp32 rounding);
- the plain version in bf16 stays within bf16 rounding of fp32;
- the wrapper runs the plain version on the CPU (no launch), refuses
  autograd, other devices and shapes it does not take;
- the fused FFN's gate (ops/cuda_ffn.py): the forward and the backward
  take the teacher's D=176 with d_ff 704; the backward refuses D=256 with
  d_ff 1280, which the forward takes; both refuse D=512 with d_ff 2048
  (shared memory).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pallas_layer import _extract
from tpu_asr.config import DecoderConfig, EncoderConfig, ModelConfig
from tpu_asr.models.conformer import ConformerLayer as JaxLayer
from tpu_asr.models.conformer import rel_positional_encoding as jax_pe
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr.ops.pallas_layer import fused_conformer_layer as pallas_layer
from tpu_asr_torch.convert.from_jax import jax_to_state_dict
from tpu_asr_torch.models.conformer import ConformerLayer
from tpu_asr_torch.ops import cuda_ffn
from tpu_asr_torch.ops.cuda_layer import (conformer_layer_plain,
                                          fused_conformer_layer, layer_params)

D, H, K = 32, 4, 9
# name: (conv norm, conv context, attention window, T)
CASES = {"batch_norm": ("batch_norm", None, (-1, -1), 50),
         "layer_norm": ("layer_norm", None, (-1, -1), 50),
         "causal": ("layer_norm", "causal", (-1, -1), 50),
         "window": ("batch_norm", None, (5, 3), 50),
         "t130": ("batch_norm", None, (-1, -1), 130)}


def _setup(name, seed=0):
    """(JAX encoder config, layer-0 variables, port layer, x, mask)."""
    norm, conv_ctx, window, t = CASES[name]
    enc = EncoderConfig(n_layers=1, d_model=D, n_heads=H, conv_kernel_size=K,
                        conv_norm_type=norm, conv_context_size=conv_ctx,
                        att_context_size=window, attention_backend="xla",
                        dropout=0.0, dropout_att=0.0)
    cfg = ModelConfig(spec_augment=None, encoder=enc,
                      decoder=DecoderConfig(feat_in=D, num_classes=16),
                      compute_dtype="float32")
    v = JaxCTCModel(cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8000)),
                              jnp.asarray([8000], jnp.int32))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(
        size=a.shape).astype(np.float32), v["params"])
    stats = {}
    if norm == "batch_norm":
        stats = jax.tree.map(lambda a: np.asarray(a) + 0.3 * np.abs(
            rng.normal(size=a.shape)).astype(np.float32), v["batch_stats"])
    sd = jax_to_state_dict(params, stats, cfg)
    layer = ConformerLayer(dataclasses.replace(enc, att_context_size=(-1, -1)))
    pre = "encoder.layers.0."
    layer.load_state_dict({k[len(pre):]: w for k, w in sd.items()
                           if k.startswith(pre)}, strict=True)
    index = lambda tree: jax.tree.map(lambda a: np.asarray(a)[0], tree)
    variables = {"params": index(params["encoder"]["layers"])}
    if stats:
        variables["batch_stats"] = index(stats["encoder"]["layers"])
    b = 3
    lengths = np.asarray([t, t - 7, 11])
    mask = np.arange(t)[None, :] < lengths[:, None]
    x = (rng.normal(size=(b, t, D)) * 0.5).astype(np.float32) * mask[..., None]
    return enc, variables, layer.eval(), x, mask


def _norm_kind(enc):
    return "affine" if enc.conv_norm_type == "batch_norm" else "layer_norm"


def _plain(enc, layer, x, mask, dtype=torch.float32):
    with torch.no_grad():
        return conformer_layer_plain(
            torch.from_numpy(x).to(dtype), torch.from_numpy(mask),
            layer_params(layer), H, K, enc.conv_context[0], _norm_kind(enc),
            enc.att_context_size)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_layer(name):
    enc, variables, layer, x, mask = _setup(name)
    t = x.shape[1]
    want = np.asarray(JaxLayer(enc, dtype=jnp.float32).apply(
        variables, jnp.asarray(x), jax_pe(t, D), jnp.asarray(mask),
        train=False))
    got = _plain(enc, layer, x, mask).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)


@pytest.mark.parametrize("name", ["batch_norm", "layer_norm", "causal",
                                  "window"])
def test_plain_matches_pallas_interpret(name):
    enc, variables, layer, x, mask = _setup(name, seed=1)
    prm, norm = _extract(variables["params"], enc, variables)
    want = np.asarray(pallas_layer(
        jnp.asarray(x), jnp.asarray(mask), prm, n_heads=H,
        conv_kernel_size=K, conv_pad_l=enc.conv_context[0], conv_norm=norm,
        att_context_size=enc.att_context_size, interpret=True))
    got = _plain(enc, layer, x, mask).numpy()
    np.testing.assert_allclose(got, want, rtol=0.05,
                               atol=0.03 * np.abs(want).max())


@pytest.mark.parametrize("name", ["batch_norm", "layer_norm"])
def test_layer_params_equal_extract(name):
    enc, variables, layer, _, _ = _setup(name, seed=2)
    want, _ = _extract(variables["params"], enc, variables)
    got = {k: v.numpy() for k, v in layer_params(layer).items()}
    tr = {"w11", "w12", "w21", "w22", "wq_full", "wk_full", "wv_full",
          "wo_full", "w1", "w2c"}
    for key, value in want.items():
        w = np.asarray(value)
        if key in tr:
            w = w.T
        elif key == "pos_kernel":
            w = w.reshape(D, D).T
        elif key == "wd":
            w = w[:, 0, :].T
        if key in ("nw", "nb"):
            np.testing.assert_allclose(got[key], w, rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert set(got) == set(want)


def test_plain_bf16_rounds_only_the_operands():
    enc, _, layer, x, mask = _setup("batch_norm", seed=3)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    got = _plain(enc, layer, x16.float().numpy(), mask, torch.bfloat16)
    want = _plain(enc, layer, x16.float().numpy(), mask)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=3e-2,
                               atol=3e-2 * max(1.0, want.abs().max().item()))


def test_wrapper_runs_plain_on_cpu_and_refuses():
    enc, _, layer, x, mask = _setup("layer_norm", seed=4)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    prm = layer_params(layer)
    args = (H, K, enc.conv_context[0], "layer_norm")
    before = fused_conformer_layer.launches
    torch.testing.assert_close(fused_conformer_layer(xt, mt, prm, *args),
                               conformer_layer_plain(xt, mt, prm, *args),
                               rtol=0, atol=0)
    assert fused_conformer_layer.launches == before
    with pytest.raises(RuntimeError, match="no gradient"):
        fused_conformer_layer(xt.clone().requires_grad_(), mt, prm, *args)
    with pytest.raises(ValueError, match="conv_norm"):
        fused_conformer_layer(xt, mt, prm, H, K, 4, "group_norm")
    with pytest.raises(ValueError, match="conv_pad_l"):
        fused_conformer_layer(xt, mt, prm, H, K, K, "layer_norm")
    with pytest.raises(ValueError, match="shapes"):
        fused_conformer_layer(xt, mt, prm, 3, *args[1:])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_conformer_layer(xt.to("meta"), mt.to("meta"),
                              {k: v.to("meta") for k, v in prm.items()},
                              *args)


def test_ffn_gate_takes_the_teacher_width_in_eval_only():
    """The FFN kernels' width gate: the teacher's d176/704 in eval and, since
    the backward no longer keeps D in registers, in training too;
    d256/1280 in eval only (the backward's tiles exceed shared memory);
    d512/2048 in neither (the forward's do)."""
    def check(d, f, train, dtype=torch.float32):
        meta = lambda *s: torch.empty(s, device="meta", dtype=dtype)
        cuda_ffn._check(meta(2, 3, d), meta(d), meta(f, d), meta(d, f),
                        train)

    assert cuda_ffn.fwd_smem(176, 704) <= 227 * 1024
    check(176, 704, train=False)
    check(88, 352, train=True)
    for dtype in (torch.float32, torch.bfloat16):
        check(176, 704, train=True, dtype=dtype)
        check(256, 1280, train=False, dtype=dtype)
        with pytest.raises(ValueError, match="backward kernel"):
            check(256, 1280, train=True, dtype=dtype)
    with pytest.raises(ValueError, match="shared memory"):
        check(512, 2048, train=False)
