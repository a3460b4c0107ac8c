"""Port parity for the eval conv module: the plain version of the conv
kernel (tpu_asr_torch/ops/cuda_conv.py), the port's ConformerConvolution
and the weight bridge for a layer-norm conv, against the JAX package on
the CPU, inputs made with numpy from a seed.

- conv_module_plain in fp32 against the JAX ConformerConvolution's XLA
  path within 1e-5: folded batch norm with randomised statistics, layer
  norm, and the causal context (k - 1, 0), ragged masks; also at D=512,
  k=31 (folded batch norm; causal layer norm);
- the same against fused_conv_module in interpret mode within rtol 2e-2,
  atol 1.2e-2: the Pallas kernel rounds its dot operands to bf16 even for
  fp32 input (the tolerance of tests/test_pallas_conv.py);
- the port's ConformerConvolution with conv_backend='pallas' in eval
  equals the 'auto' module (fp32, the depthwise conv summed in another
  order: 1e-5);
- a layer-norm conv CTCModel through the bridge equals JAX's (1e-4), and
  the bridge is the inverse of convert_state_dict there;
- the wrapper runs the plain version on the CPU, launches nothing, refuses
  autograd and padding that does not match its taps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.config import DecoderConfig, EncoderConfig, ModelConfig
from tpu_asr.convert.nemo_import import convert_state_dict
from tpu_asr.models.conformer import ConformerConvolution as JaxConv
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr.ops.pallas_conv import fused_conv_module as pallas_conv
from tpu_asr_torch.convert.from_jax import jax_to_state_dict
from tpu_asr_torch.models.conformer import ConformerConvolution
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.ops.cuda_conv import conv_module_plain, fused_conv_module

CASES = {"batch_norm": ("batch_norm", False), "layer_norm": ("layer_norm",
                                                            False),
         "causal": ("layer_norm", True), "causal_bn": ("batch_norm", True)}


def _cfg(norm, causal, d=88, k=9):
    return EncoderConfig(feat_in=24, n_layers=2, d_model=d, n_heads=4,
                         conv_kernel_size=k, conv_norm_type=norm,
                         conv_context_size="causal" if causal else None)


def _setup(name, b=3, t=50, d=88, k=9, seed=0):
    """JAX module, its variables (perturbed; randomised BN statistics), x
    and a ragged mask."""
    norm, causal = CASES[name]
    cfg = _cfg(norm, causal, d, k)
    mod = JaxConv(cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, t, d)) * 0.5).astype(np.float32)
    lengths = np.asarray([t, t - 7, 11][:b])
    mask = np.arange(t)[None, :] < lengths[:, None]
    v = mod.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x),
                 jnp.asarray(mask), False)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(
        size=a.shape).astype(np.float32), v["params"])
    variables = {"params": params}
    if norm == "batch_norm":
        variables["batch_stats"] = {"batch_norm": {
            "mean": (rng.normal(size=d) * 0.1).astype(np.float32),
            "var": (1.0 + rng.random(d)).astype(np.float32)}}
    return cfg, mod, variables, x, mask


def _port_args(cfg, variables):
    """(w1, b1, wd, bd, nw, nb, w2, b2) in PyTorch layout, and the norm."""
    p = variables["params"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    if cfg.conv_norm_type == "batch_norm":
        s = variables["batch_stats"]["batch_norm"]
        w = p["batch_norm"]["scale"] / np.sqrt(s["var"] + 1e-5)
        nw, nb, kind = w, p["batch_norm"]["bias"] - s["mean"] * w, "affine"
    else:
        nw, nb, kind = p["norm"]["scale"], p["norm"]["bias"], "layer_norm"
    return (t(p["pointwise_conv1"]["kernel"].T), t(p["pointwise_conv1"]
                                                   ["bias"]),
            t(p["depthwise_conv"]["kernel"][:, 0, :].T),
            t(p["depthwise_conv"]["bias"]), t(nw), t(nb),
            t(p["pointwise_conv2"]["kernel"].T),
            t(p["pointwise_conv2"]["bias"])), kind


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_module(name):
    cfg, mod, variables, x, mask = _setup(name)
    want = mod.apply(variables, jnp.asarray(x), jnp.asarray(mask), False)
    args, kind = _port_args(cfg, variables)
    got = conv_module_plain(torch.from_numpy(x), torch.from_numpy(mask),
                            *args, cfg.conv_context, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["batch_norm", "causal"])
def test_plain_matches_jax_module_at_d512(name):
    """conformer-LARGE's width, which the conv kernel takes and the Pallas
    kernel refuses (D % 128 == 0 leaves it no spare lane for the mask)."""
    cfg, mod, variables, x, mask = _setup(name, b=2, t=24, d=512, k=31,
                                          seed=5)
    want = mod.apply(variables, jnp.asarray(x), jnp.asarray(mask), False)
    args, kind = _port_args(cfg, variables)
    got = conv_module_plain(torch.from_numpy(x), torch.from_numpy(mask),
                            *args, cfg.conv_context, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_interpret(name):
    cfg, _, variables, x, mask = _setup(name, seed=1)
    args, kind = _port_args(cfg, variables)
    j = lambda a: jnp.asarray(a.numpy())
    w1, b1, wd, bd, nw, nb, w2, b2 = args
    want = pallas_conv(jnp.asarray(x), jnp.asarray(mask), j(w1).T, j(b1),
                       j(wd).T, j(bd), j(nw), j(nb), j(w2).T, j(b2),
                       pad_l=cfg.conv_context[0], norm=kind, interpret=True)
    got = conv_module_plain(torch.from_numpy(x), torch.from_numpy(mask),
                            *args, cfg.conv_context, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=1.2e-2)


def test_plain_bf16_rounds_only_the_operands():
    """bf16 input: the plain version rounds x, the weights and the SiLU
    output (the products' operands) and nothing else, so it stays within
    bf16 rounding of the fp32 version on the same rounded input."""
    cfg, _, variables, x, mask = _setup("batch_norm", seed=2)
    args, kind = _port_args(cfg, variables)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    got = conv_module_plain(x16, torch.from_numpy(mask), *args,
                            cfg.conv_context, kind)
    want = conv_module_plain(x16.float(), torch.from_numpy(mask), *args,
                             cfg.conv_context, kind)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=3e-2,
                               atol=3e-2 * max(1.0, want.abs().max().item()))


def _port_module(cfg, variables, backend):
    mod = ConformerConvolution(dataclasses.replace(cfg, conv_backend=backend))
    args, _ = _port_args(cfg, variables)
    w1, b1, wd, bd, nw, nb, w2, b2 = args
    sd = {"pointwise_conv1.weight": w1[..., None],
          "pointwise_conv1.bias": b1, "depthwise_conv.weight": wd[:, None],
          "depthwise_conv.bias": bd, "pointwise_conv2.weight": w2[..., None],
          "pointwise_conv2.bias": b2}
    p = variables["params"]
    norm = p.get("batch_norm", p.get("norm"))
    sd["batch_norm.weight"] = torch.from_numpy(norm["scale"])
    sd["batch_norm.bias"] = torch.from_numpy(norm["bias"])
    if "batch_stats" in variables:
        s = variables["batch_stats"]["batch_norm"]
        sd["batch_norm.running_mean"] = torch.from_numpy(s["mean"])
        sd["batch_norm.running_var"] = torch.from_numpy(s["var"])
        sd["batch_norm.num_batches_tracked"] = torch.tensor(0)
    mod.load_state_dict(sd, strict=True)
    return mod.eval()


@pytest.mark.parametrize("name", list(CASES))
def test_module_pallas_backend_equals_auto(name):
    cfg, mod, variables, x, mask = _setup(name, seed=3)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        got = _port_module(cfg, variables, "pallas")(xt, mt)
        want = _port_module(cfg, variables, "auto")(xt, mt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    jax_want = mod.apply(variables, jnp.asarray(x), jnp.asarray(mask), False)
    np.testing.assert_allclose(want.numpy(), np.asarray(jax_want), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_runs_plain_on_cpu_and_refuses():
    cfg, _, variables, x, mask = _setup("layer_norm", b=2, t=20, d=16, k=5)
    args, kind = _port_args(cfg, variables)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    torch.testing.assert_close(
        fused_conv_module(xt, mt, *args, cfg.conv_context, kind),
        conv_module_plain(xt, mt, *args, cfg.conv_context, kind), rtol=0,
        atol=0)
    assert fused_conv_module.launches == 0
    with pytest.raises(RuntimeError, match="no gradient"):
        fused_conv_module(xt.clone().requires_grad_(), mt, *args,
                          cfg.conv_context, kind)
    with pytest.raises(ValueError, match="padding"):
        fused_conv_module(xt, mt, *args, (2, 3), kind)
    with pytest.raises(ValueError, match="norm"):
        fused_conv_module(xt, mt, *args, cfg.conv_context, "group_norm")


def _ln_model_cfg(causal=False):
    return ModelConfig(
        spec_augment=None,
        encoder=EncoderConfig(n_layers=2, d_model=32, n_heads=2,
                              conv_kernel_size=7,
                              conv_norm_type="layer_norm",
                              conv_context_size="causal" if causal else None),
        decoder=DecoderConfig(feat_in=32, num_classes=16),
        compute_dtype="float32")


@pytest.mark.parametrize("causal", [False, True])
def test_layer_norm_conv_model_through_the_bridge(causal):
    cfg = _ln_model_cfg(causal)
    v = JaxCTCModel(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8000)),
                              jnp.asarray([8000], jnp.int32))
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(
        size=a.shape).astype(np.float32), v["params"])
    assert "batch_stats" not in v or not v["batch_stats"]
    sd = jax_to_state_dict(params, {}, cfg)
    assert "encoder.layers.0.conv.batch_norm.weight" in sd
    back, _ = convert_state_dict(sd, cfg)
    leaves = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]
    for (pa, a), (pb, b) in zip(leaves(params), leaves(back), strict=True):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    sig = (rng.normal(size=(2, 16000)) * 0.1).astype(np.float32)
    lens = np.asarray([16000, 9000], np.int32)
    want = JaxCTCModel(cfg).apply({"params": params}, jnp.asarray(sig),
                                  jnp.asarray(lens), train=False)
    model = CTCModel(cfg).eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(sig), torch.from_numpy(lens))
    np.testing.assert_allclose(got.log_probs.numpy(),
                               np.asarray(want.log_probs), rtol=1e-4,
                               atol=1e-4)
