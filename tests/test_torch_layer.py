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
  (shared memory);
- the kernels' weight layouts (`_kernel_weights`, built once per weight
  version): each maps back exactly to layer_params (the fragment-packed
  matrices of layer_mma_kernel through `frag_unpack`, W1's interleave, the
  zero padding of D and d_ff, q/k/v stacked, cu = bq + u, wd time-major);
  the same objects on a second call, new ones after an in-place update;
- `layer_refusal` refuses nothing on a grid of (D, heads, d_ff, k) that
  the first layer kernel's rule (dk <= 64, `layer_smem` <= 227 KB) took,
  and `layer_route` sends the serve and student widths to the tensor-core
  kernel and k = 35 to the SIMT one;
- the layer kernel keeps its own dk limit (LAYER_MAX_DK = 64) while the
  attention kernels take dk <= 128: at dk 44, 64 and 128, and at
  conformer-LARGE's and XLarge's widths, `layer_refusal` and `layer_route`
  answer as before, and d1024 / 8 heads is refused.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
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
from tpu_asr_torch.ops import cuda_attention, cuda_ffn
from tpu_asr_torch.ops import cuda_layer
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


def _random_params(d, h, dff, k, seed=0):
    """A params dict of KEYS at any (D, heads, d_ff, k), seeded."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"w11": (dff, d), "bb11": (dff,), "w12": (d, dff),
              "w21": (dff, d), "bb21": (dff,), "w22": (d, dff),
              "w1": (2 * d, d), "b1": (2 * d,), "wd": (d, k),
              "bias_u": (h, d // h), "bias_v": (h, d // h)}
    shapes.update({key: (d, d) for key in ("wq_full", "wk_full", "wv_full",
                                           "wo_full", "pos_kernel", "w2c")})
    return {key: torch.randn(shapes.get(key, (d,)), generator=g)
            for key in cuda_layer.KEYS}


@pytest.mark.parametrize("d,h,dff,k", [(176, 4, 704, 31), (88, 2, 352, 31),
                                       (40, 2, 72, 5)])
def test_mma_weights_map_back_to_layer_params(d, h, dff, k):
    """layer_mma_kernel's layout: every matrix fragment-packed (the FFNs'
    W1 in chunks of 64 rows), padded with zeros (D to 16 in K and 8 in N,
    d_ff to 64), and the vectors as the kernel reads them; each maps back
    exactly."""
    p = _random_params(d, h, dff, k)
    out, ptrs = cuda_layer._kernel_weights(2, *(p[key] for key in
                                                cuda_layer.KEYS))
    assert list(out) == list(cuda_layer._MMA_KEYS) and len(ptrs) == 34
    bf = lambda z: z.to(torch.bfloat16)
    d8, dp, fp = -(-d // 8) * 8, -(-d // 16) * 16, -(-dff // 64) * 64
    unpack = cuda_layer.frag_unpack
    qkv = out["wqkv"]
    assert qkv.shape == (dp // 16, 3 * d8 // 8, 8, 4, 2, 2)
    for i, key in enumerate(("wq_full", "wk_full", "wv_full")):
        part = unpack(qkv, 3 * d8, d)[i * d8:(i + 1) * d8]
        assert torch.equal(part[:d], bf(p[key]))
        assert part[d:].abs().sum() == 0
    for key in ("pos_kernel", "wo_full", "w2c"):
        assert torch.equal(unpack(out[key], d, d), bf(p[key]))
        assert unpack(out[key], d8, dp)[:, d:].abs().sum() == 0
    for w_in, w_out, bias in (("w11", "w12", "bb11"),
                              ("w21", "w22", "bb21")):
        assert out[w_in].shape[:2] == (fp // 64 * dp // 16, 8)
        assert torch.equal(cuda_layer.frag_unpack_chunks(out[w_in], dff, d),
                           bf(p[w_in]))
        assert torch.equal(unpack(out[w_out], d, dff), bf(p[w_out]))
        full = cuda_layer.frag_unpack_chunks(out[w_in], fp, dp)
        assert full[dff:].abs().sum() == 0 and full[:, d:].abs().sum() == 0
        assert unpack(out[w_out], d8, fp)[:, dff:].abs().sum() == 0
        assert torch.equal(out[bias][:dff], p[bias])
        assert out[bias][dff:].abs().sum() == 0
    w1 = unpack(out["w1"], 2 * d8, d).view(d8 // 8, 2, 8, d)
    assert torch.equal(w1[:, 0].reshape(d8, d)[:d], bf(p["w1"][:d]))
    assert torch.equal(w1[:, 1].reshape(d8, d)[:d], bf(p["w1"][d:]))
    assert torch.equal(out["cu"], p["bq"] + p["bias_u"].reshape(d))
    assert torch.equal(out["cv"], p["bq"] + p["bias_v"].reshape(d))
    assert torch.equal(out["wd"], p["wd"].t())
    for key in ("s1", "sb1", "bb12", "sa", "sab", "bk", "bv", "bo", "sc",
                "scb", "b1", "bd", "nw", "nb", "b2c", "s2", "sb2", "bb22",
                "sf", "sfb"):
        assert torch.equal(out[key], p[key]), key


def test_frag_pack_holds_the_mma_fragments():
    """frag_pack's tile (j, s) (stored k-step-major), lane 4 g + t:
    W[8 j + g][16 s + 2 t + e] (.x) and W[8 j + g][16 s + 8 + 2 t + e]
    (.y), e = 0, 1: the m16n8k16 B fragment of mma.cuh's layout."""
    rows, cols = torch.meshgrid(torch.arange(24.0) + 1,
                                torch.arange(40.0) + 1, indexing="ij")
    # row and column numbers (exact in bf16), each packed on its own
    fr, fc = (cuda_layer.frag_pack(w, 24, 48).float() for w in (rows, cols))
    for j, s, g, t in ((0, 0, 0, 0), (2, 1, 5, 3), (1, 2, 7, 1)):
        for e in range(2):
            n, k0 = 8 * j + g, 16 * s + 2 * t + e
            for h in range(2):
                kk = k0 + 8 * h
                assert fr[s, j, g, t, h, e] == (n + 1 if kk < 40 else 0)
                assert fc[s, j, g, t, h, e] == (kk + 1 if kk < 40 else 0)


@pytest.mark.parametrize("route", [0, 1])
def test_simt_weights_map_back_to_layer_params(route):
    p = _random_params(40, 2, 72, 5)
    out, ptrs = cuda_layer._kernel_weights(route, *(p[key] for key in
                                                    cuda_layer.KEYS))
    assert list(out) == list(cuda_layer._SIMT_KEYS) and len(ptrs) == 36
    dt = torch.float32 if route == 0 else torch.bfloat16
    for key in ("w11", "w12", "wq_full", "wk_full", "wv_full", "pos_kernel",
                "wo_full", "w1", "w2c", "w21", "w22"):
        assert out[key].dtype == dt and torch.equal(out[key], p[key].to(dt))
    assert torch.equal(out["wd"], p["wd"].t())
    assert torch.equal(out["cu"], p["bq"] + p["bias_u"].reshape(40))


def test_layer_weights_built_once_and_rebuilt_on_update():
    """The wrapper's lookup (`_weights`) returns the same prepared objects
    for the same tensors and builds anew after an in-place update (an
    optimizer step) or for another route; inference tensors, which have no
    version counter, are built on every call."""
    torch.manual_seed(5)
    layer = ConformerLayer(dataclasses.replace(
        _port_enc(), d_model=40, n_heads=2, ff_expansion_factor=2,
        conv_kernel_size=5))
    prm = layer_params(layer.eval())
    first = cuda_layer._weights(2, prm, 40, 2, 5)
    assert cuda_layer._weights(2, prm, 40, 2, 5) is first
    assert cuda_layer._weights(1, prm, 40, 2, 5) is not first
    with torch.no_grad():
        layer.conv.pointwise_conv2.weight.add_(0.5)
    again = cuda_layer._weights(2, prm, 40, 2, 5)
    assert again is not first and again[0]["w2c"] is not first[0]["w2c"]
    assert torch.equal(cuda_layer.frag_unpack(again[0]["w2c"], 40, 40),
                       prm["w2c"].to(torch.bfloat16))
    assert cuda_layer._weights(2, prm, 40, 2, 5) is again
    with torch.inference_mode():               # no version counters
        inference = {key: v.clone() for key, v in prm.items()}
    built = [cuda_layer._weights(2, inference, 40, 2, 5) for _ in range(2)]
    assert built[0] is not built[1]
    assert torch.equal(built[0][0]["w2c"], again[0]["w2c"])


def _port_enc():
    from tpu_asr_torch.config import EncoderConfig as PortEncoderConfig
    return PortEncoderConfig(n_layers=1, dropout=0.0, dropout_att=0.0)


@pytest.mark.parametrize("d,h,dff,k", [
    (176, 4, 704, 31),      # dk 44: the serve width
    (128, 2, 512, 31),      # dk 64
    (256, 2, 1024, 31),     # dk 128
    (512, 8, 2048, 31),     # conformer-LARGE: dk 64, past shared memory
    (1024, 8, 4096, 5),     # conformer-XLarge: dk 128
])
def test_layer_kernel_keeps_its_own_dk_limit(d, h, dff, k):
    """The layer kernel's attention phase holds a head row in two column
    slots a lane: it keeps dk <= 64 (LAYER_MAX_DK) while the attention
    kernels take dk <= 128 (MAX_DK), and refuses and routes every shape as
    before the attention kernels widened; d1024 / 8 heads stays refused."""
    assert cuda_layer.LAYER_MAX_DK == 64 < cuda_attention.MAX_DK == 128
    dk = d // h
    fits = dk <= 64 and cuda_layer.layer_smem(d, dff, k, dk) <= 227 * 1024
    for dt in (torch.float32, torch.bfloat16):
        mma = dt == torch.bfloat16 and cuda_layer.mma_refusal(d, h, k) is None
        why = cuda_layer.layer_refusal(dt, d, h, dff, k)
        assert (why is None) == (fits or mma), (dt, why)
        if dk > 64:
            assert f"dk={dk} (<= 64)" in why
        if why is None:
            assert cuda_layer.layer_route(dt, d, h, k) == (
                0 if dt == torch.float32 else 2 if mma else 1)
    if d == 1024:
        assert cuda_layer.layer_refusal(torch.bfloat16, d, h, dff, k)


def test_layer_refusal_takes_every_shape_the_first_kernel_took():
    """On a grid of (D, heads, d_ff, k), every shape the first layer
    kernel's rule took (dk <= 64, layer_smem <= 227 KB) runs on a kernel in
    fp32 and bf16; the tensor-core kernel takes the serve and student
    widths; what it does not take runs on layer_kernel<bf16>; a shape
    outside both rules is refused."""
    limit = 227 * 1024
    taken = 0
    for d in (24, 40, 88, 96, 120, 144, 176, 184, 192, 256, 280, 320):
        for h in (1, 2, 3, 4, 8):
            if d % h:
                continue
            dk = d // h
            for dff in (d, 2 * d, 4 * d, 352, 704):
                for k in (3, 9, 15, 31, 33, 35, 65):
                    old = (dk <= 64 and cuda_layer.layer_smem(d, dff, k, dk)
                           <= limit)
                    for dt in (torch.float32, torch.bfloat16):
                        why = cuda_layer.layer_refusal(dt, d, h, dff, k)
                        if old:
                            assert why is None, (d, h, dff, k, dt, why)
                    taken += old
    assert taken > 200
    route = cuda_layer.layer_route
    assert route(torch.bfloat16, 176, 4, 31) == 2
    assert route(torch.bfloat16, 88, 2, 31) == 2
    assert route(torch.float32, 176, 4, 31) == 0
    assert route(torch.bfloat16, 176, 4, 35) == 1
    assert route(torch.bfloat16, 192, 4, 31) == 1
    assert route(torch.bfloat16, 128, 4, 31) == 1      # dk 32
    assert route(torch.bfloat16, 96, 2, 31) == 2       # dk 48
    assert cuda_layer.mma_refusal(176, 4, 31) is None
    assert "D <= 176" in cuda_layer.mma_refusal(192, 4, 31)
    assert cuda_layer.layer_refusal(torch.bfloat16, 192, 4, 4096, 31)
    assert cuda_layer.layer_refusal(torch.float16, 176, 4, 704, 31)
