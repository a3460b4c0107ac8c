"""Port parity of packed-segment serving: tpu_asr_torch's data/packing.py,
the segment mode of the block attention, `CTCModel.pre_encode` /
`forward_packed` and `PackedTranscriber` against the JAX package on the
CPU, inputs made with numpy from a seed, the weights carried by the weight
bridge (tpu_asr_torch.convert.from_jax).

- plan_packing / pack_frames / unpack_rows / guard_frames give the JAX
  copy's arrays over a seeded sweep of length mixes;
- the plain attention with seg_id in fp32 against the JAX module
  (attention_backend='xla') with seg_id, rtol/atol 1e-4; in bf16 against
  the Pallas block kernel's segment mode in interpret mode, rtol 1e-2 and
  atol 3e-3 (tests/test_torch_attention.py's tolerances); valid rows
  compared, one row all guard/pad, every output finite;
- the model (tests/test_packing.py's widths: 2 layers, d32, 4 heads, conv
  k=7; layer-norm and batch-norm conv modules, the BatchNorm statistics
  randomised): forward_packed against JAX forward_packed (1e-4), and
  against the port's own per-utterance forward once unpacked (2e-5, as
  tests/test_packing.py holds JAX) with equal greedy ids;
- PackedTranscriber(device='cpu') gives the texts of JAX's
  PackedTranscriber and of the port's Transcriber;
- a CPU packed forward launches no kernel and builds nothing; the encoder
  takes packed rows in training too (tests/test_torch_packed_train.py
  holds packed training against JAX).
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.config import (DecoderConfig, EncoderConfig, ModelConfig,
                            PreprocessorConfig)
from tpu_asr.data import packing as jax_packing
from tpu_asr.data.tokenizer import train_bpe
from tpu_asr.models.conformer import RelPositionMultiHeadAttention as JaxMHA
from tpu_asr.models.conformer import \
    rel_positional_encoding as jax_rel_positional_encoding
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr.models.transcribe import \
    PackedTranscriber as JaxPackedTranscriber
from tpu_asr.ops.features import FilterbankFeatures as JaxFeatures
from tpu_asr.ops.pallas_attention import fused_relpos_attention_block as \
    pallas_block
from tpu_asr_torch.convert.from_jax import jax_to_state_dict
from tpu_asr_torch.data import packing
from tpu_asr_torch.models.conformer import (RelPositionMultiHeadAttention,
                                            rel_positional_encoding)
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.models.transcribe import PackedTranscriber, Transcriber
from tpu_asr_torch.ops import _kernels
from tpu_asr_torch.ops.cuda_attention import (fused_relpos_attention_block,
                                              relpos_attention_plain)
from tpu_asr_torch.ops.cuda_conv import fused_conv_module
from tpu_asr_torch.ops.cuda_features import fused_logmel
from tpu_asr_torch.ops.cuda_ffn import (fused_ffn_sublayer,
                                        fused_ffn_sublayer_int8)
from tpu_asr_torch.ops.cuda_subsampling import fused_subsampling

WRAPPERS = (fused_logmel, fused_subsampling, fused_relpos_attention_block,
            fused_ffn_sublayer, fused_ffn_sublayer_int8, fused_conv_module)


# --------------------------------------------------------------------------
# data/packing.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 7, 17, 31, 65])
def test_guard_frames_equal_jax(k):
    assert packing.guard_frames(k) == jax_packing.guard_frames(k)


@pytest.mark.parametrize("seed", range(8))
def test_plan_pack_unpack_equal_jax(seed):
    """A seeded sweep of length mixes, guards, t_pack and row_multiple:
    every array of the plan, the packed frames and the unpacked rows."""
    rng = np.random.default_rng(200 + seed)
    t_pack = int(rng.choice([64, 128, 256, 512]))
    guard = int(rng.integers(0, 12))
    rm = int(rng.choice([1, 2, 4]))
    n = int(rng.integers(1, 40))
    lengths = rng.integers(1, t_pack + 1, size=n)
    got = packing.plan_packing(lengths, t_pack, guard, row_multiple=rm)
    want = jax_packing.plan_packing(lengths, t_pack, guard, row_multiple=rm)
    for field in ("row", "start", "length", "seg_id", "src_utt", "src_pos"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert (got.t_pack, got.n_rows) == (want.t_pack, want.n_rows)
    assert got.fill_ratio == want.fill_ratio

    feats = rng.normal(size=(n, t_pack, 3)).astype(np.float32)
    packed = packing.pack_frames(torch.from_numpy(feats), got)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jax_packing.pack_frames(
            jnp.asarray(feats), want)))
    for a, b in zip(packing.unpack_rows(packed, got),
                    jax_packing.unpack_rows(np.asarray(packed), want),
                    strict=True):
        np.testing.assert_array_equal(a, b)


def test_pack_frames_utt_rows():
    """Utterance i taken from row utt_rows[i] of the frames."""
    rng = np.random.default_rng(9)
    lengths = [5, 9, 3, 7]
    plan = packing.plan_packing(lengths, 16, 2)
    feats = rng.normal(size=(4, 9, 2)).astype(np.float32)
    perm = np.asarray([2, 0, 3, 1])                    # utterance -> row
    shuffled = np.empty_like(feats)
    shuffled[perm] = feats
    np.testing.assert_array_equal(
        packing.pack_frames(torch.from_numpy(shuffled), plan,
                            utt_rows=perm).numpy(),
        packing.pack_frames(torch.from_numpy(feats), plan).numpy())


def test_plan_packing_refuses_as_jax():
    with pytest.raises(ValueError, match="exceeds"):
        packing.plan_packing([100], t_pack=64, guard=4)
    with pytest.raises(ValueError, match="positive"):
        packing.plan_packing([0, 10], t_pack=64, guard=4)


# --------------------------------------------------------------------------
# the attention's segment mode
# --------------------------------------------------------------------------

def _seg_map(t):
    """(3, t) segment ids: row 0 three segments with guards and a padded
    tail, row 1 all guard/pad, row 2 two segments end to end with a guard
    of one frame."""
    seg = np.zeros((3, t), np.int32)
    seg[0, :11], seg[0, 19:37], seg[0, 45:t - 3] = 1, 2, 3
    seg[2, :t // 2], seg[2, t // 2 + 1:] = 1, 2
    return seg


def _attention_params(rng, d, h):
    mk = lambda *s, sc=1.0: rng.normal(size=s).astype(np.float32) * sc
    dense = lambda: {"kernel": mk(d, d, sc=d ** -0.5), "bias": mk(d, sc=0.1)}
    return {"linear_q": dense(), "linear_k": dense(), "linear_v": dense(),
            "linear_out": dense(),
            "linear_pos": {"kernel": mk(d, d, sc=d ** -0.5)},
            "pos_bias_u": mk(h, d // h, sc=0.1),
            "pos_bias_v": mk(h, d // h, sc=0.1)}


def _torch_mha(p, d, h):
    mod = RelPositionMultiHeadAttention(d, h)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    sd = {"pos_bias_u": t(p["pos_bias_u"]), "pos_bias_v": t(p["pos_bias_v"]),
          "linear_pos.weight": t(p["linear_pos"]["kernel"].T)}
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        sd[f"{name}.weight"] = t(p[name]["kernel"].T)
        sd[f"{name}.bias"] = t(p[name]["bias"])
    mod.load_state_dict(sd)
    return mod


def _plain_args(mod, x, t, d, mask, h):
    return (x, mod.linear_q.weight, mod.linear_q.bias, mod.linear_k.weight,
            mod.linear_k.bias, mod.linear_v.weight, mod.linear_v.bias,
            mod.pos_bias_u, mod.pos_bias_v, mod.linear_pos.weight,
            mod.linear_out.weight, rel_positional_encoding(t, d), mask, h)


@pytest.mark.parametrize("t,d,h", [(56, 88, 2), (64, 32, 4)])
def test_segment_attention_matches_jax_xla(t, d, h):
    rng = np.random.default_rng(10)
    p = _attention_params(rng, d, h)
    seg = _seg_map(t)
    mask = seg > 0
    x = (rng.normal(size=(3, t, d)) * 0.5).astype(np.float32)
    pe = np.asarray(jax_rel_positional_encoding(t, d))
    want = np.asarray(JaxMHA(d, h, attention_backend="xla").apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(pe), jnp.asarray(mask),
        seg_id=jnp.asarray(seg)))
    mod = _torch_mha(p, d, h)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), rel_positional_encoding(t, d),
                  torch.from_numpy(mask), seg_id=torch.from_numpy(seg))
    assert torch.isfinite(got).all()
    m = mask[..., None]
    np.testing.assert_allclose(got.numpy() * m, want * m, rtol=1e-4,
                               atol=1e-4)
    # the segments matter: without them row 0 attends across its guards
    with torch.no_grad():
        dense = mod(torch.from_numpy(x), rel_positional_encoding(t, d),
                    torch.from_numpy(mask))
    assert np.abs((dense.numpy() - want) * m).max() > 1e-2


@pytest.mark.parametrize("t,d,h", [(56, 88, 2), (64, 64, 4)])
def test_segment_attention_bf16_matches_pallas_interpret(t, d, h):
    rng = np.random.default_rng(11)
    p = _attention_params(rng, d, h)
    seg = _seg_map(t)
    mask = seg > 0
    x = (rng.normal(size=(3, t, d)) * 0.5).astype(np.float32)
    j = jnp.asarray
    want = np.asarray(pallas_block(
        j(x), j(p["linear_q"]["kernel"]), j(p["linear_q"]["bias"]),
        j(p["linear_k"]["kernel"]), j(p["linear_k"]["bias"]),
        j(p["linear_v"]["kernel"]), j(p["linear_v"]["bias"]),
        j(p["pos_bias_u"]), j(p["pos_bias_v"]),
        j(p["linear_pos"]["kernel"].reshape(d, h, d // h)),
        j(p["linear_out"]["kernel"]), j(mask), n_heads=h, interpret=True,
        seg_id=j(seg)), np.float32)
    mod = _torch_mha(p, d, h)
    with torch.no_grad():
        got = relpos_attention_plain(
            *_plain_args(mod, torch.from_numpy(x).to(torch.bfloat16), t, d,
                         torch.from_numpy(mask), h),
            seg_id=torch.from_numpy(seg))
    assert got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    m = mask[..., None]
    np.testing.assert_allclose(got.float().numpy() * m, want * m,
                               rtol=1e-2, atol=3e-3)


def test_wrapper_runs_seg_id_on_cpu_without_grad():
    """The kernel wrapper on CPU tensors: the plain version, segment mode
    included, under no_grad; under autograd too, gradients included."""
    rng = np.random.default_rng(12)
    t, d, h = 40, 32, 2
    mod = _torch_mha(_attention_params(rng, d, h), d, h)
    seg = torch.from_numpy(_seg_map(t))
    x = torch.from_numpy((rng.normal(size=(3, t, d)) * 0.5).astype(
        np.float32))
    args = _plain_args(mod, x, t, d, seg > 0, h)
    with torch.no_grad():
        got = fused_relpos_attention_block(*args, seg_id=seg)
        want = relpos_attention_plain(*args, seg_id=seg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    weights = [a for a in args if isinstance(a, torch.Tensor)
               and a.requires_grad]
    got = torch.autograd.grad(
        fused_relpos_attention_block(*args, seg_id=seg).sum(), weights)
    want = torch.autograd.grad(
        relpos_attention_plain(*args, seg_id=seg).sum(), weights)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------
# the model: pre_encode, forward_packed, PackedTranscriber
# --------------------------------------------------------------------------

def _config(norm):
    return ModelConfig(
        preprocessor=PreprocessorConfig(features=24), spec_augment=None,
        encoder=EncoderConfig(feat_in=24, n_layers=2, d_model=32, n_heads=4,
                              conv_kernel_size=7, conv_norm_type=norm,
                              dropout=0.0, dropout_pre_encoder=0.0,
                              dropout_att=0.0),
        decoder=DecoderConfig(feat_in=32, num_classes=16),
        compute_dtype="float32")


@pytest.fixture(scope="module", params=["layer_norm", "batch_norm"])
def models(request):
    """(cfg, JAX model, its variables, the port's model with the same
    weights): every JAX leaf perturbed, the BatchNorm statistics drawn."""
    cfg = _config(request.param)
    jmodel = JaxCTCModel(cfg)
    v = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8000)),
                    jnp.asarray([8000], jnp.int32))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(
        size=a.shape).astype(np.float32), v["params"])
    stats = {}
    if "batch_stats" in v:
        bn = v["batch_stats"]["encoder"]["layers"]["conv"]["batch_norm"]
        stats = {"encoder": {"layers": {"conv": {"batch_norm": {
            "mean": rng.uniform(-0.3, 0.3, size=bn["mean"].shape).astype(
                np.float32),
            "var": rng.uniform(0.7, 1.5, size=bn["var"].shape).astype(
                np.float32)}}}}}
    variables = {"params": params, **({"batch_stats": stats} if stats
                                      else {})}
    port = CTCModel(cfg).eval()
    port.load_state_dict(jax_to_state_dict(params, stats, cfg), strict=True)
    return cfg, jmodel, variables, port


def _batch(seed, n=7):
    rng = np.random.default_rng(seed)
    samp = [int(s) for s in rng.integers(4000, 16000, size=n)]
    sig = np.zeros((n, max(samp)), np.float32)
    for i, s in enumerate(samp):
        sig[i, :s] = rng.normal(size=s).astype(np.float32) * 0.1
    return sig, np.asarray(samp, np.int32)


def _port_packed(port, cfg, sig, lens, t_pack=64):
    """The port's pre_encode -> pack -> forward_packed: (plan, lengths,
    log_probs, greedy)."""
    with torch.no_grad():
        feats, feat_len = port.featurizer(torch.from_numpy(sig),
                                          torch.from_numpy(lens).long())
        pre, pre_len = port.pre_encode(feats, feat_len)
        lengths = pre_len.numpy()
        plan = packing.plan_packing(
            lengths, t_pack, packing.guard_frames(
                cfg.encoder.conv_kernel_size))
        logp, greedy = port.forward_packed(packing.pack_frames(pre, plan),
                                           torch.from_numpy(plan.seg_id))
    return plan, lengths, logp, greedy


def test_forward_packed_matches_jax(models):
    cfg, jmodel, variables, port = models
    sig, lens = _batch(2)
    feats, feat_len = JaxFeatures(cfg.preprocessor)(
        jnp.asarray(sig), jnp.asarray(lens), train=False, rng=None)
    pre, pre_len = jmodel.apply(variables, feats, feat_len,
                                method=JaxCTCModel.pre_encode)
    plan, lengths, logp, greedy = _port_packed(port, cfg, sig, lens)
    np.testing.assert_array_equal(lengths, np.asarray(pre_len))
    want_plan = jax_packing.plan_packing(
        np.asarray(pre_len), 64,
        jax_packing.guard_frames(cfg.encoder.conv_kernel_size))
    want_logp, want_greedy = jmodel.apply(
        variables, jax_packing.pack_frames(pre, want_plan),
        jnp.asarray(want_plan.seg_id), method=JaxCTCModel.forward_packed)
    np.testing.assert_array_equal(plan.seg_id, want_plan.seg_id)
    assert torch.isfinite(logp).all()
    np.testing.assert_allclose(logp.numpy(), np.asarray(want_logp),
                               rtol=1e-4, atol=1e-4)
    valid = plan.seg_id > 0
    np.testing.assert_array_equal(greedy.numpy()[valid],
                                  np.asarray(want_greedy)[valid])


def test_forward_packed_matches_per_utterance(models):
    """Unpacked, each segment's log-probs are its own forward's."""
    cfg, _, _, port = models
    sig, lens = _batch(3)
    plan, lengths, logp, greedy = _port_packed(port, cfg, sig, lens)
    with torch.no_grad():
        ref = port(torch.from_numpy(sig), torch.from_numpy(lens).long())
    np.testing.assert_array_equal(ref.encoded_len.numpy(), lengths)
    ref_logp = ref.log_probs.numpy()
    for i, (lp, ids) in enumerate(zip(packing.unpack_rows(logp, plan),
                                      packing.unpack_rows(greedy, plan),
                                      strict=True)):
        np.testing.assert_allclose(lp, ref_logp[i, :lengths[i]], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_array_equal(ids, ref.greedy.numpy()[i,
                                                              :lengths[i]])


def test_packed_transcriber_matches_jax_and_transcriber(models):
    cfg, jmodel, variables, port = models
    tok = train_bpe(["a b c d e f g h"], vocab_size=16)
    rng = np.random.default_rng(4)
    waves = [rng.normal(size=int(s)).astype(np.float32) * 0.05
             for s in rng.integers(4000, 16000, size=6)]
    want = JaxPackedTranscriber(jmodel, variables, tok, t_pack=64,
                                pre_batch=3, row_multiple=2).transcribe(waves)
    packed = PackedTranscriber(port, tok, t_pack=64, pre_batch=3,
                               row_multiple=2, device="cpu")
    got = packed.transcribe(waves)
    assert got == want
    assert got == Transcriber(port, tok, batch_size=3,
                              device="cpu").transcribe(waves)
    assert any(got)
    assert packed.last_plan.n_rows % 2 == 0


def test_packed_transcriber_refuses_long_utterances(models):
    _, _, _, port = models
    tok = train_bpe(["a b c d e f g h"], vocab_size=16)
    tr = PackedTranscriber(port, tok, t_pack=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds t_pack"):
        tr.greedy_ids([np.zeros(16000, np.float32)])


def test_cpu_packed_forward_launches_and_builds_nothing(models):
    cfg, _, _, port = models
    for w in WRAPPERS:
        w.launches = 0
    sig, lens = _batch(5, n=3)
    _, _, logp, _ = _port_packed(port, cfg, sig, lens)
    assert torch.isfinite(logp).all()
    assert all(w.launches == 0 for w in WRAPPERS)
    assert _kernels.library.cache_info().currsize == 0


def test_packed_training_encodes(models):
    """encode_frames(train=True) takes packed rows: gradients reach every
    weight of the layers, guard frames stay zero, and a segment sees only itself
    (the same frames encode alike beside another segment and alone in a
    row; the encoder's dropout is 0, and BatchNorm's statistics are the
    batch's, shared by both rows)."""
    cfg, _, _, port = models
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(2, 16, cfg.encoder.d_model))
                         .astype(np.float32))
    x[1, 9:15] = x[0, 9:15]
    seg = torch.zeros(2, 16, dtype=torch.int32)
    seg[0, :6], seg[0, 9:15], seg[1, 9:15] = 1, 2, 1
    port.train()
    try:
        out, lens, _ = port.encoder.encode_frames(
            x, None, train=True, generator=torch.Generator().manual_seed(0),
            seg_id=seg)
        out.square().sum().backward()
    finally:
        port.eval()
    grads = [p.grad for p in port.encoder.layers.parameters()]
    port.zero_grad(set_to_none=True)
    np.testing.assert_array_equal(lens.numpy(), [12, 6])
    out = out.detach()
    assert float(out[seg == 0].abs().max()) == 0.0
    torch.testing.assert_close(out[1, 9:15], out[0, 9:15], rtol=1e-5,
                               atol=1e-5)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
