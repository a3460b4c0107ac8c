"""Port parity of packed-segment KD training: tpu_asr_torch's
data/packing.train_pack_arrays, the attention's segment mode under
autograd, `ConformerEncoder.encode_frames(train=True, seg_id=...)`,
`DistilCTCModel.forward_packed_train` and
`make_distil_train_step(packed=True)` against the JAX package on the CPU,
inputs made with numpy from a seed, weights carried by the bridge
(tpu_asr_torch.convert.from_jax).

- train_pack_arrays equals JAX's over seeded sample counts, row_multiple
  and pad_rows_to (every array, the plan's rows);
- the attention sublayer's gradients with seg_id through the plain version
  on three maps (packed segments with an all-guard row, a lone short
  segment, a map whose ids do not rise along the row), for a cotangent
  that is zero on guard frames, as the encoder gives one (see the guard
  test below): fp32 against jax.vjp of the XLA module at 1e-4; bf16
  against jax.vjp of the Pallas block in interpret mode at dropout 0 and
  0.1 with one seed, at tests/test_torch_attention.py's tolerances (rtol
  3e-2, atol 3e-2 x max(1, |ref|max));
- encode_frames(train=True, seg_id) against JAX's encode_packed(train=True)
  at dropout 0 (layer-norm and batch-norm conv modules): the output and
  layer features at 1e-4, the BatchNorm batch statistics;
- forward_packed_train's losses and student gradients against JAX's for
  ctc, logit and flow (tests/test_packed_train.py's tolerances: losses
  rtol 2e-5, atol 1e-6; gradients 1e-4 of the largest);
- the port's packed step against its own unpacked step at dropout 0 with a
  layer-norm conv module: losses 2e-5, gradients 1e-4 of the largest;
- the attention output's cotangent is exactly zero on guard frames (the
  layers re-mask, the conv module masks its input), so the probabilities
  of guard queries never reach a gradient;
- one make_distil_train_step(packed=True) step against JAX's: losses,
  grad_norm, and the parameters whose gradient is decided;
- a CPU packed step launches no kernel and builds nothing.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tpu_asr.data import packing as jax_packing
from tpu_asr.models.conformer import RelPositionMultiHeadAttention as JaxMHA
from tpu_asr.models.conformer import \
    rel_positional_encoding as jax_rel_positional_encoding
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil
from tpu_asr.ops.pallas_attention import fused_relpos_attention_block as \
    pallas_block
from tpu_asr.train.optim import build_optimizer as jax_build_optimizer
from tpu_asr.train.trainer import DistilTrainState as JaxState
from tpu_asr.train.trainer import make_distil_train_step as jax_make_step
from tpu_asr_torch.convert.from_jax import (distil_to_state_dict,
                                            jax_to_state_dict)
from tpu_asr_torch.data import packing
from tpu_asr_torch.models.conformer import (MaskedBatchNorm,
                                            rel_positional_encoding)
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.ops import _kernels
from tpu_asr_torch.ops.cuda_attention import (
    fused_relpos_attention_block, fused_relpos_attention_block_bwd)
from tpu_asr_torch.ops.cuda_ctc import ctc_nll, ctc_nll_bwd
from tpu_asr_torch.ops.cuda_features import fused_logmel
from tpu_asr_torch.ops.cuda_ffn import (fused_ffn_sublayer,
                                        fused_ffn_sublayer_bwd)
from tpu_asr_torch.ops.cuda_fm import fused_fm_euler, fused_fm_euler_bwd
from tpu_asr_torch.ops.cuda_subsampling import fused_subsampling
from tpu_asr_torch.train.trainer import (DistilTrainState,
                                         make_distil_train_step)

WRAPPERS = (fused_logmel, fused_subsampling, fused_relpos_attention_block,
            fused_relpos_attention_block_bwd, fused_ffn_sublayer,
            fused_ffn_sublayer_bwd, ctc_nll, ctc_nll_bwd, fused_fm_euler,
            fused_fm_euler_bwd)


# --------------------------------------------------------------------------
# data/packing.py::train_pack_arrays
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_train_pack_arrays_equal_jax(seed):
    rng = np.random.default_rng(300 + seed)
    n = int(rng.integers(1, 40))
    lens = rng.integers(1600, 16000 * 5, size=n)
    t_pack = int(rng.choice([128, 256, 512]))
    rm = int(rng.choice([1, 2, 4]))
    args = (lens, 512, 160, 4, "striding", int(rng.choice([7, 31])), t_pack)
    _, want_plan = jax_packing.train_pack_arrays(*args, row_multiple=rm)
    pad = want_plan.n_rows + int(rng.integers(0, 3))
    for kw in ({"row_multiple": rm}, {"pad_rows_to": pad}):
        got, plan = packing.train_pack_arrays(*args, **kw)
        ref, ref_plan = jax_packing.train_pack_arrays(*args, **kw)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert plan.n_rows == ref_plan.n_rows
    need = packing.train_pack_arrays(*args)[1].n_rows
    with pytest.raises(ValueError, match="pad_rows_to"):
        packing.train_pack_arrays(*args, pad_rows_to=need - 1) if need > 1 \
            else packing.plan_packing([t_pack, t_pack], t_pack, 8,
                                      pad_rows_to=1)


def test_train_pack_arrays_refuses_other_subsampling():
    with pytest.raises(ValueError, match="striding"):
        packing.train_pack_arrays([16000], 512, 160, 4, "stacking", 7, 64)


# --------------------------------------------------------------------------
# the attention's segment mode under autograd
# --------------------------------------------------------------------------

def _seg_maps(kind, t):
    """(3, t) segment maps. 'packed': three segments with guards and a
    padded tail, an all-guard row, two segments a guard frame apart;
    'lone': one short segment inside a row, a row of one segment, an
    all-guard row; 'shuffled': ids that do not rise along a row (2, 1, 3,
    1 with guards), a segment split around another."""
    seg = np.zeros((3, t), np.int32)
    if kind == "packed":
        seg[0, :11], seg[0, 19:37], seg[0, 45:t - 3] = 1, 2, 3
        seg[2, :t // 2], seg[2, t // 2 + 1:] = 1, 2
    elif kind == "lone":
        seg[0, 20:29] = 1
        seg[1, :] = 1
    else:
        seg[0, :9], seg[0, 12:20], seg[0, 24:33], seg[0, 36:t] = 2, 1, 3, 1
        seg[1, :t // 3], seg[1, t // 3:2 * t // 3], seg[1, 2 * t // 3:] = \
            2, 1, 2
        seg[2, 5:t - 5] = 4
    return seg


def _attention_params(rng, d, h):
    mk = lambda *s, sc=1.0: rng.normal(size=s).astype(np.float32) * sc
    dense = lambda: {"kernel": mk(d, d, sc=d ** -0.5), "bias": mk(d, sc=0.1)}
    return {"linear_q": dense(), "linear_k": dense(), "linear_v": dense(),
            "linear_out": dense(),
            "linear_pos": {"kernel": mk(d, d, sc=d ** -0.5)},
            "pos_bias_u": mk(h, d // h, sc=0.1),
            "pos_bias_v": mk(h, d // h, sc=0.1)}


_ORDER = [("linear_q", "kernel"), ("linear_q", "bias"),
          ("linear_k", "kernel"), ("linear_k", "bias"),
          ("linear_v", "kernel"), ("linear_v", "bias"),
          ("pos_bias_u", None), ("pos_bias_v", None),
          ("linear_pos", "kernel"), ("linear_out", "kernel")]


def _leaves(p):
    return [p[n] if leaf is None else p[n][leaf] for n, leaf in _ORDER]


def _torch_leaves(p):
    """The plain version's weight arguments, Dense kernels as Linear
    (out, in), each a leaf that requires grad."""
    return [torch.tensor(np.ascontiguousarray(a.T if leaf == "kernel"
                                              else a), requires_grad=True)
            for a, (_, leaf) in zip(_leaves(p), _ORDER)]


def _grads_jax_layout(xt, params):
    return [xt.grad.float().numpy()] + [
        (q.grad.T if leaf == "kernel" else q.grad).numpy()
        for q, (_, leaf) in zip(params, _ORDER)]


@pytest.mark.parametrize("kind", ["packed", "lone", "shuffled"])
def test_segment_grads_fp32_match_jax_xla(kind):
    t, d, h = 48, 32, 2
    rng = np.random.default_rng(20)
    p = _attention_params(rng, d, h)
    seg = _seg_maps(kind, t)
    mask = seg > 0
    x = (rng.normal(size=(3, t, d)) * 0.5).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32) * mask[..., None]
    pe = jnp.asarray(jax_rel_positional_encoding(t, d))
    mha = JaxMHA(d, h, attention_backend="xla")
    want, vjp = jax.vjp(lambda pp, xx: mha.apply(
        {"params": pp}, xx, pe, jnp.asarray(mask), seg_id=jnp.asarray(seg)),
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    params = _torch_leaves(p)
    got = fused_relpos_attention_block(
        xt, *params, rel_positional_encoding(t, d), torch.from_numpy(mask),
        h, seg_id=torch.from_numpy(seg))
    bo = torch.tensor(p["linear_out"]["bias"], requires_grad=True)
    (got + bo).backward(torch.from_numpy(g))
    np.testing.assert_allclose((got + bo).detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    want_g = [want_x] + _leaves(want_p)
    for (name, leaf), a, w in zip([("x", None)] + _ORDER,
                                  _grads_jax_layout(xt, params), want_g):
        np.testing.assert_allclose(a, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name}.{leaf}")
    np.testing.assert_allclose(bo.grad.numpy(),
                               np.asarray(want_p["linear_out"]["bias"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["packed", "lone", "shuffled"])
@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 77)])
def test_segment_grads_bf16_match_pallas_interpret(kind, rate, seed):
    t, d, h = 48, 88, 2
    rng = np.random.default_rng(21)
    p = _attention_params(rng, d, h)
    seg = _seg_maps(kind, t)
    mask = seg > 0
    x = (rng.normal(size=(3, t, d)) * 0.5).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32) * mask[..., None]
    j = jnp.asarray

    def run(xx, wq, bq, wk, bk, wv, bv, u, v, wpos, wo):
        return pallas_block(xx, wq, bq, wk, bk, wv, bv, u, v,
                            wpos.reshape(d, h, d // h), wo, j(mask),
                            n_heads=h, dropout_rate=rate,
                            dropout_seed=j([seed], jnp.int32),
                            interpret=True, seg_id=j(seg))

    want, vjp = jax.vjp(run, j(x).astype(jnp.bfloat16),
                        *map(j, _leaves(p)))
    want_g = vjp(j(g).astype(jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    params = _torch_leaves(p)
    got = fused_relpos_attention_block(
        xt, *params, rel_positional_encoding(t, d), torch.from_numpy(mask),
        h, dropout_rate=rate, dropout_seed=seed,
        seg_id=torch.from_numpy(seg))
    got.backward(torch.from_numpy(g).to(torch.bfloat16))
    m = mask[..., None]
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().detach().numpy() * m,
                               np.asarray(want, np.float32) * m, rtol=2e-2,
                               atol=1e-2)
    for (name, leaf), a, w in zip([("x", None)] + _ORDER,
                                  _grads_jax_layout(xt, params), want_g):
        w = np.asarray(w, np.float32).reshape(a.shape)
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, w, rtol=3e-2,
                                   atol=3e-2 * max(1.0, np.abs(w).max()),
                                   err_msg=f"{name}.{leaf}")


# --------------------------------------------------------------------------
# the encoder on packed rows in training
# --------------------------------------------------------------------------

def _config(norm, d=32, heads=4, dropout=0.0):
    """tests/test_packed_train.py's tiny teacher: 2 layers, conv k=7, no
    SpecAugment, no dither (the frameworks draw other random numbers)."""
    def make(mod):
        return mod.ModelConfig(
            preprocessor=mod.PreprocessorConfig(features=24, dither=0.0),
            spec_augment=None,
            encoder=mod.EncoderConfig(
                feat_in=24, n_layers=2, d_model=d, n_heads=heads,
                conv_kernel_size=7, conv_norm_type=norm, dropout=dropout,
                dropout_pre_encoder=dropout, dropout_att=dropout,
                **({"attention_backend": "xla"} if mod is JC else {})),
            decoder=mod.DecoderConfig(feat_in=d, num_classes=12),
            compute_dtype="float32")
    return make(JC), make(PC)


@pytest.mark.parametrize("norm", ["layer_norm", "batch_norm"])
def test_encode_frames_train_matches_jax_encode_packed(norm):
    jcfg, pcfg = _config(norm)
    rng = np.random.default_rng(30)
    t = 64
    seg = np.zeros((3, t), np.int32)
    seg[0, :20], seg[0, 28:61] = 1, 2
    seg[1, :t] = 1
    packed = (rng.normal(size=(3, t, 32)) * 0.5).astype(np.float32)
    packed[seg == 0] = 0.0
    jmodel = JaxCTCModel(jcfg)
    key = jax.random.PRNGKey(0)
    v = jmodel.init(key, jnp.zeros((1, 8000)), jnp.asarray([8000], jnp.int32))
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(
        size=a.shape).astype(np.float32), v["params"])
    stats = jax.tree.map(np.asarray, v.get("batch_stats", {}))
    (want, want_len, want_feats), mut = jmodel.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(packed),
        jnp.asarray(seg), train=True, rngs={"dropout": key},
        mutable=["batch_stats"], method=JaxCTCModel.encode_packed)
    port = CTCModel(pcfg)
    port.load_state_dict(jax_to_state_dict(params, stats, pcfg), strict=True)
    port.train()
    got, got_len, got_feats = port.encode_packed(
        torch.from_numpy(packed), torch.from_numpy(seg), True,
        {"dropout": torch.Generator().manual_seed(0)})
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_feats.detach().numpy(),
                               np.asarray(want_feats), rtol=1e-4, atol=1e-4)
    assert float(np.abs(got.detach().numpy()[seg == 0]).max()) == 0.0
    if norm == "batch_norm":
        want_sd = jax_to_state_dict(params, mut["batch_stats"], pcfg)
        for name, b in port.named_buffers():
            if "running" in name:
                np.testing.assert_allclose(b.numpy(), want_sd[name].numpy(),
                                           rtol=0, atol=1e-6, err_msg=name)


# --------------------------------------------------------------------------
# forward_packed_train and the packed step
# --------------------------------------------------------------------------

def _distill(mod, mode):
    if mode == "ctc":
        return mod.DistillationConfig()
    if mode == "logit":
        return mod.DistillationConfig(use_logit_distillation=True,
                                      kd_alpha=0.3)
    flow = mod.FlowMatchingConfig(
        meta_encoder_type="mlp", student_dim=16, teacher_dim=32,
        student_head_num=2, teacher_head_num=4, time_embed_dim=8,
        hidden_dim=16, training_sampling=2, inference_sampling=2,
        **({"euler_backend": "xla"} if mod is JC else {}))
    return mod.DistillationConfig(use_logit_distillation=True, kd_alpha=0.3,
                                  use_flow_matching=True, flow=flow)


def _signals(seed=0, b=4):
    rng = np.random.default_rng(seed)
    lens = [16000, 11200, 8000, 13600][:b]
    sig = (rng.normal(size=(b, max(lens))) * 0.1).astype(np.float32)
    for i, ln in enumerate(lens):
        sig[i, ln:] = 0.0
    return {"signal": sig, "signal_len": np.asarray(lens, np.int32),
            "tokens": rng.integers(0, 12, size=(b, 8)).astype(np.int32),
            "token_len": np.asarray([8, 6, 5, 7][:b], np.int32)}


def _with_plan(batch, cfg, t_pack=64, pad_rows_to=0):
    pk, plan = packing.train_pack_arrays(
        batch["signal_len"], cfg.preprocessor.n_fft,
        cfg.preprocessor.hop_length, cfg.encoder.subsampling_factor,
        cfg.encoder.subsampling, cfg.encoder.conv_kernel_size, t_pack,
        pad_rows_to=pad_rows_to)
    return {**batch, **pk}, plan


def _setup(mode, norm="layer_norm", dropout=0.0):
    """(JAX model, params, stats, numpy batch with the plan, the port's
    model with the same weights, its student config)."""
    (jt, pt) = _config(norm, dropout=dropout)
    js, ps = JC.make_student_config(jt), PC.make_student_config(pt)
    jmodel = JaxDistil(js, jt, _distill(JC, mode))
    batch, plan = _with_plan(_signals(), ps)
    assert plan.n_rows < len(batch["signal_len"])      # packs tighter
    key = jax.random.PRNGKey(0)
    jb = {k: jnp.asarray(batch[k]) for k in ("signal", "signal_len",
                                             "tokens", "token_len")}
    v = jmodel.init({"params": key, "specaug": key, "dropout": key,
                     "gumbel": key, "noise": key}, jb["signal"],
                    jb["signal_len"], jb["tokens"], jb["token_len"],
                    train=True)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(
        size=a.shape).astype(np.float32), v["params"])
    stats = jax.tree.map(np.asarray, v.get("batch_stats", {}))
    model = DistilCTCModel(ps, pt, _distill(PC, mode))
    teacher = pt if model.needs_teacher else None
    if teacher is None:
        params = {k: w for k, w in params.items() if k != "teacher"}
        stats = {k: w for k, w in stats.items() if k != "teacher"}
    model.load_state_dict(distil_to_state_dict(params, stats, ps, teacher),
                          strict=True)
    return jmodel, params, stats, batch, model, ps, teacher


_PLAN = ("pk_src_utt", "pk_src_pos", "pk_seg", "pk_row", "pk_start")


def _jax_packed_grads(jmodel, params, stats, batch, key):
    jb = {k: jnp.asarray(w) for k, w in batch.items()}
    rngs = {k: key for k in ("specaug", "dropout", "gumbel", "noise")}

    def loss_fn(p):
        out, _ = jmodel.apply(
            {"params": p, "batch_stats": stats}, jb["signal"],
            jb["signal_len"], jb["tokens"], jb["token_len"],
            *(jb[k] for k in _PLAN), train=True, rngs=rngs,
            mutable=["batch_stats"],
            method=JaxDistil.forward_packed_train)
        return out.losses["total"], out.losses

    full = dict(params)
    if "teacher" in full:
        full["teacher"] = jax.lax.stop_gradient(full["teacher"])
    (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(full)
    return losses, grads


def _port_grads(model, batch, packed):
    tb = {k: torch.from_numpy(w) for k, w in batch.items()}
    model.train()
    rngs = {"specaug": torch.Generator().manual_seed(0),
            "dropout": torch.Generator().manual_seed(1)}
    args = (tb["signal"], tb["signal_len"], tb["tokens"], tb["token_len"])
    model.zero_grad(set_to_none=True)
    if packed:
        out = model.forward_packed_train(*args, *(tb[k] for k in _PLAN),
                                         train=True, rngs=rngs)
    else:
        out = model(*args, train=True, rngs=rngs)
    out.losses["total"].backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return {k: v.item() for k, v in out.losses.items()}, grads, out


@pytest.mark.parametrize("mode", ["ctc", "logit", "flow"])
def test_forward_packed_train_matches_jax(mode):
    jmodel, params, stats, batch, model, ps, _ = _setup(mode)
    want_losses, want_grads = _jax_packed_grads(jmodel, params, stats, batch,
                                                jax.random.PRNGKey(7))
    losses, grads, out = _port_grads(model, batch, packed=True)
    assert set(losses) == set(want_losses)
    for k, w in want_losses.items():
        np.testing.assert_allclose(losses[k], float(w), rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    want = distil_to_state_dict(
        {k: w for k, w in want_grads.items() if k != "teacher"}, {}, ps)
    assert set(grads) == set(want)
    scale = max(w.abs().max().item() for w in want.values())
    for name, gr in grads.items():
        np.testing.assert_allclose(gr.numpy() / scale,
                                   want[name].numpy() / scale, atol=1e-4,
                                   err_msg=name)
    assert all(not n.startswith("teacher.") for n in grads)
    assert out.log_probs.shape[:2] == out.greedy.shape


@pytest.mark.parametrize("mode", ["ctc", "logit", "flow"])
def test_packed_step_matches_unpacked_step(mode):
    """The port against itself: at dropout 0 with a layer-norm conv module
    the packed forward computes every loss on the unpacked step's
    tensors."""
    _, _, _, batch, model, _, _ = _setup(mode)
    lu, gu, _ = _port_grads(model, batch, packed=False)
    lp, gp, _ = _port_grads(model, batch, packed=True)
    assert set(lu) == set(lp)
    for k in lu:
        np.testing.assert_allclose(lp[k], lu[k], rtol=2e-5, atol=1e-6,
                                   err_msg=k)
    scale = max(g.abs().max().item() for g in gu.values())
    assert set(gu) == set(gp)
    for name in gu:
        np.testing.assert_allclose(gp[name].numpy() / scale,
                                   gu[name].numpy() / scale, atol=1e-4,
                                   err_msg=name)


def test_guard_frames_get_no_attention_cotangent():
    """Every layer zeroes its guard frames and the conv module masks its
    input, so the attention output's cotangent is exactly 0 on guard
    frames: the probabilities the kernels give guard queries (an average
    over their span or over the row) never reach a gradient. Checked with
    BatchNorm, whose statistics include the guard frames, dropout and an
    all-guard row (pad_rows_to)."""
    _, pt = _config("batch_norm", dropout=0.1)
    ps = PC.make_student_config(pt)
    model = DistilCTCModel(ps, pt, _distill(PC, "logit"))
    batch, plan = _with_plan(_signals(), ps, pad_rows_to=3)
    assert (plan.seg_id == 0).all(axis=1).any()
    cot = []

    def keep_cotangent(mod, args, out):
        if out.requires_grad:
            out.register_hook(cot.append)

    for layer in model.student.encoder.layers:
        layer.self_attn.register_forward_hook(keep_cotangent)
    _, grads, _ = _port_grads(model, batch, packed=True)
    assert len(cot) == ps.encoder.n_layers
    guard = torch.from_numpy(plan.seg_id == 0)
    for g in cot:
        assert g.shape[:2] == guard.shape
        assert torch.count_nonzero(g[guard]) == 0
        assert torch.count_nonzero(g[~guard]) > 0
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_packed_train_step_matches_jax():
    jmodel, params, stats, batch, model, ps, teacher = _setup("flow")
    ocfg = dict(d_model=16, warmup_steps=10)
    jstate = JaxState.create(apply_fn=jmodel.apply, params=params,
                             batch_stats=stats,
                             tx=jax_build_optimizer(JC.OptimConfig(**ocfg),
                                                    params))
    key = jax.random.PRNGKey(7)
    jstate, jmetrics = jax.jit(jax_make_step(jmodel, packed=True))(
        jstate, {k: jnp.asarray(w) for k, w in batch.items()}, key)
    _, want_grads = _jax_packed_grads(
        jmodel, params, stats, batch,
        jax.random.fold_in(jax.random.fold_in(key, 0), 0))
    state = DistilTrainState.create(model, PC.OptimConfig(**ocfg))
    tb = {k: torch.from_numpy(w) for k, w in batch.items()}
    state, metrics = make_distil_train_step(model, packed=True)(state, tb, 0)
    assert state.step == 1
    for k, w in jmetrics.items():
        if k.startswith("loss/"):
            np.testing.assert_allclose(metrics[k].item(), float(w),
                                       rtol=2e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    grads = distil_to_state_dict(
        {k: w for k, w in want_grads.items() if k != "teacher"}, {}, ps)
    top = max(g.abs().max().item() for g in grads.values())
    want_sd = distil_to_state_dict(jstate.params, jstate.batch_stats, ps,
                                   teacher)
    lr = state.schedule(0)
    for name, t in model.state_dict().items():
        if name in grads:
            keep = grads[name].abs() > 1e-4 * top
            np.testing.assert_allclose(t[keep].numpy(),
                                       want_sd[name][keep].numpy(),
                                       rtol=1e-5, atol=5e-3 * lr,
                                       err_msg=name)
        elif "num_batches_tracked" not in name:
            np.testing.assert_array_equal(t.numpy(), want_sd[name].numpy(),
                                          err_msg=name)


def test_cpu_packed_step_launches_and_builds_nothing():
    _, pt = _config("batch_norm", dropout=0.1)
    ps = PC.make_student_config(pt)
    model = DistilCTCModel(ps, pt, _distill(PC, "flow"))
    for w in WRAPPERS:
        w.launches = 0
    fused_relpos_attention_block_bwd.seg_launches = 0
    batch, _ = _with_plan(_signals(), ps)
    state = DistilTrainState.create(model, PC.OptimConfig(d_model=16))
    tb = {k: torch.from_numpy(w) for k, w in batch.items()}
    step = make_distil_train_step(model, packed=True)
    state, metrics = step(state, tb, 0)
    assert torch.isfinite(metrics["loss/total"])
    assert all(w.launches == 0 for w in WRAPPERS)
    assert fused_relpos_attention_block_bwd.seg_launches == 0
    assert _kernels.library.cache_info().currsize == 0
    bn = [m for m in model.student.modules()
          if isinstance(m, MaskedBatchNorm)]
    assert bn and all(m.num_batches_tracked.item() == 1 for m in bn)
