"""Port parity for the student CTC and KD train steps: tpu_asr_torch's
DistilCTCModel + make_distil_train_step against the JAX package's on the
CPU, weights carried by the bridge (convert/from_jax.distil_to_state_dict),
batch made with numpy from a seed.

- a tiny student (2 layers, d 32, 2 heads) with every dropout rate 0, no
  SpecAugment and no dither (the two frameworks draw other random numbers):
  the loss at 1e-5, every gradient within 1e-5 + 1e-4 x its tensor's
  max|ref| (fp32 sums in another order), the BatchNorm running statistics
  after the step at 1e-6, and every parameter after one and two AdamW +
  Noam steps within 1e-5 x |ref| + 5e-3 x the learning rate (Adam divides
  by |g| + 1e-8, and in the second step its first moment can cancel, so
  the gradients' ~1e-4 rounding difference reaches the update at up to a
  few 1e-3 of the learning rate). Some
  gradients are zero in exact arithmetic (the key bias and the
  depthwise-conv bias before BatchNorm; linear_pos columns that meet
  near-constant columns of the position table): both frameworks must give
  the key and conv biases below 1e-6 x the largest gradient, and since Adam
  turns such noise into a step of either sign, the after-the-step
  comparison covers the elements whose reference gradient exceeds 1e-4 x
  the largest gradient (at least 90% of all);
- the same with global-norm clipping (gradient_clip_val 0.5) for one step
  (clipped gradients and the update), and the grad_norm metric against
  JAX's at 1e-5;
- the skip_nan_grad guard zeroes and counts non-finite gradient elements;
- the Noam and cosine schedules against the JAX ones;
- SpecAugment and dither: deterministic under a seed, masks within bounds;
- training randomness reproducible per (seed, step), and the checkpointed
  layers update BatchNorm once per step;
- the KD train steps 'logit' (logit KL + CTC) and 'flowkd' (FM-KT with
  the mlp meta encoder and 3 fixed Euler steps over both layers + logit KL
  + CTC) with a frozen tiny teacher (2 layers, d 64, 4 heads), on the
  tolerances above: every loss component, every student and FM gradient,
  the grad_norm metric, and the parameters after one and two steps (the
  second within 2e-2 x the learning rate: by then both Adam moments carry
  the first step's rounding difference); the teacher's parameters and
  statistics stay bit-unchanged and get no gradient; then the eval
  forward from JAX's weights (FM output into the decoder, no teacher) at
  1e-4;
- the KD options outside the slice raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil
from tpu_asr.train.optim import build_optimizer as jax_build_optimizer
from tpu_asr.train.optim import (cosine_annealing_schedule as jax_cosine,
                                 noam_annealing_schedule as jax_noam)
from tpu_asr.train.trainer import DistilTrainState as JaxState
from tpu_asr.train.trainer import make_distil_train_step as jax_make_step
from tpu_asr_torch.convert.from_jax import distil_to_state_dict
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.ops.features import FilterbankFeatures
from tpu_asr_torch.ops.specaug import spec_augment
from tpu_asr_torch.train.optim import (cosine_annealing_schedule,
                                       noam_annealing_schedule)
from tpu_asr_torch.train.trainer import (DistilTrainState,
                                         make_distil_train_step, step_rngs)


def _configs(mod, dropout=0.0, spec=False, dither=0.0, variant=""):
    """(teacher, student); `variant` '_int8' quantizes the teacher's FFNs
    (the student stays fp), '_int8_ln' also gives both layer-norm conv
    modules."""
    enc = mod.EncoderConfig(n_layers=2, d_model=64, n_heads=4,
                            conv_kernel_size=7, dropout=dropout,
                            dropout_pre_encoder=dropout, dropout_att=dropout,
                            conv_norm_type="layer_norm"
                            if variant.endswith("_ln") else "batch_norm")
    teacher = mod.ModelConfig(
        spec_augment=mod.SpecAugmentConfig() if spec else None,
        preprocessor=mod.PreprocessorConfig(dither=dither), encoder=enc,
        decoder=mod.DecoderConfig(feat_in=64, num_classes=16),
        compute_dtype="float32")
    student = mod.make_student_config(teacher)
    if "_int8" in variant:
        teacher = dataclasses.replace(teacher, encoder=dataclasses.replace(
            enc, quantization="int8"))
    return teacher, student


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"signal": (rng.normal(size=(2, 16000)) * 0.1).astype(np.float32),
            "signal_len": np.array([16000, 12000], np.int32),
            "tokens": rng.integers(0, 16, size=(2, 5)).astype(np.int32),
            "token_len": np.array([5, 3], np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _variant(kind):
    """'flowkd_int8' -> ('flowkd', '_int8')."""
    base = kind.split("_int8")[0]
    return base, kind[len(base):]


def _distill(mod, kind, backend="auto"):
    """DistillationConfig of `kind`: 'ctc', 'logit' or 'flowkd' (logit KD
    + FM-KT with the mlp meta encoder, 3 fixed steps), each with an
    optional `_configs` variant suffix."""
    kind, _ = _variant(kind)
    if kind == "ctc":
        return mod.DistillationConfig()
    flow = mod.FlowMatchingConfig(
        student_dim=32, teacher_dim=64, student_head_num=2,
        teacher_head_num=4, time_embed_dim=8, hidden_dim=16,
        training_sampling=3, inference_sampling=3, euler_backend=backend)
    return mod.DistillationConfig(
        use_logit_distillation=True, kd_alpha=0.1,
        use_flow_matching=kind == "flowkd",
        flow=flow if kind == "flowkd" else None)


def _jax_setup(seed=0, kind="ctc"):
    teacher, student = _configs(JC, variant=_variant(kind)[1])
    model = JaxDistil(student, teacher, _distill(JC, kind, "xla"))
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    key = jax.random.PRNGKey(seed)
    v = model.init({"params": key, "specaug": key, "dropout": key,
                    "gumbel": key, "noise": key},
                   jb["signal"], jb["signal_len"], jb["tokens"],
                   jb["token_len"], train=True)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(
        size=a.shape).astype(np.float32), v["params"])
    stats = jax.tree.map(np.asarray, v.get("batch_stats", {}))
    return model, student, params, stats, jb, key


def _port(params, stats, kind="ctc"):
    teacher, student = _configs(PC, variant=_variant(kind)[1])
    model = DistilCTCModel(student, teacher, _distill(PC, kind))
    model.load_state_dict(distil_to_state_dict(params, stats, student,
                                               teacher), strict=True)
    return model, student


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_train_step_matches_jax(clip):
    jmodel, jstudent, params, stats, jb, key = _jax_setup()

    def loss_fn(p):
        out, mut = jmodel.apply(
            {"params": p, "batch_stats": stats}, jb["signal"],
            jb["signal_len"], jb["tokens"], jb["token_len"], train=True,
            rngs={"specaug": key, "dropout": key}, mutable=["batch_stats"])
        return out.losses["total"], mut["batch_stats"]

    (want_loss, want_stats), want_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    ocfg = dict(d_model=32, warmup_steps=10, gradient_clip_val=clip)
    jstate = JaxState.create(apply_fn=jmodel.apply, params=params,
                             batch_stats=stats,
                             tx=jax_build_optimizer(JC.OptimConfig(**ocfg),
                                                    params))
    jstep = jax.jit(jax_make_step(jmodel))

    model, student = _port(params, stats)
    state = DistilTrainState.create(model, PC.OptimConfig(**ocfg))
    step = make_distil_train_step(model)
    tb = _torch_batch(_batch())
    state, metrics = step(state, tb, 0)
    np.testing.assert_allclose(metrics["loss/total"].item(), float(want_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["loss/ctc"].item(), float(want_loss),
                               rtol=1e-5)
    grads = distil_to_state_dict(want_grads, stats, student)
    if clip:        # the step leaves the clipped gradients in p.grad
        norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in
                                  jax.tree.leaves(want_grads))))
        grads = {k: v * (clip / max(norm, clip)) for k, v in grads.items()}
    top = max(g.abs().max().item() for g in grads.values())
    zero_grad = {n for n in grads
                 if n.endswith(("linear_k.bias", "depthwise_conv.bias"))}
    for name, p in model.named_parameters():
        w = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=name)
        if name in zero_grad:
            assert np.abs(w).max() < 1e-6 * top, name
            assert p.grad.abs().max().item() < 1e-6 * top, name
    want_sd = distil_to_state_dict(params, want_stats, student)
    for name, b in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(b.numpy(), want_sd[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)

    decided = {n: g.abs() > 1e-4 * top for n, g in grads.items()}
    share = (sum(m.sum().item() for m in decided.values())
             / sum(m.numel() for m in decided.values()))
    assert share > 0.9, share
    for n_steps in ((1, 2) if not clip else (1,)):
        if n_steps == 2:
            state, _ = step(state, tb, 0)
        jstate, jmetrics = jstep(jstate, jb, key)
        if n_steps == 1:
            np.testing.assert_allclose(metrics["grad_norm"].item(),
                                       float(jmetrics["grad_norm"]),
                                       rtol=1e-5)
        want_sd = distil_to_state_dict(jstate.params, jstate.batch_stats,
                                       student)
        lr = state.schedule(n_steps - 1)
        for name, t in model.state_dict().items():
            if "num_batches_tracked" in name:
                assert t.item() == n_steps
                continue
            keep = decided.get(name, torch.ones(t.shape, dtype=torch.bool))
            np.testing.assert_allclose(t[keep].numpy(),
                                       want_sd[name][keep].numpy(),
                                       rtol=1e-5, atol=5e-3 * lr,
                                       err_msg=f"step {n_steps}: {name}")


@pytest.mark.parametrize("kind", ["logit", "flowkd", "flowkd_int8",
                                  "logit_int8_ln"])
def test_kd_train_step_matches_jax(kind):
    jmodel, _, params, stats, jb, key = _jax_setup(kind=kind)
    rngs = {"specaug": key, "dropout": key, "gumbel": key, "noise": key}

    def loss_fn(p):
        out, mut = jmodel.apply(
            {"params": p, "batch_stats": stats}, jb["signal"],
            jb["signal_len"], jb["tokens"], jb["token_len"], train=True,
            rngs=rngs, mutable=["batch_stats"])
        return out.losses["total"], out.losses

    (_, want_losses), want_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    ocfg = dict(d_model=32, warmup_steps=10)
    jstate = JaxState.create(apply_fn=jmodel.apply, params=params,
                             batch_stats=stats,
                             tx=jax_build_optimizer(JC.OptimConfig(**ocfg),
                                                    params))
    jstep = jax.jit(jax_make_step(jmodel))

    model, student = _port(params, stats, kind)
    teacher_cfg = model.teacher_cfg
    teacher0 = {k: v.clone() for k, v in model.state_dict().items()
                if k.startswith("teacher.")}
    state = DistilTrainState.create(model, PC.OptimConfig(**ocfg))
    step = make_distil_train_step(model)
    tb = _torch_batch(_batch())
    state, metrics = step(state, tb, 0)
    assert set(want_losses) == {k[5:] for k in metrics if
                                k.startswith("loss/")}
    # an int8 teacher: the port's fused int8 chain against JAX's XLA
    # int8_dense chain, whose LN and activation scales round differently
    # in the last place, so a few activations may land one quantum apart
    rtol = 1e-4 if "_int8" in kind else 1e-5
    for name, want in want_losses.items():
        np.testing.assert_allclose(metrics[f"loss/{name}"].item(),
                                   float(want), rtol=rtol, err_msg=name)
    grads = distil_to_state_dict(want_grads, stats, student, teacher_cfg)
    top = max(g.abs().max().item() for g in grads.values())
    for name, p in model.named_parameters():
        if name.startswith("teacher."):
            assert p.grad is None and not p.requires_grad, name
            continue
        w = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=name)
    decided = {n: g.abs() > 1e-4 * top for n, g in grads.items()}
    for n_steps in (1, 2):
        if n_steps == 2:
            state, _ = step(state, tb, 0)
        jstate, jmetrics = jstep(jstate, jb, key)
        if n_steps == 1:
            np.testing.assert_allclose(metrics["grad_norm"].item(),
                                       float(jmetrics["grad_norm"]),
                                       rtol=1e-5)
        want_sd = distil_to_state_dict(jstate.params, jstate.batch_stats,
                                       student, teacher_cfg)
        lr = state.schedule(n_steps - 1)
        tol = 5e-3 if n_steps == 1 else 2e-2
        for name, t in model.state_dict().items():
            if name.startswith("teacher."):
                assert torch.equal(t, teacher0[name]), name
                continue
            if "num_batches_tracked" in name:
                assert t.item() == n_steps
                continue
            keep = decided.get(name, torch.ones(t.shape, dtype=torch.bool))
            np.testing.assert_allclose(t[keep].numpy(),
                                       want_sd[name][keep].numpy(),
                                       rtol=1e-5, atol=tol * lr,
                                       err_msg=f"step {n_steps}: {name}")
        np.testing.assert_allclose(
            np.concatenate([want_sd[k].numpy().ravel() for k in teacher0]),
            np.concatenate([teacher0[k].numpy().ravel() for k in teacher0]),
            rtol=0, atol=0)

    # eval from JAX's weights after the steps (Adam moves the undecided
    # elements apart): no teacher; with FM the decoder reads the last
    # layer's FM output
    model.load_state_dict(want_sd)
    want = jmodel.apply({"params": jstate.params,
                         "batch_stats": jstate.batch_stats}, jb["signal"],
                        jb["signal_len"], train=False)
    with torch.no_grad():
        got = model(tb["signal"], tb["signal_len"])
    assert got.tch_feats is None and want.tch_feats is None
    np.testing.assert_allclose(got.log_probs.numpy(),
                               np.asarray(want.log_probs), rtol=1e-4,
                               atol=1e-4)


def test_bridge_maps_the_whole_flowkd_tree():
    """Every JAX leaf (student, teacher and FM params, both batch_stats)
    becomes one port tensor, and the port's state_dict has nothing else
    but the num_batches_tracked counters."""
    _, _, params, stats, _, _ = _jax_setup(kind="flowkd")
    assert set(params) == {"student", "teacher", "flow_matching"}
    model, _ = _port(params, stats, "flowkd")
    sd = distil_to_state_dict(params, stats, model.student_cfg,
                              model.teacher_cfg)
    n_leaves = len(jax.tree.leaves(params)) + len(jax.tree.leaves(stats))
    n_layers = model.student_cfg.encoder.n_layers
    stacked = sum(len(jax.tree.leaves(params[m]["encoder"]["layers"]))
                  + len(jax.tree.leaves(stats[m]))
                  for m in ("student", "teacher"))
    # a stacked (L, ...) layer leaf becomes L tensors; one BatchNorm
    # counter per layer of the two encoders
    assert len(sd) - 2 * n_layers == n_leaves + (n_layers - 1) * stacked
    assert set(sd) == set(model.state_dict())
    with pytest.raises(ValueError, match="no port counterpart"):
        distil_to_state_dict({**params, "router": {}}, stats,
                             model.student_cfg, model.teacher_cfg)


def test_skip_nan_grad_zeroes_and_counts():
    teacher, student = _configs(PC)
    student = dataclasses.replace(student, skip_nan_grad=True)
    torch.manual_seed(0)
    model = DistilCTCModel(student, teacher)
    w = model.student.decoder.decoder_layers[0].weight
    with torch.no_grad():
        w[3, 0, 0] = float("nan")            # every logit of class 3 is NaN
    state = DistilTrainState.create(model, PC.OptimConfig(d_model=32))
    state, metrics = make_distil_train_step(model)(state,
                                                   _torch_batch(_batch()), 0)
    assert metrics["nonfinite_grad_elems"].item() > 0
    assert torch.isfinite(metrics["grad_norm"])
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.parametrize("count", [0, 1, 9, 10, 11, 5000])
def test_schedules_match_jax(count):
    np.testing.assert_allclose(noam_annealing_schedule(2.0, 176, 10, 1e-6)(
        count), float(jax_noam(2.0, 176, 10, 1e-6)(jnp.int32(count))),
        rtol=1e-6)
    np.testing.assert_allclose(cosine_annealing_schedule(1e-3, 10, 100, 1e-5)(
        count), float(jax_cosine(1e-3, 10, 100, 1e-5)(jnp.int32(count))),
        rtol=1e-5)


def test_spec_augment_is_seeded_and_bounded():
    cfg = PC.SpecAugmentConfig(freq_masks=2, time_masks=3, freq_width=5,
                               time_width=0.1, mask_value=-7.0)
    spec = torch.randn(3, 20, 50, generator=torch.Generator().manual_seed(0))
    length = torch.tensor([50, 31, 8])
    run = lambda s: spec_augment(spec, length, cfg,
                                 torch.Generator().manual_seed(s))
    a = run(1)
    assert torch.equal(a, run(1)) and not torch.equal(a, run(2))
    masked = a == -7.0
    for b in range(3):
        rows = masked[b].all(dim=1)          # whole frequency stripes
        cols = masked[b].all(dim=0)          # whole time stripes
        assert rows.sum() <= 2 * 5
        max_w = max(1, int(length[b] * 0.1))
        assert cols.sum() <= 3 * max_w
        assert torch.equal(masked[b], rows[:, None] | cols[None, :])


def test_dither_is_seeded_and_train_only():
    feat = FilterbankFeatures(PC.PreprocessorConfig(dither=1e-2))
    sig = torch.randn(2, 8000, generator=torch.Generator().manual_seed(0))
    n = torch.tensor([8000, 6000])
    run = lambda train, s: feat(sig, n, train,
                                torch.Generator().manual_seed(s))[0]
    assert torch.equal(run(True, 3), run(True, 3))
    assert not torch.equal(run(True, 3), run(True, 4))
    assert torch.equal(run(False, 3), feat(sig, n)[0])
    assert not torch.equal(run(True, 3), run(False, 3))


def test_training_randomness_is_per_seed_and_step():
    teacher, student = _configs(PC, dropout=0.1, spec=True, dither=1e-5)
    torch.manual_seed(0)
    model = DistilCTCModel(student, teacher)
    tb = _torch_batch(_batch())

    def loss(seed, step):
        out = model(tb["signal"], tb["signal_len"], tb["tokens"],
                    tb["token_len"], train=True,
                    rngs=step_rngs(seed, step, "cpu"))
        return out.losses["total"].item()

    assert loss(1, 0) == loss(1, 0)
    assert loss(1, 0) != loss(1, 1) and loss(1, 0) != loss(2, 0)


def test_checkpointed_layers_update_batch_norm_once():
    _, _, params, stats, _, _ = _jax_setup()
    runs = []
    for remat in (True, False):
        model, student = _port(params, stats)
        model.student.encoder.cfg = dataclasses.replace(
            model.student.encoder.cfg, remat=remat)
        state = DistilTrainState.create(model, PC.OptimConfig(d_model=32))
        make_distil_train_step(model)(state, _torch_batch(_batch()), 0)
        runs.append({n: b.clone() for n, b in model.named_buffers()})
    for name in runs[0]:
        torch.testing.assert_close(runs[0][name], runs[1][name], rtol=0,
                                   atol=1e-6, msg=name)
    assert all(v.item() == 1 for n, v in runs[0].items()
               if "num_batches_tracked" in n)


@pytest.mark.parametrize("option", [
    {"use_layerwise_distillation": True}, {"use_diffkd": True},
    {"use_diffm": True}, {"interctc_layers": (0,)},
    {"flow": None}, {"flow.use_dynamic_steps": True},
    {"flow.sampling_steps_per_layer": (3, 3)},
    {"flow.meta_encoder_type": "cnn"}, {"group_loss": True}])
def test_kd_options_outside_the_slice_raise(option):
    teacher, student = _configs(PC)
    distill = _distill(PC, "flowkd")
    (key, value), = option.items()
    if key.startswith("flow."):
        distill = dataclasses.replace(distill, flow=dataclasses.replace(
            distill.flow, **{key[5:]: value}))
    elif key != "group_loss":
        distill = dataclasses.replace(distill, **option)
    with pytest.raises(ValueError, match="does not implement"):
        model = DistilCTCModel(student, teacher, distill)
        feats = torch.zeros(2, 5, 32)
        model.flow_matching(feats, torch.zeros(2, 5, 64), train=True,
                            group_loss=True)
