"""Port parity for the KD train steps (tests/test_torch_train.py's
configurations, batch and tolerances): 'logit' (logit KL + CTC) and
'flowkd' (FM-KT with the mlp meta encoder and 3 fixed Euler steps over both
layers + logit KL + CTC), each also with an int8 teacher ('_int8'; '_ln'
with layer-norm conv modules), a frozen tiny teacher (2 layers, d 64, 4
heads): every loss component, every student and FM gradient, the
grad_norm metric, and the parameters after one and two steps (the second
within 2e-2 x the learning rate: by then both Adam moments carry the first
step's rounding difference); the teacher's parameters and statistics stay
bit-unchanged and get no gradient; then the eval forward from JAX's
weights (FM output into the decoder, no teacher) at 1e-4."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import jax
import numpy as np
import pytest
import torch

import tpu_asr_torch.config as PC
from tests.test_torch_train import (JC, JaxState, _batch, _jax_setup, _port,
                                    _torch_batch, jax_build_optimizer,
                                    jax_make_step)
from tpu_asr_torch.convert.from_jax import distil_to_state_dict
from tpu_asr_torch.train.trainer import (DistilTrainState,
                                         make_distil_train_step)


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
