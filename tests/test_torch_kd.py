"""The port's KD modules (tpu_asr_torch/kd/) against the JAX package's on
the CPU, weights carried by convert/from_jax.py, inputs made with numpy
from a seed:

- the three noise schedules and their derivatives at 1e-6 relative;
- logit_kl_loss and layerwise_mse_loss at 1e-6 relative;
- MLPMetaEncoder at 1e-6; the other meta encoders build, and refuse
  euler_backend='pallas' as JAX's do (their parity:
  tests/test_torch_meta.py);
- FlowMatchingModule (fp32, per-row step counts, stacked layers with
  loss_layers) for every shape transform and both metrics, training and
  eval: loss at 1e-5 relative, x_final at 1e-5, and, for training, the
  gradients of loss + mean(x_final^2) with respect to every parameter and
  the student feature at rtol 1e-4, atol 1e-5 (sums in another order);
  the JAX module runs euler_backend 'pallas' (the kernel in interpret mode);
- the same module in bf16 against the Pallas kernel's bf16 path in
  interpret mode: loss within 2e-2 relative and x_final within 3e-2
  (bf16 rounding of x, h and v at the same points, fp32 sums in another
  order);
- the group loss (the dynamic router's), with and without loss_layers,
  against JAX's euler_backend 'pallas' (the kernel in interpret mode) and
  'xla' routes: loss at 1e-5 relative and the gradients at rtol 1e-4,
  atol 1e-6, over rows with 1..4 steps of max_steps 4 (every count
  present, one row above max_steps for the form without loss_layers,
  which leaves it out); rows that are not whole stacked layers raise.
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
from tpu_asr.kd import losses as jax_losses
from tpu_asr.kd import schedules as jax_schedules
from tpu_asr.kd.flow_matching import FlowMatchingModule as JaxFM
from tpu_asr.kd.meta_encoders import MLPMetaEncoder as JaxMLP
from tpu_asr_torch.convert.from_jax import kd_to_state_dict
from tpu_asr_torch.kd import losses, schedules
from tpu_asr_torch.kd.flow_matching import FlowMatchingModule
from tpu_asr_torch.kd.meta_encoders import MLPMetaEncoder, build_meta_encoder

L, B, T, CS, CT = 2, 3, 7, 24, 40


def _rng(seed):
    rng = np.random.default_rng(seed)
    return lambda *s: rng.normal(size=s).astype(np.float32)


@pytest.mark.parametrize("name", ["rectified", "vp_ode", "ve_ode"])
def test_noise_schedules_match_jax(name):
    t = np.linspace(0.05, 1.0, 20, dtype=np.float32)
    got = schedules.get_noise_schedule(name)
    want = jax_schedules.get_noise_schedule(name)
    for g_fn, w_fn in zip(got, want):
        for g, w in zip(g_fn(torch.from_numpy(t)), w_fn(jnp.asarray(t))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    with pytest.raises(NotImplementedError):
        schedules.get_noise_schedule("cosine")


@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_logit_kl_loss_matches_jax(temperature):
    f = _rng(0)
    stu = torch.log_softmax(torch.from_numpy(f(B, T, 11)), -1)
    tch = torch.log_softmax(torch.from_numpy(f(B, T, 11) * 3), -1)
    got = losses.logit_kl_loss(stu, tch, temperature)
    want = jax_losses.logit_kl_loss(jnp.asarray(stu.numpy()),
                                    jnp.asarray(tch.numpy()), temperature)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("average", [True, False])
def test_layerwise_mse_loss_matches_jax(average):
    f = _rng(1)
    s, t = f(L, B, T, CT), f(L, B, T, CT)
    got = losses.layerwise_mse_loss(torch.from_numpy(s), torch.from_numpy(t),
                                    average)
    want = jax_losses.layerwise_mse_loss(jnp.asarray(s), jnp.asarray(t),
                                         average)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_mlp_meta_encoder_matches_jax():
    f = _rng(2)
    x = f(B, T, CS + 8)
    jm = JaxMLP(16, CS)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    pm = MLPMetaEncoder(CS + 8, 16, CS)
    p = v["params"]
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            layer = getattr(pm, name)
            layer.weight.copy_(torch.from_numpy(np.asarray(
                p[name]["kernel"]).T))
            layer.bias.copy_(torch.from_numpy(np.asarray(p[name]["bias"])))
    got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["cnn", "swin", "conformer", "unet"])
def test_other_meta_encoders_raise(kind):
    """They build (their parity: tests/test_torch_meta.py); the fused
    Euler kernel implements only the mlp, so euler_backend='pallas'
    raises with them, and an unknown kind raises."""
    x = torch.zeros(B, 17, CS + 8)
    assert build_meta_encoder(kind, in_dim=CS + 8, out_dim=CS,
                              hidden_dim=16)(x).shape == (B, 17, CS)
    with pytest.raises(ValueError, match="only the 'mlp'"):
        FlowMatchingModule(_flow(PC, meta_encoder_type=kind,
                                 euler_backend="pallas"))
    with pytest.raises(ValueError, match="Unknown meta_encoder"):
        build_meta_encoder(kind + "x", in_dim=CS + 8, out_dim=CS,
                           hidden_dim=16)


def _teacher_dim(kw):
    """identity: the teacher feature must have the student's width."""
    return CS if kw.get("shape_transform") == "identity" else CT


def _flow(mod, **kw):
    return mod.FlowMatchingConfig(
        student_dim=CS, teacher_dim=_teacher_dim(kw), time_embed_dim=8,
        hidden_dim=16, training_sampling=3, inference_sampling=3, **kw)


def _fm_pair(seed=0, dtype="float32", **kw):
    """(JAX module, its params, port module with the same weights)."""
    jm = JaxFM(_flow(JC, euler_backend="pallas", **kw), getattr(jnp, dtype))
    f = _rng(seed)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(f(B * L, T, CS)),
                jnp.asarray(f(B * L, T, _teacher_dim(kw))), steps=3,
                train=True)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * f(*a.shape),
                          v["params"])
    pm = FlowMatchingModule(_flow(PC, **kw), getattr(torch, dtype))
    pm.load_state_dict(kd_to_state_dict(params), strict=True)
    return jm, params, pm


def _stacked(seed, ct=CT):
    f = _rng(seed)
    s = f(B * L, T, CS)
    t = f(B * L, T, ct)
    steps = np.array([1, 2, 3, 4, 2, 1], np.int32)[:B * L]
    return s, t, steps


@pytest.mark.parametrize("loss", ["mse", "cosine"])
@pytest.mark.parametrize("transform", ["identity", "linear", "conv1d"])
@pytest.mark.parametrize("schedule", ["rectified", "vp_ode"])
def test_flow_matching_module_matches_jax(transform, loss, schedule):
    kw = dict(shape_transform=transform, loss=loss, noise_schedule=schedule)
    jm, params, pm = _fm_pair(3, **kw)
    s, t, steps = _stacked(4, _teacher_dim(kw))
    if schedule == "vp_ode":        # sigma(t = 1/1) = 0: x_hat is 0 / inf
        steps = steps + 1

    def jax_obj(p, sf):
        loss_, x = jm.apply({"params": p}, sf, jnp.asarray(t),
                            steps=jnp.asarray(steps), max_steps=4,
                            train=True, loss_layers=L)
        return loss_ + jnp.mean(x * x), (loss_, x)

    (_, (want_loss, want_x)), (want_gp, want_gs) = jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True)(params, jnp.asarray(s))
    sf = torch.from_numpy(s).requires_grad_()
    got_loss, got_x = pm(sf, torch.from_numpy(t), steps=torch.from_numpy(
        steps), max_steps=4, train=True, loss_layers=L)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(got_x.detach().numpy(), np.asarray(want_x),
                               rtol=1e-5, atol=1e-5)
    (got_loss + (got_x * got_x).mean()).backward()
    want_sd = kd_to_state_dict(want_gp)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(sf.grad.numpy(), np.asarray(want_gs),
                               rtol=1e-4, atol=1e-5)


def test_flow_matching_module_eval_matches_jax():
    jm, params, pm = _fm_pair(5)
    s, _, _ = _stacked(6)
    want_loss, want_x = jm.apply({"params": params}, jnp.asarray(s),
                                 train=False)
    with torch.no_grad():
        got_loss, got_x = pm(torch.from_numpy(s), train=False)
    assert got_loss.item() == float(want_loss) == 0.0
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5,
                               atol=1e-5)


def test_flow_matching_module_bf16_matches_pallas_kernel():
    jm, params, pm = _fm_pair(7, dtype="bfloat16")
    s, t, steps = _stacked(8)
    want_loss, want_x = jm.apply({"params": params}, jnp.asarray(s),
                                 jnp.asarray(t), steps=jnp.asarray(steps),
                                 max_steps=4, train=True, loss_layers=L)
    with torch.no_grad():
        got_loss, got_x = pm(torch.from_numpy(s), torch.from_numpy(t),
                             steps=torch.from_numpy(steps), max_steps=4,
                             train=True, loss_layers=L)
    assert got_x.dtype == torch.bfloat16
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=2e-2)
    np.testing.assert_allclose(got_x.float().numpy(),
                               np.asarray(want_x, np.float32), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("layers", [None, L])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_group_loss_matches_jax(backend, layers):
    jm, params, pm = _fm_pair(9)
    jm = JaxFM(_flow(JC, euler_backend=backend))
    s, t, _ = _stacked(10)
    # rows b-major: (b, l) = (0, 0) 1 step, (0, 1) 2, (1, 0) 3, (1, 1) 4,
    # (2, 0) 2, (2, 1) 4 (5 for the form without layers: above max_steps)
    steps = np.array([1, 2, 3, 4, 2, 4 if layers else 5], np.int32)

    def jax_obj(p, sf):
        return jm.apply({"params": p}, sf, jnp.asarray(t),
                        steps=jnp.asarray(steps), max_steps=4, train=True,
                        group_loss=True, loss_layers=layers)[0]

    want, (want_gp, want_gs) = jax.value_and_grad(jax_obj, argnums=(0, 1))(
        params, jnp.asarray(s))
    sf = torch.from_numpy(s).requires_grad_()
    got, _ = pm(sf, torch.from_numpy(t), steps=torch.from_numpy(steps),
                max_steps=4, train=True, group_loss=True, loss_layers=layers)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    want_sd = kd_to_state_dict(want_gp)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(sf.grad.numpy(), np.asarray(want_gs),
                               rtol=1e-4, atol=1e-6)


def test_group_loss_raises():
    """The group loss over rows that are not whole stacked layers."""
    _, _, pm = _fm_pair(9)
    s, t, steps = _stacked(10)
    with pytest.raises(ValueError, match="stacked layers"):
        pm(torch.from_numpy(s), torch.from_numpy(t), steps=torch.from_numpy(
            steps), max_steps=4, train=True, group_loss=True, loss_layers=4)


def test_xla_backend_is_the_plain_loop():
    _, _, pm = _fm_pair(11)
    s, t, steps = _stacked(12)
    run = lambda: pm(torch.from_numpy(s), torch.from_numpy(t),
                     steps=torch.from_numpy(steps), max_steps=4, train=True)
    want = run()
    pm.backend = "xla"
    got = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="does not implement"):
        FlowMatchingModule(dataclasses.replace(_flow(PC),
                                               euler_backend="triton"))
