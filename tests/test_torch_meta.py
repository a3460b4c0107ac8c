"""The port's meta encoders (tpu_asr_torch/kd/meta_encoders.py) inside
FlowMatchingModule against the JAX package's on the CPU, weights carried by
convert/from_jax.py (the whole FM tree of each meta encoder mapped, strict
load), inputs made with numpy from a seed:

- `cnn`, `swin`, `conformer` and `unet` (and `mlp` through the same generic
  Euler loop), in eval and in training, per-row step counts 1..3 over
  max_steps 3, an odd T (the U-Net's pad and crop branches run): loss at
  1e-5 relative, x_final within 1e-5 of its scale, and in training the
  gradients of loss + mean(x_final^2) with respect to every parameter and
  the student feature within 1e-4 relative + 1e-6 (sums in another
  order). JAX's nn.Dropout is made an identity in the test process and the
  port's meta-encoder dropout is set to rate 0;
- the conformer in training is in tests/test_torch_meta_conformer_train.py,
  its per-layer batch statistics in tests/test_torch_meta_conformer.py;
- the port's rate-0.1 dropout keeps 0.9 of the elements (within 0.005)
  scaled by 1 / 0.9, draws its masks from the `dropout` generator, and a
  training call without the generator raises;
- euler_backend='pallas' with a non-mlp meta encoder raises, as JAX's
  resolve_euler_backend does.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tests.test_torch_kd_menu import random_tree, run_once
from tpu_asr.kd.flow_matching import FlowMatchingModule as JaxFM
from tpu_asr_torch.convert.from_jax import kd_to_state_dict
from tpu_asr_torch.kd.flow_matching import FlowMatchingModule
from tpu_asr_torch.kd import meta_encoders
from tpu_asr_torch.kd.meta_encoders import META_DROPOUT, _drop

B, T, CS, CT, MAX = 3, 17, 16, 24, 3
STEPS = np.array([1, 3, 2], np.int32)
KINDS = ["mlp", "cnn", "swin", "conformer", "unet"]


@pytest.fixture
def no_dropout(monkeypatch):
    """JAX's nn.Dropout an identity, the port's meta-encoder dropout rate
    0."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    monkeypatch.setattr(meta_encoders, "META_DROPOUT", 0.0)


def _flow(mod, kind, **kw):
    return mod.FlowMatchingConfig(
        meta_encoder_type=kind, student_dim=CS, teacher_dim=CT,
        student_head_num=2, time_embed_dim=8, hidden_dim=8,
        training_sampling=MAX, inference_sampling=MAX, euler_backend="xla",
        **kw)


def _pair(kind, seed, rows=B):
    """(JAX module, perturbed params, port module with the same weights)."""
    jm = JaxFM(_flow(JC, kind))
    params = _params(jm, seed)
    pm = FlowMatchingModule(_flow(PC, kind))
    pm.load_state_dict(kd_to_state_dict(params), strict=True)
    return jm, params, pm


def _params(jm, seed, cs=CS, ct=CT):
    """Random params of the JAX FM `jm` (its init traced, not run)."""
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((B, T, cs)), jnp.zeros((B, T, ct)), steps=2,
        max_steps=MAX, train=True))
    return random_tree(shapes["params"], seed)


def _inputs(seed, lead=(B,)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=lead + (T, CS)).astype(np.float32),
            rng.normal(size=lead + (T, CT)).astype(np.float32))


def check_meta(kind, train):
    """FlowMatchingModule with meta encoder `kind` against JAX's (see the
    module note): in eval the forward, in training also the gradients;
    dropout off on both sides (the no_dropout fixture)."""
    jm, params, pm = _pair(kind, 3)
    s, t = _inputs(4)

    def jax_fwd(p, sf):
        return jm.apply({"params": p}, sf, jnp.asarray(t),
                        steps=jnp.asarray(STEPS), max_steps=MAX, train=train,
                        rngs={"dropout": jax.random.PRNGKey(2)})

    def jax_obj(p, sf):
        loss, x = jax_fwd(p, sf)
        return loss + jnp.mean(x * x), (loss, x)

    if train:
        (_, (want_loss, want_x)), (want_gp, want_gs) = run_once(
            jax.value_and_grad(jax_obj, argnums=(0, 1), has_aux=True),
            params, jnp.asarray(s))
    else:
        want_loss, want_x = run_once(jax_fwd, params, jnp.asarray(s))
    sf = torch.from_numpy(s).requires_grad_()
    loss, x = pm(sf, torch.from_numpy(t), steps=torch.from_numpy(STEPS),
                 max_steps=MAX, train=train,
                 generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_x = np.asarray(want_x)
    np.testing.assert_allclose(x.detach().numpy(), want_x, rtol=0,
                               atol=1e-5 * np.abs(want_x).max())
    if not train:
        assert loss.item() == 0.0
        return
    (loss + (x * x).mean()).backward()
    want_sd = kd_to_state_dict(want_gp)
    assert set(want_sd) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(sf.grad.numpy(), np.asarray(want_gs),
                               rtol=1e-4, atol=1e-6)


# the conformer in training: tests/test_torch_meta_conformer_train.py
@pytest.mark.parametrize("kind,train", [
    (k, t) for k in KINDS for t in (False, True)
    if (k, t) != ("conformer", True)])
def test_meta_encoder_flow_matching_matches_jax(kind, train, no_dropout):
    check_meta(kind, train)


def test_meta_dropout_keep_rate():
    x = torch.ones(4, 500, 64)
    gen = torch.Generator().manual_seed(0)
    y = _drop(x, META_DROPOUT, True, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert not torch.equal(kept, _drop(x, META_DROPOUT, True, gen) != 0)
    assert torch.equal(_drop(x, META_DROPOUT, False, None), x)
    _, _, pm = _pair("conformer", 6)
    with pytest.raises(ValueError, match="generator"):
        pm(torch.zeros(B, T, CS), torch.zeros(B, T, CT), steps=2,
           train=True)


@pytest.mark.parametrize("kind", KINDS[1:])
def test_pallas_backend_refuses_other_meta_encoders(kind):
    with pytest.raises(ValueError, match="only the 'mlp'"):
        FlowMatchingModule(dataclasses.replace(_flow(PC, kind),
                                               euler_backend="pallas"))
    with pytest.raises(ValueError, match="only the 'mlp'"):
        JaxFM(dataclasses.replace(_flow(JC, kind), euler_backend="pallas")
              ).init(jax.random.PRNGKey(0), jnp.zeros((1, T, CS)), steps=1)
