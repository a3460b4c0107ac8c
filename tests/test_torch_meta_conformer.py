"""The conformer meta encoder's batch-statistics norm is per layer,
against the JAX package on the CPU (tests/test_torch_meta.py holds each
meta encoder in FlowMatchingModule, test_torch_meta_conformer_train.py the
conformer in training, on the same rules): DistilCTCModel's flow matching
over L = 2 layers (per-layer step counts 2 and 3) runs the meta encoder
once per layer, held to JAX's nn.vmap route: the loss at 1e-5 relative,
the last layer's output within 1e-5 of its scale, the FM gradients at
1e-4 relative + 1e-6; the same rows stacked into one batch give another
loss (the test would see a stacked route). JAX's nn.Dropout is an identity
in the test process and the port's meta-encoder dropout rate 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tests.test_torch_meta import MAX, B, T, _params, no_dropout  # noqa
from tests.test_torch_kd_menu import run_once
from tests.test_torch_train import _configs
from tpu_asr.kd.flow_matching import FlowMatchingModule as JaxFM
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil
from tpu_asr_torch.convert.from_jax import kd_to_state_dict
from tpu_asr_torch.models.distil_model import DistilCTCModel


def test_conformer_meta_runs_per_layer(no_dropout):
    """The batch-statistics norm sees one layer's frames: the port's flow
    matching over 2 layers against JAX's vmap route."""
    teacher, student = _configs(PC)
    flow_kw = dict(meta_encoder_type="conformer", student_dim=32,
                   teacher_dim=64, student_head_num=2, time_embed_dim=8,
                   hidden_dim=8, training_sampling=MAX,
                   inference_sampling=MAX, euler_backend="xla",
                   sampling_steps_per_layer=(2, 3))
    cfg_p = PC.DistillationConfig(use_flow_matching=True,
                                  flow=PC.FlowMatchingConfig(**flow_kw))
    cfg_j = JC.DistillationConfig(use_flow_matching=True,
                                  flow=JC.FlowMatchingConfig(**flow_kw))
    rng = np.random.default_rng(5)
    stu = rng.normal(size=(2, B, T, 32)).astype(np.float32)
    # layer 1 far from layer 0: stacked statistics would differ a lot
    stu[1] = 3.0 * stu[1] + 2.0
    tch = rng.normal(size=(2, B, T, 64)).astype(np.float32)
    jt, js = _configs(JC)
    jmodel = JaxDistil(js, jt, cfg_j)
    params = _params(JaxFM(cfg_j.flow), 7, 32, 64)

    def jax_obj(p):
        loss, _, fm_last, _ = jmodel.apply(
            {"params": {"flow_matching": p}}, jnp.asarray(stu),
            jnp.asarray(tch), True, rngs={"dropout": jax.random.PRNGKey(2)},
            method=JaxDistil._flow_matching_all_layers)
        return loss + jnp.mean(fm_last * fm_last), (loss, fm_last)

    (_, (want_loss, want_last)), want_g = run_once(jax.value_and_grad(
        jax_obj, has_aux=True), params)
    model = DistilCTCModel(student, teacher, cfg_p)
    model.flow_matching.load_state_dict(kd_to_state_dict(params),
                                        strict=True)
    loss, router_loss, last = model._flow_matching_all_layers(
        torch.from_numpy(stu), torch.from_numpy(tch), True,
        {"dropout": torch.Generator().manual_seed(0)}, {})
    assert router_loss is None
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(last.detach().numpy(), np.asarray(want_last),
                               rtol=0, atol=1e-5 *
                               np.abs(np.asarray(want_last)).max())
    (loss + (last * last).mean()).backward()
    want_sd = kd_to_state_dict(want_g)
    for name, p in model.flow_matching.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    # the two layers stacked into one batch of rows: other statistics
    stacked, _ = model.flow_matching(
        torch.from_numpy(stu).reshape(2 * B, T, 32),
        torch.from_numpy(tch).reshape(2 * B, T, 64),
        steps=torch.tensor([2] * B + [3] * B), max_steps=MAX, train=True)
    assert abs(2 * stacked.item() - loss.item()) > 1e-3 * abs(loss.item())
