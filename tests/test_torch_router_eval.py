"""The port's DistilCTCModel in eval with the dynamic step router against
the JAX package's on the CPU (the tiny models and weights of
tests/test_torch_kd_menu.py, router 'group', router_fc2 solved for a
60-logit margin so that both take the same argmax steps): the teacher runs
for the router's input, log-probs at 1e-4, greedy ids equal."""

import jax.numpy as jnp
import numpy as np
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tests.test_torch_kd_menu import (_batch, _torch_batch, distill,
                                      port_model, run_once,
                                      set_router_margin, superset)
from tests.test_torch_train import _configs
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil


def test_router_eval_forward_matches_jax():
    full, stats = superset()
    cfg_p, cfg_j = distill(PC, router="group"), distill(JC, router="group")
    model, params = port_model(full, stats, cfg_p)
    tb = _torch_batch(_batch())
    params = set_router_margin(params, stats, model, tb)
    teacher, student = _configs(JC)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    want = run_once(lambda p: JaxDistil(student, teacher, cfg_j).apply(
        {"params": p, "batch_stats": stats}, jb["signal"],
        jb["signal_len"], train=False), params)
    model.eval()
    with torch.no_grad():
        got = model(tb["signal"], tb["signal_len"])
    assert got.tch_feats is not None and want.tch_feats is not None
    np.testing.assert_allclose(got.log_probs.numpy(),
                               np.asarray(want.log_probs), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got.greedy.numpy(), np.asarray(want.greedy))
