"""The port's multi-step (tpu_asr_torch/train/trainer.py
make_distil_multi_step) against JAX's make_distil_multi_step (lax.scan of
its train step, AdamW + Noam) on the CPU, from the same weights (the shapes
of JAX's init, traced, filled from a seed; carried by the bridge): the CTC
student at tests/test_torch_train.py's size, every dropout 0, no
SpecAugment, no dither, K=2 stacked batches. The steps' total losses agree
at 1e-5 relative for the first step and 1e-4 for the second, which reads
the first update: its Adam step carries the gradients' ~1e-4 rounding
difference (tests/test_torch_train.py). Apart from
tests/test_torch_multi_step.py so that each file runs alone in under 30 s.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tests.test_torch_kd_menu import random_tree, run_once
from tests.test_torch_multi_step import OPTIM, stacked_batches
from tests.test_torch_train import _batch, _configs, _distill
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil
from tpu_asr.train.optim import build_optimizer as jax_build_optimizer
from tpu_asr.train.trainer import DistilTrainState as JaxState
from tpu_asr.train.trainer import make_distil_multi_step as jax_multi_step
from tpu_asr_torch.convert.from_jax import distil_to_state_dict
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.train.trainer import (DistilTrainState,
                                         make_distil_multi_step)


@functools.lru_cache(maxsize=None)
def jax_weights():
    """JAX params and batch_stats of the CTC student: the shapes of its
    init (traced, not run) filled from a seed."""
    teacher, student = _configs(JC)
    model = JaxDistil(student, teacher, _distill(JC, "ctc"))
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        functools.partial(model.init, train=True),
        {n: key for n in ("params", "specaug", "dropout", "gumbel",
                          "noise")}, jb["signal"], jb["signal_len"],
        jb["tokens"], jb["token_len"])
    return (model, random_tree(shapes["params"], 1),
            random_tree(shapes.get("batch_stats", {}), 2))


def test_multi_step_losses_match_jax():
    jmodel, params, stats = jax_weights()
    host = stacked_batches(2)
    jstate = JaxState.create(apply_fn=jmodel.apply, params=params,
                             batch_stats=stats, tx=jax_build_optimizer(
                                 JC.OptimConfig(**OPTIM), params))
    _, jmetrics = run_once(jax_multi_step(jmodel), jstate,
                           {k: jnp.asarray(v) for k, v in host.items()},
                           jax.random.PRNGKey(1))
    want = np.asarray(jmetrics["loss/total"])

    teacher, student = _configs(PC)
    model = DistilCTCModel(student, teacher, _distill(PC, "ctc"))
    model.load_state_dict(distil_to_state_dict(params, stats, student,
                                               teacher), strict=True)
    state = DistilTrainState.create(model, PC.OptimConfig(**OPTIM))
    state, metrics = make_distil_multi_step(model)(
        state, {k: torch.from_numpy(v) for k, v in host.items()}, 0)
    got = metrics["loss/total"].numpy()
    assert got.shape == want.shape == (2,) and state.step == 2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
