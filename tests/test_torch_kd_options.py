"""The port's DistilCTCModel takes every DistillationConfig option JAX's
takes, against the JAX package on the CPU:

- the whole KD step of the case v8 (per-layer step counts 3 and 1 +
  layerwise 'all' + diffm ver 8) by the rules of tests/test_torch_kd_menu.py;
- the weight bridge on a JAX tree holding every KD module (router,
  layer_proj, flow matching, DiffKD, diffm ver 6 with all its
  submodules): every leaf becomes one port tensor (a stacked layer leaf one
  a layer), no key is left unmapped and none is missing (strict load), and
  an unknown subtree raises;
- configurations JAX's model cannot run raise at construction.
"""

import dataclasses

import jax
import pytest

import tpu_asr_torch.config as PC
from tests.test_torch_kd_menu import FULL, distill, run_case, superset
from tests.test_torch_train import _configs
from tpu_asr_torch.convert.from_jax import (KD_MODULES, distil_to_state_dict,
                                            kd_to_state_dict)
from tpu_asr_torch.models.distil_model import DistilCTCModel


def test_kd_step_matches_jax(monkeypatch):
    run_case("v8_per_layer_layerwise_all", monkeypatch)


def test_bridge_maps_every_kd_module():
    params, stats = superset()
    assert set(params) == {"student", "teacher", *KD_MODULES}
    teacher, student = _configs(PC)
    model = DistilCTCModel(student, teacher, distill(PC, **FULL))
    sd = distil_to_state_dict(params, stats, student, teacher)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    for name in KD_MODULES:
        assert len(kd_to_state_dict(params[name])) == len(
            jax.tree.leaves(params[name])), name
    n_layers = student.encoder.n_layers
    stacked = sum(len(jax.tree.leaves(params[m]["encoder"]["layers"]))
                  + len(jax.tree.leaves(stats[m]))
                  for m in ("student", "teacher"))
    n_leaves = len(jax.tree.leaves(params)) + len(jax.tree.leaves(stats))
    assert len(sd) - 2 * n_layers == n_leaves + (n_layers - 1) * stacked
    with pytest.raises(ValueError, match="no port counterpart"):
        distil_to_state_dict({**params, "bogus": {}}, stats, student,
                             teacher)


@pytest.mark.parametrize("change", [
    {"flow": None}, {"router": None}, {"diffkd": None}, {"diffm": None},
    {"layer_kd_scope": "first"}, {"interctc_layers": (2,)},
    {"flow.router_strategy": "batch_max"},
    {"flow.sampling_steps_per_layer": (3, 3, 3)},
    {"diffm.model_version": 9}])
def test_config_errors_raise(change):
    teacher, student = _configs(PC)
    cfg = distill(PC, router="group", use_diffkd=True,
                  use_layerwise_distillation=True)
    (key, value), = change.items()
    if "." in key:
        sub, field = key.split(".")
        cfg = dataclasses.replace(cfg, **{sub: dataclasses.replace(
            getattr(cfg, sub), **{field: value})})
    else:
        cfg = dataclasses.replace(cfg, **change)
    with pytest.raises(ValueError):
        DistilCTCModel(student, teacher, cfg)
