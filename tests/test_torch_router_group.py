"""The whole KD step with router 'group' (the group loss over (layer, count)
pairs) + layerwise 'all' + diffm ver 1 against the JAX package on the CPU,
by the rules of tests/test_torch_kd_menu.py (case v1_group_layerwise_all)."""

from tests.test_torch_kd_menu import run_case


def test_kd_step_matches_jax(monkeypatch):
    run_case("v1_group_layerwise_all", monkeypatch)
