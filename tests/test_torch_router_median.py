"""The whole KD step with router 'batch_median' (even batches: the lower
middle) + layerwise 'last' + diffm ver 4 against the JAX package on the CPU,
by the rules of tests/test_torch_kd_menu.py (case
v4_batch_median_layerwise_last)."""

from tests.test_torch_kd_menu import run_case


def test_kd_step_matches_jax(monkeypatch):
    run_case("v4_batch_median_layerwise_last", monkeypatch)
