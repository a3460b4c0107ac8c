"""The whole KD step with per-layer step counts (2 and 3 Euler steps),
interCTC on both student layers and diffm ver 5 against the JAX package on
the CPU, by the rules of tests/test_torch_kd_menu.py (case
v5_per_layer_interctc)."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
from tests.test_torch_kd_menu import run_case


def test_kd_step_matches_jax(monkeypatch):
    run_case("v5_per_layer_interctc", monkeypatch)
