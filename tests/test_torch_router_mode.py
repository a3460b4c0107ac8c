"""The whole KD step with router 'batch_mode' (a tie: the smallest count) +
interCTC on layer 0 + diffm ver 2 against the JAX package on the CPU, by the
rules of tests/test_torch_kd_menu.py (case v2_batch_mode_interctc)."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
from tests.test_torch_kd_menu import run_case


def test_kd_step_matches_jax(monkeypatch):
    run_case("v2_batch_mode_interctc", monkeypatch)
