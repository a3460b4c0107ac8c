"""The whole KD step with router 'batch_avg' (means 1.5 and 3.5: half to even)
+ DiffKD + diffm ver 3 against the JAX package on the CPU, by the rules of
tests/test_torch_kd_menu.py (case v3_batch_avg_diffkd)."""

from tests.test_torch_kd_menu import run_case


def test_kd_step_matches_jax(monkeypatch):
    run_case("v3_batch_avg_diffkd", monkeypatch)
