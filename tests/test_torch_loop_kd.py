"""The port's fit loop against JAX's Trainer under logit KD: the checks of
test_torch_loop.py (per-step losses, the port's own trained weights,
`evaluate` on them) with `use_logit_distillation`, so the frozen teacher's
forward and the KD loss run inside every step of both fits."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
from test_torch_loop import cancelled, fit_both


def test_fit_and_evaluate_match_jax_logit_kd(tmp_path):
    assert cancelled(fit_both(tmp_path, lambda mod: mod.DistillationConfig(
        use_logit_distillation=True)))
