"""The all-layer teacher cache against the JAX package on the CPU: the
case of tests/test_torch_cache.py (see its docstring) with FM-KT (mlp, 8
Euler steps) + logit KD + DiffKD + diffm ver 3, whose losses read every
teacher layer. The port's harvest step returns every teacher layer equal to
JAX's teacher encode at 1e-4 (fp32); the cached step fed them equals the
harvest step at 1e-6 and JAX's cached loss and gradients on the same
features (losses and grad_norm at 1e-5, gradients within 1e-5 + 1e-4 x the
tensor's max|ref|). Apart from tests/test_torch_cache.py so that each file
compiles one JAX program and runs alone in under 30 s.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
from tests.test_torch_cache import check_cached_step, check_harvest


def test_harvest_matches_jax_teacher():
    check_harvest("all")


def test_cached_step_matches_harvest_and_jax():
    check_cached_step("all")
