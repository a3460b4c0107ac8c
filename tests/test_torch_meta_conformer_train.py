"""FlowMatchingModule with the conformer meta encoder in training against
the JAX package's on the CPU: loss, x_final and gradients by the rules of
tests/test_torch_meta.py (which holds the other meta encoders and the
conformer in eval)."""

from tests.test_torch_meta import check_meta, no_dropout  # noqa: F401


def test_conformer_meta_training_matches_jax(no_dropout):  # noqa: F811
    check_meta("conformer", True)
