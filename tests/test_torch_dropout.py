"""The port's counter-based dropout masks against the JAX package's
interpret-mode hash (tpu_asr/ops/pallas_attention.py::_dropout_keep),
bit for bit, including seeds and streams near and past int32 overflow, and
the stream layouts of the attention and FFN kernels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.ops.pallas_attention import _dropout_keep
from tpu_asr_torch.ops.dropout import (batch_streams, dropout, keep_mask,
                                       threshold)


@pytest.mark.parametrize("stream", [0, 1, 12345, 2 ** 31 - 1, -1, -2 ** 31,
                                    2 ** 30 + 7])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hash_is_bit_equal_to_jax(stream, rate):
    want = np.asarray(_dropout_keep(jnp.int32(stream), 1, (7, 384), rate,
                                    interpret=True))[0]
    got = keep_mask(torch.tensor(stream), 7, 384, rate).numpy()
    np.testing.assert_array_equal(got, want)


def test_streams_wrap_like_int32():
    """base + b * H + h and 2 * (base + b) + salt in int32 arithmetic: the
    streams past 2^31 - 1 wrap to the same uint32 bits."""
    base = 2 ** 31 - 2
    s = batch_streams(base, 3, per_row=2)
    want = (np.int32(base) + np.arange(3, dtype=np.int32)[:, None] * 2
            + np.arange(2, dtype=np.int32)[None, :])
    np.testing.assert_array_equal(s.numpy(), want.astype(np.uint32))
    s2 = batch_streams(base, 3, scale=2, salt=1)
    want2 = (np.int32(base) + np.arange(3, dtype=np.int32)) * 2 + 1
    np.testing.assert_array_equal(s2.numpy(), want2.astype(np.uint32))


def test_threshold_and_plain_site():
    assert threshold(0.0) == 0
    assert threshold(1.0) == 2 ** 32 - 1
    x = torch.ones(4, 50, 32)
    y = dropout(x, 0.25, 99)
    kept = (y != 0).float().mean().item()
    assert 0.7 < kept < 0.8
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 4 / 3))
    assert torch.equal(y, dropout(x, 0.25, 99))
    assert torch.equal(dropout(x, 0.0, 99), x)
