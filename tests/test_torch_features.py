"""Port parity: the log-mel frontend of tpu_asr_torch against the JAX
package, fp32 on the CPU, inputs made with numpy from a seed.

- log-mel (the CUDA kernel's plain version) and the whole frontend against
  FilterbankFeatures(backend='xla') at rtol/atol 1e-4;
- the plain version against the Pallas log-mel kernel in interpret mode
  with fp32 operands (passes=0), atol 2e-3 on live bins: log(x + 2^-24)
  amplifies summation-order differences without bound near the guard, as
  tests/test_pallas_features.py explains.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.config import PreprocessorConfig
from tpu_asr.ops.features import FilterbankFeatures as JaxFilterbank
from tpu_asr.ops.features import _dft_basis
from tpu_asr.ops.features import mel_filterbank as jax_mel_filterbank
from tpu_asr.ops.pallas_features import fused_logmel as pallas_logmel
from tpu_asr_torch.ops.cuda_features import fused_logmel, logmel_plain
from tpu_asr_torch.ops.features import (FilterbankFeatures, dft_basis,
                                        mel_filterbank)


def _signal(b, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n)) * 0.1).astype(np.float32)


def _padded(cfg, sig):
    """Pre-emphasised, reflect-padded audio and its frame count."""
    x = np.concatenate([sig[:, :1], sig[:, 1:] - cfg.preemph * sig[:, :-1]],
                       axis=1)
    pad = cfg.n_fft // 2
    xp = np.pad(x, ((0, 0), (pad, pad)), mode="reflect")
    return x, xp, (xp.shape[1] - cfg.n_fft) // cfg.hop_length + 1


def _plain_args(cfg, xp, n_frames):
    feat = FilterbankFeatures(cfg)
    return (torch.from_numpy(xp), n_frames, feat.basis, feat.fb_t,
            cfg.hop_length, cfg.log_zero_guard_value)


@pytest.mark.parametrize("cfg", [
    PreprocessorConfig(),
    PreprocessorConfig(window_size=0.032, window_stride=0.016, features=64),
])
def test_constants_match_jax(cfg):
    cos_b, sin_b = _dft_basis(cfg.n_fft, cfg.win_length, cfg.window)
    np.testing.assert_array_equal(
        dft_basis(cfg.n_fft, cfg.win_length, cfg.window),
        np.concatenate([cos_b, sin_b], axis=1))
    np.testing.assert_array_equal(
        mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.features),
        jax_mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.features))


def test_logmel_plain_matches_jax_xla():
    cfg = PreprocessorConfig()
    x, xp, n_frames = _padded(cfg, _signal(2, 16000))
    jf = JaxFilterbank(cfg, backend="xla")
    power = jf._block_stft_power(jnp.asarray(x))
    want = np.asarray(jnp.log(jnp.einsum("btf,fm->btm", power, jf._fb_t)
                              + cfg.log_zero_guard_value))
    got = logmel_plain(*_plain_args(cfg, xp, n_frames)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cfg", [
    PreprocessorConfig(),
    PreprocessorConfig(window_size=0.032, window_stride=0.016, features=64),
])
def test_frontend_matches_jax_xla(cfg):
    sig = _signal(3, 20000, seed=1)
    lengths = np.asarray([20000, 13001, 4000], np.int32)
    for i, n in enumerate(lengths):
        sig[i, n:] = 0.0
    want, want_len = JaxFilterbank(cfg, backend="xla")(
        jnp.asarray(sig), jnp.asarray(lengths))
    got, got_len = FilterbankFeatures(cfg)(torch.from_numpy(sig),
                                           torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_logmel_plain_matches_pallas_interpret():
    cfg = PreprocessorConfig()
    _, xp, n_frames = _padded(cfg, _signal(2, 24000, seed=2))
    want = np.asarray(pallas_logmel(jnp.asarray(xp), n_frames, cfg,
                                    interpret=True, passes=0))
    got = logmel_plain(*_plain_args(cfg, xp, n_frames)).numpy()
    live = want > np.log(cfg.log_zero_guard_value) + 8.0
    assert got.shape == want.shape and live.mean() > 0.5
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=2e-3)


def test_wrapper_runs_plain_on_cpu_and_launches_nothing():
    cfg = PreprocessorConfig()
    _, xp, n_frames = _padded(cfg, _signal(1, 8000, seed=3))
    args = _plain_args(cfg, xp, n_frames)
    before = fused_logmel.launches
    torch.testing.assert_close(fused_logmel(*args), logmel_plain(*args),
                               rtol=0, atol=0)
    assert fused_logmel.launches == before == 0
    with pytest.raises(ValueError, match="unsupported device"):
        fused_logmel(args[0].to("meta"), *args[1:])
