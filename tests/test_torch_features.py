"""Port parity: the log-mel frontend of tpu_asr_torch against the JAX
package, fp32 on the CPU, inputs made with numpy from a seed.

- log-mel (the CUDA kernel's plain version) and the whole frontend against
  FilterbankFeatures(backend='xla') at rtol/atol 1e-4;
- the plain version against the Pallas log-mel kernel in interpret mode
  with fp32 operands (passes=0), atol 2e-3 on live bins: log(x + 2^-24)
  amplifies summation-order differences without bound near the guard, as
  tests/test_pallas_features.py explains;
- the TPU kernel's options: mag_power 1.0, log False and each normalize
  mode of the frontend against JAX's backend='xla', rtol/atol 1e-4 (1e-4
  of the largest |value| without the log);
- what the FFT kernel is handed: the mel bands give fb_t's dense product
  bit for bit in fp32 (each filter summed bin by bin in increasing order,
  the zeros adding nothing), the twiddles and the window lie within one
  fp32 ulp of their float64 definitions, and the kernel's algorithm (the
  two radix-16 passes at n_fft = 512, the Stockham radix-4/2 stages
  elsewhere, and the real split, in numpy on those fp32 tables) gives the
  plain version's log-mel within 1e-4.
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
from tpu_asr_torch.ops import cuda_features
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


@pytest.mark.parametrize("mag_power,log,normalize", [
    (1.0, True, "per_feature"),
    (2.0, False, "per_feature"),
    (2.0, True, "all_features"),
    (2.0, True, None),
    (1.0, False, "none"),
])
def test_frontend_options_match_jax_xla(mag_power, log, normalize):
    kw = dict(mag_power=mag_power, log=log, normalize=normalize)
    sig = _signal(2, 9000, seed=4)
    sig[1, 6000:] = 0.0
    lengths = np.asarray([9000, 6000], np.int32)
    want, _ = JaxFilterbank(PreprocessorConfig(**kw), backend="xla")(
        jnp.asarray(sig), jnp.asarray(lengths))
    got, _ = FilterbankFeatures(PreprocessorConfig(**kw))(
        torch.from_numpy(sig), torch.from_numpy(lengths))
    want = np.asarray(want)
    scale = 1.0 if log or normalize in ("per_feature", "all_features") \
        else np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * scale)


def _band_product(power, band, weights):
    """power (..., n_freq) through the bands -> (..., n_mels), each
    filter's sum taken bin by bin in increasing order in fp32."""
    out = torch.zeros(power.shape[:-1] + (band.shape[0],))
    for lo, cnt, off, m in band:
        acc = torch.zeros(power.shape[:-1])
        for i in range(cnt):
            acc = acc + power[..., lo + i] * float(weights[off + i])
        out[..., m] = acc
    return out


def test_mel_bands_reproduce_the_dense_product():
    cfg = PreprocessorConfig()
    fb_t = np.ascontiguousarray(mel_filterbank(
        cfg.sample_rate, cfg.n_fft, cfg.features).T)
    band, weights = cuda_features.mel_bands(fb_t)
    assert sorted(band[:, 3]) == list(range(fb_t.shape[1]))
    dense = np.zeros_like(fb_t)
    for lo, cnt, off, m in band:
        dense[lo:lo + cnt, m] = weights[off:off + cnt]
    np.testing.assert_array_equal(dense, fb_t)
    # Slaney triangles: each bin lies in at most two bands
    assert (np.count_nonzero(fb_t, axis=1) <= 2).all()
    assert band[:, 1].sum() <= 2 * fb_t.shape[0]
    power = torch.from_numpy(np.random.default_rng(5).gamma(
        1.0, size=(3, fb_t.shape[0])).astype(np.float32))
    want = torch.zeros(3, fb_t.shape[1])
    for f in range(fb_t.shape[0]):          # dense, bin by bin, fp32
        want = want + power[:, f:f + 1] * torch.from_numpy(fb_t[f])
    got = _band_product(power, band, weights)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_fft", [64, 512, 2048])
def test_twiddles_and_window_within_one_ulp(n_fft):
    tw = cuda_features.twiddles(n_fft)
    angle = 2.0 * np.pi * np.arange(n_fft) / n_fft
    tw16 = cuda_features.twiddles16()
    r, j = np.divmod(np.arange(256), 16)
    angle16 = 2.0 * np.pi * r * j / 256
    for got, want in ((tw[:, 0], np.cos(angle)), (tw[:, 1], -np.sin(angle)),
                      (tw16[:, 0], np.cos(angle16)),
                      (tw16[:, 1], -np.sin(angle16))):
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got.astype(np.float64) - want) <= ulp).all()
    cfg = PreprocessorConfig()
    feat = FilterbankFeatures(cfg)
    window = cuda_features._fft_tables(feat.basis, feat.fb_t)[0].numpy()
    left = (cfg.n_fft - cfg.win_length) // 2
    want = np.zeros(cfg.n_fft)
    want[left:left + cfg.win_length] = np.hanning(cfg.win_length)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(window.astype(np.float64) - want) <= ulp).all()


def _dft16(v):
    """logmel.cu's 16-point DFT in registers: 4 x 4 with W_16 twiddles,
    X[k1 + 4 k2] at v[4 k1 + k2] (returned in natural order)."""
    v = list(v)
    w16 = np.exp(-2j * np.pi * np.arange(16) / 16).astype(np.complex64)

    def dft4(a, b, c, d):
        s0, s1, s2, s3 = a + c, a - c, b + d, (b - d) * np.complex64(-1j)
        return s0 + s2, s1 + s3, s0 - s2, s1 - s3
    for n2 in range(4):
        v[n2], v[4 + n2], v[8 + n2], v[12 + n2] = dft4(
            v[n2], v[4 + n2], v[8 + n2], v[12 + n2])
    for k1 in range(1, 4):
        for n2 in range(1, 4):
            v[4 * k1 + n2] = v[4 * k1 + n2] * w16[n2 * k1]
    for k1 in range(4):
        v[4 * k1:4 * k1 + 4] = dft4(*v[4 * k1:4 * k1 + 4])
    return [v[4 * (q % 4) + q // 4] for q in range(16)]


def _fft_power(frames, window, tw, tw16):
    """|rfft|^2 of the windowed frames (F, 2N) by logmel.cu's algorithm in
    numpy complex64 on the kernel's fp32 tables: the packed N-point FFT
    (at N = 256 two radix-16 Stockham passes with the tw16 table, else
    Stockham stages, a radix-2 first stage where log2 N is odd, then
    radix 4) and the real split."""
    n = frames.shape[1] // 2
    twc = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    z = (frames[:, 0::2] * window[0::2]
         + 1j * (frames[:, 1::2] * window[1::2])).astype(np.complex64)
    ns = 1 if n != 256 else n
    if n == 256:
        t16 = (tw16[:, 0] + 1j * tw16[:, 1]).astype(np.complex64)
        buf = np.empty_like(z)
        for h in range(16):
            y = _dft16([z[:, h + 16 * r] for r in range(16)])
            for q in range(16):
                buf[:, 16 * h + q] = y[q]
        for h in range(16):
            y = _dft16([buf[:, h + 16 * r] * t16[16 * r + h]
                        for r in range(16)])
            for q in range(16):
                z[:, h + 16 * q] = y[q]
    while ns < n:
        r = 2 if ns == 1 and int(np.log2(n)) % 2 else 4
        kb = n // r
        j = np.arange(kb)
        k = j & (ns - 1)
        v = [z[:, j + q * kb] * (twc[q * k * (2 * n // (ns * r))]
                                 if ns > 1 else 1) for q in range(r)]
        if r == 4:
            a0, a1, a2 = v[0] + v[2], v[0] - v[2], v[1] + v[3]
            a3 = (v[1] - v[3]) * np.complex64(-1j)
            y = [a0 + a2, a1 + a3, a0 - a2, a1 - a3]
        else:
            y = [v[0] + v[1], v[0] - v[1]]
        out = np.empty_like(z)
        for q in range(r):
            out[:, (j - k) * r + k + q * ns] = y[q]
        z, ns = out, ns * r
    k = np.arange(n // 2 + 1)
    zk, zn = z[:, k], z[:, (n - k) & (n - 1)]
    e, o = 0.5 * (zk + np.conj(zn)), (zk - np.conj(zn)) / np.complex64(2j)
    wo = twc[k] * o
    power = np.empty((frames.shape[0], n + 1), np.float32)
    power[:, k] = np.abs(e + wo) ** 2
    power[:, n - k] = np.abs(e - wo) ** 2
    return power


@pytest.mark.parametrize("window_size,n_fft", [(0.025, 512), (0.05, 1024)])
def test_fft_algorithm_matches_plain(window_size, n_fft):
    cfg = PreprocessorConfig(window_size=window_size, n_fft=n_fft)
    _, xp, n_frames = _padded(cfg, _signal(1, 6000, seed=6))
    feat = FilterbankFeatures(cfg)
    window, tw, tw16, band, weights = (
        z.numpy() for z in cuda_features._fft_tables(feat.basis, feat.fb_t))
    frames = np.lib.stride_tricks.sliding_window_view(
        xp[0], n_fft)[::cfg.hop_length][:n_frames]
    power = torch.from_numpy(_fft_power(frames, window, tw, tw16))
    got = torch.log(_band_product(power, band, weights)
                    + cfg.log_zero_guard_value)
    want = logmel_plain(*_plain_args(cfg, xp, n_frames))[0]
    live = want > np.log(cfg.log_zero_guard_value) + 8.0
    assert live.float().mean() > 0.5
    torch.testing.assert_close(got[live], want[live], rtol=0, atol=1e-4)
