"""diffm in the port against the JAX package on the CPU (the rules of
tests/test_torch_kd_menu.py):

- the whole KD step of the case v7 (layerwise 'last' + DiffKD, diffm's two
  unchained latent FMs);
- NoiseAdapter's mixing alone: z_noisy = gamma z + (1 - gamma) eps with eps
  the standard normal draw of the `noise` generator (the same seed draws
  the same eps; another seed another), gamma = sigmoid(g2(relu(g1 z)))
  against JAX's convolutions on the bridged weights at 1e-6, and eps of
  mean 0 within 0.1 and standard deviation 1 within 0.08 (4 standard
  errors over its 1600 values).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_kd_menu import run_case
from tpu_asr_torch.convert.from_jax import kd_to_state_dict
from tpu_asr_torch.kd.diffm import NoiseAdapter


def test_kd_step_matches_jax(monkeypatch):
    run_case("v7_layerwise_last_diffkd", monkeypatch)


def test_noise_adapter_mixes_gamma_and_noise():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(4, 50, 8)).astype(np.float32)
    params = {"g1": {"kernel": rng.normal(size=(1, 8, 8)).astype(np.float32)
                     / 3, "bias": rng.normal(size=8).astype(np.float32)},
              "g2": {"kernel": rng.normal(size=(1, 8, 1)).astype(np.float32)
                     / 4, "bias": np.zeros(1, np.float32)}}
    conv = lambda p, x: fnn.Conv(p["kernel"].shape[-1], (1,)).apply(
        {"params": p}, x)
    want_gamma = np.asarray(jax.nn.sigmoid(conv(params["g2"], jax.nn.relu(
        conv(params["g1"], jnp.asarray(z))))))
    adapter = NoiseAdapter(8)
    adapter.load_state_dict(kd_to_state_dict(params), strict=True)
    zt = torch.from_numpy(z)
    with torch.no_grad():
        gamma = adapter.gamma(zt)
        out = adapter(zt, torch.Generator().manual_seed(1))
        again = adapter(zt, torch.Generator().manual_seed(1))
        other = adapter(zt, torch.Generator().manual_seed(2))
    np.testing.assert_allclose(gamma.numpy(), want_gamma, rtol=1e-6,
                               atol=1e-6)
    assert 0.02 < gamma.min() and gamma.max() < 0.98
    eps = torch.randn(zt.shape, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(out, gamma * zt + (1 - gamma) * eps)
    assert torch.equal(out, again) and not torch.equal(out, other)
    assert abs(eps.mean()) < 0.1 and abs(eps.std() - 1) < 0.08
