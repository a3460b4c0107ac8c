"""Port parity: CTC loss of tpu_asr_torch (the plain version of the CUDA
kernels) against the JAX package on the CPU, log-probs made with numpy from
a seed, ragged input and target lengths, a repeated label, a zero-length
target and an impossible alignment (zero_infinity).

- per-sample NLL against ctc_forward_logprob at 1e-5 and gradients at 1e-4,
  every reduction;
- NLL and gradient against ctc_nll_pallas in interpret mode, each
  reduction applied as tpu_asr/ops/ctc.py::ctc_loss applies it (its
  analytic posterior backward carries ~6e-4 fp32 error, pallas_ctc.py's
  note): loss 1e-4, gradients 2e-3;
- the wrapper runs the plain version on the CPU and launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.ops.ctc import ctc_forward_logprob
from tpu_asr.ops.ctc import ctc_loss as jax_ctc_loss
from tpu_asr.ops.pallas_ctc import ctc_nll_pallas
from tpu_asr_torch.ops.ctc import REDUCTIONS, ctc_loss
from tpu_asr_torch.ops.cuda_ctc import ctc_nll, ctc_nll_bwd, ctc_nll_plain


def _inputs(seed=0, b=4, t=40, v=12, s=7):
    rng = np.random.default_rng(seed)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(
        rng.normal(size=(b, t, v)).astype(np.float32) * 2.0)))
    tg = rng.integers(0, v - 1, size=(b, s)).astype(np.int32)
    tg[0, 3] = tg[0, 2]                               # a repeated label
    il = np.array([t, 31, 9, 3], np.int32)[:b]
    tl = np.array([s, 4, 0, 5], np.int32)[:b]         # 0 and 5 > frames
    return lp, tg, il, tl


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_loss_and_grads_match_jax_scan(reduction):
    lp, tg, il, tl = _inputs()
    j = jnp.asarray
    f = lambda x: jax_ctc_loss(x, j(tg), j(il), j(tl), reduction=reduction,
                               backend="scan")
    want = np.asarray(f(j(lp)))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(f(x)))(j(lp)))
    x = torch.tensor(lp, requires_grad=True)
    got = ctc_loss(x, torch.from_numpy(tg), torch.from_numpy(il),
                   torch.from_numpy(tl), reduction=reduction)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-4, atol=1e-4)


def test_nll_matches_forward_logprob_unmasked():
    lp, tg, il, tl = _inputs(seed=1)
    j = jnp.asarray
    want = np.asarray(ctc_forward_logprob(j(lp), j(tg), j(il), j(tl)))
    got = ctc_nll_plain(torch.from_numpy(lp), torch.from_numpy(tg),
                        torch.from_numpy(il), torch.from_numpy(tl))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _jax_reduce(nll, tl, reduction):
    """tpu_asr/ops/ctc.py::ctc_loss's zero_infinity and reductions."""
    nll = jnp.where(~jnp.isfinite(nll) | (nll >= 1e29), 0.0, nll)
    tlf = tl.astype(nll.dtype)
    return {"none": nll, "mean_batch": jnp.mean(nll), "sum": jnp.sum(nll),
            "mean": jnp.mean(nll / jnp.maximum(tlf, 1.0)),
            "mean_volume": jnp.sum(nll) / jnp.maximum(jnp.sum(tlf), 1.0)
            }[reduction]


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_matches_pallas_interpret(reduction):
    lp, tg, il, tl = _inputs(seed=2, b=8, t=48, v=10, s=6)
    il = np.full(8, 48, np.int32) - np.arange(8, dtype=np.int32)
    tl = np.array([6, 5, 4, 3, 2, 1, 0, 6], np.int32)
    j = jnp.asarray
    f = lambda x: _jax_reduce(ctc_nll_pallas(x, j(tg), j(il), j(tl), 9, True),
                              j(tl), reduction)
    want = np.asarray(f(j(lp)))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(f(x)))(j(lp)))
    x = torch.tensor(lp, requires_grad=True)
    got = ctc_loss(x, torch.from_numpy(tg), torch.from_numpy(il),
                   torch.from_numpy(tl), 9, reduction=reduction)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=2e-3, atol=2e-3)


def test_wrapper_runs_plain_on_cpu_and_checks_device():
    lp, tg, il, tl = (torch.from_numpy(a) for a in _inputs(seed=3))
    torch.testing.assert_close(ctc_nll(lp, tg, il, tl),
                               ctc_nll_plain(lp, tg, il, tl), rtol=0, atol=0)
    assert (ctc_nll.launches, ctc_nll_bwd.launches) == (0, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        ctc_nll(lp.to("meta"), tg, il, tl)
    with pytest.raises(ValueError, match="unknown reduction"):
        ctc_loss(lp, tg, il, tl, reduction="median")
