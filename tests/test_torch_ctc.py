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
- the wrapper runs the plain version on the CPU and launches nothing;
- each kernel's own plain version (ctc_alpha_plain, ctc_nll_bwd_plain)
  against the TPU kernels in interpret mode at 1e-5, with a repeated
  label, an empty target, an impossible alignment, input lengths below T,
  a non-unit cotangent and 2S+1 > 128.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.ops.ctc import ctc_forward_logprob
from tpu_asr.ops.ctc import ctc_loss as jax_ctc_loss
from tpu_asr.ops.pallas_ctc import _ctc_fwd, ctc_nll_pallas
from tpu_asr_torch.ops.ctc import REDUCTIONS, ctc_loss
from tpu_asr_torch.ops.cuda_ctc import (_ctc_args, ctc_alpha_plain, ctc_nll,
                                        ctc_nll_bwd, ctc_nll_bwd_plain,
                                        ctc_nll_plain)


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


# --------------------------------------------------------------------------
# Each kernel's own plain version against the TPU kernels (interpret mode):
# ctc_alpha_plain against _ctc_fwd's alpha lattice and NLL, and
# ctc_nll_bwd_plain against ctc_nll_pallas's VJP. Both are the same
# algorithm as their TPU kernel, so they agree to fp32 rounding: 1e-5.
# --------------------------------------------------------------------------

def _case(name):
    """(log-probs, targets, input lengths, target lengths, cotangent g,
    blank) from a numpy seed. 'base': a repeated label, an empty target,
    an impossible alignment and input lengths below T; 'wide': 2S+1 = 141
    (> 128), ragged lengths, no repeat forced."""
    if name == "base":
        lp, tg, il, tl = _inputs(seed=5, b=5, t=40, v=12, s=7)
        tg[0, 4] = tg[0, 3] = tg[0, 2]                # repeated, also apart
        tg[1, 5] = tg[1, 1]
        il = np.array([40, 31, 9, 3, 22], np.int32)
        tl = np.array([7, 6, 0, 5, 7], np.int32)      # 5 labels in 3 frames
    else:
        rng = np.random.default_rng(6)
        b, t, v, s = 3, 160, 20, 70
        lp = np.array(jax.nn.log_softmax(jnp.asarray(
            rng.normal(size=(b, t, v)).astype(np.float32) * 2.0)))
        tg = rng.integers(0, v - 1, size=(b, s)).astype(np.int32)
        il = np.array([160, 151, 145], np.int32)
        tl = np.array([70, 64, 66], np.int32)
    rng = np.random.default_rng(7)
    g = rng.uniform(0.5, 2.0, size=len(il)).astype(np.float32)
    return lp, tg, il, tl, g, lp.shape[-1] - 1


CASES = ("base", "wide")


@pytest.mark.parametrize("name", CASES)
def test_alpha_plain_matches_pallas_forward(name):
    lp, tg, il, tl, _, blank = _case(name)
    j = jnp.asarray
    nll_j, res = _ctc_fwd(j(lp), j(tg), j(il), j(tl), blank, True)
    t = lp.shape[1]
    l = 2 * tg.shape[1] + 1
    alpha, nll = ctc_alpha_plain(*(torch.from_numpy(a)
                                   for a in (lp, tg, il, tl)), blank)
    assert alpha.shape == (len(il), t, l)
    ran = np.arange(t)[None, :] < il[:, None]             # frames t < ilen
    np.testing.assert_allclose(alpha.numpy()[ran],
                               np.asarray(res[1])[:, :, :l][ran],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_j), rtol=1e-5,
                               atol=1e-5)
    if name == "base":
        assert nll[3].item() >= 1e29                  # the impossible one


@pytest.mark.parametrize("name", CASES)
def test_bwd_plain_matches_pallas_vjp(name):
    lp, tg, il, tl, g, blank = _case(name)
    j = jnp.asarray
    tt = [torch.from_numpy(a) for a in (lp, tg, il, tl)]
    alpha, nll = ctc_alpha_plain(*tt, blank)
    # a zero cotangent where the alignment is impossible, as zero_infinity
    # gives it: the TPU kernel's posterior is not masked there
    g = np.where(nll.numpy() >= 1e29, 0.0, g).astype(np.float32)
    _, vjp = jax.vjp(lambda x: ctc_nll_pallas(x, j(tg), j(il), j(tl), blank,
                                              True), j(lp))
    want = np.asarray(vjp(j(g))[0])
    got = ctc_nll_bwd_plain(*tt, alpha, nll, torch.from_numpy(g), blank)
    assert got.shape == lp.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_bwd_plain_matches_autograd(name):
    """The analytic posterior against autograd through the recursion (the
    ~6e-4 fp32 gap of pallas_ctc.py's note), under a non-unit g."""
    lp, tg, il, tl, g, blank = _case(name)
    tt = [torch.from_numpy(a) for a in (lp, tg, il, tl)]
    x = tt[0].clone().requires_grad_()
    alpha, nll = ctc_alpha_plain(x, *tt[1:], blank)
    live = nll.detach() < 1e29
    gt = torch.from_numpy(g) * live
    want = torch.autograd.grad((nll * gt).sum(), x)[0]
    got = ctc_nll_bwd_plain(*tt, alpha.detach(), nll.detach(), gt, blank)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_bwd_plain_live_rule_and_padded_alpha():
    """An impossible alignment or a zero g gives exact zeros whatever the
    other operands; frames at and past the input length are zeros; alpha
    may carry the kernel's padding to a multiple of 4 positions."""
    lp, tg, il, tl, g, blank = _case("base")
    tt = [torch.from_numpy(a) for a in (lp, tg, il, tl)]
    alpha, nll = ctc_alpha_plain(*tt, blank)
    g[1] = 0.0
    gt = torch.from_numpy(g)
    got = ctc_nll_bwd_plain(*tt, alpha, nll, gt, blank)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.equal(got[3], torch.zeros_like(got[3]))     # impossible
    for b, n in enumerate(il):
        assert torch.equal(got[b, n:], torch.zeros_like(got[b, n:]))
    assert (got[0, :il[0]].abs().sum(-1) > 0).all()
    padded = torch.cat([alpha, torch.full((*alpha.shape[:2], 1), -1e30)], -1)
    assert padded.shape[-1] % 4 == 0
    assert torch.equal(ctc_nll_bwd_plain(*tt, padded, nll, gt, blank), got)


def test_nll_plain_is_alpha_plain_nll():
    lp, tg, il, tl, _, blank = _case("base")
    tt = [torch.from_numpy(a) for a in (lp, tg, il, tl)]
    assert torch.equal(ctc_nll_plain(*tt, blank),
                       ctc_alpha_plain(*tt, blank)[1])


def test_plain_versions_take_a_batch_with_no_labels():
    """S = 0 (every target empty; the kernels take it): the NLL is minus
    the blank's log-probs summed over each sample's frames, as
    F.ctc_loss gives it, and d log-probs is -g on the blank of those
    frames, as autograd through the recursion gives it."""
    lp, _, il, _ = _inputs(seed=5)
    blank = lp.shape[-1] - 1
    x = torch.from_numpy(lp).requires_grad_()
    tg = torch.zeros((4, 0), dtype=torch.int64)
    il_t, tl = torch.from_numpy(il), torch.zeros(4, dtype=torch.int64)
    alpha, nll = ctc_alpha_plain(x, tg, il_t, tl, blank)
    want = torch.nn.functional.ctc_loss(
        x.detach().transpose(0, 1), tg, il_t, tl, blank=blank,
        reduction="none")
    np.testing.assert_allclose(nll.detach().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
    g = torch.tensor([1.0, 0.5, 2.0, 1.5])
    auto = torch.autograd.grad((nll * g).sum(), x)[0]
    got = ctc_nll_bwd_plain(x.detach(), tg, il_t, tl, alpha.detach(),
                            nll.detach(), g, blank)
    frames = torch.arange(lp.shape[1])[None, :] < il_t[:, None]
    expect = torch.zeros_like(got)
    expect[..., blank] = -g[:, None] * frames
    # the posterior exp(alpha + beta - lp + nll) carries fp32 rounding of
    # |NLL| (~100 here) in its exponent: ~1e-5 of the blank's 1
    np.testing.assert_allclose(got.numpy(), expect.numpy(), atol=1e-4)
    np.testing.assert_allclose(auto.numpy(), expect.numpy(), atol=1e-6)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    """The checks before a launch, on a meta tensor (never launched)."""
    lp, tg, il, tl = (torch.from_numpy(a) for a in _inputs(seed=3))
    args = (tg, il, tl)
    with pytest.raises(ValueError, match="fp32"):
        _ctc_args(lp.double(), *args, 11)
    with pytest.raises(ValueError, match="1024"):
        _ctc_args(lp, torch.zeros((4, 512), dtype=torch.int64), il, tl, 11)
    with pytest.raises(ValueError, match="blank"):
        _ctc_args(lp, *args, 12)
    out = _ctc_args(lp, tg.long(), il.short(), tl, 11)
    assert out[1].dtype == torch.int64 and out[2].dtype == torch.int64
    assert out[4] == 0b011                         # targets, input lengths
