"""The flow-matching Euler loop at conformer-LARGE's and XLarge's student
widths and past 16 steps: the port's plain version (ops/cuda_fm.py::
fm_euler_plain, which the CUDA kernels are held to on the card) against the
JAX package's Pallas kernel (tpu_asr/ops/pallas_fm.py::fused_fm_euler) in
interpret mode on the CPU, inputs made with numpy from a seed.

- C = 256 (LARGE's student) and C = 512 (XLarge's), H = 128, max_steps 24
  with ragged per-row step counts (1 .. 24): x_final and last_v in fp32
  within 1e-5 and with bf16 rounding within 3e-2 (tests/test_torch_fm.py's
  tolerances: both round x, h and v at the same points, and a sum landing
  on a rounding boundary moves one bf16 ulp);
- the gradients of mean(last_v * r) + mean(x_final^2) against jax.grad
  through the kernel's custom VJP, rtol 1e-4, atol 1e-5 (fp32), at both
  widths, by autograd through fm_euler_plain and by fm_euler_bwd_plain
  (the explicit backward the CUDA backward kernels are held to on the
  card) at the same cotangents, which also agree with each other within
  1e-5;
- fm_euler_bwd_plain against jax.vjp of the kernel (_fm_bwd_kernel) in
  bf16 at both widths and at C=88, H=512 (the route's edge: bf16 at C <=
  128 and H > 256 runs the wide kernels on the card): within 1e-2 of each
  gradient's max magnitude, because both round x, h, round(dv) and
  round(dp) at the same points but sum the products in another order, and
  JAX's custom VJP returns dW1x and dW2 rounded to bf16 (its weights'
  dtype);
- `fm_refusal` takes these shapes in fp32 and bf16 (so 'auto' routes the
  FM of a flowkd_large step to the kernels on the card), and the model's
  route (FlowMatchingModule.uses_kernel) agrees.

Each case is small in rows and frames (3 rows x 4 frames): the width and
the step count are what is under test.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.ops.pallas_fm import fused_fm_euler as jax_fm
from tpu_asr_torch.ops.cuda_fm import (check_kernel_args,
                                       fm_euler_bwd_plain, fm_euler_plain,
                                       fm_refusal)

ROWS, T, H, MAX_STEPS = 3, 4, 128, 24
STEPS = [24, 7, 1]                     # ragged, the longest at max_steps
WIDTHS = (256, 512)


def _inputs(c, seed=0, h=H):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return (f(ROWS, T, c), f(c, h, scale=c ** -0.5), f(h, scale=0.3),
            f(h, scale=0.1), f(h, c, scale=h ** -0.5), f(c, scale=0.1))


@functools.lru_cache(maxsize=None)
def _jax_vjp(c, h, max_steps, steps, dtype, seed):
    """(outputs, vjp function) of the Pallas kernel in interpret mode on
    _inputs(c, seed) at H = h, x0 in `dtype` (the compute dtype): one
    forward trace, shared by the forward and backward tests of a shape."""
    args = _inputs(c, seed, h)
    jdt = getattr(jnp, dtype)

    def fn(x0, *w):
        return jax_fm(x0, jnp.asarray(steps, jnp.int32), *w,
                      max_steps=max_steps, compute_dtype=jdt, interpret=True)

    return jax.vjp(fn, jnp.asarray(args[0]).astype(jdt),
                   *(jnp.asarray(z) for z in args[1:]))


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_wide(c, dtype):
    args = _inputs(c)
    want, _ = _jax_vjp(c, H, MAX_STEPS, tuple(STEPS), dtype, 0)
    tdt = getattr(torch, dtype)
    x0t, *rest = (torch.from_numpy(z) for z in args)
    got = fm_euler_plain(x0t.to(tdt), torch.tensor(STEPS), *rest,
                         max_steps=MAX_STEPS, compute_dtype=tdt)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for g, w, name in zip(got, want, ("x_final", "last_v")):
        assert g.dtype == tdt and g.shape == (ROWS, T, c)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol, err_msg=name)
    # the row that ran one step moved, the longest ran all 24
    assert not np.allclose(np.asarray(got[0][2].float()), args[0][2])


@pytest.mark.parametrize("c", WIDTHS)
def test_gradients_match_pallas_kernel_wide(c):
    args = _inputs(c, 1)
    r = np.random.default_rng(2).normal(size=args[0].shape).astype(np.float32)

    def jax_obj(*z):
        x, v = jax_fm(z[0], jnp.asarray(STEPS, jnp.int32), *z[1:],
                      max_steps=MAX_STEPS, interpret=True)
        return jnp.mean(v * r) + jnp.mean(x * x)

    want = jax.grad(jax_obj, argnums=tuple(range(6)))(
        *(jnp.asarray(z) for z in args))
    leaves = [torch.from_numpy(z).requires_grad_() for z in args]
    x, v = fm_euler_plain(leaves[0], torch.tensor(STEPS), *leaves[1:],
                          max_steps=MAX_STEPS)
    obj = (v * torch.from_numpy(r)).mean() + (x * x).mean()
    got = torch.autograd.grad(obj, leaves)
    # the explicit backward at the objective's cotangents
    gx, gv = 2 * x.detach() / x.numel(), torch.from_numpy(r) / v.numel()
    plain = fm_euler_bwd_plain(*(torch.from_numpy(z) for z in args[:1]),
                               torch.tensor(STEPS, dtype=torch.float32),
                               *(torch.from_numpy(z) for z in args[1:]), gx,
                               gv, MAX_STEPS)
    names = ("x0", "w1x", "a", "c", "w2", "b2")
    for g, p, w, name in zip(got, plain, want, names):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=f"explicit {name}")
        np.testing.assert_allclose(p.numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"autograd {name}")


@pytest.mark.parametrize("c,h,max_steps,steps", [
    (256, H, MAX_STEPS, STEPS), (512, H, MAX_STEPS, STEPS),
    (88, 512, 4, [4, 3, 1])])
def test_bwd_plain_matches_pallas_vjp_bf16(c, h, max_steps, steps):
    args = _inputs(c, 0, h)
    rng = np.random.default_rng(3)
    gx, gv = (rng.normal(size=(ROWS, T, c)).astype(np.float32)
              for _ in range(2))
    bf = jnp.bfloat16
    _, vjp = _jax_vjp(c, h, max_steps, tuple(steps), "bfloat16", 0)
    want = vjp((jnp.asarray(gx).astype(bf), jnp.asarray(gv).astype(bf)))
    t = lambda z: torch.from_numpy(z)
    got = fm_euler_bwd_plain(
        t(args[0]).bfloat16(), torch.tensor(steps, dtype=torch.float32),
        t(args[1]).bfloat16(), t(args[2]), t(args[3]),
        t(args[4]).bfloat16(), t(args[5]), t(gx), t(gv), max_steps)
    assert got[0].dtype == torch.bfloat16
    for g, w, name in zip(got, want, ("x0", "w1x", "a", "c", "w2", "b2")):
        w = np.asarray(w, np.float32)
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=1e-2 * scale, err_msg=name)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_refusal_takes_the_wide_shapes(c, dtype):
    from tpu_asr_torch.config import FlowMatchingConfig
    from tpu_asr_torch.kd.flow_matching import FlowMatchingModule

    for ms in (8, MAX_STEPS, 64):
        assert fm_refusal(c, H, ms, dtype) is None
        check_kernel_args(torch.zeros(2, 5, c, dtype=dtype),
                          torch.zeros(c, H), torch.zeros(H, c), ms, dtype)
    fm = FlowMatchingModule(FlowMatchingConfig(
        student_dim=c, teacher_dim=2 * c, student_head_num=4,
        hidden_dim=H), dtype)
    assert fm.uses_kernel(fm.euler_weights()[0], MAX_STEPS)
