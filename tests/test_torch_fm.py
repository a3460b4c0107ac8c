"""The flow-matching Euler loop of the PyTorch port (ops/cuda_fm.py) against
the JAX package's Pallas kernel (tpu_asr/ops/pallas_fm.py::fused_fm_euler)
in interpret mode on the CPU, inputs made with numpy from a seed:

- x_final and last_v with uniform and per-row step counts ([1, 2, 3, 4, 2,
  1], max_steps 4): fp32 within 1e-5; bf16 within 2 bf16 ulps of the
  value's scale (3e-2 relative + 3e-2 absolute at |x| ~ 1: both round x,
  h and v at the same points, but the fp32 sums under them run in another
  order, and a sum that lands on a rounding boundary moves one ulp, which
  the recurrence carries on);
- the gradients of mean(last_v * r) + mean(x_final^2), so that both
  output cotangents reach the backward, against jax.grad through the
  kernel's custom VJP: rtol 1e-4, atol 1e-5 (tests/test_pallas_fm.py's
  tolerance between the two JAX backends);
- on CPU tensors the wrapper runs the plain loop and launches nothing, and
  the kernel's argument check refuses what the CUDA kernel does not take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.ops.pallas_fm import fused_fm_euler as jax_fm
from tpu_asr_torch.ops import _kernels
from tpu_asr_torch.ops.cuda_fm import (check_kernel_args, fm_euler_plain,
                                       fused_fm_euler, fused_fm_euler_bwd)

ROWS, T, C, H = 6, 9, 24, 32
STEPS = {"uniform": ([3] * ROWS, 3), "per_row": ([1, 2, 3, 4, 2, 1], 4)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return (f(ROWS, T, C), f(C, H, scale=C ** -0.5), f(H, scale=0.3),
            f(H, scale=0.1), f(H, C, scale=H ** -0.5), f(C, scale=0.1))


def _jax_run(args, steps, ms, dtype):
    x0, w1, a, c, w2, b2 = (jnp.asarray(z) for z in args)
    return jax_fm(x0.astype(dtype), jnp.asarray(steps, jnp.int32), w1, a, c,
                  w2, b2, max_steps=ms, compute_dtype=dtype, interpret=True)


def _port_run(args, steps, ms, dtype, fn=fm_euler_plain):
    x0, *rest = (torch.from_numpy(z) for z in args)
    return fn(x0.to(dtype), torch.tensor(steps), *rest, max_steps=ms,
              compute_dtype=dtype)


@pytest.mark.parametrize("kind", sorted(STEPS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(kind, dtype):
    steps, ms = STEPS[kind]
    args = _inputs()
    want = _jax_run(args, steps, ms, getattr(jnp, dtype))
    got = _port_run(args, steps, ms, getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 3e-2
    for g, w, name in zip(got, want, ("x_final", "last_v")):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_gradients_match_pallas_kernel(kind):
    steps, ms = STEPS[kind]
    args = _inputs(1)
    r = np.random.default_rng(2).normal(size=(ROWS, T, C)).astype(np.float32)

    def jax_obj(*z):
        x, v = jax_fm(z[0], jnp.asarray(steps, jnp.int32), *z[1:],
                      max_steps=ms, interpret=True)
        return jnp.mean(v * r) + jnp.mean(x * x)

    want = jax.grad(jax_obj, argnums=tuple(range(6)))(
        *(jnp.asarray(z) for z in args))
    leaves = [torch.from_numpy(z).requires_grad_() for z in args]
    x, v = fm_euler_plain(leaves[0], torch.tensor(steps), *leaves[1:],
                          max_steps=ms)
    obj = (v * torch.from_numpy(r)).mean() + (x * x).mean()
    got = torch.autograd.grad(obj, leaves)
    for g, w, name in zip(got, want, ("x0", "w1x", "a", "c", "w2", "b2")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_wrapper_runs_plain_on_cpu_and_launches_nothing():
    steps, ms = STEPS["per_row"]
    args = _inputs(3)
    got = _port_run(args, steps, ms, torch.float32, fused_fm_euler)
    want = _port_run(args, steps, ms, torch.float32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fused_fm_euler.launches == 0 and fused_fm_euler_bwd.launches == 0
    assert _kernels.library.cache_info().currsize == 0


@pytest.mark.parametrize("case", ["c64", "h64", "steps17", "steps0",
                                  "float16"])
def test_kernel_refuses_shapes_outside_its_build(case):
    c = 64 if case == "c64" else 88
    h = 64 if case == "h64" else 128
    ms = {"steps17": 17, "steps0": 0}.get(case, 8)
    dtype = torch.float16 if case == "float16" else torch.bfloat16
    x0 = torch.zeros(2, 5, c, dtype=dtype)
    check_kernel_args(torch.zeros(2, 5, 88), torch.zeros(88, 128),
                      torch.zeros(128, 88), 16, torch.bfloat16)
    with pytest.raises(ValueError, match="fused_fm_euler"):
        check_kernel_args(x0, torch.zeros(c, h), torch.zeros(h, c), ms, dtype)
