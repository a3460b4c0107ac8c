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
- the same at a second width (C = 40, H = 64, ragged steps), which the
  bf16 kernel takes and the fp32 kernel does not;
- on CPU tensors the wrapper runs the plain loop and launches nothing, and
  the kernel's argument check refuses what the CUDA kernels do not take,
  per dtype: bf16 any C % 8 == 0 up to 128 and H % 32 == 0 up to 256, fp32
  C = 88 and H = 128 only, max_steps 1..16 and no float16 in either.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.ops.pallas_fm import fused_fm_euler as jax_fm
from tpu_asr_torch.ops import _kernels
from tpu_asr_torch.ops.cuda_fm import (_aligned, check_kernel_args,
                                       fm_euler_plain, fm_refusal,
                                       fused_fm_euler, fused_fm_euler_bwd)

ROWS, T, C, H = 6, 9, 24, 32
STEPS = {"uniform": ([3] * ROWS, 3), "per_row": ([1, 2, 3, 4, 2, 1], 4)}
WIDE = (40, 64)                          # a second (C, H): bf16 only
WIDE_STEPS = ([5, 1, 3, 6, 2, 4], 6)


def _inputs(seed=0, c=C, h=H):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return (f(ROWS, T, c), f(c, h, scale=c ** -0.5), f(h, scale=0.3),
            f(h, scale=0.1), f(h, c, scale=h ** -0.5), f(c, scale=0.1))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_at_another_width(dtype):
    steps, ms = WIDE_STEPS
    args = _inputs(4, *WIDE)
    want = _jax_run(args, steps, ms, getattr(jnp, dtype))
    got = _port_run(args, steps, ms, getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 3e-2
    for g, w, name in zip(got, want, ("x_final", "last_v")):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("kind", sorted(STEPS) + ["wide"])
def test_gradients_match_pallas_kernel(kind):
    steps, ms = WIDE_STEPS if kind == "wide" else STEPS[kind]
    args = _inputs(1, *WIDE) if kind == "wide" else _inputs(1)
    r = np.random.default_rng(2).normal(size=args[0].shape).astype(np.float32)

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


# case: (C, H, max_steps, compute dtype) the kernels refuse, and a word of
# the refusal (the limit it names)
REFUSED = {
    "c64": (64, 128, 8, torch.float32, "fp32 kernel takes C=88"),
    "h64": (88, 64, 8, torch.float32, "fp32 kernel takes C=88, H=128"),
    "steps17": (88, 128, 17, torch.bfloat16, "max_steps 17"),
    "steps0": (88, 128, 0, torch.bfloat16, "max_steps 0"),
    "float16": (88, 128, 8, torch.float16, "compute dtype"),
    "bf16_c136": (136, 128, 8, torch.bfloat16, "C % 8 == 0 up to 128"),
    "bf16_c90": (90, 128, 8, torch.bfloat16, "C % 8 == 0 up to 128"),
    "bf16_h272": (88, 272, 8, torch.bfloat16, "H % 32 == 0 up to 256"),
    "bf16_h48": (88, 48, 8, torch.bfloat16, "H % 32 == 0 up to 256"),
    "fp32_steps17": (88, 128, 17, torch.float32, "max_steps 17"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_kernel_refuses_shapes_outside_its_build(case):
    c, h, ms, dtype, why = REFUSED[case]
    x0 = torch.zeros(2, 5, c, dtype=dtype)
    check_kernel_args(torch.zeros(2, 5, 88), torch.zeros(88, 128),
                      torch.zeros(128, 88), 16, torch.bfloat16)
    with pytest.raises(ValueError, match="fused_fm_euler") as err:
        check_kernel_args(x0, torch.zeros(c, h), torch.zeros(h, c), ms, dtype)
    assert why in str(err.value)


@pytest.mark.parametrize("c,h", [(64, 64), (40, 64), (8, 32), (128, 256),
                                 (88, 128)])
def test_bf16_kernel_takes_its_widths(c, h):
    """bf16: any C % 8 == 0 up to 128 and H % 32 == 0 up to 256, 1..16
    steps; fp32 only the flagship's C = 88, H = 128."""
    for ms in (1, 16):
        assert fm_refusal(c, h, ms, torch.bfloat16) is None
        check_kernel_args(torch.zeros(2, 5, c, dtype=torch.bfloat16),
                          torch.zeros(c, h), torch.zeros(h, c), ms,
                          torch.bfloat16)
    assert (fm_refusal(c, h, 8, torch.float32) is None) == ((c, h) ==
                                                            (88, 128))


def test_aligned_copies_only_misaligned_views():
    base = torch.arange(40, dtype=torch.bfloat16)
    assert _aligned(base) is base
    view = base[3:35]
    copy = _aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)
