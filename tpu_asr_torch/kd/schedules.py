"""Noise schedules for flow-matching KD: the PyTorch counterpart of
tpu_asr/kd/schedules.py (reference asr_train.py:790-823).

Each schedule maps t in (0, 1] to (alpha_t, sigma_t); the `_deriv` variants
return the analytic (d alpha/dt, d sigma/dt) of the FM training loss
x_hat = (dalpha_dt * s_f - velocity) / (-dsigma_dt).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def rectified_flow_schedule(t: torch.Tensor) -> Pair:
    return t, 1.0 - t


def rectified_flow_schedule_deriv(t: torch.Tensor) -> Pair:
    return torch.ones_like(t), -torch.ones_like(t)


def vp_ode_schedule(t: torch.Tensor, a: float = 19.9,
                    b: float = 0.1) -> Pair:
    alpha_t = torch.exp(-0.25 * a * (1 - t) ** 2 - 0.5 * b * (1 - t))
    return alpha_t, torch.sqrt(1 - alpha_t ** 2)


def vp_ode_schedule_deriv(t: torch.Tensor, a: float = 19.9,
                          b: float = 0.1) -> Pair:
    alpha_t = torch.exp(-0.25 * a * (1 - t) ** 2 - 0.5 * b * (1 - t))
    dalpha_dt = alpha_t * (0.5 * a * (1 - t) + 0.5 * b)
    sigma_t = torch.sqrt(1 - alpha_t ** 2)
    return dalpha_dt, -alpha_t * dalpha_dt / sigma_t


def ve_ode_schedule(t: torch.Tensor, a: float = 0.02,
                    b: float = 100.0) -> Pair:
    return a * (b / a) ** t, torch.ones_like(t)


def ve_ode_schedule_deriv(t: torch.Tensor, a: float = 0.02,
                          b: float = 100.0) -> Pair:
    alpha_t = a * (b / a) ** t
    return alpha_t * math.log(b / a), torch.zeros_like(t)


_SCHEDULES = {
    "rectified": (rectified_flow_schedule, rectified_flow_schedule_deriv),
    "vp_ode": (vp_ode_schedule, vp_ode_schedule_deriv),
    "ve_ode": (ve_ode_schedule, ve_ode_schedule_deriv),
}


def get_noise_schedule(name: str) -> Tuple[Callable, Callable]:
    """Returns (schedule, schedule_deriv) by name."""
    if name not in _SCHEDULES:
        raise NotImplementedError(f"unknown noise schedule: {name}")
    return _SCHEDULES[name]
