"""ASR confidence estimation: the PyTorch counterpart of
tpu_asr/ops/confidence.py (NeMo's asr_confidence_utils contract).

- `get_confidence_measure_bank()`: name -> measure(log_probs (..., V),
  vocab_size, alpha) -> (...) confidence, 1 at a one-hot and 0 at the
  uniform distribution: max_prob, and the Tsallis, Renyi and alpha-weighted
  Gibbs entropies with 'lin' or 'exp' normalisation (alpha = 1 is their
  common Shannon limit);
- `get_confidence_aggregation_bank()`: mean / min / max / prod of a
  sequence of confidences (host);
- `ConfidenceConfig` / `ConfidenceMethodConfig`: NeMo's surface.

The measures are elementwise torch with one reduction over the vocabulary,
so frame confidence runs on the log-probs' device. With p = exp(x),
t = alpha, v = vocab size:
- max_prob:  (max p * v - 1) / (v - 1)
- Tsallis:   S = (1 - sum p^t) / (t - 1), S_max = (1 - v^(1-t)) / (t - 1)
- Renyi:     R = ln(sum p^t) / (1 - t), R_max = ln v
- Gibbs:     H = -sum p^t ln p, H_uni = v^(1-t) ln v
- 'lin': 1 - S / S_max; 'exp': (exp(-S) - exp(-S_max)) / (1 - exp(-S_max)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class ConfidenceMethodConfig:
    """How one (..., V) log-prob vector becomes one confidence value
    (defaults: entropy / tsallis / 0.33 / exp, as NeMo's)."""

    name: str = "entropy"            # 'entropy' | 'max_prob'
    entropy_type: str = "tsallis"    # 'gibbs' | 'tsallis' | 'renyi'
    alpha: float = 0.33
    entropy_norm: str = "exp"        # 'lin' | 'exp'

    def measure_name(self) -> str:
        if self.name == "max_prob":
            return "max_prob"
        if self.name != "entropy":
            raise ValueError(f"unknown confidence method name: {self.name}")
        key = f"entropy_{self.entropy_type}_{self.entropy_norm}"
        if key not in get_confidence_measure_bank():
            raise ValueError(f"unknown entropy measure: {key}")
        return key


@dataclass
class ConfidenceConfig:
    """NeMo's ConfidenceConfig surface."""

    preserve_frame_confidence: bool = False
    preserve_token_confidence: bool = False
    preserve_word_confidence: bool = False
    # leave blank frames out when pooling frame confidences into tokens
    exclude_blank: bool = True
    aggregation: str = "min"         # 'mean' | 'min' | 'max' | 'prod'
    method_cfg: ConfidenceMethodConfig = field(
        default_factory=ConfidenceMethodConfig)

    def wants_any(self) -> bool:
        return (self.preserve_frame_confidence
                or self.preserve_token_confidence
                or self.preserve_word_confidence)


def _sum_p_alpha(x: torch.Tensor, t: float) -> torch.Tensor:
    """sum_i p_i^t, computed stably as exp(logsumexp(t * x))."""
    return torch.exp(torch.logsumexp(t * x, dim=-1))


def _on_tensor(measure):
    return lambda x, v, t: measure(torch.as_tensor(x), v, t)


def get_confidence_measure_bank():
    """name -> fn(log_probs (..., V), vocab_size, alpha) -> (...). Takes a
    tensor or an array (computed in its floating dtype)."""

    def _is_shannon(t):
        # alpha == 1: the generic formulas' removable 0/0
        return abs(t - 1.0) < 1e-8

    def _shannon_h(x):
        return -(torch.exp(x) * x).sum(-1)

    def _lin_shannon(x, v):
        return 1.0 - _shannon_h(x) / math.log(v)

    def _exp_shannon(x, v):
        return (torch.exp(-_shannon_h(x)) - 1.0 / v) / (1.0 - 1.0 / v)

    def max_prob(x, v, t):
        return (torch.exp(x.max(-1).values) * v - 1.0) / (v - 1.0)

    def entropy_tsallis_lin(x, v, t):
        if _is_shannon(t):
            return _lin_shannon(x, v)
        return 1.0 - (1.0 - _sum_p_alpha(x, t)) / (1.0 - math.pow(v, 1.0 - t))

    def entropy_tsallis_exp(x, v, t):
        if _is_shannon(t):
            return _exp_shannon(x, v)
        s = (1.0 - _sum_p_alpha(x, t)) / (t - 1.0)
        exp_neg_max = math.exp(-(1.0 - math.pow(v, 1.0 - t)) / (t - 1.0))
        return (torch.exp(-s) - exp_neg_max) / (1.0 - exp_neg_max)

    def entropy_renyi_lin(x, v, t):
        if _is_shannon(t):
            return _lin_shannon(x, v)
        r = torch.log(_sum_p_alpha(x, t)) / (1.0 - t)
        return 1.0 - r / math.log(v)

    def entropy_renyi_exp(x, v, t):
        if _is_shannon(t):
            return _exp_shannon(x, v)
        # exp(-R) = (sum p^t)^(1/(t-1)), mapped from [1/v, 1] to [0, 1]
        return (_sum_p_alpha(x, t) ** (1.0 / (t - 1.0)) * v - 1.0) / (v - 1.0)

    def _gibbs_h(x, t):
        return -(torch.exp(t * x) * x).sum(-1)

    def entropy_gibbs_lin(x, v, t):
        if _is_shannon(t):
            return _lin_shannon(x, v)
        return 1.0 - _gibbs_h(x, t) / (math.pow(v, 1.0 - t) * math.log(v))

    def entropy_gibbs_exp(x, v, t):
        if _is_shannon(t):
            return _exp_shannon(x, v)
        exp_neg_max = math.exp(-math.pow(v, 1.0 - t) * math.log(v))
        return (torch.exp(-_gibbs_h(x, t)) - exp_neg_max) / (1.0 - exp_neg_max)

    bank = {
        "max_prob": max_prob,
        "entropy_gibbs_lin": entropy_gibbs_lin,
        "entropy_gibbs_exp": entropy_gibbs_exp,
        "entropy_tsallis_lin": entropy_tsallis_lin,
        "entropy_tsallis_exp": entropy_tsallis_exp,
        "entropy_renyi_lin": entropy_renyi_lin,
        "entropy_renyi_exp": entropy_renyi_exp,
    }
    return {name: _on_tensor(fn) for name, fn in bank.items()}


def get_confidence_aggregation_bank():
    """Aggregations of a 1-D sequence of confidences (host lists or
    arrays) in float64; an empty sequence gives 0.0."""

    def _arr(xs):
        return np.asarray(xs, np.float64)

    return {
        "mean": lambda xs: float(_arr(xs).mean()) if len(xs) else 0.0,
        "min": lambda xs: float(_arr(xs).min()) if len(xs) else 0.0,
        "max": lambda xs: float(_arr(xs).max()) if len(xs) else 0.0,
        "prod": lambda xs: float(_arr(xs).prod()) if len(xs) else 0.0,
    }


def frame_confidence_fn(method_cfg: ConfidenceMethodConfig, vocab_size: int):
    """fn: log_probs (B, T, V) -> confidence (B, T) fp32, on their
    device."""
    measure = get_confidence_measure_bank()[method_cfg.measure_name()]
    alpha = float(method_cfg.alpha)

    def fn(log_probs: torch.Tensor) -> torch.Tensor:
        return measure(log_probs.float(), vocab_size, alpha).float()

    return fn
