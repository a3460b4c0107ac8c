"""The relative sinusoid position table of the rel-pos attention, beside
the ops that take it (ops/cuda_attention.py, ops/cuda_layer.py); the
counterpart of tpu_asr/models/conformer.py::rel_positional_encoding.
models/conformer.py re-exports it."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def rel_positional_encoding(t: int, d_model: int,
                            device=None) -> torch.Tensor:
    """Relative sinusoid table (2t - 1, d_model) fp32 for positions
    t-1 .. -(t-1): sin on even columns, cos on odd (NeMo
    RelPositionalEncoding), computed in numpy float32 as the JAX
    package computes it."""
    positions = np.arange(t - 1, -t, -1, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * -(math.log(10000.0) / d_model))
    pe = np.zeros((2 * t - 1, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(positions * div)
    pe[:, 1::2] = np.cos(positions * div)
    return torch.from_numpy(pe).to(device)


@functools.lru_cache(maxsize=16)
def position_table(t: int, d_model: int, device,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """rel_positional_encoding(t, d_model) on `device` in `dtype`, built
    once per (t, d_model, device, dtype) for the kernel wrappers, which
    only read it."""
    return rel_positional_encoding(t, d_model, device).to(dtype)
