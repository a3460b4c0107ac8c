"""Greedy CTC decoding: the PyTorch counterpart of
tpu_asr/ops/ctc.py::ctc_greedy_decode."""

from __future__ import annotations

from typing import Tuple

import torch


def ctc_greedy_decode(ids: torch.Tensor, lengths: torch.Tensor, blank: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) frame-wise argmax ids (the model's `greedy` output) ->
    (tokens (B, T) int32 left-packed with -1 padding, n_tokens (B,)).
    Collapses repeats, then drops blanks, within each sample's length; runs
    on the tensor's device."""
    b, t = ids.shape
    ids = ids.to(torch.int32)
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    t_idx = torch.arange(t, device=ids.device)[None, :]
    keep = (ids != blank) & (ids != prev) & (t_idx < lengths[:, None])
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    n_tokens = keep.sum(dim=1).to(torch.int32)
    # kept ids go to their packed slot; the rest to a spill column T
    out = torch.full((b, t + 1), -1, dtype=torch.int32, device=ids.device)
    out.scatter_(1, torch.where(keep, pos, torch.full_like(pos, t)), ids)
    return out[:, :t], n_tokens
