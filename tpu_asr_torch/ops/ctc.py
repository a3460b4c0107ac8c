"""CTC loss and greedy decoding: the PyTorch counterparts of
tpu_asr/ops/ctc.py::ctc_loss and ::ctc_greedy_decode."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_asr_torch.ops.cuda_ctc import NEG_INF, ctc_nll, ctc_nll_plain

REDUCTIONS = ("none", "mean_batch", "sum", "mean", "mean_volume")


def ctc_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             input_lengths: torch.Tensor, target_lengths: torch.Tensor,
             blank: Optional[int] = None, reduction: str = "mean_batch",
             zero_infinity: bool = True,
             backend: str = "auto") -> torch.Tensor:
    """CTC loss with NeMo's reductions: 'mean_batch' (mean of per-sample
    NLLs), 'mean' (NLL / target length, then batch mean), 'mean_volume'
    (sum / total target tokens), 'sum' or 'none'. backend 'auto'/'pallas'
    runs `ctc_nll` (the CUDA kernels for a CUDA tensor), 'scan'/'xla' the
    plain recursion."""
    if reduction not in REDUCTIONS:
        raise ValueError(f"unknown reduction: {reduction}")
    if backend in ("auto", "pallas"):
        nll = ctc_nll(log_probs, targets, input_lengths, target_lengths,
                      blank)
    elif backend in ("scan", "xla"):
        nll = ctc_nll_plain(log_probs, targets, input_lengths,
                            target_lengths, blank)
    else:
        raise ValueError(f"unknown ctc backend: {backend}")
    if zero_infinity:
        bad = ~torch.isfinite(nll) | (nll >= -NEG_INF / 2)
        nll = torch.where(bad, torch.zeros_like(nll), nll)
    if reduction == "none":
        return nll
    if reduction == "mean_batch":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return (nll / target_lengths.to(nll.dtype).clamp(min=1.0)).mean()
    return nll.sum() / target_lengths.sum().to(nll.dtype).clamp(min=1.0)


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
