"""CTC loss and greedy decoding: the PyTorch counterparts of
tpu_asr/ops/ctc.py::ctc_loss, ::ctc_greedy_decode,
::ctc_greedy_decode_with_timestamps and ::ctc_greedy_decode_full, and
`ctc_greedy_decode_ids`, the serving fast path on the model's argmax
ids."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_asr_torch.ops.cuda_ctc import NEG_INF, ctc_nll, ctc_nll_plain
from tpu_asr_torch.parallel.mesh import batch_mean, global_sum

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
    plain recursion. Under data parallelism (parallel/mesh.py) a reduced
    loss is this rank's share of the global batch's: its NLL sum over the
    global rows or the global target tokens."""
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
        return batch_mean(nll)
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return batch_mean(nll / target_lengths.to(nll.dtype).clamp(min=1.0))
    return nll.sum() / global_sum(
        target_lengths.sum().to(nll.dtype)).clamp(min=1.0)


def _pack(keep: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """values (B, T) where `keep` left-packed into (B, T) int32, -1 after
    each row's kept entries (the rest go to a spill column T)."""
    b, t = keep.shape
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    out = torch.full((b, t + 1), -1, dtype=torch.int32, device=keep.device)
    out.scatter_(1, torch.where(keep, pos, torch.full_like(pos, t)),
                 values.to(torch.int32))
    return out[:, :t]


def _frames(ids: torch.Tensor, lengths: torch.Tensor):
    """(previous id, frame index, valid) of (B, T) frame ids."""
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    t_idx = torch.arange(ids.shape[1], device=ids.device)[None, :]
    return prev, t_idx, t_idx < lengths[:, None]


def ctc_greedy_decode_ids(ids: torch.Tensor, lengths: torch.Tensor,
                          blank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) frame-wise argmax ids (the model's `greedy` output) ->
    (tokens (B, T) int32 left-packed with -1 padding, n_tokens (B,)).
    Collapses repeats, then drops blanks, within each sample's length; runs
    on the tensor's device. The serving fast path: the model's own argmax,
    no (B, T, V) tensor read again."""
    ids = ids.to(torch.int32)
    prev, _, valid = _frames(ids, lengths)
    keep = (ids != blank) & (ids != prev) & valid
    return _pack(keep, ids), keep.sum(dim=1).to(torch.int32)


def ctc_greedy_decode(log_probs: torch.Tensor, lengths: torch.Tensor,
                      blank: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ctc_greedy_decode: (B, T, V) log-probs (blank = V - 1 by
    default) and (B,) lengths -> (tokens (B, T) int32 left-packed with -1
    padding, n_tokens (B,)), on the tensor's device."""
    v = log_probs.shape[-1]
    return ctc_greedy_decode_ids(log_probs.argmax(dim=-1), lengths,
                                 v - 1 if blank is None else blank)


def ctc_greedy_decode_with_timestamps(
        log_probs: torch.Tensor, lengths: torch.Tensor,
        blank: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy decode with each token's emission frame: (tokens (B, T),
    n_tokens (B,), frames (B, T) int32, -1 padding); frames[b, j] is the
    first encoder frame of packed token j."""
    tokens, n_tokens, starts, _, _ = ctc_greedy_decode_full(
        log_probs, lengths, blank)
    return tokens, n_tokens, starts


def ctc_greedy_decode_full(
        log_probs: torch.Tensor, lengths: torch.Tensor,
        blank: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Greedy decode with each token's extent and the raw frame labels:
    (tokens (B, T), n_tokens (B,), starts (B, T), ends (B, T), labels
    (B, T)). starts / ends are the first and last encoder frame (inclusive;
    -1 padding) of packed token j's emission run, labels the per-frame
    argmax before the collapse. A token is a maximal run of equal non-blank
    argmax frames: a start is a run's head, an end its tail (or the last
    valid frame), so the k-th start pairs with the k-th end."""
    b, t, v = log_probs.shape
    blank = v - 1 if blank is None else blank
    ids = log_probs.argmax(dim=-1).to(torch.int32)
    prev, t_idx, valid = _frames(ids, lengths)
    nxt = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -1)], dim=1)
    keep_s = (ids != blank) & (ids != prev) & valid
    keep_e = ((ids != blank) & ((ids != nxt) | (t_idx == lengths[:, None] - 1))
              & valid)
    frames = t_idx.expand(b, t)
    return (_pack(keep_s, ids), keep_s.sum(dim=1).to(torch.int32),
            _pack(keep_s, frames), _pack(keep_e, frames), ids)
