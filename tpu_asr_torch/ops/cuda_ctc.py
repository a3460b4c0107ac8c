"""CTC forward-backward kernels (`csrc/ctc.cu`) and their plain versions.

Counterpart of tpu_asr/ops/pallas_ctc.py::ctc_nll_pallas: per-sample CTC
negative log-likelihood (B,) of (B, T, V) log-probs (blank = `blank`),
differentiable in the log-probs. The forward kernel runs the log-space
alpha recursion, saves the alpha lattice and returns the NLL; the backward
kernel runs the beta recursion fused with the posterior and writes
d log-probs (B, T, V) itself, already scaled by the incoming gradient (the
JAX package leaves that scatter onto the vocabulary to a one-hot einsum).

Plain versions, each the function of one kernel: `ctc_alpha_plain` (the
alpha lattice and the NLL: the `lax.scan` recursion of
tpu_asr/ops/ctc.py::ctc_forward_logprob written as a loop over time) and
`ctc_nll_bwd_plain` (the beta recursion, the posterior times g and the
scatter onto V, as `_ctc_bwd_kernel` and `_ctc_vjp_bwd` do).
`ctc_nll_plain` is the NLL of the first, differentiated by autograd. A CPU
tensor runs the plain versions; a CUDA tensor launches the kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_asr_torch.ops import _kernels as K

NEG_INF = -1.0e30
MAX_POSITIONS = 1024            # 2S+1 the kernels take
_FWD_ARGS = (K.PTR,) * 6 + (K.INT,) * 7 + (K.PTR,)
_BWD_ARGS = (K.PTR,) * 8 + (K.INT,) * 7 + (K.PTR,)


def extended_labels(targets: torch.Tensor, blank: int) -> torch.Tensor:
    """(B, S) labels -> (B, 2S+1) [blank, y1, blank, y2, ..., blank]."""
    b, s = targets.shape
    ext = torch.full((b, 2 * s + 1), blank, dtype=torch.int64,
                     device=targets.device)
    ext[:, 1::2] = targets
    return ext


def _lse3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Max-shifted log(e^a + e^b + e^c); NEG_INF where the max is at or
    below NEG_INF / 2."""
    stacked = torch.stack([a, b, c])
    m = stacked.max(dim=0).values
    summed = m + torch.log(torch.exp(stacked - m[None]).sum(dim=0))
    return torch.where(m <= NEG_INF / 2, torch.full_like(m, NEG_INF), summed)


def _lattice(log_probs, targets, target_lengths, blank):
    """(ext (B, L), label log-probs (B, T, L) fp32, valid (B, L))."""
    b, t_max, _ = log_probs.shape
    ext = extended_labels(targets, blank)
    l = ext.shape[1]
    pos = torch.arange(l, device=log_probs.device)[None, :]
    valid = pos <= 2 * target_lengths[:, None]
    lp = log_probs.float().gather(2, ext[:, None, :].expand(b, t_max, l))
    return ext, lp, valid


def ctc_alpha_plain(log_probs: torch.Tensor, targets: torch.Tensor,
                    input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                    blank: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha (B, T, 2S+1) fp32, NLL (B,) fp32): the forward kernel's
    function. alpha[:, t] is the lattice after frame t; past a sample's
    input length it keeps its last frame's row (as the TPU kernel's)."""
    b, t_max, v = log_probs.shape
    blank = v - 1 if blank is None else blank
    dev = log_probs.device
    ext, lp, valid = _lattice(log_probs, targets, target_lengths, blank)
    l = ext.shape[1]
    pos = torch.arange(l, device=dev)[None, :]
    # [:, :l]: a batch with no labels (S = 0) has the one position 0
    ext_prev2 = torch.cat([torch.full((b, 2), blank, dtype=ext.dtype,
                                      device=dev), ext[:, :-2]], dim=1)[:, :l]
    can_skip = (ext != blank) & (ext != ext_prev2) & (pos >= 2)
    neg = lambda n: torch.full((b, n), NEG_INF, device=dev)

    alpha = torch.cat([lp[:, 0, :1],
                       torch.where(target_lengths[:, None] > 0, lp[:, 0, 1:2],
                                   neg(1)), neg(max(l - 2, 0))], dim=1)
    alpha = torch.where(valid, alpha, neg(l))
    rows = [alpha]
    for t in range(1, t_max):
        a1 = torch.cat([neg(1), alpha[:, :-1]], dim=1)
        a2 = torch.where(can_skip,
                         torch.cat([neg(2), alpha[:, :-2]], dim=1)[:, :l],
                         neg(l))
        new = torch.where(valid, _lse3(alpha, a1, a2) + lp[:, t], neg(l))
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
        rows.append(alpha)

    idx_last = (2 * target_lengths).long()[:, None]
    a_last = alpha.gather(1, idx_last)[:, 0]
    a_prev = alpha.gather(1, (idx_last - 1).clamp(min=0))[:, 0]
    a_prev = torch.where(target_lengths > 0, a_prev, neg(1)[:, 0])
    m = torch.maximum(a_last, a_prev)
    nll = -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)))
    return torch.stack(rows, dim=1), nll


def ctc_nll_plain(log_probs: torch.Tensor, targets: torch.Tensor,
                  input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                  blank: Optional[int] = None) -> torch.Tensor:
    """Per-sample CTC NLL (B,) fp32, unreduced (torch CTCLoss
    reduction='none' contract)."""
    return ctc_alpha_plain(log_probs, targets, input_lengths, target_lengths,
                           blank)[1]


def ctc_nll_bwd_plain(log_probs, targets, input_lengths, target_lengths,
                      alpha, nll, g, blank: Optional[int] = None
                      ) -> torch.Tensor:
    """d(sum_b g[b] * nll[b]) / d log_probs (B, T, V) fp32 from a saved
    forward (alpha (B, T, >= 2S+1), nll (B,)): the backward kernel's
    function. beta runs from each sample's last input frame; the posterior
    exp(alpha + beta - lp + nll) at valid positions, summed onto the
    vocabulary and times -g. A zero g or an impossible alignment (nll >=
    1e29 or not finite) gives exact zeros."""
    b, t_max, v = log_probs.shape
    blank = v - 1 if blank is None else blank
    dev = log_probs.device
    ext, lp, valid = _lattice(log_probs, targets, target_lengths, blank)
    l = ext.shape[1]
    pos = torch.arange(l, device=dev)[None, :]
    ext_next2 = torch.cat([ext[:, 2:], torch.full((b, 2), blank,
                                                  dtype=ext.dtype,
                                                  device=dev)], dim=1)[:, :l]
    skip_from = (ext_next2 != blank) & (ext_next2 != ext) & (pos + 2 < l)
    tl = target_lengths[:, None]
    is_end = (pos == 2 * tl) | ((pos == 2 * tl - 1) & (tl > 0))
    il = input_lengths.clamp(max=t_max)[:, None]
    g = g.float()
    nll = nll.float()
    live = ((g != 0) & torch.isfinite(nll) & (nll < 1e29))[:, None]
    alpha = alpha[:, :, :l].float()
    neg = torch.full((b, l), NEG_INF, device=dev)
    beta = neg
    gamma = torch.zeros((b, t_max, l), device=dev)
    for t in range(t_max - 1, -1, -1):
        b1 = torch.cat([beta[:, 1:], neg[:, :1]], dim=1)
        b2 = torch.where(skip_from, torch.cat([beta[:, 2:], neg[:, :2]],
                                              dim=1)[:, :l], neg)
        new = _lse3(beta, b1, b2) + lp[:, t]
        new = torch.where(t == il - 1, torch.where(is_end, lp[:, t], neg),
                          new)
        beta = torch.where(valid & (t <= il - 1), new, neg)
        w = alpha[:, t] + beta - lp[:, t] + nll[:, None]
        gamma[:, t] = torch.where(valid & (t <= il - 1) & live,
                                  torch.exp(w), 0.0)
    onehot = F.one_hot(ext, v).float()                      # (B, L, V)
    return torch.bmm(-gamma, onehot) * g[:, None, None]


def _index(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """An index tensor as the kernels take it: int32 or int64, contiguous,
    and 1 where it is int64."""
    if x.dtype not in (torch.int32, torch.int64):
        x = x.to(torch.int64)
    return x.contiguous(), int(x.dtype == torch.int64)


def _ctc_args(log_probs, targets, input_lengths, target_lengths, blank):
    """The kernels' operands (the kernel builds the extended labels and
    clamps the lengths itself) and the flags of the int64 ones."""
    v = log_probs.shape[-1]
    if log_probs.dtype != torch.float32:
        raise ValueError("ctc_nll: the kernel takes fp32 log-probs")
    if 2 * targets.shape[1] + 1 > MAX_POSITIONS:
        raise ValueError("ctc_nll: 2S+1 > 1024 labels")
    if not 0 <= blank < v:
        raise ValueError(f"ctc_nll: blank {blank} outside [0, {v})")
    (tg, w0), (il, w1), (tl, w2) = map(
        _index, (targets, input_lengths, target_lengths))
    return log_probs.contiguous(), tg, il, tl, w0 | w1 << 1 | w2 << 2


def _shape_args(lp, tg):
    b, t_max, v = lp.shape
    s = tg.shape[1]
    return b, t_max, v, s, (2 * s + 4) // 4 * 4


class _CTCNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths,
                blank):
        lp, tg, il, tl, wide = _ctc_args(log_probs, targets, input_lengths,
                                         target_lengths, blank)
        b, t_max, v, s, lpad = _shape_args(lp, tg)
        alpha = torch.empty((b, t_max, lpad), device=lp.device)
        nll = torch.empty((b,), device=lp.device)
        tensors = (lp, tg, il, tl, alpha, nll)
        K.check_cuda("ctc_nll", *tensors)
        K.call("tat_ctc_fwd", _FWD_ARGS, lp.device,
               *(z.data_ptr() for z in tensors), b, t_max, v, s, lpad, blank,
               wide)
        ctc_nll.launches += 1
        ctx.blank = blank
        ctx.save_for_backward(lp, tg, il, tl, alpha, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        lp, tg, il, tl, alpha, nll = ctx.saved_tensors
        return (ctc_nll_bwd(lp, tg, il, tl, alpha, nll, g, ctx.blank),
                None, None, None, None)


def ctc_nll_bwd(lp, targets, il, tl, alpha, nll, g, blank: int
                ) -> torch.Tensor:
    """d(sum_b g[b] * nll[b]) / d log_probs (B, T, V) fp32 from the saved
    forward (the operands `_CTCNLL` saves): one kernel launch, which writes
    every entry."""
    lp, tg, il, tl, wide = _ctc_args(lp, targets, il, tl, blank)
    b, t_max, v, s, lpad = _shape_args(lp, tg)
    g = g.float().contiguous()
    dlp = torch.empty((b, t_max, v), device=lp.device)
    tensors = (lp, tg, il, tl, alpha, nll, g, dlp)
    K.check_cuda("ctc_nll_bwd", *tensors)
    if alpha.shape != (b, t_max, lpad):
        raise ValueError(f"ctc_nll_bwd: alpha {tuple(alpha.shape)} is not "
                         f"{(b, t_max, lpad)}")
    K.call("tat_ctc_bwd", _BWD_ARGS, lp.device,
           *(z.data_ptr() for z in tensors), b, t_max, v, s, lpad, blank,
           wide)
    ctc_nll_bwd.launches += 1
    return dlp


def ctc_nll(log_probs: torch.Tensor, targets: torch.Tensor,
            input_lengths: torch.Tensor, target_lengths: torch.Tensor,
            blank: Optional[int] = None) -> torch.Tensor:
    """Same contract as `ctc_nll_plain`. A CPU tensor runs the plain
    version; a CUDA tensor launches the forward kernel (and, under autograd,
    the backward kernel)."""
    blank = log_probs.shape[-1] - 1 if blank is None else int(blank)
    if log_probs.device.type == "cpu":
        return ctc_nll_plain(log_probs, targets, input_lengths,
                             target_lengths, blank)
    if not log_probs.is_cuda:
        raise ValueError(f"ctc_nll: unsupported device {log_probs.device}")
    return _CTCNLL.apply(log_probs, targets, input_lengths, target_lengths,
                         blank)


ctc_nll.launches = 0
ctc_nll_bwd.launches = 0
