"""CTC forward-backward kernels (`csrc/ctc.cu`) and their plain version.

Counterpart of tpu_asr/ops/pallas_ctc.py::ctc_nll_pallas: per-sample CTC
negative log-likelihood (B,) of (B, T, V) log-probs (blank = `blank`),
differentiable in the log-probs. The forward kernel runs the log-space
alpha recursion, saves alpha and returns the NLL; the backward kernel runs
the beta recursion fused with the posterior and emits d(label log-probs)
(B, T, 2S+1), already scaled by the incoming gradient. The scatter back onto
the vocabulary is one batched one-hot product outside the kernel, as the JAX
package leaves it to an einsum.

The plain version is the `lax.scan` recursion of tpu_asr/ops/ctc.py::
ctc_forward_logprob written as a loop over time, differentiated by autograd.
A CPU tensor runs it; a CUDA tensor launches the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tpu_asr_torch.ops import _kernels as K

NEG_INF = -1.0e30
_FWD_ARGS = (K.PTR,) * 6 + (K.INT,) * 5 + (K.PTR,)
_BWD_ARGS = (K.PTR,) * 8 + (K.INT,) * 5 + (K.PTR,)


def extended_labels(targets: torch.Tensor, blank: int) -> torch.Tensor:
    """(B, S) labels -> (B, 2S+1) [blank, y1, blank, y2, ..., blank]."""
    b, s = targets.shape
    ext = torch.full((b, 2 * s + 1), blank, dtype=torch.int64,
                     device=targets.device)
    ext[:, 1::2] = targets
    return ext


def ctc_nll_plain(log_probs: torch.Tensor, targets: torch.Tensor,
                  input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                  blank: Optional[int] = None) -> torch.Tensor:
    """Per-sample CTC NLL (B,) fp32, unreduced (torch CTCLoss
    reduction='none' contract)."""
    b, t_max, v = log_probs.shape
    blank = v - 1 if blank is None else blank
    dev = log_probs.device
    ext = extended_labels(targets, blank)
    l = ext.shape[1]
    pos = torch.arange(l, device=dev)[None, :]
    valid = pos <= 2 * target_lengths[:, None]
    ext_prev2 = torch.cat([torch.full((b, 2), blank, dtype=ext.dtype,
                                      device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_prev2) & (pos >= 2)
    lp = log_probs.float().gather(2, ext[:, None, :].expand(b, t_max, l))
    neg = lambda n: torch.full((b, n), NEG_INF, device=dev)

    alpha = torch.cat([lp[:, 0, :1],
                       torch.where(target_lengths[:, None] > 0, lp[:, 0, 1:2],
                                   neg(1)), neg(l - 2)], dim=1)
    alpha = torch.where(valid, alpha, neg(l))
    for t in range(1, t_max):
        a1 = torch.cat([neg(1), alpha[:, :-1]], dim=1)
        a2 = torch.where(can_skip, torch.cat([neg(2), alpha[:, :-2]], dim=1),
                         neg(l))
        stacked = torch.stack([alpha, a1, a2])
        m = stacked.max(dim=0).values
        summed = m + torch.log(torch.exp(stacked - m[None]).sum(dim=0))
        new = torch.where(m <= NEG_INF / 2, neg(l), summed) + lp[:, t]
        new = torch.where(valid, new, neg(l))
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)

    idx_last = (2 * target_lengths).long()[:, None]
    a_last = alpha.gather(1, idx_last)[:, 0]
    a_prev = alpha.gather(1, (idx_last - 1).clamp(min=0))[:, 0]
    a_prev = torch.where(target_lengths > 0, a_prev, neg(1)[:, 0])
    m = torch.maximum(a_last, a_prev)
    return -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)))


def _ctc_args(log_probs, targets, input_lengths, target_lengths, blank):
    b, t_max, v = log_probs.shape
    if log_probs.dtype != torch.float32:
        raise ValueError("ctc_nll: the kernel takes fp32 log-probs")
    ext = extended_labels(targets, blank).to(torch.int32).contiguous()
    if ext.shape[1] > 1024:
        raise ValueError("ctc_nll: 2S+1 > 1024 labels")
    il = input_lengths.to(torch.int32).clamp(max=t_max).contiguous()
    tl = target_lengths.to(torch.int32).contiguous()
    return log_probs.contiguous(), ext, il, tl


class _CTCNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths,
                blank):
        lp, ext, il, tl = _ctc_args(log_probs, targets, input_lengths,
                                    target_lengths, blank)
        b, t_max, v = lp.shape
        l = ext.shape[1]
        alpha = torch.empty((b, t_max, l), device=lp.device)
        nll = torch.empty((b,), device=lp.device)
        tensors = (lp, ext, il, tl, alpha, nll)
        K.check_cuda("ctc_nll", *tensors)
        K.call("tat_ctc_fwd", _FWD_ARGS, lp.device,
               *(z.data_ptr() for z in tensors), b, t_max, v, l, blank)
        ctc_nll.launches += 1
        ctx.blank = blank
        ctx.save_for_backward(lp, ext, il, tl, alpha, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        lp, ext, il, tl, alpha, nll = ctx.saved_tensors
        return (ctc_nll_bwd(lp, ext, il, tl, alpha, nll, g, ctx.blank),
                None, None, None, None)


def ctc_nll_bwd(lp, ext, il, tl, alpha, nll, g, blank: int) -> torch.Tensor:
    """d(sum_b g[b] * nll[b]) / d log_probs (B, T, V) fp32 from the saved
    forward: the backward kernel, then the one-hot scatter onto V."""
    b, t_max, v = lp.shape
    l = ext.shape[1]
    g = g.float().contiguous()
    dlab = torch.empty((b, t_max, l), device=lp.device)
    tensors = (lp, ext, il, tl, alpha, nll, g, dlab)
    K.check_cuda("ctc_nll_bwd", *tensors)
    K.call("tat_ctc_bwd", _BWD_ARGS, lp.device,
           *(z.data_ptr() for z in tensors), b, t_max, v, l, blank)
    ctc_nll_bwd.launches += 1
    onehot = F.one_hot(ext.long(), v).float()               # (B, L, V)
    return torch.bmm(dlab, onehot)


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
