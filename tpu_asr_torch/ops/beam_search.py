"""Batched CTC prefix beam search on the device: the PyTorch counterpart of
tpu_asr/ops/beam_search.py (JAX's `lax.scan` over frames becomes a Python
loop of device ops with no host synchronisation inside it, so a later
change can capture it in a CUDA graph). The host prefix search
(ops/decoding.py::ctc_prefix_beam_search) is its semantics oracle.

- The beam state is fixed-width tensors: token buffers (B, W, L), lengths,
  last tokens, (p_blank, p_non_blank) in log space and two 32-bit rolling
  prefix hashes (the merge key). Torch has no unsigned 32-bit multiply on
  the device, so the hashes live in int64 and each product is split into
  16-bit halves that never overflow: the values are JAX's uint32 ones.
- Each frame scores a (B, W * V) grid: slot (j, c) extends beam j by token
  c, and the blank slot is beam j's "stay" (its blank transition and its
  same-symbol continuation).
- A live prefix has at most two producers, its beam's stay and one extend
  of its parent, so merging is a (B, W, V, W) hash match of the extends
  against the beams: a matched extend joins that beam's stay slot.
  Duplicate beams (possible when fewer finite candidates than W exist)
  fold into the earliest at the start of each frame.
- The best W candidates are taken by a stable descending sort: among equal
  scores the lower slot first, as `lax.top_k` keeps them (`torch.topk`
  promises no order for ties on the card).
- Frames past a sample's length are identity steps (a state select).

Shallow fusion: `word_bonus` on every extension; `bigram_lm` (V, V)
log P(col | row), row `blank` the start; `ngram_tables` (scores (S, V),
next_state (S, V), init_state) from NgramLM.to_dense_automaton, each beam
carrying its automaton state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1.0e30
MASK32 = 0xFFFFFFFF
# rolling-hash multipliers (odd, so invertible mod 2^32)
H1_MULT = 0x9E3779B1      # golden-ratio constant
H2_MULT = 0x85EBCA77      # murmur3 constant


def _lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp(a) + exp(b)) floored at NEG_INF, as JAX's `_lse`."""
    m_safe = torch.maximum(a, b).clamp(min=NEG_INF)
    return m_safe + torch.log1p(torch.exp(torch.minimum(a, b) - m_safe))


def _roll(h: torch.Tensor, mult: int, tok: torch.Tensor) -> torch.Tensor:
    """(h * mult + tok) mod 2^32 for int64 h < 2^32, tok < 2^16: the
    product in 16-bit halves of h, each below 2^48."""
    hi, lo = h >> 16, h & 0xFFFF
    return ((((hi * mult) & 0xFFFF) << 16) + lo * mult + tok) & MASK32


def ctc_beam_search_batched(
        log_probs: torch.Tensor, lengths: torch.Tensor, beam_width: int = 16,
        blank: Optional[int] = None, word_bonus: float = 0.0,
        bigram_lm: Optional[torch.Tensor] = None, lm_weight: float = 1.0,
        max_tokens: Optional[int] = None, ngram_tables=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, V) log-softmax and (B,) valid frames -> (tokens (B, W, L)
    int32, token_lens (B, W) int32, scores (B, W) fp32), beams sorted best
    first, on the log-probs' device. L = max_tokens or T."""
    dev = log_probs.device
    b, t_max, v = log_probs.shape
    w = beam_width
    blank = v - 1 if blank is None else blank
    l_cap = int(max_tokens or t_max)
    lp_all = log_probs.float()
    if bigram_lm is not None and ngram_tables is not None:
        raise ValueError("pass bigram_lm or ngram_tables, not both")
    if bigram_lm is not None:
        lm_tab = lm_weight * torch.as_tensor(bigram_lm, device=dev).float()
    if ngram_tables is not None:
        lm_scores = lm_weight * torch.as_tensor(ngram_tables[0],
                                                device=dev).float()
        lm_next = torch.as_tensor(ngram_tables[1], device=dev).long()

    tok_ids = torch.arange(v, device=dev)
    tok_u = tok_ids + 2
    is_ext = tok_ids != blank
    lower = torch.ones(w, w, dtype=torch.bool, device=dev).tril(-1)
    l_idx = torch.arange(l_cap, device=dev)
    first_beam = torch.arange(w, device=dev) == 0

    def beam0(value, other, dtype):
        return torch.where(first_beam, value, other).to(dtype).expand(
            b, w).clone()

    buf = torch.zeros(b, w, l_cap, dtype=torch.int32, device=dev)
    length = torch.zeros(b, w, dtype=torch.int64, device=dev)
    last = torch.full((b, w), -1, dtype=torch.int64, device=dev)
    pb = beam0(0.0, NEG_INF, torch.float32)
    pnb = torch.full((b, w), NEG_INF, device=dev)
    h1 = beam0(1, 0, torch.int64)
    h2 = h1.clone()
    lm_s = (torch.full((b, w), int(ngram_tables[2]), dtype=torch.int64,
                       device=dev) if ngram_tables is not None else None)
    active_all = (torch.arange(t_max, device=dev)[:, None]
                  < lengths.to(dev)[None, :])                 # (T, B)
    neg = torch.tensor(NEG_INF, device=dev)

    for t in range(t_max):
        lp, active = lp_all[:, t], active_all[t]
        # fold later twin beams (equal hashes) into the earliest
        eq = ((h1[:, :, None] == h1[:, None, :])
              & (h2[:, :, None] == h2[:, None, :]))          # (B, W, W)
        has_earlier = (eq & lower).any(dim=2)
        into = eq & lower.T & ~has_earlier[:, :, None]
        inflow_pb = torch.logsumexp(
            torch.where(into, pb[:, None, :], neg), dim=2)
        inflow_pnb = torch.logsumexp(
            torch.where(into, pnb[:, None, :], neg), dim=2)
        pb = torch.where(has_earlier, neg, _lse(pb, inflow_pb))
        pnb = torch.where(has_earlier, neg, _lse(pnb, inflow_pnb))

        p_tot = _lse(pb, pnb)
        lp_last = torch.gather(lp, 1, last.clamp(min=0))     # (B, W)
        has_last = length > 0
        is_rep = tok_ids == last[:, :, None]                 # (B, W, V)
        base = torch.where(is_rep, pb[:, :, None], p_tot[:, :, None])
        cand_pnb = base + lp[:, None, :] + word_bonus        # extends
        if bigram_lm is not None:
            cand_pnb = cand_pnb + lm_tab[torch.where(has_last, last, blank)]
        if lm_s is not None:
            cand_pnb = cand_pnb + lm_scores[lm_s]
        stay_pb = p_tot + lp[:, blank, None]
        stay_pnb = pnb + torch.where(has_last, lp_last, neg)
        rh1 = _roll(h1[:, :, None], H1_MULT, tok_u)          # (B, W, V)
        rh2 = _roll(h2[:, :, None], H2_MULT, tok_u)

        # an extend that rebuilds an existing beam's prefix joins its stay
        match = ((rh1[..., None] == h1[:, None, None, :])
                 & (rh2[..., None] == h2[:, None, None, :])
                 & is_ext[:, None])                          # (B, W, V, Wq)
        first = match & (match.cumsum(dim=-1) == 1)
        absorbed = torch.where(first, cand_pnb[..., None], neg).amax(
            dim=(1, 2))                                      # (B, Wq)
        stay_pnb = _lse(stay_pnb, absorbed)
        cand_pnb = torch.where(first.any(dim=-1), neg, cand_pnb)

        stay = tok_ids == blank
        cand_pb = torch.where(stay, stay_pb[:, :, None], neg)
        cand_pnb = torch.where(stay, stay_pnb[:, :, None], cand_pnb)
        ch1 = torch.where(stay, h1[:, :, None], rh1).reshape(b, w * v)
        ch2 = torch.where(stay, h2[:, :, None], rh2).reshape(b, w * v)
        cand_pb, cand_pnb = cand_pb.reshape(b, w * v), cand_pnb.reshape(
            b, w * v)
        totals = _lse(cand_pb, cand_pnb)
        top = torch.sort(totals, dim=1, descending=True,
                         stable=True).indices[:, :w]         # (B, W)
        sel_parent, sel_tok = top // v, top % v
        is_stay = sel_tok == blank

        parent_buf = torch.gather(buf, 1, sel_parent[:, :, None].expand(
            -1, -1, l_cap))
        parent_len = torch.gather(length, 1, sel_parent)
        parent_last = torch.gather(last, 1, sel_parent)
        write = ((l_idx == parent_len.clamp(max=l_cap - 1)[:, :, None])
                 & ~is_stay[:, :, None])
        sel = lambda new, old: torch.where(
            active.view(-1, *([1] * (new.dim() - 1))), new, old)
        buf = sel(torch.where(write, sel_tok[:, :, None].to(torch.int32),
                              parent_buf), buf)
        if lm_s is not None:
            parent_lm = torch.gather(lm_s, 1, sel_parent)
            lm_s = sel(torch.where(is_stay, parent_lm,
                                   lm_next[parent_lm, sel_tok]), lm_s)
        length = sel(parent_len + (~is_stay).long(), length)
        last = sel(torch.where(is_stay, parent_last, sel_tok), last)
        pb = sel(torch.gather(cand_pb, 1, top), pb)
        pnb = sel(torch.gather(cand_pnb, 1, top), pnb)
        h1 = sel(torch.gather(ch1, 1, top), h1)
        h2 = sel(torch.gather(ch2, 1, top), h2)

    totals = _lse(pb, pnb)
    order = torch.sort(totals, dim=1, descending=True, stable=True).indices
    tokens = torch.gather(buf, 1, order[:, :, None].expand(-1, -1, l_cap))
    return (tokens, torch.gather(length, 1, order).to(torch.int32),
            torch.gather(totals, 1, order))
