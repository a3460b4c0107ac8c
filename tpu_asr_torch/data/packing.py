"""Packed-segment batching for serving and training: the port's copy of
tpu_asr/data/packing.py (the plan is numpy; the gather is one torch index
on the device).

Several utterances go end to end into one encoder row, separated by
zeroed guard frames:

    row 0: [ utt 3 ....... |g| utt 7 .... |g| utt 12 .. |  pad ]
    row 1: [ utt 1 ......... |g| utt 9 ...... |g| utt 4 ...... ]

Packing happens after the subsampling pre-encode (`CTCModel.pre_encode`),
so the frontend and subsampling see ordinary per-utterance batches. The
encoder then attends within segments only (seg_id[t] == seg_id[s], the
segment mode of `fused_relpos_attention_block`), relative-position scores
are translation-invariant, and every layer zeroes guard frames, so the
depthwise conv reads only zeros across a guard of at least (k - 1) / 2
frames: a segment's log-probs are those of its per-utterance forward.
Training (`train_pack_arrays`) plans a batch from its sample counts alone,
through the length arithmetic of the featurizer and the subsampling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch


def guard_frames(conv_kernel_size: int) -> int:
    """Smallest gap (post-subsampling frames) that keeps the depthwise conv
    from reading a neighbouring segment: (k - 1) / 2, rounded up to a
    multiple of 8, at least 8."""
    need = (conv_kernel_size - 1) // 2
    return max(8, -(-need // 8) * 8)


@dataclass
class PackPlan:
    """Placement of N segments into (n_rows, t_pack) packed rows.

    Per utterance (length N): `row`, `start`, `length`. Per packed frame
    (n_rows, t_pack): `src_utt` and `src_pos` index the (N, T_src, D)
    per-utterance frames; `seg_id` is the segment map (0 = guard/pad, else
    the 1-based index of the segment within its row)."""

    t_pack: int
    n_rows: int
    row: np.ndarray          # (N,) int32
    start: np.ndarray        # (N,) int32
    length: np.ndarray       # (N,) int32
    seg_id: np.ndarray       # (n_rows, t_pack) int32
    src_utt: np.ndarray      # (n_rows, t_pack) int32
    src_pos: np.ndarray      # (n_rows, t_pack) int32

    @property
    def fill_ratio(self) -> float:
        return float(self.length.sum()) / (self.n_rows * self.t_pack)


def plan_packing(lengths: Sequence[int], t_pack: int, guard: int,
                 row_multiple: int = 1, pad_rows_to: int = 0) -> PackPlan:
    """First-fit-decreasing packing of segments of `lengths` frames into
    rows of `t_pack` frames, `guard` zeroed frames between neighbours (none
    before the first or after the last). `row_multiple` rounds the row
    count up; `pad_rows_to` sets it exactly (one shape for the batches of
    a bucket), adding all-guard rows."""
    lengths = np.asarray(lengths, np.int64)
    n = len(lengths)
    if n and int(lengths.max()) > t_pack:
        raise ValueError(f"segment of {int(lengths.max())} frames exceeds "
                         f"t_pack={t_pack}")
    if (lengths <= 0).any():
        raise ValueError("all segment lengths must be positive")
    order = np.argsort(-lengths, kind="stable")
    row = np.zeros(n, np.int32)
    start = np.zeros(n, np.int32)
    cursors: List[int] = []            # next free frame per row
    for i in order:
        ln = int(lengths[i])
        for r, cur in enumerate(cursors):
            need = cur + (guard if cur else 0)
            if need + ln <= t_pack:
                row[i], start[i] = r, need
                cursors[r] = need + ln
                break
        else:
            row[i], start[i] = len(cursors), 0
            cursors.append(ln)
    n_rows = max(len(cursors), 1)
    n_rows = -(-n_rows // row_multiple) * row_multiple
    if pad_rows_to:
        if len(cursors) > pad_rows_to:
            raise ValueError(f"packing needs {len(cursors)} rows > "
                             f"pad_rows_to={pad_rows_to}")
        n_rows = pad_rows_to

    seg_id = np.zeros((n_rows, t_pack), np.int32)
    src_utt = np.zeros((n_rows, t_pack), np.int32)
    src_pos = np.zeros((n_rows, t_pack), np.int32)
    per_row_next = np.zeros(n_rows, np.int32)
    for i in np.lexsort((start, row)):     # 1-based ids in start order
        r, s, ln = int(row[i]), int(start[i]), int(lengths[i])
        per_row_next[r] += 1
        seg_id[r, s:s + ln] = per_row_next[r]
        src_utt[r, s:s + ln] = i
        src_pos[r, s:s + ln] = np.arange(ln)
    return PackPlan(t_pack=t_pack, n_rows=n_rows, row=row, start=start,
                    length=lengths.astype(np.int32), seg_id=seg_id,
                    src_utt=src_utt, src_pos=src_pos)


def pack_frames(feats: torch.Tensor, plan: PackPlan,
                utt_rows: Optional[np.ndarray] = None) -> torch.Tensor:
    """Gather per-utterance frames (N', T_src, D) into packed rows
    (n_rows, t_pack, D) on feats' device, guard/pad frames zeroed.
    Utterance i lies in row `utt_rows[i]` of feats (default: row i)."""
    src_utt = plan.src_utt if utt_rows is None else \
        np.asarray(utt_rows)[plan.src_utt]
    idx = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
        feats.device)
    packed = feats[idx(src_utt), idx(plan.src_pos)]
    valid = torch.from_numpy(plan.seg_id > 0).to(feats.device)
    return packed.masked_fill(~valid[..., None], 0)


def train_pack_arrays(signal_lens, n_fft: int, hop_length: int,
                      subsampling_factor: int, subsampling: str,
                      conv_kernel_size: int, t_pack: int,
                      row_multiple: int = 1, pad_rows_to: int = 0):
    """The packed-training plan of one batch from its (B,) sample counts,
    through the frame arithmetic alone (stft_seq_len, then
    subsampled_length; no model runs): ({'pk_src_utt', 'pk_src_pos',
    'pk_seg'}: (R, Tp) int32, {'pk_row', 'pk_start'}: (B,) int32 numpy
    arrays, for train/trainer.make_distil_train_step(packed=True)), and the
    PackPlan. The port subsamples by 'striding' only."""
    from tpu_asr_torch.models.conformer import subsampled_length
    from tpu_asr_torch.ops.features import stft_seq_len

    if subsampling != "striding":
        raise ValueError(f"train_pack_arrays: tpu_asr_torch subsamples by "
                         f"'striding' only (got {subsampling!r})")
    lens = np.asarray(signal_lens, np.int64)
    enc = subsampled_length(stft_seq_len(lens, n_fft, hop_length),
                            subsampling_factor)
    plan = plan_packing(enc, t_pack=t_pack,
                        guard=guard_frames(conv_kernel_size),
                        row_multiple=row_multiple, pad_rows_to=pad_rows_to)
    return {"pk_src_utt": plan.src_utt.astype(np.int32),
            "pk_src_pos": plan.src_pos.astype(np.int32),
            "pk_seg": plan.seg_id.astype(np.int32),
            "pk_row": plan.row.astype(np.int32),
            "pk_start": plan.start.astype(np.int32)}, plan


def unpack_rows(rows, plan: PackPlan) -> List[np.ndarray]:
    """Split per-frame outputs (n_rows, t_pack, ...) back into N
    per-utterance numpy arrays."""
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    rows = np.asarray(rows)
    return [rows[plan.row[i], plan.start[i]:plan.start[i] + plan.length[i]]
            for i in range(len(plan.row))]
