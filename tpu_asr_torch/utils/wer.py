"""Word error rate: the port's own copy of tpu_asr/utils/wer.py (NeMo's WER
helpers, reference wer.py:35-208, and the accumulating metric of
wer.py:210-359). Edit distances run in the native library (tpu_asr_torch/
native, a copy of native/editdistance.c, built at first use);
`edit_distance_plain` is its pure-Python version. A distributed evaluation
sums the (scores, words) pair across processes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple


def edit_distance_plain(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance in Python: the native one's plain version."""
    n, m = len(a), len(b)
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ai = a[i - 1]
        for j in range(1, m + 1):
            cur[j] = min(prev[j - 1] + (ai != b[j - 1]), prev[j] + 1,
                         cur[j - 1] + 1)
        prev = cur
    return prev[m]


def _edit_distance(a: Sequence, b: Sequence) -> int:
    from tpu_asr_torch.native import edit_distance as native
    return native(a, b)


def edit_distance(a: Sequence, b: Sequence) -> int:
    return _edit_distance(a, b)


def word_error_rate(hypotheses: List[str], references: List[str], use_cer: bool = False) -> float:
    """Aggregate WER over lists of utterances (reference wer.py:35-80 semantics:
    sum of edit distances / sum of reference lengths)."""
    scores, words = 0, 0
    if len(hypotheses) != len(references):
        raise ValueError(
            f"hypotheses/references count mismatch: {len(hypotheses)} vs {len(references)}"
        )
    for h, r in zip(hypotheses, references):
        h_list = list(h) if use_cer else h.split()
        r_list = list(r) if use_cer else r.split()
        words += len(r_list)
        scores += _edit_distance(h_list, r_list)
    return scores / words if words != 0 else float("inf")


def word_error_rate_detail(
    hypotheses: List[str], references: List[str], use_cer: bool = False
) -> Tuple[float, int, float, float, float]:
    """(wer, total_words, ins_rate, del_rate, sub_rate) — reference wer.py:83-145."""
    scores, words, ops_count = 0, 0, {"ins": 0, "del": 0, "sub": 0}
    for h, r in zip(hypotheses, references):
        h_list = list(h) if use_cer else h.split()
        r_list = list(r) if use_cer else r.split()
        words += len(r_list)
        ins, dels, subs = _alignment_counts(h_list, r_list)
        ops_count["ins"] += ins
        ops_count["del"] += dels
        ops_count["sub"] += subs
        scores += ins + dels + subs
    if words == 0:
        return float("inf"), 0, float("inf"), float("inf"), float("inf")
    return (
        scores / words,
        words,
        ops_count["ins"] / words,
        ops_count["del"] / words,
        ops_count["sub"] / words,
    )


def word_error_rate_per_utt(
    hypotheses: List[str], references: List[str], use_cer: bool = False
) -> Tuple[List[float], float]:
    """Per-utterance WERs + aggregate (reference wer.py:148-208)."""
    wers, scores, words = [], 0, 0
    for h, r in zip(hypotheses, references):
        h_list = list(h) if use_cer else h.split()
        r_list = list(r) if use_cer else r.split()
        d = _edit_distance(h_list, r_list)
        wers.append(d / len(r_list) if r_list else float("inf"))
        scores += d
        words += len(r_list)
    return wers, (scores / words if words else float("inf"))


def _alignment_counts(hyp: List, ref: List) -> Tuple[int, int, int]:
    """(insertions, deletions, substitutions) via DP backtrace."""
    n, m = len(ref), len(hyp)
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        dp[i][0] = i
    for j in range(m + 1):
        dp[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            dp[i][j] = min(
                dp[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]),
                dp[i - 1][j] + 1,   # deletion
                dp[i][j - 1] + 1,   # insertion
            )
    ins = dels = subs = 0
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1] and ref[i - 1] == hyp[j - 1]:
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1] + 1:
            subs += 1
            i, j = i - 1, j - 1
        elif j > 0 and dp[i][j] == dp[i][j - 1] + 1:
            ins += 1
            j -= 1
        else:
            dels += 1
            i -= 1
    return ins, dels, subs


@dataclass
class WERMetric:
    """Accumulating WER over batches (reference wer.py:210-359): a plain
    (scores, words) int pair."""

    use_cer: bool = False
    scores: int = 0
    words: int = 0

    def update(self, hypotheses: List[str], references: List[str]) -> None:
        for h, r in zip(hypotheses, references):
            h_list = list(h) if self.use_cer else h.split()
            r_list = list(r) if self.use_cer else r.split()
            self.scores += _edit_distance(h_list, r_list)
            self.words += len(r_list)

    def merge(self, other: "WERMetric") -> None:
        self.scores += other.scores
        self.words += other.words

    def compute(self) -> float:
        return self.scores / self.words if self.words else float("inf")

    def reset(self) -> None:
        self.scores = 0
        self.words = 0
