"""N-gram language model for beam-search fusion: the port's own copy of
tpu_asr/ops/ngram_lm.py (standard library, numpy for the dense tables),
KenLM's role in NeMo's beam decoders.

- `NgramLM.train(...)`: interpolated Kneser-Ney estimation over token (or
  word) sequences, the smoothing family KenLM implements;
- ARPA save and load (interoperable with KenLM's files);
- `lm_score_fn()`: the scoring hook of the host prefix search
  (ops/decoding.py) with standard backoff queries (p(w|h) = stored if
  (h, w) is, else bo(h) * p(w|h'));
- `to_dense_automaton()`: the LM as dense (state, token) tables for the
  on-device beam search (ops/beam_search.py).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LOG10 = math.log(10.0)

BOS = -1   # sentence-start sentinel (ARPA <s>)
EOS = -2   # sentence-end sentinel (ARPA </s>)
UNK = -3   # unknown token (ARPA <unk>)

_SPECIAL_TO_STR = {BOS: "<s>", EOS: "</s>", UNK: "<unk>"}
_STR_TO_SPECIAL = {v: k for k, v in _SPECIAL_TO_STR.items()}


class NgramLM:
    """Backoff n-gram LM. `probs[k]` maps k-gram tuples to natural-log
    conditional probabilities; `backoffs[k]` maps k-gram contexts to
    natural-log backoff weights."""

    def __init__(self, order: int):
        self.order = order
        self.probs: List[Dict[Tuple[int, ...], float]] = [
            {} for _ in range(order + 1)]      # probs[k]: k-grams
        self.backoffs: List[Dict[Tuple[int, ...], float]] = [
            {} for _ in range(order)]          # backoffs[k]: k-gram contexts

    # ------------------------------------------------------------- training
    @classmethod
    def train(cls, sequences: Iterable[Sequence[int]], order: int = 3,
              discount: float = 0.75) -> "NgramLM":
        """Interpolated Kneser-Ney estimation (fixed discount).

        sequences: token-id sequences (one per sentence/utterance).
        """
        if order < 1:
            raise ValueError("order must be >= 1")
        # raw counts per order; highest order uses actual counts, lower orders
        # use continuation counts (Kneser-Ney).
        counts: List[Dict[Tuple[int, ...], int]] = [
            defaultdict(int) for _ in range(order + 1)]
        for seq in sequences:
            toks = [BOS] * (order - 1) + [int(t) for t in seq] + [EOS]
            lo = order - 1 if order > 1 else 0
            for i in range(lo, len(toks)):
                for k in range(1, order + 1):
                    if i - k + 1 < 0:
                        continue
                    gram = tuple(toks[i - k + 1: i + 1])
                    # skip grams that are entirely BOS padding
                    if all(g == BOS for g in gram):
                        continue
                    counts[k][gram] += 1

        # continuation counts: N1+(• g) for lower orders
        cont: List[Dict[Tuple[int, ...], int]] = [
            defaultdict(int) for _ in range(order)]
        if order > 1:
            for k in range(2, order + 1):
                seen = set(counts[k].keys())
                for gram in seen:
                    cont[k - 1][gram[1:]] += 1

        lm = cls(order)

        def ctx_totals(table: Dict[Tuple[int, ...], int], k: int):
            tot: Dict[Tuple[int, ...], int] = defaultdict(int)
            nfollow: Dict[Tuple[int, ...], int] = defaultdict(int)
            for gram, c in table.items():
                tot[gram[:-1]] += c
                nfollow[gram[:-1]] += 1
            return tot, nfollow

        # unigram (lowest order): continuation distribution
        if order == 1:
            uni = counts[1]
            total = sum(uni.values())
            vocab = len(uni)
            for (w,), c in uni.items():
                lm.probs[1][(w,)] = math.log(
                    (c + 1.0) / (total + vocab + 1.0))   # add-one floor
            lm._unk_logp = math.log(1.0 / (total + vocab + 1.0))
            return lm

        uni_table = cont[1] if any(cont[1].values()) else counts[1]
        total_cont = sum(uni_table.values())
        n_types = len(uni_table) + 1
        interp: Dict[Tuple[int, ...], float] = {}
        for (w,), c in uni_table.items():
            interp[(w,)] = max(c - discount, 0.0) / total_cont + \
                discount * len(uni_table) / total_cont * (1.0 / n_types)
        lm._unk_logp = math.log(discount * len(uni_table) /
                                total_cont * (1.0 / n_types))
        for g, p in interp.items():
            lm.probs[1][g] = math.log(p)
        # interpolated estimates already carry the lower-order mass, so the
        # empty-context backoff weight is 1 (log 0)
        lm.backoffs[0][()] = 0.0

        prev_interp = interp
        for k in range(2, order + 1):
            table = counts[k] if k == order else (
                cont[k] if any(cont[k].values()) else counts[k])
            tot, nfollow = ctx_totals(table, k)
            cur: Dict[Tuple[int, ...], float] = {}
            for gram, c in table.items():
                ctx = gram[:-1]
                t = tot[ctx]
                lam = discount * nfollow[ctx] / t
                lower = prev_interp.get(gram[1:], math.exp(lm._unk_logp))
                cur[gram] = max(c - discount, 0.0) / t + lam * lower
            for gram, p in cur.items():
                lm.probs[k][gram] = math.log(p)
            for ctx in tot:
                lam = discount * nfollow[ctx] / tot[ctx]
                lm.backoffs[k - 1][ctx] = math.log(lam) if lam > 0 else -99.0
            prev_interp = cur
        return lm

    # -------------------------------------------------------------- queries
    def log_prob(self, context: Sequence[int], token: int) -> float:
        """Natural-log p(token | context) with standard backoff semantics."""
        ctx = tuple(context)[-(self.order - 1):] if self.order > 1 else ()
        offset = 0.0
        while True:
            p = self.probs[len(ctx) + 1].get(ctx + (token,))
            if p is not None:
                return offset + p
            if not ctx:
                return offset + self._unk_logp
            offset += self.backoffs[len(ctx)].get(ctx, 0.0)
            ctx = ctx[1:]

    def score_sequence(self, tokens: Sequence[int], bos: bool = True,
                       eos: bool = True) -> float:
        """Total natural-log probability of a token sequence."""
        hist: List[int] = [BOS] * (self.order - 1) if bos else []
        total = 0.0
        seq = list(tokens) + ([EOS] if eos else [])
        for t in seq:
            total += self.log_prob(hist, int(t))
            hist.append(int(t))
        return total

    def lm_score_fn(self):
        """Adapter for ctc_prefix_beam_search(lm_score_fn=...): called with
        (prefix_tuple, candidate_token) -> log p(candidate | prefix)."""
        pad = (BOS,) * (self.order - 1)

        def fn(prefix: Tuple[int, ...], token: int) -> float:
            ctx = (pad + tuple(prefix))[-(self.order - 1):] \
                if self.order > 1 else ()
            return self.log_prob(ctx, token)

        return fn

    # ------------------------------------------------------- device compile
    def to_dense_automaton(self, vocab_size: int):
        """Compile the backoff LM into a dense finite-state automaton for
        on-device beam fusion (ops/beam_search.py `ngram_tables`): one
        gather per beam extension instead of a host callback per
        candidate.

        Returns (scores (S, V) f32, next_state (S, V) i32, init_state int):
        `scores[s, v]` = backoff-resolved natural-log p(v | context s),
        `next_state[s, v]` = automaton state after emitting v in state s,
        `init_state` = the <s> (BOS) context state.

        Exactly `lm_score_fn`'s scores (tests/test_torch_beam_search.py):
        states are the stored contexts (every context that has stored
        continuations or a backoff weight); reducing a history to its
        longest stored-context suffix cannot change any future query, since
        absent contexts contribute backoff 0.0 and have no stored n-grams.
        """
        # state set: all contexts with stored continuations or backoffs
        ctxs = {()}
        for k in range(1, self.order):
            ctxs.update(self.backoffs[k].keys())
            ctxs.update(key[:-1] for key in self.probs[k + 1].keys())

        def reduce(ctx):
            ctx = tuple(ctx)[-(self.order - 1):] if self.order > 1 else ()
            while ctx not in ctxs:
                ctx = ctx[1:]
            return ctx

        states = sorted(ctxs, key=lambda c: (len(c), c))
        sid = {c: i for i, c in enumerate(states)}
        import numpy as np
        scores = np.empty((len(states), vocab_size), np.float32)
        nxt = np.empty((len(states), vocab_size), np.int32)
        for c, i in sid.items():
            for v in range(vocab_size):
                scores[i, v] = self.log_prob(c, v)
                nxt[i, v] = sid[reduce(c + (v,))]
        init_state = sid[reduce((BOS,) * max(self.order - 1, 1))]
        return scores, nxt, init_state

    # ----------------------------------------------------------------- ARPA
    def save_arpa(self, path: str, id_to_str=None) -> None:
        """Write the standard ARPA format (log10 probs, KenLM-compatible)."""
        to_s = id_to_str or (lambda i: _SPECIAL_TO_STR.get(i, str(i)))
        with open(path, "w") as f:
            f.write("\\data\\\n")
            for k in range(1, self.order + 1):
                f.write(f"ngram {k}={len(self.probs[k])}\n")
            f.write("\n")
            for k in range(1, self.order + 1):
                f.write(f"\\{k}-grams:\n")
                for gram, lp in sorted(self.probs[k].items()):
                    words = " ".join(to_s(g) for g in gram)
                    line = f"{lp / LOG10:.7f}\t{words}"
                    if k < self.order:
                        bo = self.backoffs[k].get(gram)
                        if bo is not None:
                            line += f"\t{bo / LOG10:.7f}"
                    f.write(line + "\n")
                f.write("\n")
            f.write("\\end\\\n")

    @classmethod
    def load_arpa(cls, path: str, str_to_id=None) -> "NgramLM":
        """Read an ARPA file (as produced by this module or by KenLM)."""
        to_i = str_to_id or (
            lambda s: (_STR_TO_SPECIAL.get(s, None) if not _is_int(s)
                       else int(s)))
        orders: List[int] = []
        with open(path) as f:
            lines = [ln.rstrip("\n") for ln in f]
        i = 0
        while i < len(lines) and lines[i].strip() != "\\data\\":
            i += 1
        i += 1
        while i < len(lines) and lines[i].strip().startswith("ngram"):
            orders.append(int(lines[i].split("=")[0].split()[1]))
            i += 1
        order = max(orders) if orders else 1
        lm = cls(order)
        lm._unk_logp = math.log(1e-10)
        k = 0
        while i < len(lines):
            s = lines[i].strip()
            if s.startswith("\\") and s.endswith("-grams:"):
                k = int(s[1:].split("-")[0])
            elif s and s != "\\end\\" and k > 0:
                parts = s.split("\t")
                if len(parts) == 1:
                    parts = s.split()
                    lp, words, bo = parts[0], parts[1:1 + k], \
                        parts[1 + k:] or [None]
                    bo = bo[0]
                else:
                    lp, words = parts[0], parts[1].split()
                    bo = parts[2] if len(parts) > 2 else None
                ids = tuple(to_i(w) for w in words)
                if any(x is None for x in ids):
                    i += 1
                    continue
                lm.probs[k][ids] = float(lp) * LOG10
                if bo is not None and k < order:
                    lm.backoffs[k][ids] = float(bo) * LOG10
                if ids == (UNK,):
                    lm._unk_logp = float(lp) * LOG10
            i += 1
        return lm


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def train_ngram_from_manifest(manifest_path: str, tokenizer, order: int = 3,
                              discount: float = 0.75) -> NgramLM:
    """Train a subword n-gram LM from a NeMo-style JSONL manifest's `text`
    fields — the self-contained equivalent of NeMo's
    train_kenlm.py over tokenized transcripts."""
    import json
    seqs = []
    with open(manifest_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            text = json.loads(line).get("text", "")
            if text:
                seqs.append(tokenizer.text_to_ids(text))
    return NgramLM.train(seqs, order=order, discount=discount)
