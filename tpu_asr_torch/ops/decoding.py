"""CTC decoding strategies and Hypothesis: the PyTorch counterpart of
tpu_asr/ops/decoding.py (NeMo's ctc_decoding / rnnt_utils.Hypothesis
contract).

- greedy / greedy_batch: the collapse on the log-probs' device
  (ops/ctc.py); with timestamps, confidence (ops/confidence.py) or
  alignments, the full payload (`_greedy_full`): decode and frame
  confidence on the device, offsets and pooling on the host;
  `greedy_ids_predictions` decodes the model's own argmax ids (the
  Transcribers' fast path, no (B, T, V) tensor read again);
- beam: the host prefix beam search (Hannun et al. 2014; numpy, the
  oracle of the device search), with an LM scoring hook, a word bonus and
  a lexicon trie (`pyctcdecode` and `flashlight` name it too);
- beam_batch: the batched search on the log-probs' device
  (ops/beam_search.py) with word bonus, a dense bigram table or an n-gram
  LM compiled to dense tables (ops/ngram_lm.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_asr_torch.ops.ctc import (ctc_greedy_decode, ctc_greedy_decode_full,
                                   ctc_greedy_decode_ids)

NEG_INF = -float("inf")


@dataclass
class Hypothesis:
    """Decoding hypothesis (NeMo rnnt_utils.Hypothesis contract subset).

    timestamp: with compute_timestamps it is the NeMo dict shape
    {'timestep': [token start frames], 'char': [offset dicts],
     'word': [offset dicts], 'segment': [offset dicts]}
    (test_timestamps.py:142-153); otherwise an empty list.
    alignments: with preserve_alignments, (labels (T,), log_probs (T, V)) —
    the raw per-frame argmax before CTC collapse plus the frame posteriors.
    frame/token/word_confidence: per ConfidenceConfig (ops/confidence.py)."""

    score: float
    y_sequence: List[int]
    text: Optional[str] = None
    timestamp: object = field(default_factory=list)
    alignments: Optional[tuple] = None
    frame_confidence: Optional[List[float]] = None
    token_confidence: Optional[List[float]] = None
    word_confidence: Optional[List[float]] = None


def _logsumexp(*xs: float) -> float:
    m = max(xs)
    if m == NEG_INF:
        return NEG_INF
    return m + math.log(sum(math.exp(x - m) for x in xs))


class Lexicon:
    """Token-id trie over an allowed word list — the flashlight/pyctcdecode
    lexicon-constrained strategy (SURVEY.md N10 beam externals): beam
    extensions must stay on a trie path; a completed word may chain into the
    next word from the root.

    Build from word token-id sequences (each word tokenized STANDALONE so a
    BPE/SPM first piece carries its word-boundary marker):
    `Lexicon(tokenizer.text_to_ids(w) for w in words)`."""

    _ROOT = 0

    def __init__(self, word_id_seqs):
        self._children: List[dict] = [{}]
        self._terminal: List[bool] = [False]
        for seq in word_id_seqs:
            node = self._ROOT
            for tok in seq:
                nxt = self._children[node].get(tok)
                if nxt is None:
                    nxt = len(self._children)
                    self._children.append({})
                    self._terminal.append(False)
                    self._children[node][tok] = nxt
                node = nxt
            self._terminal[node] = True

    def start(self) -> int:
        return self._ROOT

    def step(self, state: int, token: int) -> Optional[int]:
        """Next trie state after emitting `token`, or None (prune). A
        terminal state may restart from the root (next word)."""
        nxt = self._children[state].get(token)
        if nxt is not None:
            return nxt
        if self._terminal[state]:
            return self._children[self._ROOT].get(token)
        return None

    def is_terminal(self, state: int) -> bool:
        return self._terminal[state]


def ctc_prefix_beam_search(
    log_probs: np.ndarray,          # (T, V) log-softmax; blank = V-1
    seq_len: Optional[int] = None,
    beam_width: int = 16,
    blank: Optional[int] = None,
    lm_score_fn: Optional[Callable[[Tuple[int, ...], int], float]] = None,
    lm_weight: float = 0.0,
    word_bonus: float = 0.0,
    lexicon: Optional[Lexicon] = None,
) -> List[Hypothesis]:
    """Single-utterance prefix beam search. Returns hypotheses sorted by
    total log-probability (best first). With `lexicon`, extensions that
    leave the word trie are pruned (flashlight-style constrained search)."""
    t_max, v = log_probs.shape
    if blank is None:
        blank = v - 1
    if seq_len is not None:
        t_max = min(t_max, int(seq_len))
    states: dict = {(): lexicon.start()} if lexicon is not None else {}

    # prefix -> (log p ending in blank, log p ending in non-blank)
    beams = {(): (0.0, NEG_INF)}
    for t in range(t_max):
        lp = log_probs[t]
        # prune vocabulary to the top candidates for speed
        k = min(beam_width * 2, v)
        topk = np.argpartition(lp, -k)[-k:]
        next_beams: dict = {}

        def add(prefix, pb, pnb):
            old_pb, old_pnb = next_beams.get(prefix, (NEG_INF, NEG_INF))
            next_beams[prefix] = (_logsumexp(old_pb, pb),
                                  _logsumexp(old_pnb, pnb))

        for prefix, (p_b, p_nb) in beams.items():
            p_tot = _logsumexp(p_b, p_nb)
            for c in topk:
                c = int(c)
                p_c = float(lp[c])
                if c == blank:
                    add(prefix, p_tot + p_c, NEG_INF)
                    continue
                last = prefix[-1] if prefix else None
                if c == last:
                    # repeat: extends the non-blank path of the same prefix,
                    # or starts a new symbol after a blank
                    add(prefix, NEG_INF, p_nb + p_c)
                    ext = p_b + p_c
                else:
                    ext = p_tot + p_c
                new_prefix = prefix + (c,)
                if lexicon is not None and new_prefix not in states:
                    nxt_state = lexicon.step(states[prefix], c)
                    if nxt_state is None:
                        continue                       # off-lexicon: prune
                    states[new_prefix] = nxt_state
                if lm_score_fn is not None:
                    ext += lm_weight * lm_score_fn(prefix, c)
                add(new_prefix, NEG_INF, ext + word_bonus)

        ranked = sorted(next_beams.items(),
                        key=lambda kv: _logsumexp(*kv[1]), reverse=True)
        beams = dict(ranked[:beam_width])
        if lexicon is not None:
            states = {p: states[p] for p in beams}

    items = beams.items()
    if lexicon is not None:
        # final hypotheses must end on a COMPLETE word (or be empty);
        # mid-word prefixes were only legal as in-flight beams
        done = [(p, s) for p, s in items
                if not p or lexicon.is_terminal(states[p])]
        items = done or items
    hyps = [Hypothesis(score=_logsumexp(*pbs), y_sequence=list(prefix))
            for prefix, pbs in items]
    hyps.sort(key=lambda h: h.score, reverse=True)
    return hyps


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class CTCDecoding:
    """Strategy dispatcher with NeMo CTCBPEDecoding's surface: 'greedy' /
    'greedy_batch' (device), 'beam' (host prefix search; aliases
    'pyctcdecode', and 'flashlight' with a lexicon), 'beam_batch'
    (device search)."""

    def __init__(self, tokenizer, strategy: str = "greedy",
                 beam_width: int = 16, lm_score_fn=None,
                 lm_weight: float = 0.0,
                 word_bonus: float = 0.0, compute_timestamps: bool = False,
                 ngram_lm=None, lexicon_words=None, bigram_lm=None,
                 confidence_cfg=None, preserve_alignments: bool = False,
                 word_seperator: str = " ",
                 segment_seperators: Sequence[str] = (".", "?", "!"),
                 segment_gap_threshold: Optional[int] = None):
        """ngram_lm: an ops.ngram_lm.NgramLM (or an ARPA file's path), the
        beam-search LM (KenLM's role). lexicon_words: the allowed words;
        beams stay on their token trie (flashlight's lexicon strategy).
        'beam_batch' takes word_bonus, a dense (V, V) `bigram_lm` log-prob
        table (row `blank` the start) or `ngram_lm` (compiled once to
        dense tables, NgramLM.to_dense_automaton); host hooks
        (`lm_score_fn`) and the lexicon stay on 'beam'."""
        if strategy == "pyctcdecode":
            strategy = "beam"
        elif strategy == "flashlight":
            if lexicon_words is None:
                raise ValueError(
                    "strategy='flashlight' is the lexicon-constrained "
                    "search: pass lexicon_words")
            strategy = "beam"
        if strategy not in ("greedy", "greedy_batch", "beam", "beam_batch"):
            raise ValueError(f"unknown decoding strategy: {strategy}")
        if strategy == "beam_batch" and (lm_score_fn is not None
                                         or lexicon_words is not None):
            raise ValueError(
                "beam_batch is the on-device search: host lm_score_fn/"
                "lexicon hooks are not supported — use strategy='beam', or "
                "pass ngram_lm/bigram_lm (device-compiled) instead")
        self.bigram_lm = bigram_lm
        self.ngram_tables = None     # compiled at first use: the logits' V
        self._device_ngram = None
        if strategy == "beam_batch" and ngram_lm is not None:
            from tpu_asr_torch.ops.ngram_lm import NgramLM
            if isinstance(ngram_lm, str):
                ngram_lm = NgramLM.load_arpa(ngram_lm)
            self._device_ngram = ngram_lm
            if lm_weight == 0.0:
                lm_weight = 1.0
            ngram_lm = None          # consumed: no host hook
        if bigram_lm is not None and lm_weight == 0.0:
            lm_weight = 1.0
        self.tokenizer = tokenizer
        self.strategy = strategy
        self.beam_width = beam_width
        self.lexicon = None
        if lexicon_words is not None:
            self.lexicon = Lexicon(
                tokenizer.text_to_ids(w) for w in lexicon_words)
        if ngram_lm is not None and lm_score_fn is None:
            from tpu_asr_torch.ops.ngram_lm import NgramLM
            if isinstance(ngram_lm, str):
                ngram_lm = NgramLM.load_arpa(ngram_lm)
            lm_score_fn = ngram_lm.lm_score_fn()
            if lm_weight == 0.0:
                lm_weight = 1.0
        self.lm_score_fn = lm_score_fn
        self.lm_weight = lm_weight
        self.word_bonus = word_bonus
        self.compute_timestamps = compute_timestamps
        # confidence, alignments and word / segment offsets: the greedy
        # strategies' payload
        self.confidence_cfg = confidence_cfg
        self.preserve_alignments = preserve_alignments
        self.word_seperator = word_seperator
        self.segment_seperators = list(segment_seperators)
        self.segment_gap_threshold = segment_gap_threshold
        if confidence_cfg is not None and confidence_cfg.wants_any():
            if strategy not in ("greedy", "greedy_batch"):
                raise ValueError(
                    "confidence estimation is supported on the greedy "
                    f"strategies (got strategy={strategy!r})")

    def decode_tokens_to_str(self, tokens: Sequence[int]) -> str:
        return self.tokenizer.ids_to_text(list(tokens))

    @property
    def plain_greedy(self) -> bool:
        """Greedy without timestamps, confidence or alignments: the model's
        argmax ids are all it needs (`greedy_ids_predictions`)."""
        return (self.strategy in ("greedy", "greedy_batch")
                and not self.compute_timestamps
                and not self.preserve_alignments
                and not (self.confidence_cfg is not None
                         and self.confidence_cfg.wants_any()))

    def greedy_ids_predictions(self, greedy: torch.Tensor,
                               decoder_lengths: torch.Tensor, blank: int,
                               return_hypotheses: bool = False):
        """Plain greedy from the model's (B, T) argmax ids
        (`CTCModelOutput.greedy`): the collapse on their device, then
        texts or Hypothesis objects."""
        tokens, n_tokens = ctc_greedy_decode_ids(greedy, decoder_lengths,
                                                 blank)
        return self._finish(self._packed_hyps(tokens, n_tokens),
                            return_hypotheses)

    @staticmethod
    def _packed_hyps(tokens, n_tokens) -> List[Hypothesis]:
        tokens, n_tokens = _host(tokens), _host(n_tokens)
        return [Hypothesis(score=0.0,
                           y_sequence=tokens[i, :n_tokens[i]].tolist())
                for i in range(tokens.shape[0])]

    def _finish(self, hyps, return_hypotheses: bool):
        for h in hyps:
            h.text = self.decode_tokens_to_str(h.y_sequence)
        return hyps if return_hypotheses else [h.text for h in hyps]

    def ctc_decoder_predictions_tensor(self, decoder_outputs,
                                       decoder_lengths,
                                       return_hypotheses: bool = False):
        """(B, T, V) log-probs (a tensor on any device, or an array) and
        (B,) lengths -> texts, or Hypothesis objects."""
        if self.strategy in ("greedy", "greedy_batch"):
            if not self.plain_greedy:
                hyps = self._greedy_full(decoder_outputs, decoder_lengths)
            else:
                hyps = self._packed_hyps(*ctc_greedy_decode(
                    torch.as_tensor(decoder_outputs),
                    torch.as_tensor(decoder_lengths)))
        elif self.strategy == "beam_batch":
            from tpu_asr_torch.ops.beam_search import ctc_beam_search_batched
            if self._device_ngram is not None and self.ngram_tables is None:
                # against the logits' V (num_classes + blank; the blank
                # column is the stay candidate's)
                self.ngram_tables = self._device_ngram.to_dense_automaton(
                    int(decoder_outputs.shape[-1]))
            lp = torch.as_tensor(decoder_outputs)
            tokens, lens, scores = ctc_beam_search_batched(
                lp, torch.as_tensor(decoder_lengths, device=lp.device),
                beam_width=self.beam_width, word_bonus=self.word_bonus,
                bigram_lm=self.bigram_lm, lm_weight=self.lm_weight,
                ngram_tables=self.ngram_tables)
            tokens, lens, scores = _host(tokens), _host(lens), _host(scores)
            hyps = [Hypothesis(score=float(scores[i, 0]),
                               y_sequence=tokens[i, 0, :lens[i, 0]].tolist())
                    for i in range(tokens.shape[0])]
        else:
            lp = _host(decoder_outputs).astype(np.float32)
            lens = _host(decoder_lengths)
            hyps = [ctc_prefix_beam_search(
                lp[i], int(lens[i]), self.beam_width,
                lm_score_fn=self.lm_score_fn, lm_weight=self.lm_weight,
                word_bonus=self.word_bonus, lexicon=self.lexicon)[0]
                for i in range(lp.shape[0])]
        return self._finish(hyps, return_hypotheses)

    # ---- greedy with timestamps / confidence / alignments -----------------

    def _is_char_mode(self) -> bool:
        return type(self.tokenizer).__name__ == "CharTokenizer"

    def _piece_starts_word(self, piece: str) -> bool:
        if type(self.tokenizer).__name__ == "WordPieceTokenizer":
            return not piece.startswith("##")
        from tpu_asr_torch.data.tokenizer import WS
        return piece.startswith(WS)

    def _greedy_full(self, decoder_outputs, decoder_lengths):
        """Greedy decode with NeMo's whole hypothesis payload: the
        timestamp offset dict, frame / token / word confidence and
        alignments. The decode and the frame confidence run on the
        log-probs' device, then (B, T) tensors come to the host (the
        (B, T, V) log-probs only for `preserve_alignments`), where the
        offsets are grouped and the confidences pooled per utterance."""
        from tpu_asr_torch.ops.confidence import (
            frame_confidence_fn, get_confidence_aggregation_bank)

        cfg = self.confidence_cfg
        want_conf = cfg is not None and cfg.wants_any()
        lp_dev = torch.as_tensor(decoder_outputs)
        len_dev = torch.as_tensor(decoder_lengths, device=lp_dev.device)
        tokens, n_tokens, starts, ends, labels = map(
            _host, ctc_greedy_decode_full(lp_dev, len_dev))
        v = int(lp_dev.shape[-1])
        frame_conf = agg = None
        if want_conf:
            frame_conf = _host(frame_confidence_fn(cfg.method_cfg, v)(lp_dev))
            agg = get_confidence_aggregation_bank()[cfg.aggregation]
        lens = _host(decoder_lengths)
        lp_host = (_host(lp_dev).astype(np.float32)
                   if self.preserve_alignments else None)
        vocab = self.tokenizer.vocab
        char_mode = self._is_char_mode()

        hyps = []
        for i in range(tokens.shape[0]):
            n = int(n_tokens[i])
            length = int(lens[i])
            ids = tokens[i, :n].tolist()
            st = starts[i, :n].tolist()
            en = ends[i, :n].tolist()
            h = Hypothesis(score=0.0, y_sequence=ids)
            if self.preserve_alignments:
                h.alignments = (labels[i, :length].copy(), lp_host[i, :length])
            token_conf = None
            if want_conf:
                fc = frame_conf[i]
                if cfg.preserve_frame_confidence:
                    h.frame_confidence = fc[:length].tolist()
                if (cfg.preserve_token_confidence
                        or cfg.preserve_word_confidence):
                    token_conf = []
                    for j in range(n):
                        if cfg.exclude_blank:
                            # a token's emission run is exactly its
                            # non-blank frames (ctc_greedy_decode_full)
                            fr = fc[st[j]:en[j] + 1]
                        else:
                            hi = st[j + 1] if j + 1 < n else length
                            fr = fc[st[j]:hi]
                        token_conf.append(agg(fr))
                    if cfg.preserve_token_confidence:
                        h.token_confidence = token_conf
            need_words = self.compute_timestamps or (
                want_conf and cfg.preserve_word_confidence)
            if need_words:
                units = self._units_from_token_ids(ids, st, en)
                words, idx_groups = self._group_word_units(
                    units, self.word_seperator,
                    set(self.segment_seperators), subword=not char_mode)
                if self.compute_timestamps:
                    def _piece(tid):
                        return vocab[tid] if 0 <= tid < len(vocab) else ""
                    if char_mode:
                        char_offsets = [
                            {"char": _piece(tid), "start_offset": s,
                             "end_offset": e}
                            for tid, s, e in zip(ids, st, en)]
                    else:
                        char_offsets = [
                            {"char": [_piece(tid)], "start_offset": s,
                             "end_offset": e}
                            for tid, s, e in zip(ids, st, en)]
                    h.timestamp = {
                        "timestep": list(st),
                        "char": char_offsets,
                        "word": words,
                        "segment": self._get_segment_offsets(
                            words, self.segment_seperators,
                            set(self.segment_seperators),
                            self.segment_gap_threshold),
                    }
                if want_conf and cfg.preserve_word_confidence:
                    h.word_confidence = [
                        agg([token_conf[j] for j in g]) for g in idx_groups]
            hyps.append(h)
        return hyps

    def _units_from_token_ids(self, ids, starts, ends):
        """Packed token ids -> word units [(text, start, end, [token idx])].
        Char tokenizer: every char is its own atom. Subword: a unit spans a
        word-start piece plus its continuation pieces."""
        vocab = self.tokenizer.vocab
        if self._is_char_mode():
            return [(vocab[t] if 0 <= t < len(vocab) else "", s, e, [j])
                    for j, (t, s, e) in enumerate(zip(ids, starts, ends))]
        return self._subword_units(ids, starts, ends)

    def _subword_units(self, ids, starts, ends):
        units = []
        cur_ids: List[int] = []
        cur_idx: List[int] = []
        cur_s = cur_e = 0
        vocab = self.tokenizer.vocab
        for j, (t, s, e) in enumerate(zip(ids, starts, ends)):
            # ids past the tokenizer vocab (decoder num_classes > vocab_size,
            # possible in synthetic configs) start a unit; ids_to_text skips
            # them like decode_tokens_to_str does
            piece = vocab[t] if 0 <= t < len(vocab) else ""
            if cur_ids and (not piece or self._piece_starts_word(piece)):
                units.append((self.tokenizer.ids_to_text(cur_ids),
                              cur_s, cur_e, cur_idx))
                cur_ids, cur_idx = [], []
            if not cur_ids:
                cur_s = s
            cur_ids.append(t)
            cur_idx.append(j)
            cur_e = e
        if cur_ids:
            units.append((self.tokenizer.ids_to_text(cur_ids),
                          cur_s, cur_e, cur_idx))
        return units

    @staticmethod
    def _group_word_units(units, word_delimiter_char, supported_punctuation,
                          subword):
        """Units -> (word offset dicts, per-word token-index groups).

        Pinned rules (test_timestamps.py fixtures): word start = first
        constituent token's start_offset, end = last constituent's
        end_offset; units matching the delimiter are dropped and split words;
        for subword tokenizers the default ' ' delimiter makes every unit its
        own word while a custom delimiter groups the units BETWEEN delimiter
        matches into one space-joined word; a standalone all-punctuation word
        merges into the previous word (`e` + `.` -> `e.`)."""
        if subword and word_delimiter_char == " ":
            groups = [[u] for u in units]
        else:
            groups = []
            cur = []
            for u in units:
                if u[0] == word_delimiter_char:
                    if cur:
                        groups.append(cur)
                        cur = []
                else:
                    cur.append(u)
            if cur:
                groups.append(cur)
        join = " " if subword else ""
        words = []
        idx_groups: List[List[int]] = []
        for g in groups:
            text = join.join(u[0] for u in g)
            start, end = g[0][1], g[-1][2]
            idxs = [j for u in g for j in u[3]]
            if (words and text
                    and all(ch in supported_punctuation for ch in text)):
                words[-1]["word"] += text
                words[-1]["end_offset"] = end
                idx_groups[-1].extend(idxs)
            else:
                words.append({"word": text, "start_offset": start,
                              "end_offset": end})
                idx_groups.append(idxs)
        return words, idx_groups

    def get_words_offsets(self, char_offsets=None, encoded_char_offsets=None,
                          word_delimiter_char: str = " ",
                          supported_punctuation=(".", "!", "?")):
        """Word offsets from char/token offsets (NeMo CTCDecoding surface,
        test_timestamps.py:211-269). `char_offsets`: char-tokenizer entries
        {'char': <char str>, 'start_offset', 'end_offset'};
        `encoded_char_offsets`: subword entries whose 'char' is a token id
        (int), [id], or piece string."""
        punct = set(supported_punctuation)
        if encoded_char_offsets is not None:
            vocab = self.tokenizer.vocab
            piece_to_id = {p: i for i, p in enumerate(vocab)}
            ids = []
            for entry in encoded_char_offsets:
                c = entry["char"]
                if isinstance(c, (list, tuple)):
                    c = c[0]
                ids.append(int(c) if not isinstance(c, str)
                           else piece_to_id[c])
            starts = [e["start_offset"] for e in encoded_char_offsets]
            ends = [e["end_offset"] for e in encoded_char_offsets]
            units = self._subword_units(ids, starts, ends)
            words, _ = self._group_word_units(
                units, word_delimiter_char, punct, subword=True)
            return words
        units = [(e["char"], e["start_offset"], e["end_offset"], [j])
                 for j, e in enumerate(char_offsets)]
        words, _ = self._group_word_units(
            units, word_delimiter_char, punct, subword=False)
        return words

    def _get_segment_offsets(self, offsets, segment_delimiter_tokens,
                             supported_punctuation=None,
                             segment_gap_threshold: Optional[int] = None):
        """Group word offsets into segments: split after a word ending in a
        segment delimiter ('.', '?', '!'), or — when segment_gap_threshold is
        set — where the frame gap between consecutive words exceeds it
        (test_timestamps.py:270-289)."""
        del supported_punctuation  # delimiters already merged into words
        segments = []
        cur = []

        def flush():
            if cur:
                segments.append({
                    "segment": self.word_seperator.join(
                        w["word"] for w in cur),
                    "start_offset": cur[0]["start_offset"],
                    "end_offset": cur[-1]["end_offset"],
                })
                cur.clear()

        for w in offsets:
            if (segment_gap_threshold is not None and cur
                    and w["start_offset"] - cur[-1]["end_offset"]
                    > segment_gap_threshold):
                flush()
            cur.append(w)
            if (segment_gap_threshold is None and w["word"]
                    and w["word"][-1] in segment_delimiter_tokens):
                flush()
        flush()
        return segments
