"""SentencePiece-compatible BPE tokenizer: the port's own copy of
`SentencePieceBPETokenizer` and `train_bpe` from the JAX package's
tpu_asr/data/tokenizer.py (same pieces, same ids), standard library only.

- a minimal protobuf wire-format reader and writer for SentencePiece
  `ModelProto` files, enough to load a real `tokenizer.model` and pick the
  encode algorithm (BPE merges or unigram Viterbi);
- decoding (ids -> pieces -> text, `▁` -> space, byte pieces re-assembled);
- a small BPE trainer (score = -merge_rank, SentencePiece convention).
"""

from __future__ import annotations

import json
import struct
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WS = "▁"   # ▁ SentencePiece whitespace marker

# SentencePiece piece types (sentencepiece_model.proto)
_TYPE_NORMAL = 1
_TYPE_UNKNOWN = 2
_TYPE_CONTROL = 3
_TYPE_USER_DEFINED = 4
_TYPE_UNUSED = 5
_TYPE_BYTE = 6


# ---------------------------------------------------------------------------
# protobuf wire-format reader (just enough for ModelProto)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                      # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:                    # fixed64
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:                    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:                    # fixed32
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


# TrainerSpec.model_type enum (sentencepiece_model.proto)
_MODEL_TYPE_NAMES = {1: "unigram", 2: "bpe", 3: "word", 4: "char"}


def parse_model_proto(data: bytes):
    """ModelProto bytes -> ([(piece, score, type), ...] in id order, meta).

    meta: {"model_type": "unigram"|"bpe"|"word"|"char",
           "add_dummy_prefix": bool}. The proto defaults apply when the spec
    submessages are absent: model_type=UNIGRAM, add_dummy_prefix=True.
    """
    pieces: List[Tuple[str, float, int]] = []
    meta = {"model_type": "unigram", "add_dummy_prefix": True}
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 2:       # repeated SentencePiece
            piece, score, ptype = "", 0.0, _TYPE_NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append((piece, score, ptype))
        elif field == 2 and wire == 2:     # TrainerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 3 and w2 == 0:    # model_type
                    meta["model_type"] = _MODEL_TYPE_NAMES.get(v2, "unigram")
        elif field == 3 and wire == 2:     # NormalizerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 3 and w2 == 0:    # add_dummy_prefix
                    meta["add_dummy_prefix"] = bool(v2)
    if not pieces:
        raise ValueError("no pieces found — not a SentencePiece model?")
    return pieces, meta


def parse_sentencepiece_model(data: bytes) -> List[Tuple[str, float, int]]:
    """ModelProto bytes -> [(piece, score, type), ...] in id order."""
    return parse_model_proto(data)[0]


# ---------------------------------------------------------------------------
# protobuf wire-format writer (the inverse of parse_model_proto: enough of
# ModelProto that sentencepiece — and this file's reader — can load it)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wire) + payload


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2, _varint(len(payload)) + payload)


def build_model_proto(pieces: Sequence[Tuple[str, float, int]],
                      model_type: str = "bpe",
                      add_dummy_prefix: bool = True) -> bytes:
    """[(piece, score, type), ...] -> binary SentencePiece ModelProto.

    Emits: repeated SentencePiece (field 1: piece=1, score=2 float,
    type=3 enum), TrainerSpec.model_type (2.3), and
    NormalizerSpec.{name=1, add_dummy_prefix=3} (field 3) — the fields the
    real library requires plus everything parse_model_proto reads back."""
    type_ids = {v: k for k, v in _MODEL_TYPE_NAMES.items()}
    out = bytearray()
    for piece, score, ptype in pieces:
        sp = (_len_field(1, piece.encode("utf-8"))
              + _field(2, 5, struct.pack("<f", float(score)))
              + _field(3, 0, _varint(int(ptype))))
        out += _len_field(1, sp)
    out += _len_field(2, _field(3, 0, _varint(type_ids.get(model_type, 2))))
    out += _len_field(3, (_len_field(1, b"identity")
                          + _field(3, 0, _varint(int(add_dummy_prefix)))))
    return bytes(out)


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

class SentencePieceBPETokenizer:
    """Tokenizer with SentencePiece encode/decode semantics (BPE or unigram).

    vocab ids are piece indices; `unk_id` is the UNKNOWN-type piece (0 in
    standard models). CTC blank is NOT part of the vocab (NeMo appends it as
    the last decoder class, conv_asr.py:407-507).

    `model_type` selects the encode algorithm the C++ lib would use for the
    loaded model: "bpe" = greedy highest-score adjacent merges, "unigram" =
    Viterbi max-log-prob segmentation. `from_file` reads it from the proto's
    TrainerSpec; direct construction defaults to "bpe" (our own trainer).
    """

    def __init__(self, pieces: Sequence[Tuple[str, float, int]],
                 add_dummy_prefix: bool = True, model_type: str = "bpe"):
        if model_type not in ("bpe", "unigram", "char", "word"):
            raise ValueError(f"unsupported model_type {model_type!r}")
        self.pieces = [p for p, _, _ in pieces]
        self.scores = [s for _, s, _ in pieces]
        self.types = [t for _, _, t in pieces]
        self.model_type = model_type
        # first occurrence wins on duplicate piece strings (sentencepiece
        # keeps the lowest id)
        self.piece_to_id: Dict[str, int] = {}
        for i, p in enumerate(self.pieces):
            self.piece_to_id.setdefault(p, i)
        self.add_dummy_prefix = add_dummy_prefix
        unk = [i for i, t in enumerate(self.types) if t == _TYPE_UNKNOWN]
        self.unk_id = unk[0] if unk else 0
        self._control = {i for i, t in enumerate(self.types)
                         if t in (_TYPE_CONTROL, _TYPE_UNUSED)}
        self._byte_to_id: Dict[int, int] = {}
        for i, (p, t) in enumerate(zip(self.pieces, self.types)):
            if t == _TYPE_BYTE and len(p) == 6 and p[:3] == "<0x" and p[-1] == ">":
                self._byte_to_id[int(p[3:5], 16)] = i
        # unigram lattice bounds: longest matchable piece, unk penalty
        matchable = [len(self.pieces[i]) for i in range(len(self.pieces))
                     if i not in self._control and self.types[i] != _TYPE_BYTE]
        self._max_piece_len = max(matchable, default=1)
        normal_scores = [s for s, t in zip(self.scores, self.types)
                         if t in (_TYPE_NORMAL, _TYPE_USER_DEFINED)]
        # sentencepiece unigram_model.cc: unk score = min_score - kUnkPenalty(10)
        self._unk_score = (min(normal_scores) if normal_scores else 0.0) - 10.0

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_file(cls, path) -> "SentencePieceBPETokenizer":
        path = Path(path)
        data = path.read_bytes()
        if data[:1] == b"{":               # our JSON format
            obj = json.loads(data)
            return cls([(p, s, t) for p, s, t in obj["pieces"]],
                       obj.get("add_dummy_prefix", True),
                       obj.get("model_type", "bpe"))
        pieces, meta = parse_model_proto(data)
        return cls(pieces, meta["add_dummy_prefix"], meta["model_type"])

    @classmethod
    def from_bytes(cls, data: bytes) -> "SentencePieceBPETokenizer":
        if data[:1] == b"{":               # our JSON format
            obj = json.loads(data)
            return cls([(p, s, t) for p, s, t in obj["pieces"]],
                       obj.get("add_dummy_prefix", True),
                       obj.get("model_type", "bpe"))
        pieces, meta = parse_model_proto(data)
        return cls(pieces, meta["add_dummy_prefix"], meta["model_type"])

    def serialized_proto(self) -> bytes:
        """Binary SentencePiece ModelProto (the real library's on-disk
        format — what NGC .nemo archives ship as tokenizer.model)."""
        return build_model_proto(
            list(zip(self.pieces, self.scores, self.types)),
            self.model_type, self.add_dummy_prefix)

    def save_proto(self, path) -> None:
        Path(path).write_bytes(self.serialized_proto())

    def save(self, path) -> None:
        obj = {"pieces": [[p, s, t] for p, s, t in
                          zip(self.pieces, self.scores, self.types)],
               "add_dummy_prefix": self.add_dummy_prefix,
               "model_type": self.model_type}
        Path(path).write_text(json.dumps(obj, ensure_ascii=False))

    # -- properties ---------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    @property
    def vocab(self) -> List[str]:
        return list(self.pieces)

    # -- encode -------------------------------------------------------------
    def _pretokenize(self, text: str) -> List[str]:
        text = text.replace(" ", WS)
        if self.add_dummy_prefix and not text.startswith(WS):
            text = WS + text
        return list(text)

    def encode_pieces(self, text: str) -> List[str]:
        """Segment `text` with the loaded model's algorithm."""
        if not text:
            return []
        if self.model_type == "unigram":
            return self._viterbi_pieces(text)
        if self.model_type == "char":
            return self._pretokenize(text)
        # "word" degenerates to whitespace pieces; BPE merge handles it when
        # whole words are in-vocab, so both remaining types share one path.
        return self._bpe_pieces(text)

    def _viterbi_pieces(self, text: str) -> List[str]:
        """SentencePiece unigram Viterbi: maximize the sum of piece log-probs
        over all segmentations of the (escaped) text. Positions with no
        single-char piece get an <unk> node at min_score − 10; if the model
        ships BYTE pieces, unknown chars byte-decompose instead."""
        chars = self._pretokenize(text)
        n = len(chars)
        text_esc = "".join(chars)
        # char index -> string offset (pieces are matched on string slices)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Tuple[int, Optional[str]]] = [(0, None)] * (n + 1)
        best[0] = 0.0
        offs = [0] * (n + 1)
        for i, ch in enumerate(chars):
            offs[i + 1] = offs[i] + len(ch)
        for i in range(n):
            if best[i] == NEG:
                continue
            matched_single = False
            for j in range(i + 1, min(i + 1 + self._max_piece_len, n + 1)):
                cand = text_esc[offs[i]:offs[j]]
                pid = self.piece_to_id.get(cand)
                if (pid is not None and pid not in self._control
                        and self.types[pid] != _TYPE_BYTE):
                    if j == i + 1:
                        matched_single = True
                    sc = best[i] + self.scores[pid]
                    if sc > best[j]:
                        best[j] = sc
                        back[j] = (i, cand)
            if not matched_single:          # unk / byte-fallback node, len 1
                sc = best[i] + self._unk_score
                if sc > best[i + 1]:
                    best[i + 1] = sc
                    back[i + 1] = (i, None)
        out: List[str] = []
        j = n
        while j > 0:
            i, piece = back[j]
            if piece is None:               # unknown char
                ch = chars[i]
                if self._byte_to_id:
                    out.extend(f"<0x{b:02X}>"
                               for b in reversed(ch.encode("utf-8")))
                else:
                    out.append(ch)
                j = i
            else:
                out.append(piece)
                j = i
        out.reverse()
        return out

    def _bpe_pieces(self, text: str) -> List[str]:
        """Greedy highest-score adjacent merge (SentencePiece BPE)."""
        symbols = self._pretokenize(text)
        while len(symbols) > 1:
            best_score = None
            best_idx = -1
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                mid = self.piece_to_id.get(merged)
                if mid is None or mid in self._control:
                    continue
                sc = self.scores[mid]
                if best_score is None or sc > best_score:
                    best_score = sc
                    best_idx = i
            if best_idx < 0:
                break
            symbols[best_idx:best_idx + 2] = [symbols[best_idx] +
                                              symbols[best_idx + 1]]
        return symbols

    def text_to_ids(self, text: str) -> List[int]:
        return [self.piece_to_id.get(p, self.unk_id)
                for p in self.encode_pieces(text)]

    # -- decode -------------------------------------------------------------
    def ids_to_text(self, ids: Iterable[int]) -> str:
        chunks: List[str] = []
        byte_run: List[int] = []

        def flush_bytes():
            if byte_run:
                chunks.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run.clear()

        for i in ids:
            if not 0 <= i < len(self.pieces) or i in self._control:
                continue
            if self.types[i] == _TYPE_BYTE:
                byte_run.append(int(self.pieces[i][3:5], 16))
                continue
            flush_bytes()
            chunks.append(self.pieces[i])
        flush_bytes()
        text = "".join(chunks).replace(WS, " ")
        return text.lstrip(" ")

    def ids_to_pieces(self, ids: Iterable[int]) -> List[str]:
        return [self.pieces[i] for i in ids if 0 <= i < len(self.pieces)]



def train_bpe(corpus: Iterable[str], vocab_size: int,
              character_coverage: float = 1.0) -> SentencePieceBPETokenizer:
    """Tiny BPE trainer with SentencePiece conventions: `<unk>` id 0 (UNKNOWN),
    `<s>`/`</s>` control pieces, `▁`-marked words, score = -merge_rank.

    Replaces the reference's offline NeMo tokenizer-build step for training
    from scratch (the KD scripts themselves reuse the teacher's tokenizer).
    """
    word_counts: Counter = Counter()
    char_counts: Counter = Counter()
    for line in corpus:
        for w in line.strip().split():
            word_counts[WS + w] += 1
            for ch in WS + w:
                char_counts[ch] += 1

    # alphabet by frequency (full coverage by default)
    alphabet = [c for c, _ in char_counts.most_common()]
    specials = [("<unk>", 0.0, _TYPE_UNKNOWN), ("<s>", 0.0, _TYPE_CONTROL),
                ("</s>", 0.0, _TYPE_CONTROL)]
    n_reserved = len(specials) + len(alphabet)
    if vocab_size < n_reserved:
        raise ValueError(f"vocab_size {vocab_size} < alphabet+specials {n_reserved}")

    words = {w: (list(w), c) for w, c in word_counts.items()}
    merges: List[str] = []
    while len(merges) < vocab_size - n_reserved:
        pair_counts: Counter = Counter()
        for sym, cnt in words.values():
            for i in range(len(sym) - 1):
                pair_counts[(sym[i], sym[i + 1])] += cnt
        if not pair_counts:
            break
        (a, b), cnt = pair_counts.most_common(1)[0]
        if cnt < 2:
            break
        merged = a + b
        merges.append(merged)
        for w, (sym, c) in words.items():
            i = 0
            while i < len(sym) - 1:
                if sym[i] == a and sym[i + 1] == b:
                    sym[i:i + 2] = [merged]
                else:
                    i += 1

    pieces = list(specials)
    # alphabet pieces score below all merges (sentencepiece puts chars last)
    for rank, m in enumerate(merges):
        pieces.append((m, -float(rank), _TYPE_NORMAL))
    base = len(merges)
    for rank, ch in enumerate(alphabet):
        pieces.append((ch, -float(base + rank), _TYPE_NORMAL))
    return SentencePieceBPETokenizer(pieces)
