"""Text normalizers: the port's own copy of tpu_asr/data/normalizers.py,
the reference's inline normalizers (R6 in SURVEY.md §2.1):

- `normalize_text_cv`       — asr_inference.py:27-48 (same code in asr_train_GS.py:43-64)
- `strip_gigaspeech_tags` / `normalize_text_gigaspeech`
                            — asr_train_GS.py:80-100, 191-198
- `clean_tedlium_text`      — asr_train.py:34-38
- `clean_text_commonvoice`  — asr_inference_CV.py:199-211
"""

from __future__ import annotations

import re
import unicodedata
from typing import Tuple

try:
    import regex as _regex
    _HAS_REGEX = True
except ImportError:  # pragma: no cover
    _regex = None
    _HAS_REGEX = False

# asr_inference.py:31-33 character map (DOUBLE QUESTION MARK and ellipsis/
# guillemets go to space; curly quotes/dashes normalize)
_CHAR_MAP = {
    "⁇": " ",
    "“": '"', "”": '"', "„": '"',
    "‘": "'", "’": "'",
    "–": "-", "—": "-",
    "…": " ", "‹": " ", "›": " ", "«": " ", "»": " ",
}


def normalize_text_cv(s: str, keep_punct: bool = False) -> str:
    """Reference normalize_text_cv (asr_inference.py:27-48), step by step:
    NFKC+strip+lower -> char map -> strip one wrapping double-quote pair ->
    `\\s+'\\s*s\\b` -> `'s` -> (unless keep_punct) keep only letters/digits/
    whitespace/apostrophe/hyphen -> squeeze whitespace."""
    s = unicodedata.normalize("NFKC", s or "").strip().lower()
    for k, v in _CHAR_MAP.items():
        s = s.replace(k, v)
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        s = s[1:-1]
    s = re.sub(r"\s+'\s*s\b", "'s", s)
    if not keep_punct:
        if _HAS_REGEX:
            s = _regex.sub(r"[^\p{L}\p{N}\s'\-]", " ", s)
        else:  # pragma: no cover
            s = re.sub(r"[^\w\s'\-]", " ", s, flags=re.UNICODE)
    s = re.sub(r"\s+", " ", s).strip()
    return s


# asr_train_GS.py:81-85: GigaSpeech special tags (case-insensitive)
_GIGASPEECH_BANNED_TAGS = (
    "<MUSIC>", "<COMMA>", "<NOISE>", "<VOCALIZED_NOISE>", "<LAUGHTER>",
    "<SPOKEN_NOISE>", "<PERIOD>", "<QUESTION_MARK>", "<EXCLAMATION_MARK>",
    "<SEMICOLON>", "<COLON>", "<DASH>", "<ELLIPSIS>", "<SIL>", "<OTHER>",
)
_GIGASPEECH_TAGS_RE = re.compile(
    "(?:%s)" % "|".join(re.escape(t) for t in _GIGASPEECH_BANNED_TAGS),
    re.IGNORECASE)


def strip_gigaspeech_tags(text: str) -> Tuple[str, bool]:
    """Returns (tags_removed_text, is_tag_only) — asr_train_GS.py:91-100."""
    if not text:
        return "", True
    no_tags = _GIGASPEECH_TAGS_RE.sub(" ", text)
    no_tags = re.sub(r"\s+", " ", no_tags).strip()
    return no_tags, (len(no_tags) == 0)


def normalize_text_gigaspeech(text: str) -> str:
    """Tag strip + CV normalization, the GigaSpeech manifest-builder text path
    (asr_train_GS.py:191-198). Tag-only utterances normalize to ''."""
    stripped, tag_only = strip_gigaspeech_tags(text)
    if tag_only:
        return ""
    return normalize_text_cv(stripped, keep_punct=False)


def clean_tedlium_text(s: str) -> str:
    """Reference _clean_tedlium_text (asr_train.py:34-38): drop {COUGH}-style
    brace tags, `<sil>` -> space, squeeze, lowercase."""
    s = re.sub(r"\{.*?\}", "", s)
    s = s.replace("<sil>", " ")
    s = re.sub(r"\s+", " ", s).strip()
    return s.lower()


def clean_text_commonvoice(s: str) -> str:
    """Reference clean_text_commonvoice (asr_inference_CV.py:199-211): strip,
    remove one wrapping double-quote pair, ADD a trailing period when the text
    does not already end with sentence punctuation, squeeze."""
    s = s.strip()
    if len(s) >= 2 and s.startswith('"') and s.endswith('"'):
        s = s[1:-1]
    if len(s) > 0 and s[-1] not in (".", "?", "!"):
        s = s + "."
    s = re.sub(r"\s+", " ", s).strip()
    return s
