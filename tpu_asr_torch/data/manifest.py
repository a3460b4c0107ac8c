"""NeMo-style JSONL manifests and the Hugging Face manifest builder: the
port's own copy of tpu_asr/data/manifest.py. A line is `{"audio_filepath":
..., "duration": ..., "text": ...}` plus any extra keys.

`build_manifest_from_hf` takes any iterable of Hugging Face sample dicts
(`{"audio": {"path", "array", "sampling_rate"}, "text" or "sentence",
...}`): the reference's path-resolution ladder (audio.path ->
sample["file"] -> a recursive `cache/extracted` glob -> the decoded array
written to a tmp WAV), durations from the arrays, per-corpus text
normalization and the GigaSpeech min-duration and tag-only filters
(asr_train.py:98-163, asr_train_GS.py:66-209, asr_inference_CV.py:213-260).
It needs no `datasets` package; loading a dataset does (the CLIs,
cli/common.py `prepare_manifests`).
"""

from __future__ import annotations

import glob
import json
import os
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from tpu_asr_torch.data.audio import write_wav
from tpu_asr_torch.data.normalizers import (clean_tedlium_text,
                                            clean_text_commonvoice,
                                            normalize_text_cv,
                                            strip_gigaspeech_tags)


@dataclass
class ManifestEntry:
    audio_filepath: str
    duration: float
    text: str
    extra: Dict = field(default_factory=dict)

    def to_json(self) -> str:
        obj = {"audio_filepath": self.audio_filepath,
               "duration": self.duration, "text": self.text, **self.extra}
        return json.dumps(obj, ensure_ascii=False)


def read_manifest(path) -> List[ManifestEntry]:
    entries = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            entries.append(ManifestEntry(
                audio_filepath=obj.pop("audio_filepath"),
                duration=float(obj.pop("duration", 0.0)),
                text=obj.pop("text", ""), extra=obj))
    return entries


def write_manifest(path, entries: Iterable[ManifestEntry]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for e in entries:
            f.write(e.to_json() + "\n")


# ---------------------------------------------------------------------------
# HF dataset -> manifest builders (reference R5)
# ---------------------------------------------------------------------------

_TEXT_NORMALIZERS: Dict[str, Callable[[str], str]] = {
    # asr_train.py:156 routes every sample through _clean_tedlium_text (which
    # also lowercases): LibriSpeech and TED alike in the reference
    "librispeech": clean_tedlium_text,
    "tedlium": clean_tedlium_text,
    "gigaspeech": lambda s: s,           # handled specially (tag filter)
    "commonvoice": clean_text_commonvoice,
}


def _resolve_audio_path(audio: Dict, sample: Dict, cache_dir: str,
                        tmp_audio_dir: str) -> Optional[str]:
    """Reference path ladder: audio.path -> sample['file'] -> glob under
    cache/extracted -> write a tmp wav from the decoded array
    (asr_train.py:113-142, asr_inference_CV.py:228-241)."""
    candidates = []
    p = audio.get("path")
    if isinstance(p, str) and p:
        candidates.append(p)
    f = sample.get("file")
    if isinstance(f, str) and f:
        candidates.append(f)
    for c in candidates:
        if os.path.isfile(c):
            return c
    extract_root = os.path.join(cache_dir, "extracted")
    for c in candidates:
        matches = glob.glob(os.path.join(extract_root, "**",
                                         os.path.basename(c)), recursive=True)
        if matches:
            return matches[0]
    arr = audio.get("array")
    if arr is None:
        return None
    sr = int(audio.get("sampling_rate", 16000))
    base = None
    if isinstance(f, str) and f:
        base = os.path.splitext(os.path.basename(f))[0]
    if not base:
        base = str(sample.get("id", uuid.uuid4().hex))
    os.makedirs(tmp_audio_dir, exist_ok=True)
    wav_path = os.path.join(tmp_audio_dir, base + ".wav")
    if os.path.exists(wav_path):
        wav_path = os.path.join(tmp_audio_dir,
                                base + f"_{uuid.uuid4().hex[:8]}.wav")
    write_wav(wav_path, np.asarray(arr, np.float32), sr)
    return wav_path


def build_manifest_from_hf(ds, manifest_path: str, cache_dir: str,
                           corpus: str = "librispeech",
                           min_duration: Optional[float] = None,
                           text_key: Optional[str] = None) -> int:
    """HF samples -> NeMo JSONL manifest. Returns the lines written.

    corpus selects the text normalizer and filters:
    - librispeech/tedlium: `clean_tedlium_text` (brace tags, <sil>, lower)
    - gigaspeech: min_duration default 1.0 s; tag-strip, skip tag-only refs
      (asr_train_GS.py:180-205)
    - commonvoice: `clean_text_commonvoice` on the `sentence` field
    """
    if corpus not in _TEXT_NORMALIZERS:
        raise ValueError(f"unknown corpus: {corpus}")
    if corpus == "gigaspeech" and min_duration is None:
        min_duration = 1.0
    tmp_audio_dir = os.path.join(cache_dir, "tmp_audio", corpus)
    os.makedirs(os.path.dirname(manifest_path) or ".", exist_ok=True)

    n_written = 0
    with open(manifest_path, "w", encoding="utf-8") as fout:
        for sample in ds:
            audio = sample["audio"]
            orig_path = _resolve_audio_path(audio, sample, cache_dir,
                                            tmp_audio_dir)
            if not orig_path:
                continue
            arr = audio.get("array")
            sr = float(audio.get("sampling_rate", 16000)) or 16000.0
            duration = float(len(arr)) / sr if arr is not None else 0.0
            if duration <= 0:
                continue
            if min_duration is not None and duration < min_duration:
                continue

            if text_key is not None:
                raw = sample.get(text_key, "")
            else:
                raw = sample.get("sentence", None)
                if raw is None:
                    raw = sample.get("text", "")

            if corpus == "gigaspeech":
                stripped, tag_only = strip_gigaspeech_tags(raw)
                if tag_only:
                    continue
                text = normalize_text_cv(stripped, keep_punct=False)
            else:
                text = _TEXT_NORMALIZERS[corpus](raw)

            fout.write(ManifestEntry(orig_path, duration, text).to_json()
                       + "\n")
            n_written += 1
    return n_written
