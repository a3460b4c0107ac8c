"""NeMo-style JSONL manifests: the port's own copy of
tpu_asr/data/manifest.py. A line is `{"audio_filepath": ..., "duration":
..., "text": ...}` plus any extra keys. Building a manifest from a Hugging
Face dataset (`build_manifest_from_hf`) needs the `datasets` package, which
the port does not use: it raises."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List


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


def build_manifest_from_hf(*args, **kwargs):
    raise NotImplementedError(
        "tpu_asr_torch does not build manifests from Hugging Face datasets "
        "(that needs the `datasets` package); pass explicit JSONL manifests "
        "(--train_manifest / --val_manifest / --test_manifest)")
