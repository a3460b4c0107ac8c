"""Tarred (sharded-archive) dataset: the port's own copy of
tpu_asr/data/tarred.py, NeMo's tarred-audio variant of the dataloader.

Audio lives in tar shards (`audio_0.tar`, ...) whose members the manifest
names by basename. Shards are read in order, with a per-epoch shard shuffle
and `num_shards` / `shard_index` striping; samples are batched greedily
within duration buckets (the map-style loader's edges), a bucket flushed
when full and every bucket drained at the end. The batches equal JAX's.
"""

from __future__ import annotations

import tarfile
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

from tpu_asr_torch.config import DataConfig
from tpu_asr_torch.data.audio import read_audio_bytes, resample
from tpu_asr_torch.data.dataset import Sample, _bucket_edges, _collate
from tpu_asr_torch.data.manifest import read_manifest


def expand_shard_pattern(pattern) -> List[Path]:
    """'audio_{0..3}.tar', a glob or a list -> shard paths."""
    if isinstance(pattern, (list, tuple)):
        return [Path(p) for p in pattern]
    pattern = str(pattern)
    if "{" in pattern and ".." in pattern:
        head, rest = pattern.split("{", 1)
        rng, tail = rest.split("}", 1)
        lo, hi = rng.split("..")
        return [Path(f"{head}{i}{tail}") for i in range(int(lo), int(hi) + 1)]
    paths = sorted(Path(pattern).parent.glob(Path(pattern).name))
    if not paths:
        raise FileNotFoundError(f"no tar shards match {pattern}")
    return paths


class TarredAudioToBPEDataset:
    """Iterable dataset over tar shards and manifest metadata."""

    def __init__(self, manifest_filepath: str, tarred_audio_filepaths,
                 tokenizer, sample_rate: int = 16000,
                 min_duration: float = 0.1, max_duration: float = 16.7):
        self.tokenizer = tokenizer
        self.sample_rate = sample_rate
        self.shards = expand_shard_pattern(tarred_audio_filepaths)
        self.meta: Dict[str, dict] = {}
        for e in read_manifest(manifest_filepath):
            if min_duration is not None and e.duration < min_duration:
                continue
            if max_duration is not None and e.duration > max_duration:
                continue
            self.meta[Path(e.audio_filepath).name] = {
                "text": e.text, "duration": e.duration}

    def __len__(self) -> int:
        return len(self.meta)

    def iter_samples(self, epoch: int = 0, shuffle_shards: bool = True,
                     num_shards: int = 1, shard_index: int = 0
                     ) -> Iterator[Sample]:
        shards = list(self.shards)
        if shuffle_shards:
            np.random.default_rng(epoch).shuffle(shards)
        for shard in shards[shard_index::num_shards]:
            with tarfile.open(shard, "r:*") as tar:
                for member in tar:
                    if not member.isfile():
                        continue
                    meta = self.meta.get(Path(member.name).name)
                    if meta is None:
                        continue
                    x, sr = read_audio_bytes(
                        tar.extractfile(member).read(), member.name)
                    tokens = np.asarray(
                        self.tokenizer.text_to_ids(meta["text"]), np.int32)
                    yield Sample(resample(x, sr, self.sample_rate), tokens,
                                 meta["text"], meta["duration"])


def make_tarred_dataloader(dataset: TarredAudioToBPEDataset, cfg: DataConfig,
                           epoch: int = 0, token_quantum: int = 16,
                           num_shards: int = 1, shard_index: int = 0
                           ) -> Iterator[Dict[str, np.ndarray]]:
    edges = _bucket_edges(cfg.max_duration, cfg.num_buckets,
                          dataset.sample_rate)
    pending: List[List[Sample]] = [[] for _ in edges]

    def flush(b: int):
        samples, pending[b] = pending[b], []
        return _collate(samples, int(edges[b]), token_quantum)

    for sample in dataset.iter_samples(epoch, cfg.shuffle, num_shards,
                                       shard_index):
        n = int(np.ceil(sample.duration * dataset.sample_rate))
        b = int(np.searchsorted(edges, n, side="left").clip(0, len(edges) - 1))
        pending[b].append(sample)
        if len(pending[b]) >= cfg.batch_size:
            yield flush(b)
    for b in range(len(edges)):
        if pending[b]:
            yield flush(b)
