"""Audio-to-BPE dataset and the bucketed dataloader: the port's own copy of
tpu_asr/data/dataset.py.

JSONL manifest -> duration filter (min 0.1 / max 16.7 s) -> host decode
-> tokenize -> pad-collate (signal, signal_len, tokens, token_len). Batches
are formed within linear duration buckets, each padded to its bucket's
edge and the tokens to a multiple of a quantum, so the model sees a few
fixed shapes. `make_dataloader` yields the same batches as JAX's, bit for
bit: the same shuffles, bucket edges, `bucketing_batch_size`, token
quantum, `num_shards` / `shard_index` stripes and `pad_batch_to` cyclic
padding. Its worker threads decode a batch's samples, and the batch keeps
the manifest order whatever order they finish in.

Data parallelism (`world`, `rank`): the port plans each epoch's batches
once, from the whole manifest and the shared seed, which is the plan the
single-rank run draws; each batch is padded cyclically to a multiple of
`world` (JAX's `pad_batch_to=dp_size`) and rank r takes its block of rows
[r B/world, (r+1) B/world). So every rank has the same number of steps and
the same padded shape at each step (the token width is the global batch's),
and the blocks concatenate to the single-rank batch. A rank decodes only its
own rows; `texts` holds its real rows, which come first in its block. (JAX's
multi-process loader stripes the manifest first and plans each stripe on its
own, so its processes can disagree on the count and the shapes of their
batches; ROADMAP.md, "Faults of the reference".)

`stack_batches` groups same-shape batches for `steps_per_dispatch` > 1.
`to_device` takes the place of JAX's `prefetch_to_device`: it copies each
host batch from pinned memory with `non_blocking=True`, one batch ahead.

The decode cache (`decode_cache_dir`) writes each utterance's waveform once
as `<sha1>.npy`, beside a sidecar of the source's (size, mtime_ns), and
memory-maps it on later reads. An entry whose sidecar disagrees with the
source, or is missing while the source exists (JAX trusts such an entry
forever, tpu_asr/data/dataset.py:96-99), is decoded again; a missing
source still serves the cache.
"""

from __future__ import annotations

import hashlib
import math
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from tpu_asr_torch.config import DataConfig
from tpu_asr_torch.data.audio import load_audio
from tpu_asr_torch.data.manifest import ManifestEntry, read_manifest


@dataclass
class Sample:
    signal: np.ndarray       # (L,) float32 at the sample rate
    tokens: np.ndarray       # (S,) int32
    text: str
    duration: float


class AudioToBPEDataset:
    """Manifest-backed dataset with on-demand host decode and tokenize."""

    def __init__(self, manifest_filepath: str, tokenizer,
                 sample_rate: int = 16000, min_duration: float = 0.1,
                 max_duration: float = 16.7,
                 decode_cache_dir: Optional[str] = None):
        self.tokenizer = tokenizer
        self.sample_rate = sample_rate
        self.cache_dir = decode_cache_dir
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
        self.entries: List[ManifestEntry] = [
            e for e in read_manifest(manifest_filepath)
            if (min_duration is None or e.duration >= min_duration)
            and (max_duration is None or e.duration <= max_duration)]

    def __len__(self) -> int:
        return len(self.entries)

    def _load_signal(self, e: ManifestEntry) -> np.ndarray:
        if not self.cache_dir:
            return load_audio(e.audio_filepath, self.sample_rate)
        key = hashlib.sha1(
            f"{e.audio_filepath}:{self.sample_rate}".encode()).hexdigest()
        path = os.path.join(self.cache_dir, key + ".npy")
        meta = path + ".meta"
        try:
            st = os.stat(e.audio_filepath)
            stamp = f"{st.st_size}:{st.st_mtime_ns}"
        except OSError:
            stamp = None
        if os.path.isfile(path):
            fresh = True
            if stamp is not None:
                try:
                    with open(meta) as f:
                        fresh = f.read().strip() == stamp
                except OSError:
                    fresh = False         # no sidecar: decode again
            if fresh:
                try:
                    return np.load(path, mmap_mode="r")
                except Exception:
                    pass                  # partial or corrupt: decode again
        signal = load_audio(e.audio_filepath, self.sample_rate)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.save(f, signal)
            os.replace(tmp, path)
            if stamp is not None:
                with open(f"{meta}.tmp{os.getpid()}", "w") as f:
                    f.write(stamp)
                os.replace(f"{meta}.tmp{os.getpid()}", meta)
        except OSError:                   # read-only or full disk
            pass
        return signal

    def tokens(self, i: int) -> np.ndarray:
        return np.asarray(self.tokenizer.text_to_ids(self.entries[i].text),
                          np.int32)

    def __getitem__(self, i: int) -> Sample:
        e = self.entries[i]
        return Sample(self._load_signal(e), self.tokens(i), e.text,
                      e.duration)


def _bucket_edges(max_duration: float, num_buckets: int,
                  sample_rate: int) -> np.ndarray:
    """Linear duration buckets; each edge is a padded signal length."""
    edges = np.linspace(max_duration / num_buckets, max_duration, num_buckets)
    return np.ceil(edges * sample_rate).astype(np.int64)


def make_dataloader(dataset: AudioToBPEDataset, cfg: DataConfig,
                    epoch: int = 0, drop_last: bool = False,
                    token_quantum: int = 16, num_shards: int = 1,
                    shard_index: int = 0, num_workers: int = 4,
                    pad_batch_to: Optional[int] = None,
                    skip_batches: int = 0, world: int = 1, rank: int = 0
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields dict batches of numpy arrays with bucket-quantized shapes,
    plus `texts` (the real rows) and `utt_idx` (dataset index a row).
    `skip_batches` leaves out the epoch's first batches without decoding
    them (a fit resumed mid-epoch). `world` > 1: rank `rank`'s block of
    each batch of the agreed plan (the module's docstring)."""
    if world > 1 and (num_shards > 1 or pad_batch_to):
        raise ValueError("make_dataloader: world > 1 plans the whole "
                         "manifest; num_shards and pad_batch_to do not apply")
    n = len(dataset)
    order = np.arange(n)
    if cfg.shuffle:
        np.random.default_rng(cfg.seed + epoch).shuffle(order)
    order = order[shard_index::num_shards]

    edges = _bucket_edges(cfg.max_duration, cfg.num_buckets,
                          dataset.sample_rate)
    durations = np.asarray([dataset.entries[i].duration for i in order])
    sig_lens = np.ceil(durations * dataset.sample_rate).astype(np.int64)
    bucket_of = np.searchsorted(edges, sig_lens, side="left").clip(
        0, len(edges) - 1)
    buckets: List[List[int]] = [[] for _ in edges]
    for idx, b in zip(order, bucket_of):
        buckets[b].append(int(idx))

    bbs = getattr(cfg, "bucketing_batch_size", None)
    if bbs is None:
        sizes = [cfg.batch_size] * len(edges)
    elif isinstance(bbs, int):
        sizes = [max(1, int(round(bbs * edges[-1] / e))) for e in edges]
    else:
        if len(bbs) != len(edges):
            raise ValueError(f"bucketing_batch_size has {len(bbs)} entries "
                             f"for {len(edges)} buckets")
        sizes = [int(v) for v in bbs]

    batches: List[tuple] = []
    for b, idxs in enumerate(buckets):
        bs = sizes[b]
        for s in range(0, len(idxs), bs):
            chunk = idxs[s:s + bs]
            if drop_last and len(chunk) < bs:
                continue
            batches.append((b, chunk))
    if cfg.shuffle:
        np.random.default_rng(cfg.seed * 7919 + epoch).shuffle(batches)
    batches = batches[skip_batches:]

    pool = (ThreadPoolExecutor(max_workers=num_workers)
            if num_workers > 1 else None)
    load = lambda ids: (list(pool.map(dataset.__getitem__, ids))
                        if pool is not None else [dataset[i] for i in ids])
    try:
        for b, idxs in batches:
            if world == 1:
                yield _collate(load(idxs), int(edges[b]), token_quantum,
                               pad_batch_to, idxs=idxs)
                continue
            n = len(idxs)
            rows = -(-n // world)                    # rows a rank
            block = [idxs[i % n] for i in range(rank * rows,
                                                (rank + 1) * rows)]
            max_tok = max(len(dataset.tokens(i)) for i in idxs)
            yield _collate(load(block), int(edges[b]), token_quantum,
                           idxs=block, n_real=min(max(n - rank * rows, 0),
                                                  rows), max_tok=max_tok)
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def _collate(samples, pad_sig: int, token_quantum: int,
             pad_batch_to: Optional[int] = None, idxs=None,
             n_real: Optional[int] = None,
             max_tok: Optional[int] = None) -> Dict[str, np.ndarray]:
    """`n_real`: the real rows among `samples` (the rest repeat rows of the
    global batch); `max_tok`: the global batch's longest token row."""
    if max_tok is None:
        max_tok = max((len(s.tokens) for s in samples), default=1)
    pad_tok = max(token_quantum,
                  int(math.ceil(max_tok / token_quantum) * token_quantum))
    texts = [s.text for s in samples[:n_real]]
    n_real = bs = len(samples)
    if pad_batch_to and bs % pad_batch_to:
        bs += pad_batch_to - bs % pad_batch_to
    signal = np.zeros((bs, pad_sig), np.float32)
    signal_len = np.zeros((bs,), np.int32)
    tokens = np.zeros((bs, pad_tok), np.int32)
    token_len = np.zeros((bs,), np.int32)
    for i in range(bs):
        s = samples[i % n_real]      # cyclic repeat fills the padding rows
        ln = min(len(s.signal), pad_sig)
        signal[i, :ln] = s.signal[:ln]
        signal_len[i] = ln
        tl = min(len(s.tokens), pad_tok)
        tokens[i, :tl] = s.tokens[:tl]
        token_len[i] = tl
    out = {"signal": signal, "signal_len": signal_len,
           "tokens": tokens, "token_len": token_len,
           "texts": texts}
    if idxs is not None:
        out["utt_idx"] = np.asarray([idxs[i % n_real] for i in range(bs)],
                                    np.int32)
    return out


def stack_batches(iterator, k: int):
    """Groups of `k` consecutive SAME-SHAPE host batches, each stacked along
    a leading (K, ...) steps axis for train/trainer.make_distil_multi_step
    (JAX's stack_batches: the bucketed loader emits a few shapes, so a
    group waits for k batches of its shape). A stack carries `"_steps":
    True` and the `texts` of its last batch; the batches left over at the
    end (fewer than k of a shape) are yielded unstacked, so every batch
    trains. `utt_idx` is stacked like the arrays."""
    pending: dict = {}
    for batch in iterator:
        texts = batch.pop("texts", None)
        key = tuple(sorted((n, v.shape) for n, v in batch.items()))
        group = pending.setdefault(key, [])
        group.append((batch, texts))
        if len(group) == k:
            stacked = {n: np.stack([b[n] for b, _ in group])
                       for n in group[0][0]}
            stacked["texts"] = group[-1][1]
            stacked["_steps"] = True
            del pending[key]
            yield stacked
    for group in pending.values():
        for batch, texts in group:
            batch["texts"] = texts
            yield batch


def to_device(iterator, device) -> Iterator[Dict]:
    """Host batches -> batches of tensors on `device`, one batch ahead: each
    numpy array or CPU tensor (the teacher cache's features) is pinned (on
    CUDA) and copied with non_blocking=True, so the copy of batch i + 1
    overlaps the step on batch i. Other keys (`texts`, `_steps`) pass
    through."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(batch):
        out = {}
        for k, v in batch.items():
            if isinstance(v, (np.ndarray, torch.Tensor)):
                t = (v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.ascontiguousarray(v)))
                if pin:
                    t = t.pin_memory()
                out[k] = t.to(device, non_blocking=pin)
            else:
                out[k] = v
        return out

    pending = None
    for batch in iterator:
        nxt = put(batch)
        if pending is not None:
            yield pending
        pending = nxt
    if pending is not None:
        yield pending
