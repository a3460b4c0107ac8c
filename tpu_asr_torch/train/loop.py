"""The fit loop and evaluation: the port's counterpart of
tpu_asr/train/loop.py (the Lightning `Trainer.fit` / `trainer.test` of
reference asr_train.py:1690-1890 and NeMo ctc_models.py:549-692), on one
device or on one rank of a data-parallel group.

- `fit`: epochs of bucketed batches (data/dataset.py; each host batch
  copied to the device one batch ahead), the KD train step
  (train/trainer.py), a checkpoint (`checkpoints/last`) after every epoch
  and on SIGTERM, `val` metrics after every epoch. A run started afresh
  rotates an old `last` to `last-vN`; a resumed one restores the model,
  the optimizer, the step and its place in the epoch, so it draws the
  same batches and the same per-step randomness as a run never stopped.
  SIGTERM is saved at the next step boundary (or after the epoch's val
  pass), then the process exits 143.
- Metrics stay on the device; they are read only when a log boundary is
  crossed (`log_every`), as JAX's loop reads them with jax.device_get.
  Heartbeats and the straggler report use the same interval-crossing test
  (exp_manager.crossed), not `step % N == 0`.
- `evaluate`: CTC loss over the real utterances only and greedy WER,
  accumulated as (scores, words) sums, as JAX's `evaluate`.
- `evaluate_packed`: the same metrics with the student's encoder on dense
  packed rows (data/packing.py; the attention kernel's segment mode).
  Flow matching feeds the decoder from the FM output, so it is refused, as
  in JAX.
- Metrics go to <workdir>/metrics.jsonl, one JSON object a line, and to
  W&B where `wandb` imports and its `init` succeeds (JAX's passthrough).

Data parallelism (parallel/mesh.py): in an initialised process group of N
ranks every rank builds the same Trainer and calls the same methods. Each
takes its block of every batch of one agreed plan (data/dataset.py), the
step runs under DDP (train/trainer.py), and the run takes the steps that
one rank takes with the same flags: `batch_size` is the GLOBAL batch. Rank
0 alone writes metrics and checkpoints (barriers around them); every rank
writes its own heartbeat. The logged losses are the sums of the ranks'
shares, read at a log boundary; `evaluate` and `evaluate_packed` sum
(scores, words, loss, tokens, utterances) over the ranks and count only
real rows. `cfg.dp_size` is -1 or the world size.

- `steps_per_dispatch` K > 1: K same-shape batches stacked
  (data/dataset.stack_batches) run as one multi-step
  (train/trainer.make_distil_multi_step); the last step's metrics are
  logged.
- The teacher feature caches (`cache_teacher`: the last layer, for logit
  KD and last-scope layerwise KD; `cache_teacher_all`: every layer, for
  every KD mode): the frozen teacher reads the unaugmented signal in eval
  mode, so its features are a function of the utterance. A batch whose
  utterances are all cached runs the cached step (no teacher forward);
  any other runs the harvest step, which trains as usual and stores the
  teacher's features of its utterances (`TeacherFeatureCache`: in RAM, or
  one .npy a utterance under `cache_teacher_dir`, read back by mmap).
  With N ranks the ranks agree on the step a batch takes; in RAM every
  harvest gathers the global batch's features, so every rank holds every
  utterance; with a directory each rank writes its own utterances and the
  ranks exchange what they wrote at the end of each epoch.

Tensor parallelism (`tp_size` > 1): the Trainer builds a ('data',
'model') mesh of the world (parallel/mesh.make_mesh) and keeps each rank's
slices of the model (parallel/sharding.shard_module); the data ranks split
the global batch, the ranks of a model group hold the same rows, and the
checkpoints hold whole tensors (utils/checkpoint.py). JAX's Trainer keeps
its state replicated at any tp_size (tpu_asr/train/loop.py), which
computes the same numbers; the port stores it sharded by the rules, as
JAX's `__graft_entry__.py` does for its TP step.

Refused (ValueError): a `tp_size` that does not divide the world, a
`dp_size` other than world / tp_size, a teacher cache with tp_size > 1,
and, as JAX does, `cache_teacher` with flow matching, DiffKD, diffm
or all-scope layerwise KD (use `cache_teacher_all`) and a cache together
with `steps_per_dispatch` > 1.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from tpu_asr_torch.config import TrainConfig
from tpu_asr_torch.data.dataset import (AudioToBPEDataset, make_dataloader,
                                        stack_batches, to_device)
from tpu_asr_torch.models.distil_model import (DistilCTCModel,
                                               last_layer_cacheable)
from tpu_asr_torch.parallel import mesh
from tpu_asr_torch.parallel.sharding import shard_module
from tpu_asr_torch.train.trainer import (DistilTrainState,
                                         make_distil_eval_step,
                                         make_distil_multi_step,
                                         make_distil_train_step)
from tpu_asr_torch.utils.checkpoint import (Preemption,
                                            install_preemption_handler,
                                            restore_signal_handler,
                                            restore_train_state, rotate_last,
                                            save_train_state)
from tpu_asr_torch.utils.exp_manager import (StragglerDetector, crossed,
                                             maybe_inject_fault,
                                             write_heartbeat)
from tpu_asr_torch.utils.wer import WERMetric


class MetricsLogger:
    """JSONL metrics: <workdir>/metrics.jsonl, one {"step": ..., name:
    float} object a line; written by rank 0 alone, which also passes each
    row to W&B (`wandb.init(project, name, dir=workdir)` and `log(row,
    step)`) when the `wandb` package imports and its `init` succeeds, as
    JAX's MetricsLogger does; otherwise W&B is left out without a word."""

    def __init__(self, workdir, project: str = "", name: str = ""):
        self.path = Path(workdir) / "metrics.jsonl"
        self.enabled = mesh.is_main_process()
        self._wandb = None
        if not self.enabled:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        try:
            import wandb
            self._wandb = wandb.init(project=project or None,
                                     name=name or None, dir=str(workdir))
        except Exception:
            self._wandb = None

    def log(self, metrics: Dict, step: int) -> None:
        if not self.enabled:
            return
        row = {"step": int(step)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self._wandb is not None:
            self._wandb.log(row, step=int(step))


class TeacherFeatureCache:
    """Host store of the frozen teacher's features a utterance (JAX's class
    of that name): the last layer (T_i, Dt), or with `all_layers` every
    layer (L, T_i, Dt), cut to the utterance's T_i frames. It stores
    bfloat16 under bf16 compute (lossless; bf16 keeps fp32's exponent
    range, where the unnormalised mid-stack features can pass fp16's 65504)
    and float32 under fp32. bfloat16 is kept as its bits, uint16 numpy
    arrays (numpy has no bfloat16), and viewed back as torch.bfloat16.
    With `spill_dir` each utterance goes to <dir>/<idx>.npy (written to a
    temporary name and renamed) and is read back by mmap; else it stays in
    RAM. `fresh` holds the utterances written to the directory since
    `merge` last took other ranks' writes in."""

    def __init__(self, dtype: torch.dtype, all_layers: bool = False,
                 spill_dir: Optional[str] = None):
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"TeacherFeatureCache stores bfloat16 or "
                             f"float32, not {dtype}")
        self.dtype = dtype
        self.all_layers = all_layers
        self.spill_dir = spill_dir
        if spill_dir:
            Path(spill_dir).mkdir(parents=True, exist_ok=True)
        self.data = {}        # utt idx -> stored array
        self._on_disk = set()
        self.fresh = set()
        self.tprime = {}      # padded signal length -> encoded T'

    def has_all(self, idxs) -> bool:
        return all(int(i) in self.data or int(i) in self._on_disk
                   for i in idxs)

    def to_host(self, feats: torch.Tensor) -> np.ndarray:
        """`feats` in the stored form: a numpy array of uint16 bits
        (bfloat16) or float32."""
        t = feats.detach().to(self.dtype).cpu()
        if self.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    def _from_host(self, arr: np.ndarray) -> torch.Tensor:
        if self.dtype == torch.bfloat16:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)

    def _store(self, i: int, arr: np.ndarray) -> None:
        if self.spill_dir:
            path = Path(self.spill_dir) / f"{i}.npy"
            tmp = path.with_name(f"{i}.npy.tmp{os.getpid()}")
            with open(tmp, "wb") as f:
                np.save(f, np.ascontiguousarray(arr))
            os.replace(tmp, path)
            self._on_disk.add(i)
            self.fresh.add(i)
        else:
            self.data[i] = np.ascontiguousarray(arr)

    def _load(self, i: int) -> np.ndarray:
        if i in self.data:
            return self.data[i]
        return np.load(Path(self.spill_dir) / f"{i}.npy", mmap_mode="r")

    def put_rows(self, idxs, host: np.ndarray, lengths, l_pad: int) -> None:
        """Store batch-major stored-form features: `host` (B, T', Dt), or
        (B, L, T', Dt) for the all-layer cache; utterances already held
        are skipped."""
        self.tprime[int(l_pad)] = int(host.shape[-2])
        for r, i in enumerate(idxs):
            i = int(i)
            if i in self.data or i in self._on_disk:
                continue
            n = int(lengths[r])
            self._store(i, host[r, :, :n] if self.all_layers
                        else host[r, :n])

    def put_batch(self, idxs, feats: torch.Tensor, lengths,
                  l_pad: int) -> None:
        """feats: (B, T', Dt) last-layer, or (L, B, T', Dt) all-layer (the
        harvest step's outputs)."""
        if self.all_layers:
            feats = feats.transpose(0, 1)
        self.put_rows(idxs, self.to_host(feats), np.asarray(lengths), l_pad)

    def merge(self, idxs) -> None:
        """Take in utterances that other ranks wrote to the directory."""
        self._on_disk.update(int(i) for i in idxs)

    def assemble(self, idxs, t_prime: int, d_t: int) -> torch.Tensor:
        """Last-layer: (B, T', Dt). All-layer: (B, L, T', Dt), batch-major
        as the cached step reads it. Frames past an utterance are 0; a CPU
        tensor of the stored dtype."""
        first = self._load(int(idxs[0]))
        lead = (len(idxs), first.shape[0]) if self.all_layers else \
            (len(idxs),)
        out = np.zeros(lead + (t_prime, d_t), first.dtype)
        for r, i in enumerate(idxs):
            f = self._load(int(i))
            if self.all_layers:
                out[r, :, :f.shape[1]] = f
            else:
                out[r, :f.shape[0]] = f
        return self._from_host(out)


def refusals(cfg: TrainConfig, distill=None):
    """What of `cfg` (with the model's DistillationConfig `distill`) the
    port's Trainer does not run, as messages."""
    out = []
    world = mesh.process_count()
    if world % max(cfg.tp_size, 1):
        out.append(f"tp_size={cfg.tp_size} in a world of {world} rank(s)")
    elif cfg.dp_size not in (-1, world // max(cfg.tp_size, 1)):
        out.append(f"dp_size={cfg.dp_size} x tp_size={cfg.tp_size} in a "
                   f"world of {world} rank(s): start the ranks with "
                   "tpu_asr_torch.parallel.launch, the CLIs' --gpus N or "
                   "torchrun")
    if cfg.tp_size > 1 and (cfg.cache_teacher or cfg.cache_teacher_all):
        out.append("a teacher feature cache with tp_size > 1")
    if cfg.cache_teacher or cfg.cache_teacher_all:
        if (distill is not None and not cfg.cache_teacher_all
                and not last_layer_cacheable(distill)):
            out.append("cache_teacher with flow matching, DiffKD, diffm or "
                       "all-scope layerwise KD, which read every teacher "
                       "layer (use cache_teacher_all)")
        if cfg.steps_per_dispatch > 1:
            out.append("a teacher feature cache with steps_per_dispatch > "
                       "1 (cached and harvest batches cannot stack)")
    return out


# the step's metrics computed after the gradient reduction, equal on every
# rank; every other metric is the rank's share of the global value
_NOT_SHARES = ("grad_norm", "nonfinite_grad_elems")


class Trainer:
    """Config-driven KD trainer (one class for the reference's four)."""

    def __init__(self, model: DistilCTCModel, cfg: TrainConfig, tokenizer,
                 workdir, log_every: int = 50, train_wer_every: int = 0,
                 device="cuda"):
        refused = refusals(cfg, model.distill)
        if refused:
            raise ValueError("tpu_asr_torch's Trainer does not run "
                             + "; ".join(refused))
        self.device = torch.device(device)
        self.model = model.to(self.device)
        if cfg.tp_size > 1:
            # a ('data', 'model') mesh; each rank keeps its slices
            shard_module(model, mesh.make_mesh(cfg.dp_size, cfg.tp_size))
        # the loader splits the global batch over the data ranks
        self.world, self.rank = mesh.axis_size("data"), mesh.axis_index(
            "data")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.workdir = Path(workdir)
        self.ckpt_dir = self.workdir / "checkpoints"
        self.logger = MetricsLogger(self.workdir)
        self.log_every = log_every
        self.train_wer_every = train_wer_every
        self._train_step = make_distil_train_step(model)
        self._multi_step = make_distil_multi_step(model)
        self._eval_step = make_distil_eval_step(model)
        self._cache: Optional[TeacherFeatureCache] = None
        if (cfg.cache_teacher or cfg.cache_teacher_all) and \
                model.needs_teacher:
            all_layers = cfg.cache_teacher_all
            self._cache = TeacherFeatureCache(
                torch.bfloat16 if model.student_cfg.compute_dtype
                == "bfloat16" else torch.float32, all_layers=all_layers,
                spill_dir=cfg.cache_teacher_dir)
            self._train_step_cached = make_distil_train_step(
                model, cached_teacher=not all_layers,
                cached_all_layers=all_layers)
            self._train_step_harvest = make_distil_train_step(
                model, harvest_teacher=True, harvest_all=all_layers)
        self.state: Optional[DistilTrainState] = None

    # ------------------------------------------------------------------
    def init_state(self) -> DistilTrainState:
        """The train state over the model's current weights: the optimizer
        of cfg.optim at step 0."""
        self.state = DistilTrainState.create(self.model, self.cfg.optim)
        return self.state

    def load_teacher_params(self, teacher_state_dict) -> None:
        """Load converted teacher weights (a CTCModel state_dict, e.g.
        convert/nemo_import.load_nemo_checkpoint's) into the frozen
        teacher; it is not in the optimizer, so the state stays."""
        self.model.teacher.load_state_dict(teacher_state_dict, strict=True)

    # ------------------------------------------------------------------
    def _dataset(self, manifest: str, ds_cfg) -> AudioToBPEDataset:
        return AudioToBPEDataset(manifest, self.tokenizer,
                                 ds_cfg.sample_rate, ds_cfg.min_duration,
                                 ds_cfg.max_duration,
                                 decode_cache_dir=ds_cfg.decode_cache_dir)

    def fit(self, train_manifest: str, val_manifest: Optional[str] = None,
            resume: bool = False, max_steps: Optional[int] = None,
            resume_from=None) -> DistilTrainState:
        """Train cfg.max_epochs epochs (or up to `max_steps`).
        `resume_from`, a checkpoint file, is restored and must exist;
        without it, `resume` restores checkpoints/last when it exists, as
        JAX's fit does. A fit that restores nothing rotates an old `last`
        to `last-vN`."""
        dataset = self._dataset(train_manifest, self.cfg.train_ds)
        if len(dataset) == 0:
            raise ValueError(f"empty training dataset: {train_manifest}")
        if resume_from is not None and not Path(resume_from).is_file():
            raise FileNotFoundError(f"no checkpoint at {resume_from}")
        if self.state is None:
            self.init_state()
        src = Path(resume_from) if resume_from else self.ckpt_dir / "last"
        if resume_from or (resume and src.is_file()):
            self.state = restore_train_state(src.parent, self.state,
                                             name=src.name)
        else:
            rotate_last(self.ckpt_dir)
        preempt = Preemption()
        prev = install_preemption_handler(preempt)
        try:
            return self._fit_epochs(dataset, val_manifest, max_steps,
                                    preempt)
        finally:
            restore_signal_handler(prev)

    def _fit_epochs(self, dataset, val_manifest, max_steps, preempt):
        cfg, state = self.cfg, self.state
        save = lambda: save_train_state(self.ckpt_dir, state)
        straggler = (StragglerDetector() if cfg.straggler_report_every
                     else None)
        t0 = t_prev = time.perf_counter()
        step0, done = state.step, False
        while state.epoch < cfg.max_epochs and not done:
            epoch = state.epoch
            raw = make_dataloader(dataset, cfg.train_ds, epoch=epoch,
                                  skip_batches=state.step - state.epoch_step,
                                  world=self.world, rank=self.rank)
            if cfg.steps_per_dispatch > 1:
                raw = stack_batches(raw, cfg.steps_per_dispatch)
            if self._cache is not None:
                raw = self._attach_cached_teacher(raw)
            for batch in to_device(raw, self.device):
                texts = batch.pop("texts", None)
                utt_idx = batch.pop("utt_idx", None)
                n_done = 1
                if batch.pop("_steps", False):
                    # K steps in one dispatch; the last step's metrics
                    state, metrics = self._multi_step(state, batch,
                                                      cfg.seed)
                    n_done = batch["signal"].shape[0]
                    metrics = {k: v[-1] for k, v in metrics.items()}
                    batch = {k: v[-1] for k, v in batch.items()}
                elif "tch_last_feat" in batch or "tch_all_feat" in batch:
                    state, metrics = self._train_step_cached(state, batch,
                                                             cfg.seed)
                elif self._cache is not None and utt_idx is not None:
                    state, metrics, harvested = self._train_step_harvest(
                        state, batch, cfg.seed)
                    self._harvest(utt_idx, harvested,
                                  batch["signal"].shape[1])
                else:
                    state, metrics = self._train_step(state, batch, cfg.seed)
                step = state.step
                maybe_inject_fault(cfg.simulated_fault, step, n_done)
                if crossed(step, n_done, cfg.heartbeat_every):
                    write_heartbeat(self.workdir, step)
                if straggler is not None:
                    now = time.perf_counter()
                    straggler.tick((now - t_prev) / n_done)
                    t_prev = now
                    if crossed(step, n_done, cfg.straggler_report_every):
                        rep = straggler.report()
                        self.logger.log(
                            {f"straggler/rank{i}_mean_s": v
                             for i, v in enumerate(rep["per_rank_mean_s"])}
                            | {"straggler/n_flagged":
                               len(rep["stragglers"])}, step)
                if crossed(step, n_done, self.log_every) or step == n_done:
                    row = global_metrics(metrics)
                    row["epoch"] = epoch
                    row["steps_per_sec"] = (step - step0) / max(
                        time.perf_counter() - t0, 1e-9)
                    if (self.train_wer_every
                            and crossed(step, n_done, self.train_wer_every)):
                        row["train_wer"] = self._batch_wer(batch, texts)
                    self.logger.log(row, step)
                preempt.exit_if_requested(save)
                if max_steps is not None and step >= max_steps:
                    done = True
                    break
            else:
                state.epoch, state.epoch_step = epoch + 1, state.step
            if self._cache is not None and self._cache.spill_dir:
                # every rank's writes of the epoch, to every rank
                for written in mesh.gather_objects(
                        sorted(self._cache.fresh)):
                    self._cache.merge(written)
                self._cache.fresh.clear()
            save()
            if val_manifest:
                val = self.evaluate(val_manifest)
                self.logger.log({f"val/{k}": v for k, v in val.items()},
                                state.step)
            preempt.exit_if_requested(save)
        return state

    def _attach_cached_teacher(self, raw):
        """Host batches with the cached teacher features attached
        (`tch_last_feat` (B, T', Dt) or `tch_all_feat` (B, L, T', Dt)) when
        every utterance of the batch is cached and its padded length's T'
        is known; at N ranks only when that holds on every rank, so that
        the ranks take the same step."""
        d_t = self.model.teacher_cfg.encoder.d_model
        cache = self._cache
        key = "tch_all_feat" if cache.all_layers else "tch_last_feat"
        for batch in raw:
            idxs = batch.get("utt_idx")
            l_pad = batch["signal"].shape[1]
            ready = (idxs is not None and l_pad in cache.tprime
                     and cache.has_all(idxs))
            if self.world > 1:
                ready = not mesh.any_process(not ready)
            if ready:
                batch[key] = cache.assemble(idxs, cache.tprime[l_pad], d_t)
            yield batch

    def _harvest(self, utt_idx, harvested, l_pad: int) -> None:
        """Store the harvest step's teacher features of the batch's
        utterances; in RAM at N ranks, the global batch's (gathered)."""
        tch_last, tch_feats, enc_len = harvested
        cache = self._cache
        host = cache.to_host(tch_feats.transpose(0, 1) if cache.all_layers
                             else tch_last)
        idxs = utt_idx.cpu().numpy()
        lens = enc_len.cpu().numpy()
        if self.world > 1 and not cache.spill_dir:
            host, idxs, lens = (mesh.gather_host_rows(a)
                                for a in (host, idxs, lens))
        cache.put_rows(idxs, host, lens, l_pad)

    def _batch_wer(self, batch, texts) -> float:
        """Greedy WER on the current train batch (its real rows, over every
        rank)."""
        _, (tokens, n_tokens) = self._eval_step(self.state, batch)
        wer = WERMetric()
        texts = texts or []
        wer.update(self._hyps(tokens.cpu().numpy(), n_tokens.cpu().numpy(),
                              len(texts)), texts)
        scores, words = mesh.cross_process_sum([wer.scores, wer.words])
        return scores / words if words else float("inf")

    def _hyps(self, tokens, n_tokens, n):
        return [self.tokenizer.ids_to_text(tokens[i, :n_tokens[i]].tolist())
                for i in range(n)]

    # ------------------------------------------------------------------
    def _eval_batches(self, dataset):
        return make_dataloader(dataset, self.cfg.test_ds, epoch=0,
                               world=self.world, rank=self.rank)

    def evaluate(self, manifest: str) -> Dict[str, float]:
        """{'wer', 'loss', 'num_utts'} of the student on `manifest`
        (cfg.test_ds): the CTC NLL of each real row, divided by its target
        length under ctc_reduction 'mean', summed and divided by the
        utterances (by the target tokens under 'mean_volume'); greedy WER
        as (scores, words) sums."""
        cfg = self.cfg
        assert self.state is not None, "call init_state first"
        dataset = self._dataset(manifest, cfg.test_ds)
        wer = WERMetric()
        nll_contrib, tok_sum, n = 0.0, 0.0, 0
        reduction = self.model.student_cfg.ctc_reduction
        for batch in to_device(self._eval_batches(dataset), self.device):
            texts = batch.pop("texts")
            batch.pop("utt_idx", None)
            metrics, (tokens, n_tokens) = self._eval_step(self.state, batch)
            per_nll = metrics["per_sample_ctc"][:len(texts)].cpu().numpy()
            tl = batch["token_len"][:len(texts)].cpu().numpy().astype(
                np.float64)
            if reduction == "mean":
                nll_contrib += float((per_nll / np.maximum(tl, 1.0)).sum())
            else:
                nll_contrib += float(per_nll.sum())
            tok_sum += float(tl.sum())
            n += len(texts)
            wer.update(self._hyps(tokens.cpu().numpy(),
                                  n_tokens.cpu().numpy(), len(texts)), texts)
        return _result(wer, nll_contrib, tok_sum, n, reduction)

    def evaluate_packed(self, manifest: str, t_pack: int = 512,
                        row_multiple: int = 4,
                        utt_chunk: int = 512) -> Dict[str, float]:
        """`evaluate`'s metrics with the student's encoder on packed rows
        of `t_pack` subsampled frames (several utterances a row, guard
        frames between them, the attention's segment mode): bucketed
        featurize and pre-encode, then every ~`utt_chunk` utterances one
        pack, one `forward_packed` and per-utterance CTC NLL and greedy
        decode. Each utterance's log-probs are those of its own forward, so
        loss and WER match `evaluate` up to float summation order."""
        from tpu_asr_torch.data.packing import (guard_frames, pack_frames,
                                                plan_packing)
        from tpu_asr_torch.ops.ctc import ctc_greedy_decode, ctc_loss

        if self.model.distill.use_flow_matching:
            raise ValueError(
                "evaluate_packed requires the plain CTC decode path; "
                "use_flow_matching feeds the decoder from the FM output — "
                "use evaluate()")
        cfg, dev = self.cfg, self.device
        assert self.state is not None, "call init_state first"
        student = self.model.student.eval()
        guard = guard_frames(student.cfg.encoder.conv_kernel_size)
        blank = student.cfg.decoder.num_classes
        reduction = student.cfg.ctc_reduction
        wer = WERMetric()
        agg = {"nll": 0.0, "tok": 0.0, "n": 0}
        feats, enc_lens, toks_l, tlens_l, texts_p = [], [], [], [], []
        idx = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        def flush():
            n_ch = len(enc_lens)
            if n_ch == 0:
                return
            ech = np.asarray(enc_lens, np.int64)
            t_src = max(int(f.shape[1]) for f in feats)
            big = torch.cat([torch.nn.functional.pad(
                f, (0, 0, 0, t_src - f.shape[1])) for f in feats])
            plan = plan_packing(ech, t_pack=t_pack, guard=guard,
                                row_multiple=row_multiple)
            lp, _ = student.forward_packed(pack_frames(big, plan),
                                           idx(plan.seg_id))
            pos = idx(plan.start)[:, None] + torch.arange(t_pack, device=dev)
            lp_u = lp[idx(plan.row)[:, None],
                      pos.clamp(max=t_pack - 1)].float()
            tk = np.zeros((n_ch, max(max(tlens_l), 1)), np.int32)
            for i, t in enumerate(toks_l):
                m = min(len(t), tk.shape[1])
                tk[i, :m] = np.asarray(t)[:m]
            tl = np.asarray(tlens_l, np.int32)
            with torch.no_grad():
                nll = ctc_loss(lp_u, torch.from_numpy(tk).to(dev), idx(ech),
                               torch.from_numpy(tl).to(dev),
                               reduction="none",
                               backend=self.model.ctc_backend)
                toks, ntoks = ctc_greedy_decode(lp_u, idx(ech), blank)
            per_nll = nll.cpu().numpy().astype(np.float64)
            tlf = tl.astype(np.float64)
            if reduction == "mean":
                agg["nll"] += float((per_nll / np.maximum(tlf, 1.0)).sum())
            else:
                agg["nll"] += float(per_nll.sum())
            agg["tok"] += float(tlf.sum())
            agg["n"] += n_ch
            wer.update(self._hyps(toks.cpu().numpy(), ntoks.cpu().numpy(),
                                  n_ch), texts_p)
            for lst in (feats, enc_lens, toks_l, tlens_l, texts_p):
                lst.clear()

        dataset = self._dataset(manifest, cfg.test_ds)
        for batch in to_device(self._eval_batches(dataset), dev):
            n_real = len(batch["texts"])
            with torch.no_grad():
                f, fl = student.featurizer(batch["signal"],
                                           batch["signal_len"])
                x, ln = student.pre_encode(f, fl)
            feats.append(x[:n_real])
            tokens = batch["tokens"].cpu().numpy()
            for i in range(n_real):
                toks_l.append(tokens[i])
                tlens_l.append(int(batch["token_len"][i]))
            enc_lens.extend(ln[:n_real].cpu().tolist())
            texts_p.extend(batch["texts"])
            if len(enc_lens) >= utt_chunk:
                flush()
        flush()
        return _result(wer, agg["nll"], agg["tok"], agg["n"], reduction)


def global_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The step's metrics as floats, each share summed over the ranks."""
    row = {k: v.item() for k, v in metrics.items()}
    keys = sorted(k for k in row if k not in _NOT_SHARES)
    for k, v in zip(keys, mesh.cross_process_sum([row[k] for k in keys])):
        row[k] = float(v)
    return row


def _result(wer: WERMetric, loss_sum: float, tok_sum: float, n: int,
            reduction: str) -> Dict[str, float]:
    """The metrics of this rank's sums, summed over the ranks first."""
    scores, words, loss_sum, tok_sum, n = mesh.cross_process_sum(
        [wer.scores, wer.words, loss_sum, tok_sum, n])
    if reduction == "mean_volume":
        loss = loss_sum / max(tok_sum, 1.0)
    else:
        loss = loss_sum / max(n, 1)
    return {"wer": scores / words if words else float("inf"),
            "loss": float(loss), "num_utts": float(n)}
