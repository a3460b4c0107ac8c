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
- Metrics go to <workdir>/metrics.jsonl, one JSON object a line. JAX's
  W&B passthrough is not ported.

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

Not ported: `steps_per_dispatch` > 1, the teacher feature caches and
tensor parallelism; the Trainer raises for them.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from tpu_asr_torch.config import TrainConfig
from tpu_asr_torch.data.dataset import (AudioToBPEDataset, make_dataloader,
                                        to_device)
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.parallel import mesh
from tpu_asr_torch.train.trainer import (DistilTrainState,
                                         make_distil_eval_step,
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
    float} object a line; written by rank 0 alone."""

    def __init__(self, workdir):
        self.path = Path(workdir) / "metrics.jsonl"
        self.enabled = mesh.is_main_process()
        if self.enabled:
            self.path.parent.mkdir(parents=True, exist_ok=True)

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


def refusals(cfg: TrainConfig):
    """What of `cfg` the port's Trainer does not run, as messages."""
    out = []
    if cfg.steps_per_dispatch > 1:
        out.append("steps_per_dispatch > 1")
    if cfg.cache_teacher or cfg.cache_teacher_all:
        out.append("the teacher feature caches (cache_teacher, "
                   "cache_teacher_all)")
    if cfg.tp_size > 1:
        out.append("tensor parallelism (tp_size > 1)")
    world = mesh.process_count()
    if cfg.dp_size not in (-1, world):
        out.append(f"dp_size={cfg.dp_size} in a world of {world} rank(s): "
                   "start the ranks with tpu_asr_torch.parallel.launch, "
                   "the CLIs' --gpus N or torchrun")
    return out


# the step's metrics computed after the gradient reduction, equal on every
# rank; every other metric is the rank's share of the global value
_NOT_SHARES = ("grad_norm", "nonfinite_grad_elems")


class Trainer:
    """Config-driven KD trainer (one class for the reference's four)."""

    def __init__(self, model: DistilCTCModel, cfg: TrainConfig, tokenizer,
                 workdir, log_every: int = 50, train_wer_every: int = 0,
                 device="cuda"):
        refused = refusals(cfg)
        if refused:
            raise ValueError("tpu_asr_torch's Trainer does not run "
                             + "; ".join(refused))
        self.device = torch.device(device)
        self.world, self.rank = mesh.process_count(), mesh.process_index()
        self.model = model.to(self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.workdir = Path(workdir)
        self.ckpt_dir = self.workdir / "checkpoints"
        self.logger = MetricsLogger(self.workdir)
        self.log_every = log_every
        self.train_wer_every = train_wer_every
        self._train_step = make_distil_train_step(model)
        self._eval_step = make_distil_eval_step(model)
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
            for batch in to_device(raw, self.device):
                texts = batch.pop("texts", None)
                batch.pop("utt_idx", None)
                state, metrics = self._train_step(state, batch, cfg.seed)
                step = state.step
                maybe_inject_fault(cfg.simulated_fault, step)
                if crossed(step, 1, cfg.heartbeat_every):
                    write_heartbeat(self.workdir, step)
                if straggler is not None:
                    now = time.perf_counter()
                    straggler.tick(now - t_prev)
                    t_prev = now
                    if crossed(step, 1, cfg.straggler_report_every):
                        rep = straggler.report()
                        self.logger.log(
                            {f"straggler/rank{i}_mean_s": v
                             for i, v in enumerate(rep["per_rank_mean_s"])}
                            | {"straggler/n_flagged":
                               len(rep["stragglers"])}, step)
                if crossed(step, 1, self.log_every) or step == 1:
                    row = global_metrics(metrics)
                    row["epoch"] = epoch
                    row["steps_per_sec"] = (step - step0) / max(
                        time.perf_counter() - t0, 1e-9)
                    if (self.train_wer_every
                            and crossed(step, 1, self.train_wer_every)):
                        row["train_wer"] = self._batch_wer(batch, texts)
                    self.logger.log(row, step)
                preempt.exit_if_requested(save)
                if max_steps is not None and step >= max_steps:
                    done = True
                    break
            else:
                state.epoch, state.epoch_step = epoch + 1, state.step
            save()
            if val_manifest:
                val = self.evaluate(val_manifest)
                self.logger.log({f"val/{k}": v for k, v in val.items()},
                                state.step)
            preempt.exit_if_requested(save)
        return state

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
