"""Checkpoints and resume: the port's counterpart of
tpu_asr/utils/checkpoint.py, with `torch.save` files in place of orbax
directories and JAX's names: `checkpoints/last`, rotated to `last-vN` when
a run starts afresh, `student` (and `student_config.json`) for inference,
and the trainer's `tokenizer.model` sidecar beside them.

- `save_train_state`: the model's `state_dict` (BatchNorm statistics, the
  frozen teacher and the KD modules included), the optimizer's
  `state_dict`, the step and the fit loop's place (the epoch in progress
  and the step it began at, so a resumed fit goes on where it stopped),
  written to a temporary file and renamed over
  the target, so a preemption cannot leave half a checkpoint.
- `restore_train_state`: loads such a file into a state built the same way
  (the same model and optimizer, parameters in the same order).
- `export_student` / `load_student`: the student's weights only; the KD
  wrapper (teacher, flow matching, router, ...) is not part of them.
- `install_preemption_handler`: SIGTERM only raises a flag; the fit loop
  saves and exits 143 where its state is whole (after a step, after an
  epoch), never from inside an optimizer update.

Under data parallelism (parallel/mesh.py) the state is the unwrapped
model's (no DDP `module.` prefix) and equal on every rank: rank 0 alone
writes, rotates and exports, the others wait at a barrier after it, and
every rank restores the same file, so a checkpoint saved at one world size
restores at any other. The ranks agree on a SIGTERM that reached any of
them before they save and exit.

Under tensor parallelism (parallel/sharding.shard_module) a rank holds
slices of some parameters and of their optimizer moments: every rank
gathers them whole over the model group before rank 0 writes, and a
restore cuts the whole tensors to the rank's slices, so the file is the
one-rank checkpoint's and restores at any layout (JAX's
tests/test_sharding.py shows the same of its orbax checkpoints).
"""

from __future__ import annotations

import json
import os
import signal
import sys
from pathlib import Path
from typing import Callable

import torch

from tpu_asr_torch.parallel.mesh import (any_process, is_main_process,
                                         sync_processes)
from tpu_asr_torch.parallel.sharding import (full_optimizer_state,
                                             full_state_dict,
                                             load_full_state_dict,
                                             shard_optimizer_state)


def _atomic_save(obj, target: Path) -> Path:
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f".{target.name}.tmp{os.getpid()}")
    torch.save(obj, tmp)
    os.replace(tmp, target)
    return target


def rotate_last(ckpt_dir) -> None:
    """last -> last-vN (the first free N), as a fresh run starts."""
    ckpt_dir = Path(ckpt_dir).absolute()
    last = ckpt_dir / "last"
    if is_main_process() and last.exists():
        n = 1
        while (ckpt_dir / f"last-v{n}").exists():
            n += 1
        last.rename(ckpt_dir / f"last-v{n}")
    sync_processes("rotate_last")


def save_train_state(ckpt_dir, state, name: str = "last") -> Path:
    """Write {step, epoch, epoch_step, model, optimizer} of a
    DistilTrainState (rank 0; the others wait)."""
    target = Path(ckpt_dir).absolute() / name
    model, opt = state.model.state_dict(), state.optimizer.state_dict()
    if _sharded(state.model):
        # whole tensors, gathered on every rank of the model group
        model = full_state_dict(state.model)
        opt = full_optimizer_state(state.optimizer)
    if is_main_process():
        _atomic_save({"step": int(state.step), "epoch": state.epoch,
                      "epoch_step": state.epoch_step,
                      "model": model, "optimizer": opt}, target)
    sync_processes("save_train_state")
    return target


def restore_train_state(ckpt_dir, state, name: str = "last"):
    """Load `ckpt_dir/name` into `state` (its model and optimizer) in
    place; returns the state."""
    dev = next(state.model.parameters()).device
    saved = torch.load(Path(ckpt_dir).absolute() / name, map_location=dev,
                       weights_only=True)
    if _sharded(state.model):
        load_full_state_dict(state.model, saved["model"])
        state.optimizer.load_state_dict(shard_optimizer_state(
            state.optimizer, saved["optimizer"]))
    else:
        state.model.load_state_dict(saved["model"], strict=True)
        state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    state.epoch, state.epoch_step = saved["epoch"], saved["epoch_step"]
    return state


def _sharded(model) -> bool:
    return model.__dict__.get("_tp", (1, 0))[0] > 1


def export_student(ckpt_dir, state, student_cfg,
                   name: str = "student") -> Path:
    """The student's `state_dict` alone, and its config as JSON beside it
    (`<name>_config.json`); rank 0 writes, the others wait."""
    ckpt_dir = Path(ckpt_dir).absolute()
    target = ckpt_dir / name
    student = state.model.student.state_dict()
    if _sharded(state.model):
        student = {k[len("student."):]: v for k, v in
                   full_state_dict(state.model).items()
                   if k.startswith("student.")}
    if is_main_process():
        _atomic_save(student, target)
        (ckpt_dir / f"{name}_config.json").write_text(
            json.dumps(student_cfg.to_dict(), indent=2))
    sync_processes("export_student")
    return target


def load_student(ckpt_path, student: torch.nn.Module) -> torch.nn.Module:
    """Load a student export into `student` (a CTCModel of its config)."""
    dev = next(student.parameters()).device
    student.load_state_dict(torch.load(ckpt_path, map_location=dev,
                                       weights_only=True), strict=True)
    return student


class Preemption:
    """Set by the SIGTERM handler; `requested` is read by the fit loop at
    its step boundaries."""

    def __init__(self):
        self.requested = False

    def exit_if_requested(self, save_fn: Callable[[], None]) -> None:
        """Checkpoint and exit 143 when a SIGTERM has arrived (at any rank:
        every rank must call this at the same step)."""
        if any_process(self.requested):
            save_fn()
            sys.exit(143)


def install_preemption_handler(flag: Preemption, sig=signal.SIGTERM):
    """On SIGTERM set `flag.requested` (the state may be mid-update, so
    the handler saves nothing). Returns the previous handler, for
    `restore_signal_handler`."""

    def handler(signum, frame):
        flag.requested = True

    return signal.signal(sig, handler)


def restore_signal_handler(prev, sig=signal.SIGTERM) -> None:
    signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
