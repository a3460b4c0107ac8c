"""What each rank runs in tests/test_torch_ddp.py (spawned by
tpu_asr_torch/parallel/launch.py, so importable by name; torch and the port
only, no JAX). Also run in the pytest process itself, without a process
group, as the one-rank reference.

The configurations and the batch are those of tests/ddp_cases.py.
"""

import dataclasses

import numpy as np
import torch

from tpu_asr_torch.config import OptimConfig
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.parallel import mesh
from tpu_asr_torch.train.loop import global_metrics
from tpu_asr_torch.train.trainer import (DistilTrainState,
                                         make_distil_train_step)

def rank_block(batch, packed=False):
    """This rank's block of a global numpy batch, as tensors; `packed`:
    its part of the batch's packing plan (mesh.packed_rank_block)."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in batch.items()}
    if packed:
        return (mesh.packed_rank_block(tensors)
                if mesh.process_count() > 1 else tensors)
    n = batch["signal"].shape[0] // mesh.process_count()
    r = mesh.row_offset(n)
    return {k: v[r:r + n] for k, v in tensors.items()}


def run_steps(student, teacher, distill, state_dict, batch, steps=1,
              seed=0, lr=None, packed=False):
    """`steps` KD train steps of the rank's rows of `batch` from the weights
    `state_dict` (a path or a dict): per step the metrics (shares summed
    over the ranks), the reduced gradients of the first step, the router's
    per-sample counts and their Gumbel margins (gathered over the ranks),
    the BatchNorm running statistics after the first step and the final
    state_dict, all numpy. `packed`: packed training on the plan that
    `batch` carries, each rank on its part of it."""
    torch.manual_seed(0)
    model = DistilCTCModel(student, teacher, distill)
    if isinstance(state_dict, str):
        state_dict = torch.load(state_dict, weights_only=True)
    model.load_state_dict(state_dict, strict=True)
    optim = OptimConfig(d_model=student.encoder.d_model, warmup_steps=10)
    if lr is not None:
        optim = dataclasses.replace(optim, lr=lr)
    state = DistilTrainState.create(model, optim)
    step = make_distil_train_step(model, packed=packed)
    routed = []
    if model.routed:
        def hook(mod, args, out):
            scores = out[2]["scores"].detach()
            top2 = scores.topk(2, dim=-1).values
            routed.append((mesh.all_gather_rows(out[0], 1),
                           mesh.all_gather_rows(top2[..., 0] - top2[..., 1],
                                                1)))
        model.router.register_forward_hook(hook)
    out = {"metrics": [], "router": []}
    local = rank_block(batch, packed)
    for i in range(steps):
        state, metrics = step(state, local, seed)
        out["metrics"].append(global_metrics(metrics))
        if i == 0:
            out["grads"] = {n: p.grad.detach().numpy().copy()
                            for n, p in model.named_parameters()
                            if p.grad is not None}
            out["stats1"] = {n: b.numpy().copy()
                             for n, b in model.named_buffers()
                             if "running" in n}
    out["router"] = [(s.numpy(), m.numpy()) for s, m in routed]
    out["state"] = {k: v.detach().numpy().copy()
                    for k, v in model.state_dict().items()}
    return out


def mesh_probe():
    """The mesh helpers under the group, as plain values."""
    r, w = mesh.process_index(), mesh.process_count()
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    y = mesh.all_reduce_sum(x * 2.0)
    (y * (r + 1)).sum().backward()             # d/dx: 2 * sum_r (r + 1)
    gen = torch.Generator().manual_seed(7)
    drawn = mesh.draw_rows(lambda s: torch.rand(s, generator=gen), (2, 5))
    return {"rank": r, "world": w, "main": mesh.is_main_process(),
            "sum": mesh.cross_process_sum([r, 1.0]).tolist(),
            "bcast": mesh.broadcast_int(41 + r),
            "any": [mesh.any_process(r == 1), mesh.any_process(False)],
            "offset": mesh.row_offset(3), "rows": mesh.global_rows(3),
            "gather": mesh.all_gather_rows(torch.tensor([[r, 10 + r]],
                                                        dtype=torch.int32),
                                           1).numpy(),
            "reduced": y.detach().numpy(), "grad": x.grad.numpy(),
            "gsum": mesh.global_sum(torch.tensor([float(r)])).item(),
            "gmean": mesh.global_mean(torch.arange(4.0).reshape(2, 2) + 4 * r,
                                      (0, 1)).item(),
            "bmean": mesh.batch_mean(torch.full((2, 2), float(r))).item(),
            "drawn": drawn.numpy(), "local": mesh.local_rows(7)}


def fit_and_eval(student, teacher, distill, tokenizer, manifest, workdir,
                 train_cfg):
    """A Trainer.fit of the rank's rows, then evaluate and evaluate_packed
    on `manifest`; (fit's last state step, evaluate, evaluate_packed)."""
    from tpu_asr_torch.train.loop import Trainer

    torch.manual_seed(0)
    model = DistilCTCModel(student, teacher, distill)
    tr = Trainer(model, train_cfg, tokenizer, workdir, log_every=1,
                 train_wer_every=1, device="cpu")
    tr.fit(manifest, manifest, max_steps=3)
    return (tr.state.step, tr.evaluate(manifest),
            tr.evaluate_packed(manifest, t_pack=96, row_multiple=2,
                               utt_chunk=3))


def restore_and_eval(student, teacher, distill, tokenizer, manifest, workdir,
                     train_cfg, ckpt):
    """`evaluate` of the train state restored from the file `ckpt`."""
    from pathlib import Path

    from tpu_asr_torch.train.loop import Trainer
    from tpu_asr_torch.utils.checkpoint import restore_train_state

    torch.manual_seed(0)
    model = DistilCTCModel(student, teacher, distill)
    tr = Trainer(model, train_cfg, tokenizer, workdir, device="cpu")
    tr.init_state()
    tr.state = restore_train_state(Path(ckpt).parent, tr.state,
                                   name=Path(ckpt).name)
    return tr.state.step, tr.evaluate(manifest)


def fit_cached(student, teacher, distill, tokenizer, manifest, workdir,
               train_cfg):
    """A Trainer.fit of the rank's rows with `train_cfg` (with a teacher
    cache or without); (the steps' logged losses, rank 0's; the cached
    steps run; the utterances this rank's cache holds; the final
    parameters, numpy)."""
    import json
    from pathlib import Path

    from tpu_asr_torch.train.loop import Trainer

    torch.manual_seed(0)
    model = DistilCTCModel(student, teacher, distill)
    tr = Trainer(model, train_cfg, tokenizer, workdir, log_every=1,
                 device="cpu")
    n = [0]
    if tr._cache is not None:
        cached = tr._train_step_cached

        def counting(*a):
            n[0] += 1
            return cached(*a)

        tr._train_step_cached = counting
    tr.fit(manifest)
    rows = []
    if mesh.is_main_process():
        rows = [json.loads(l) for l in open(Path(workdir) / "metrics.jsonl")]
    losses = {r["step"]: {k: v for k, v in r.items() if k.startswith(
        "loss/")} for r in rows if "loss/total" in r}
    held = (sorted(set(tr._cache.data) | tr._cache._on_disk)
            if tr._cache is not None else [])
    return (losses, n[0], held, {k: p.detach().numpy().copy()
                                 for k, p in model.named_parameters()})


def run_cli(name, argv):
    """`tpu_asr_torch.cli.<name>.main(argv)` on this rank: (its results,
    what it printed)."""
    import contextlib
    import importlib
    import io

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        results = importlib.import_module(
            f"tpu_asr_torch.cli.{name}").main(argv)
    return results, printed.getvalue()


def run_jobs(jobs):
    """[(name of a function of this module, args)] run in order; their
    values."""
    return [globals()[name](*args) for name, args in jobs]
