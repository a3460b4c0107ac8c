"""What each rank runs in tests/test_torch_tensor_parallel.py and
tests/test_torch_pipeline_parallel.py (spawned by
tpu_asr_torch/parallel/launch.py, so importable by name; torch and the port
only, no JAX). Every function takes whole weights (a state_dict file, which
tp_steps waits for: the test writes it while the ranks start) and a
global numpy batch, builds its mesh, cuts the model to its slices and its
stage, and returns plain numpy values; rank 0's whole tensors come back
gathered (parallel/sharding.full_state_dict)."""

import numpy as np
import torch

from tpu_asr_torch.config import OptimConfig
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.parallel import mesh, pipeline, sharding
from tpu_asr_torch.train.loop import global_metrics
from tpu_asr_torch.train.trainer import (DistilTrainState,
                                         make_distil_train_step, step_rngs)


def data_block(batch, device="cpu"):
    """This rank's block of a global numpy batch along the data axis, as
    tensors on `device`."""
    n = batch["signal"].shape[0] // mesh.axis_size("data")
    r = mesh.row_offset(n)
    return {k: torch.from_numpy(np.ascontiguousarray(v[r:r + n])).to(device)
            for k, v in batch.items()}


def load_when_written(path, timeout=120.0):
    """torch.load of `path` once it exists (the test writes it atomically
    while the ranks start)."""
    import os
    import time
    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.05)
    return torch.load(path, weights_only=True)


def _numpy(state):
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def _full_grads(model):
    """Every parameter's gradient, whole (gathered like the state)."""
    grads = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        g = p.grad.detach()
        if getattr(p, "tp_dim", None) is not None:
            g = mesh.gather(g, p.tp_dim, "model")
        grads[name] = g.cpu().numpy().copy()
    return grads


def tp_steps(student, teacher, distill, state_dict, batch, dp, tp, steps,
             ckpt_dir=None, restore=None):
    """`steps` KD train steps at a dp x tp mesh from the whole weights
    `state_dict` (a path): per step the global metrics, the whole
    gradients of the first step and the whole state after each step
    (rank 0's). `ckpt_dir`: the state after the last step saved there
    (utils/checkpoint.save_train_state). `restore`: first restore that
    one-rank checkpoint file into the sharded state (the step counter,
    the parameters and the optimizer moments) and return the whole
    restored state before stepping."""
    from pathlib import Path

    from tpu_asr_torch.utils.checkpoint import (restore_train_state,
                                                save_train_state)
    torch.manual_seed(0)
    m = mesh.make_mesh(dp, tp)
    model = DistilCTCModel(student, teacher, distill)
    model.load_state_dict(load_when_written(state_dict), strict=True)
    sharding.shard_module(model, m)
    state = DistilTrainState.create(
        model, OptimConfig(d_model=student.encoder.d_model, warmup_steps=10))
    out = {"metrics": [], "states": [], "heads": [
        mod.local_heads() for _, mod in model.named_modules()
        if hasattr(mod, "local_heads")]}
    if restore is not None:
        load_when_written(restore)
        state = restore_train_state(Path(restore).parent, state,
                                    Path(restore).name)
        out["restored"] = _numpy(sharding.full_state_dict(model))
        out["restored_step"] = state.step
        out["restored_opt"] = {
            i: {k: v.numpy().copy() for k, v in st.items()
                if torch.is_tensor(v) and v.dim() > 0}
            for i, st in sharding.full_optimizer_state(
                state.optimizer)["state"].items()}
    step = make_distil_train_step(model)
    local = data_block(batch)
    for i in range(steps):
        state, metrics = step(state, local, 0)
        out["metrics"].append(global_metrics(metrics))
        if i == 0:
            out["grads"] = _full_grads(model)
        out["states"].append(_numpy(sharding.full_state_dict(model)))
    if ckpt_dir is not None:
        save_train_state(ckpt_dir, state)
    if not mesh.is_main_process():
        out = {"metrics": out["metrics"], "heads": out["heads"]}
    return out


def tp_fit(student, teacher, distill, tokenizer, manifest, workdir,
           train_cfg):
    """A Trainer.fit of 3 steps at train_cfg.tp_size; the logged rows of
    metrics.jsonl (rank 0's)."""
    import json
    from pathlib import Path

    from tpu_asr_torch.train.loop import Trainer

    torch.manual_seed(0)
    model = DistilCTCModel(student, teacher, distill)
    tr = Trainer(model, train_cfg, tokenizer, workdir, log_every=1,
                 device="cpu")
    tr.fit(manifest, max_steps=3)
    if not mesh.is_main_process():
        return None
    return [json.loads(line)
            for line in open(Path(workdir) / "metrics.jsonl")]


def _stage_model(student, teacher, distill, state_dict, dp, pp, tp):
    m = mesh.make_pp_mesh(dp, pp, tp)
    model = DistilCTCModel(student, teacher, distill)
    model.load_state_dict(load_when_written(state_dict), strict=True)
    pipeline.apply_pp_sharding(model, m)
    return model


def pp_distil(student, teacher, distill, state_dict, batch, dp, pp, tp,
              n_micro, seed=0, device="cpu"):
    """One training forward and backward of distil_forward_pipelined at a
    dp x pp x tp mesh, the step's draws from step_rngs(seed, 0): the
    losses (each rank's; at dp > 1 its data replicas' shares summed, the
    global batch's), the whole gradients of every trained parameter
    (the stages' layers gathered), rank 0's, and the global norm of the
    gradients (train/optim.global_norm), each rank's."""
    from tpu_asr_torch.train.optim import global_norm

    torch.manual_seed(0)
    model = _stage_model(student, teacher, distill, state_dict, dp, pp, tp)
    model.to(device).train()
    local = data_block(batch, device)
    out = pipeline.distil_forward_pipelined(
        model, local["signal"], local["signal_len"], local["tokens"],
        local["token_len"], n_micro, rngs=step_rngs(seed, 0, device))
    out.losses["total"].backward()
    params = [p for p in model.parameters() if p.grad is not None]
    norm = float(global_norm([p.grad for p in params], params))
    grads = {sharding.global_key(model, k): torch.from_numpy(v)
             for k, v in _full_grads(model).items()}
    grads = {k: v.cpu().numpy() for k, v in sharding.gather_stages(
        grads, model).items()}
    losses = {k: float(mesh.axis_sum(v.detach(), "data"))
              for k, v in out.losses.items()}
    if not mesh.is_main_process():
        return {"losses": losses, "norm": norm}
    return {"losses": losses, "grads": grads, "norm": norm}


def pp_ctc(cfg, state_dict, signal, signal_len, pp, n_micro):
    """ctc_forward_pipelined of a stage-cut CTCModel: (log_probs,
    lengths), numpy."""
    m = mesh.make_pp_mesh(1, pp, 1)
    model = CTCModel(cfg)
    model.load_state_dict(load_when_written(state_dict), strict=True)
    pipeline.apply_pp_sharding(model, m, encoder_path="")
    model.eval()
    lp, n = pipeline.ctc_forward_pipelined(
        model, torch.from_numpy(signal), torch.from_numpy(signal_len),
        n_micro)
    return lp.numpy(), n.numpy()


def pp_encoder_grads(cfg, state_dict, signal, signal_len, pp, n_micro,
                     cotangent):
    """The gradients of sum(encoded * cotangent) through a pipelined
    stage-cut CTCModel's encoder, whole (rank 0's), in eval
    (deterministic) mode."""
    m = mesh.make_pp_mesh(1, pp, 1)
    model = CTCModel(cfg)
    model.load_state_dict(load_when_written(state_dict), strict=True)
    pipeline.apply_pp_sharding(model, m, encoder_path="")
    feats, feat_len = model.featurizer(torch.from_numpy(signal),
                                       torch.from_numpy(signal_len), False,
                                       None)
    encoded, _ = pipeline.encode_pipelined(model, feats, feat_len, n_micro)
    (encoded * torch.from_numpy(cotangent)).sum().backward()
    grads = {sharding.global_key(model, k): torch.from_numpy(v)
             for k, v in _full_grads(model).items()}
    grads = sharding.gather_stages(grads, model)
    return ({k: v.numpy() for k, v in grads.items()}
            if mesh.is_main_process() else None)


def run_jobs(jobs):
    """[(name of a function of this module, args)] run in order; their
    values."""
    return [globals()[name](*args) for name, args in jobs]
