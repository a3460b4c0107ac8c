"""Time and profile a train step on one CUDA card, on the hand-written
kernels ('auto') and on the plain PyTorch versions ('xla').

    python -m tpu_asr_torch.profile_train [--config ctc_student|flowkd_mlp8|
        flowkd_mlp8_int8_teacher] [--out FILE]

DistilCTCModel(make_student_config(ModelConfig()), ModelConfig(), distill)
at its own compute dtype (bf16) with seeded random weights and
OptimConfig(), on B=32 x 15 s of seeded noise with 48 target tokens, with
the `distill` of bench_train.py's configuration of that name: `ctc_student`
(CTC only), `flowkd_mlp8` (frozen teacher, logit KD at alpha 0.1 and
FM-KT with the mlp meta encoder, 8 Euler steps over all 16 layers) or
`flowkd_mlp8_int8_teacher` (the same with the teacher's FFN sublayers
through the int8 serving kernel). Per
backend it prints one line with:
  - `step_ms`: median host-clock time of a train step + synchronize over
    5 steps after 2 warm-up steps;
  - `device_ms`: device time per step, the union of all kernel and copy
    intervals that torch.profiler records over 3 steps, divided by 3;
  - `busy`: device_ms / step_ms, the share of the step the card works;
  - `launches`: device activities per step;
then the device time per step by group (the port's kernels by name, the
rest as cuBLAS/cuDNN/ATen) and the top device activities. `--out` also
writes the profiler's own tables.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import numpy as np
import torch

from tpu_asr_torch.profile_forward import (device_activity, mark_call,
                                           print_groups, seed_weights,
                                           set_backend)

B, SECONDS, SR, TOKENS = 32, 15, 16000, 48
WARMUP, ITERS, PROFILED, TOP = 2, 5, 3, 15
CONFIGS = ("ctc_student", "flowkd_mlp8", "flowkd_mlp8_int8_teacher")


def distill_config(name: str):
    """The DistillationConfig of bench_train.py's configuration `name`."""
    from tpu_asr_torch.config import DistillationConfig, FlowMatchingConfig
    if name == "ctc_student":
        return DistillationConfig()
    if name in ("flowkd_mlp8", "flowkd_mlp8_int8_teacher"):
        flow = FlowMatchingConfig(meta_encoder_type="mlp", student_dim=88,
                                  teacher_dim=176, student_head_num=2,
                                  training_sampling=8, inference_sampling=8)
        return DistillationConfig(use_logit_distillation=True, kd_alpha=0.1,
                                  use_flow_matching=True, flow=flow)
    raise ValueError(f"unknown configuration {name!r}; one of {CONFIGS}")


def teacher_config(name: str):
    """The teacher ModelConfig of bench_train.py's configuration `name`:
    ModelConfig(), its FFN sublayers in int8 for the int8-teacher step."""
    from tpu_asr_torch.config import ModelConfig
    cfg = ModelConfig()
    if name == "flowkd_mlp8_int8_teacher":
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, quantization="int8"))
    return cfg


def make_batch(device="cuda"):
    rng = np.random.default_rng(0)
    return {"signal": torch.from_numpy(rng.normal(size=(B, SECONDS * SR))
                                       .astype(np.float32) * 0.1).to(device),
            "signal_len": torch.full((B,), SECONDS * SR, device=device),
            "tokens": torch.from_numpy(rng.integers(0, 128, size=(B, TOKENS))
                                       ).to(device),
            "token_len": torch.full((B,), TOKENS, device=device)}


def profile_backend(backend: str, config: str = "ctc_student",
                    out=None) -> None:
    from tpu_asr_torch.config import (ModelConfig, OptimConfig,
                                      make_student_config)
    from tpu_asr_torch.models.distil_model import DistilCTCModel
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step)

    scfg = make_student_config(ModelConfig())
    model = seed_weights(DistilCTCModel(scfg, teacher_config(config),
                                        distill_config(config)), 1).cuda()
    set_backend(model, backend)
    state = DistilTrainState.create(model, OptimConfig())
    step = make_distil_train_step(model)
    batch = make_batch()
    for _ in range(WARMUP):
        state, _ = step(state, batch, 0)
    torch.cuda.synchronize()
    host = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            mark_call()
            state, metrics = step(state, batch, 0)
        torch.cuda.synchronize()
    step_ms = float(np.median(host))
    device_ms, launches, names = device_activity(prof, PROFILED)
    print(f"train step {config} {backend} (B={B} x {SECONDS} s, {TOKENS} "
          f"tokens, {scfg.compute_dtype}): step_ms {step_ms:.3f} device_ms "
          f"{device_ms:.3f} busy {device_ms / step_ms:.3f} launches "
          f"{launches:.0f} loss {metrics['loss/total'].item():.4f}")
    print_groups(names, device_ms)
    ranked = sorted(names.items(), key=lambda kv: -kv[1][0])
    for name, (ms, calls) in ranked[:TOP]:
        print(f"  {ms:8.3f} ms {100 * ms / device_ms:5.1f}% x{calls:<5g} "
              f"{name[:90]}")
    if out is not None:
        out.write(f"== train step {config} {backend}\n")
        out.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=50) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="ctc_student", choices=CONFIGS)
    ap.add_argument("--out", default=None,
                    help="file for the profiler tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    out = open(args.out, "w") if args.out else None
    try:
        for backend in ("auto", "xla"):
            profile_backend(backend, args.config, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
