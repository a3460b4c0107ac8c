"""Time and profile a train step on one CUDA card, on the hand-written
kernels ('auto') and on the plain PyTorch versions ('xla').

    python -m tpu_asr_torch.profile_train [--config ctc_student|flowkd_mlp8|
        flowkd_mlp8_int8_teacher|flowkd_router16|kd_menu|ctc_large|
        ctc_xlarge|ctc_fastconformer_local] [--packed] [--out FILE]

DistilCTCModel(make_student_config(ModelConfig()), ModelConfig(), distill)
at its own compute dtype (bf16) with seeded random weights and
OptimConfig(), on B=32 x 15 s of seeded noise with 48 target tokens, with
the `distill` of bench_train.py's configuration of that name: `ctc_student`
(CTC only), `flowkd_mlp8` (frozen teacher, logit KD at alpha 0.1 and
FM-KT with the mlp meta encoder, 8 Euler steps over all 16 layers) or
`flowkd_mlp8_int8_teacher` (the same with the teacher's FFN sublayers
through the int8 serving kernel), `flowkd_router16` (flowkd_mlp8 with
the dynamic step router: bench_train.py's RouterConfig(max_steps=16,
stu_dim=88, tch_dim=176, num_layers=16), strategy 'group', up to 16
Euler steps a row) or `kd_menu` (logit KD 0.1, layerwise KD over all
layers, DiffKD, diffm ver 6 and interCTC on layer 7, no FM-KT);
`ctc_large`, `ctc_xlarge` and
`ctc_fastconformer_local` train conformer-LARGE, conformer-XLarge and
FastConformer-Large with limited context themselves
(profile_forward.model_config) with the CTC loss alone, as bench_train.py's
LARGE step does (the teacher gated off). Per
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

`--packed` (with `--config flowkd_mlp8`) profiles on the kernels, instead,
bench_train.py's packed_train batches (`packed_batches`: 512 utterances of
lognormal durations in 4 linear buckets, audio-matched batch sizes, each
bucket's batches at one row count): the packed step
(make_distil_train_step(packed=True), rows of 512 frames) and the bucketed
step on the same utterances, each over one pass of all the batches after
one warm-up pass: audio s/s, ms and device ms a step, and the device time
a step by group, the segment mode's attention kernels in groups of their
own; `--out` then writes each path's profile sorted by host time.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_asr_torch.profile_forward import (built_on, device_activity,
                                           mark_call, print_groups,
                                           seed_weights, set_backend)

B, SECONDS, SR, TOKENS = 32, 15, 16000, 48
WARMUP, ITERS, PROFILED, TOP = 2, 5, 3, 15
CONFIGS = ("ctc_student", "flowkd_mlp8", "flowkd_mlp8_int8_teacher",
           "flowkd_router16", "kd_menu", "ctc_large", "ctc_xlarge",
           "ctc_fastconformer_local")
CTC_ONLY = ("ctc_student", "ctc_large", "ctc_xlarge",
            "ctc_fastconformer_local")
# bench_train.py's packed_train: utterances, seed, the longest clip (s),
# rows of T_PACK subsampled frames, 4 linear duration buckets
N_UTTS, PACK_SEED, MAX_S, T_PACK, BUCKETS = 512, 3, 16.7, 512, 4


def distill_config(name: str):
    """The DistillationConfig of bench_train.py's configuration `name`."""
    from tpu_asr_torch.config import (DiffKDConfig, DiffmConfig,
                                      DistillationConfig, FlowMatchingConfig,
                                      RouterConfig)
    if name in CTC_ONLY:
        return DistillationConfig()
    flow = FlowMatchingConfig(meta_encoder_type="mlp", student_dim=88,
                              teacher_dim=176, student_head_num=2,
                              training_sampling=8, inference_sampling=8)
    if name in ("flowkd_mlp8", "flowkd_mlp8_int8_teacher"):
        return DistillationConfig(use_logit_distillation=True, kd_alpha=0.1,
                                  use_flow_matching=True, flow=flow)
    if name == "flowkd_router16":
        flow = dataclasses.replace(flow, use_dynamic_steps=True,
                                   router_strategy="group",
                                   router_max_sampling_steps=16)
        return DistillationConfig(
            use_logit_distillation=True, kd_alpha=0.1,
            use_flow_matching=True, flow=flow,
            router=RouterConfig(max_steps=16, stu_dim=88, tch_dim=176,
                                num_layers=16))
    if name == "kd_menu":
        return DistillationConfig(
            use_logit_distillation=True, kd_alpha=0.1,
            use_layerwise_distillation=True, layer_kd_scope="all",
            use_diffkd=True, diffkd=DiffKDConfig(), use_diffm=True,
            diffm=DiffmConfig(model_version=6), interctc_layers=(7,))
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


def student_config(name: str):
    """The trained model's ModelConfig of configuration `name`: the student
    of ModelConfig(), or the profile_forward.model_config of the name
    after `ctc_` for ctc_large, ctc_xlarge and ctc_fastconformer_local."""
    from tpu_asr_torch.config import ModelConfig, make_student_config
    from tpu_asr_torch.profile_forward import model_config
    if name in CTC_ONLY[1:]:
        return model_config(name[4:])
    if name not in CONFIGS:
        raise ValueError(f"unknown configuration {name!r}; one of {CONFIGS}")
    return make_student_config(ModelConfig())


def make_batch(device="cuda"):
    rng = np.random.default_rng(0)
    return {"signal": torch.from_numpy(rng.normal(size=(B, SECONDS * SR))
                                       .astype(np.float32) * 0.1).to(device),
            "signal_len": torch.full((B,), SECONDS * SR, device=device),
            "tokens": torch.from_numpy(rng.integers(0, 128, size=(B, TOKENS))
                                       ).to(device),
            "token_len": torch.full((B,), TOKENS, device=device)}


def packed_batches(scfg, device="cuda"):
    """bench_train.py's packed_train batches, drawn in its order from
    default_rng(3): N_UTTS durations lognormal(ln 6.2, 0.55) clipped to
    1-16.7 s; BUCKETS linear duration buckets over [0, 16.7] s, each
    utterance cut to its bucket's edge, every batch padded to that edge,
    with batch size max(8, round(B * SECONDS / edge / 8) * 8) and only full
    batches; each batch's plan (data/packing.train_pack_arrays, rows of
    T_PACK) padded to the most rows of its bucket's batches, so a bucket
    has one shape. Returns [(bucketed batch, the same batch with its plan,
    audio seconds, PackPlan)], tensors on `device`."""
    from tpu_asr_torch.data.packing import train_pack_arrays

    rng = np.random.default_rng(PACK_SEED)
    durs = np.clip(rng.lognormal(np.log(6.2), 0.55, N_UTTS), 1.0, MAX_S)
    edges = np.linspace(MAX_S / BUCKETS, MAX_S, BUCKETS)
    bucket_of = np.searchsorted(edges, durs, side="left")
    pre, enc = scfg.preprocessor, scfg.encoder
    plan_of = lambda lens, pad=0: train_pack_arrays(
        lens, pre.n_fft, pre.hop_length, enc.subsampling_factor,
        enc.subsampling, enc.conv_kernel_size, T_PACK, pad_rows_to=pad)
    out = []
    for b_i, edge in enumerate(edges):
        ids = np.where(bucket_of == b_i)[0]
        cap = int(np.ceil(edge * SR))
        bsz = max(8, int(round(B * SECONDS / edge / 8)) * 8)
        chunks = []
        for ci in range(len(ids) // bsz):
            c = ids[ci * bsz:(ci + 1) * bsz]
            lens = np.minimum((durs[c] * SR).astype(np.int64), cap)
            chunks.append((c, lens, plan_of(lens)[1].n_rows))
        rows = max((r for _, _, r in chunks), default=0)
        for c, lens, _ in chunks:
            pk, plan = plan_of(lens, rows)
            sig = rng.normal(size=(bsz, cap)).astype(np.float32) * 0.1
            for r, n in enumerate(lens):
                sig[r, n:] = 0.0
            tokens = rng.integers(0, 128, size=(bsz, TOKENS))
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            batch = {"signal": t(sig), "signal_len": t(lens),
                     "tokens": t(tokens),
                     "token_len": torch.full((bsz,), TOKENS, device=device)}
            out.append((batch, {**batch, **{k: t(v) for k, v in pk.items()}},
                        float(durs[c].sum()), plan))
    return out


def timed_pass(step, state, batches, seed: int = 0):
    """One pass of `step` over `batches`, timed on the host clock up to a
    synchronize: (state, host ms a step, [metrics])."""
    torch.cuda.synchronize()
    metrics = []
    t0 = time.perf_counter()
    for batch in batches:
        state, m = step(state, batch, seed)
        metrics.append(m)
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) * 1e3 / len(batches), metrics


def profiled_pass(step, state, batches, seed: int = 0):
    """One pass of `step` over `batches` under torch.profiler, a marker
    before each step: (state, device ms a step, launches a step,
    {name: (ms, launches) a step}, the profile)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            mark_call()
            state, _ = step(state, batch, seed)
        torch.cuda.synchronize()
    return (state, *device_activity(prof, len(batches)), prof)


class PackedRun(NamedTuple):
    """One path of profile_packed: audio s/s and ms a step on the host
    clock, device ms and launches a step, each step's total loss, the
    kernels' launch counts over the timed pass (None without `counters`),
    and the model and batches it ran."""
    audio_s_per_s: float
    step_ms: float
    device_ms: float
    launches: float
    losses: list
    counts: Optional[dict]
    model: torch.nn.Module
    batches: list


def profile_packed(out=None, batches=None, counters=None) -> dict:
    """The flowkd_mlp8 step on bench_train.py's packed_train batches
    (`batches`, by default packed_batches'), bucketed and packed, on the
    kernels (see the module docstring). `counters`, where given, is called
    just before each path's timed pass and returns a function that reads
    the kernels' launch counts just after it. Returns {'bucketed' |
    'packed': PackedRun}."""
    from tpu_asr_torch.config import OptimConfig, make_student_config
    from tpu_asr_torch.models.distil_model import DistilCTCModel
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step)

    tcfg = teacher_config("flowkd_mlp8")
    scfg = make_student_config(tcfg)
    batches = batches or packed_batches(scfg)
    audio = sum(a for _, _, a, _ in batches)
    plans = [p for _, _, _, p in batches]
    print(f"packed_train batches: {len(batches)} of "
          f"{[b['signal'].shape[0] for b, _, _, _ in batches]} utterances, "
          f"{audio:.1f} s of audio; rows a batch "
          f"{[p.n_rows for p in plans]} of {T_PACK}, fill "
          f"{np.mean([p.fill_ratio for p in plans]):.4f}; bucketed (rows, "
          f"samples) {[tuple(b['signal'].shape) for b, _, _, _ in batches]}")
    res = {}
    for col, tag in ((0, "bucketed"), (1, "packed")):
        model = seed_weights(DistilCTCModel(scfg, tcfg,
                                            distill_config("flowkd_mlp8")),
                             1).cuda()
        state = DistilTrainState.create(model, OptimConfig())
        step = make_distil_train_step(model, packed=col == 1)
        run = [b[col] for b in batches]
        state, _, _ = timed_pass(step, state, run)       # every shape once
        read = counters() if counters is not None else None
        state, host, metrics = timed_pass(step, state, run)
        counts = read() if read is not None else None
        _, dev, launches, names, prof = profiled_pass(step, state, run)
        loss = [m["loss/total"].item() for m in metrics]
        res[tag] = PackedRun(audio / (host * len(batches) / 1e3), host, dev,
                             launches, loss, counts, model, run)
        print(f"train step flowkd_mlp8 {tag} ({scfg.compute_dtype}): "
              f"audio_s_per_s {res[tag].audio_s_per_s:.1f} "
              f"step_ms {host:.3f} device_ms {dev:.3f} busy "
              f"{dev / host:.3f} launches {launches:.0f} loss "
              f"{[round(x, 4) for x in loss]}")
        print_groups(names, dev)
        if out is not None:
            out.write(f"== train step flowkd_mlp8 {tag}, {len(run)} steps, by "
                      f"host time\n" + prof.key_averages().table(
                          sort_by="self_cpu_time_total", row_limit=40) + "\n")
    b, p = res["bucketed"], res["packed"]
    print(f"packed over bucketed (same run): audio s/s "
          f"{p.audio_s_per_s:.1f} / {b.audio_s_per_s:.1f} = "
          f"{p.audio_s_per_s / b.audio_s_per_s:.3f}x; device ms a step "
          f"{p.device_ms:.4f} / {b.device_ms:.4f} = "
          f"{p.device_ms / b.device_ms:.3f}x")
    return res


def profile_backend(backend: str, config: str = "ctc_student",
                    out=None) -> None:
    from tpu_asr_torch.config import OptimConfig
    from tpu_asr_torch.models.distil_model import DistilCTCModel
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step)

    scfg = student_config(config)
    model = seed_weights(built_on(DistilCTCModel, scfg,
                                  teacher_config(config),
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
    ap.add_argument("--packed", action="store_true",
                    help="flowkd_mlp8 on bench_train.py's packed_train "
                         "batches, packed and bucketed")
    ap.add_argument("--out", default=None,
                    help="file for the profiler tables")
    args = ap.parse_args(argv)
    if args.packed and args.config != "flowkd_mlp8":
        ap.error("--packed profiles --config flowkd_mlp8")
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    out = open(args.out, "w") if args.out else None
    try:
        if args.packed:
            profile_packed(out)
        for backend in () if args.packed else ("auto", "xla"):
            profile_backend(backend, args.config, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
