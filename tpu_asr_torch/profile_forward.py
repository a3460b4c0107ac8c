"""Time and profile the CTCModel forward on one CUDA card, on the
hand-written kernels ('auto') and on the plain PyTorch versions ('xla').

    python -m tpu_asr_torch.profile_forward [--quantization none|int8]
        [--conv_backend auto|pallas] [--out FILE]

`ModelConfig()` at its own compute dtype (bf16) with seeded random weights
(`seeded_model`), its encoder's `quantization` and `conv_backend` as given
(int8 serving: `--quantization int8 --conv_backend pallas`), at B=32 x 15 s
(a full serving batch) and B=8 x 16 s (a small request), clips not padded.
Per shape and backend it prints one line with:
  - `event_ms`: median over 10 forwards of the time from CUDA events
    recorded around the forward with the card idle before it (host issue
    time included);
  - `host_ms`: median host-clock time of forward + synchronize;
  - `device_ms`: device time per forward, the union of all kernel and copy
    intervals that torch.profiler records over 3 forwards, divided by 3;
  - `busy`: device_ms / event_ms, the share of the forward the card works;
  - `launches`: device activities per forward.
then the device time per forward by group (the port's kernels by name,
the rest as cuBLAS/cuDNN/ATen) and the top device activities. `--out` also
writes the profiler's own table per shape and backend.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

SR = 16000
SHAPES = ((32, 15.0), (8, 16.0))        # (clips, seconds)
ITERS, TOP = 10, 8
# kernel name prefixes of the port's own sources -> group
GROUPS = (("ffn_int8_kernel", "ffn int8"), ("conv_module_kernel",
                                            "conv module"),
          ("fm_fwd", "fm fwd"), ("fm_bwd", "fm bwd"),
          ("fm_partial_sum", "fm bwd"), ("core_kernel", "attention fwd"),
          ("proj_kernel", "attention proj"),
          ("dq_kernel", "attention bwd"), ("dkv_kernel", "attention bwd"),
          ("dpos_kernel", "attention bwd"), ("wgrad_kernel", "attention bwd"),
          ("sum_parts_kernel", "attention bwd"), ("ffn_fwd", "ffn fwd"),
          ("ffn_bwd", "ffn bwd"), ("sum_rows_kernel", "ffn bwd"),
          ("ctc_fwd", "ctc fwd"), ("ctc_bwd", "ctc bwd"),
          ("conv1_kernel", "subsampling"), ("conv2_linear", "subsampling"),
          ("logmel", "logmel"))


def group_of(name: str) -> str:
    for prefix, group in GROUPS:
        if prefix in name:
            return group
    if "gemm" in name or "cutlass" in name or "sm90" in name:
        return "cuBLAS/cuDNN products"
    if "conv" in name.lower() or "cudnn" in name.lower():
        return "cuDNN convolutions"
    return "other ATen (elementwise, reductions, copies, optimizer)"


def print_groups(names, device_ms: float) -> None:
    """One line per group of device_activity's {name: (ms, calls)}."""
    groups = defaultdict(lambda: [0.0, 0.0])
    for name, (ms, calls) in names.items():
        groups[group_of(name)][0] += ms
        groups[group_of(name)][1] += calls
    for group, (ms, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  group {ms:8.3f} ms {100 * ms / device_ms:5.1f}% "
              f"x{calls:<6g} {group}")


def seeded_model(cfg, seed: int, device="cuda"):
    """CTCModel on `device` in eval mode, with weights from a seeded
    torch.Generator and randomised BatchNorm running statistics."""
    from tpu_asr_torch.models.ctc_model import CTCModel

    return seed_weights(CTCModel(cfg), seed).to(device).eval()


def seed_weights(model, seed: int):
    """Fill a model's weights from a seeded torch.Generator (norm scales
    near 1, biases small, matrices scaled by fan-in) and randomise its
    BatchNorm running statistics; returns the model."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("norm_feed_forward1.weight",
                              "norm_self_att.weight", "norm_conv.weight",
                              "norm_feed_forward2.weight", "norm_out.weight",
                              "batch_norm.weight")):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            elif p.dim() == 1 or name.endswith(("pos_bias_u", "pos_bias_v")):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.empty(buf.shape).uniform_(-0.3, 0.3,
                                                          generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(torch.empty(buf.shape).uniform_(0.7, 1.5,
                                                          generator=gen))
    return model


def waveforms(rng, n: int, lo: float, hi: float, sr: int = SR):
    """Seeded test audio: three tones plus noise, n clips of lo..hi s."""
    out = []
    for _ in range(n):
        t = np.arange(int(rng.uniform(lo, hi) * sr)) / sr
        f = rng.uniform(120, 3000, size=3)
        x = sum(0.2 * np.sin(2 * np.pi * fi * t) for fi in f)
        out.append((x + 0.05 * rng.normal(size=t.shape)).astype(np.float32))
    return out


def set_backend(model, backend: str) -> None:
    """Point the featurizer, subsampling, every attention, FFN and conv
    module, the flow-matching Euler loop and the CTC loss at `backend`:
    'xla' the plain versions; 'auto' the kernels, and for the FFN and conv
    routes the EncoderConfig's own choice (in eval the FFN runs a kernel
    with quantization='int8' or ffn_backend='pallas', the conv module with
    conv_backend='pallas')."""
    from tpu_asr_torch.kd.flow_matching import FlowMatchingModule
    from tpu_asr_torch.models.conformer import (ConformerLayer,
                                                ConvSubsampling,
                                                RelPositionMultiHeadAttention)
    from tpu_asr_torch.models.distil_model import DistilCTCModel
    from tpu_asr_torch.ops.features import FilterbankFeatures
    plain = backend == "xla"
    for m in model.modules():
        if isinstance(m, (ConvSubsampling, RelPositionMultiHeadAttention,
                          FilterbankFeatures, FlowMatchingModule)):
            m.backend = backend
        elif isinstance(m, ConformerLayer):
            m.ffn_backend = backend if plain else m.cfg.ffn_backend
            m.conv.backend = backend if plain else m.cfg.conv_backend
        elif isinstance(m, DistilCTCModel):
            m.ctc_backend = "scan" if plain else backend


def device_activity(prof, n_forwards: int):
    """(union device ms per forward, launches per forward,
    {name: (ms per forward, calls per forward)}) from a profiler run."""
    from torch.autograd import DeviceType

    spans, per_name = [], defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        per_name[e.name][0] += (end - start) / 1e3
        per_name[e.name][1] += 1
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    names = {k: (v[0] / n_forwards, v[1] / n_forwards)
             for k, v in per_name.items()}
    return busy_us / 1e3 / n_forwards, len(spans) / n_forwards, names


def profile_shape(model, batch: int, seconds: float, out=None):
    rng = np.random.default_rng(0)
    sig = torch.from_numpy(np.stack(waveforms(rng, batch, seconds, seconds))
                           ).cuda()
    lens = torch.full((batch,), sig.shape[1], device="cuda")
    enc = model.cfg.encoder
    label = (f"B={batch} x {seconds:g} s, {model.cfg.compute_dtype}, "
             f"quantization {enc.quantization}, conv {enc.conv_backend}")
    for backend in ("auto", "xla"):
        set_backend(model, backend)
        with torch.inference_mode():
            for _ in range(3):
                model(sig, lens)
            events, host = [], []
            for _ in range(ITERS):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                model(sig, lens)
                end.record()
                end.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
                events.append(start.elapsed_time(end))
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    model(sig, lens)
                torch.cuda.synchronize()
        event_ms, host_ms = float(np.median(events)), float(np.median(host))
        device_ms, launches, names = device_activity(prof, 3)
        print(f"forward {label} {backend}: event_ms {event_ms:.3f} "
              f"host_ms {host_ms:.3f} device_ms {device_ms:.3f} "
              f"busy {device_ms / event_ms:.3f} launches {launches:.0f}")
        print_groups(names, device_ms)
        ranked = sorted(names.items(), key=lambda kv: -kv[1][0])
        for name, (ms, calls) in ranked[:TOP]:
            print(f"  {ms:8.3f} ms {100 * ms / device_ms:5.1f}% "
                  f"x{calls:<5g} {name[:90]}")
        if out is not None:
            out.write(f"== {label} {backend}\n")
            out.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40) + "\n")
    set_backend(model, "auto")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quantization", default="none",
                    choices=("none", "int8"))
    ap.add_argument("--conv_backend", default="auto",
                    choices=("auto", "pallas"))
    ap.add_argument("--out", default=None,
                    help="file for the profiler tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_forward: no CUDA device", file=sys.stderr)
        return 2
    from tpu_asr_torch.config import ModelConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    cfg = ModelConfig()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, quantization=args.quantization,
        conv_backend=args.conv_backend))
    model = seeded_model(cfg, seed=2)
    out = open(args.out, "w") if args.out else None
    try:
        for batch, seconds in SHAPES:
            profile_shape(model, batch, seconds, out=out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
