"""Time and profile the CTCModel forward on one CUDA card, on the
hand-written kernels ('auto') and on the plain PyTorch versions ('xla').

    python -m tpu_asr_torch.profile_forward [--model small|large|xlarge|
        fastconformer_local]
        [--quantization none|int8] [--conv_backend auto|pallas] [--out FILE]

`--model` (`model_config`): `ModelConfig()` (small, the default),
conformer-LARGE (d512, 18 layers, 8 heads) or conformer-XLarge (d1024, 24
layers, 8 heads, dk 128, conv k=5) or FastConformer-Large with limited
context (fastconformer_local: d512, 17 layers, dw_striding x8, window
(128, 128), 1024 tokens), at its own compute dtype (bf16) with
seeded random weights (`seeded_model`), its encoder's `quantization` and
`conv_backend` as given (int8 serving: `--quantization int8 --conv_backend
pallas`; the int8 FFN kernel takes D <= 512, so not XLarge), at B=32 x
15 s (a full serving batch) and B=8 x 16 s (a small request), clips not
padded.
Per shape and backend it prints one line with:
  - `event_ms`: median over 10 forwards of the time from CUDA events
    recorded around the forward with the card idle before it (host issue
    time included);
  - `host_ms`: median host-clock time of forward + synchronize;
  - `device_ms`: device time per forward, the union of all kernel and copy
    intervals that torch.profiler records over 3 forwards, divided by the
    forwards whose marker it kept (`mark_call`);
  - `busy`: device_ms / event_ms, the share of the forward the card works;
  - `launches`: device activities per forward.
then the device time per forward by group (the port's kernels by name,
the rest as cuBLAS/cuDNN/ATen) and the top device activities. `--out` also
writes the profiler's own table per shape and backend.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

SR = 16000
SHAPES = ((32, 15.0), (8, 16.0))        # (clips, seconds)
MODELS = ("small", "large", "xlarge", "fastconformer_local")  # model_config
BIG_D = 512          # from this width models are built and seeded on the card
PACK_ROWS, T_PACK = 16, 512    # the packed serve shape (PackedTranscriber)
ITERS, TOP = 10, 8
# torch.cuda._sleep's kernel, launched once before each profiled call
MARKER = "spin_kernel"
# names of the port's own kernels (csrc/*.cu; matched as substrings of the
# profiler's names, first entry first) -> group
GROUPS = (("core_mma_kernel<128", "attention fwd dk128"),
          ("core_kernel<float, false, 4>", "attention fwd dk128"),
          ("dq_mma_kernel<128", "attention bwd dk128"),
          ("dkv_mma_kernel<128", "attention bwd dk128"),
          ("dq_kernel<float, false, 4>", "attention bwd dk128"),
          ("dkv_kernel<float, false, 4>", "attention bwd dk128"),
          ("ffn_int8_kernel", "ffn int8"),
          ("conv_module_kernel", "conv module"),
          ("conv_module_mma_kernel", "conv module"),
          ("fm_fwd", "fm fwd"), ("fm_bwd", "fm bwd"),
          ("core_kernel", "attention fwd"),
          ("core_mma_kernel", "attention fwd"),
          ("proj_kernel", "attention proj"),
          ("proj_mma_kernel", "attention proj"),
          ("dq_kernel", "attention bwd"), ("dq_mma_kernel", "attention bwd"),
          ("dkv_kernel", "attention bwd"), ("dkv_mma_kernel", "attention bwd"),
          ("dpos_kernel", "attention bwd"), ("wgrad_kernel", "attention bwd"),
          ("wgrad_mma_kernel", "attention bwd"),
          ("sum_parts_kernel", "attention bwd"),
          ("ffn_fwd", "ffn fwd"), ("ffn_bwd", "ffn bwd"),
          ("ctc_fwd", "ctc fwd"), ("ctc_bwd", "ctc bwd"),
          ("conv1_kernel", "subsampling"), ("conv2_kernel", "subsampling"),
          ("linear_kernel", "subsampling"),
          ("logmel", "logmel"), ("layer_kernel", "conformer layer"),
          ("layer_mma_kernel", "conformer layer"))


def group_of(name: str) -> str:
    """A kernel's group; an attention kernel's segment mode (packed rows,
    its `kSeg` template argument true) and its narrowed window (the
    tensor-core kernels' `kWin`, the third) are groups of their own."""
    for prefix, group in GROUPS:
        if prefix in name:
            seg = re.search(r"<[^,<>]+, true[,>]", name)
            win = re.search(r"<[^,<>]+, (?:true|false), true>", name)
            modes = ", ".join(m for m, on in (("segments", seg),
                                              ("window", win)) if on)
            return f"{group} ({modes})" if modes else group
    if ("gemm" in name or "cutlass" in name or "sm90" in name
            or "nvjet" in name):
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


def short_symbol(name: str) -> str:
    """A mangled kernel symbol of csrc (a namespace, then the kernel) as
    `kernel`, `kernel<N>` (its first integer template argument) or
    `kernel<float>` / `kernel<bf16>` (its first type argument), with a
    bool second argument (the attention kernels' segment mode) as
    `kernel<N, true>`, and a bool third one (their window) as
    `kernel<N, true, false>`, a second integer one (layer_mma_kernel's) as
    `kernel<N, M>` and an integer after a type and a bool (the fp32
    attention kernels' column slots) as `kernel<float, false, 4>`."""
    m = re.match(r"_ZN(\d+)", name)
    k = m and re.match(r"(\d+)", name[m.end() + int(m.group(1)):])
    if not k:
        return name
    at = m.end() + int(m.group(1)) + k.end()
    end = at + int(k.group(1))
    flag = lambda b: "" if b is None else ", true" if b == "1" else ", false"
    arg = re.match(r"ILi(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?(?:Lb([01])E)?",
                   name[end:])
    if arg:
        second = f", {arg.group(2)}" if arg.group(2) else ""
        return (f"{name[at:end]}<{arg.group(1)}{second}{flag(arg.group(3))}"
                f"{flag(arg.group(4))}>")
    typ = re.match(r"I(f|13__nv_bfloat16)(?:Lb([01])E)?(?:Li(\d+)E)?",
                   name[end:])
    slots = lambda n: "" if n is None else f", {n}"
    return name[at:end] + (
        f"<{'float' if typ.group(1) == 'f' else 'bf16'}{flag(typ.group(2))}"
        f"{slots(typ.group(3))}>" if typ else "")


def packed_seg_map():
    """(PACK_ROWS, T_PACK) int32 segment map at the packed serve shape: the
    first rows from plan_packing of seeded serve-window lengths (25-376
    frames: 1-15 s clips; guard 16), whose segments straddle the 64-key
    tiles; the row before last one segment of 40 frames at frame 100,
    shorter than a tile and off its edges; the last row all guard."""
    from tpu_asr_torch.data.packing import plan_packing
    rng = np.random.default_rng(16)
    lengths, plan = [], None
    while True:
        trial = lengths + [int(rng.integers(25, 377))]
        nxt = plan_packing(trial, T_PACK, 16)
        if nxt.n_rows > PACK_ROWS - 2:
            break
        lengths, plan = trial, nxt
    seg = np.zeros((PACK_ROWS, T_PACK), np.int32)
    seg[:plan.n_rows] = plan.seg_id
    seg[PACK_ROWS - 2, 100:140] = 1
    return seg



def model_config(name: str):
    """The ModelConfig of `name`: 'small' ModelConfig(); 'large'
    conformer-LARGE, bench.py's large_cfg (d512, 18 layers, 8 heads, d_ff
    2048, no SpecAugment, 128 classes: 121 M parameters); 'xlarge'
    conformer-XLarge, bench.py's xl_cfg (d1024, 24 layers, 8 heads: dk 128,
    conv k=5: 635 M parameters); 'fastconformer_local' the widths of NVIDIA
    NeMo's Fast Conformer Large (examples/asr/conf/fastconformer/
    fast-conformer_ctc_bpe.yaml: d512, 17 layers, 8 heads, dw_striding x8
    with 256 channels, conv k=9, batch norm) with the limited context of
    its long-form variant (long_fastconformer/: rel_pos_local_attn, window
    (128, 128)), no SpecAugment, a 1024-piece tokenizer plus the blank:
    109.3 M parameters."""
    from tpu_asr_torch.config import (DecoderConfig, EncoderConfig,
                                      ModelConfig)
    if name == "small":
        return ModelConfig()
    if name == "large":
        return ModelConfig(spec_augment=None,
                           encoder=EncoderConfig(n_layers=18, d_model=512,
                                                 n_heads=8),
                           decoder=DecoderConfig(feat_in=512,
                                                 num_classes=128))
    if name == "xlarge":
        return ModelConfig(spec_augment=None,
                           encoder=EncoderConfig(n_layers=24, d_model=1024,
                                                 n_heads=8,
                                                 conv_kernel_size=5),
                           decoder=DecoderConfig(feat_in=1024,
                                                 num_classes=128))
    if name == "fastconformer_local":
        return ModelConfig(
            spec_augment=None,
            encoder=EncoderConfig(
                n_layers=17, d_model=512, n_heads=8, ff_expansion_factor=4,
                subsampling="dw_striding", subsampling_factor=8,
                subsampling_conv_channels=256, conv_kernel_size=9,
                conv_norm_type="batch_norm",
                self_attention_model="rel_pos_local_attn",
                att_context_size=(128, 128), att_context_style="regular",
                global_tokens=0, xscaling=True),
            decoder=DecoderConfig(feat_in=512, num_classes=1024))
    raise ValueError(f"unknown model {name!r}; one of {MODELS}")


def built_on(module_cls, *args, device="cuda"):
    """module_cls(*args) for seeding on `device`: built there when the
    encoder is at least BIG_D wide (conformer-LARGE and XLarge: their
    default initialisation and seed_weights' draws then run on the card),
    else on the CPU, so that the smaller models keep the weights every
    earlier run drew."""
    if args[0].encoder.d_model < BIG_D:
        return module_cls(*args)
    with torch.device(device):
        return module_cls(*args).to(device)


def seeded_model(cfg, seed: int, device="cuda"):
    """CTCModel on `device` in eval mode, with weights from a seeded
    torch.Generator and randomised BatchNorm running statistics (drawn on
    `device` from BIG_D up: `built_on`)."""
    from tpu_asr_torch.models.ctc_model import CTCModel

    model = built_on(CTCModel, cfg, device=device)
    return seed_weights(model, seed).to(device).eval()


def seed_weights(model, seed: int):
    """Fill a model's weights from a torch.Generator seeded with `seed`
    on the device of its parameters (norm scales near 1, biases small,
    matrices scaled by fan-in) and randomise its BatchNorm running
    statistics; returns the model."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda shape: torch.randn(shape, generator=gen, device=dev)
    uniform = lambda shape, lo, hi: torch.empty(shape, device=dev).uniform_(
        lo, hi, generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("norm_feed_forward1.weight",
                              "norm_self_att.weight", "norm_conv.weight",
                              "norm_feed_forward2.weight", "norm_out.weight",
                              "batch_norm.weight")):
                p.copy_(1.0 + 0.1 * randn(p.shape))
            elif p.dim() == 1 or name.endswith(("pos_bias_u", "pos_bias_v")):
                p.copy_(0.1 * randn(p.shape))
            else:
                fan_in = p[0].numel()
                p.copy_(randn(p.shape) / fan_in ** 0.5)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(uniform(buf.shape, -0.3, 0.3))
            elif name.endswith("running_var"):
                buf.copy_(uniform(buf.shape, 0.7, 1.5))
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


def mark_call() -> None:
    """Launch the marker kernel (MARKER) before a profiled call, so that
    `device_activity` counts the calls whose events the profiler kept."""
    torch.cuda._sleep(0)


def device_activity(prof, n_calls: int):
    """(union device ms per call, launches per call,
    {name: (ms per call, launches per call)}) from a profiler run of
    n_calls calls. torch.profiler sometimes keeps only part of a run's
    events: 3 of 5 launches of a phase, or a call's events without its
    marker. Where each call was preceded by `mark_call`, the markers cut
    the run into calls, the median of their launch counts is a call's
    launches, and the recorded launches over it the number of calls the
    figures are divided by, so they read neither low nor high; without
    markers they are divided by n_calls. Each kernel's ms per call over
    its launches per call is its time a launch in any case. The markers
    themselves count nowhere."""
    from torch.autograd import DeviceType

    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events() if e.device_type == DeviceType.CUDA)
    spans, per_name, segments = [], defaultdict(lambda: [0.0, 0]), []
    for start, end, name in events:
        if MARKER in name:
            segments.append(0)
            continue
        if segments:
            segments[-1] += 1
        spans.append((start, end))
        per_name[name][0] += (end - start) / 1e3
        per_name[name][1] += 1
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    per_call = float(np.median(segments)) if segments else 0.0
    calls = len(spans) / per_call if per_call else n_calls
    names = {k: (v[0] / calls, v[1] / calls) for k, v in per_name.items()}
    return busy_us / 1e3 / calls, len(spans) / calls, names


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
                    mark_call()
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
    ap.add_argument("--model", default="small", choices=MODELS)
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    cfg = model_config(args.model)
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
