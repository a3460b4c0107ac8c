"""Drive the PyTorch port (tpu_asr_torch) once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each on its own output lines:
  1. card: exit non-zero without a CUDA device; print the card's name and
     power limit (nvidia-smi).
  2. build: compile csrc/*.cu with nvcc (seconds printed).
  3. kernels: each hand-written kernel against its plain PyTorch version at
     the flagship serving shapes (B=32 x 15 s), fp32 and bf16: max error
     within its tolerance, and median times of kernel and plain (CUDA
     events).
  4. model: ModelConfig() in float32 with seeded random weights and
     randomised BatchNorm statistics, run once on the kernels ('auto') and
     once with every backend 'xla': max |delta log-prob| < 2e-3, equal
     greedy ids wherever the plain top-2 margin exceeds 1e-3, and every
     kernel launched.
  5. serve: Transcriber at the config's own bf16 compute dtype answers 64
     requests of 32 waveforms (1-15 s, drawn from a seeded pool of 256)
     after 2 warm-up requests; launch counters are reset just before and
     read just after, every result must be a string, and the audio seconds
     over the wall seconds of all 64 requests is printed as RTFx.
Then one JSON line of per-kernel results, and last the JSON device line.
Any failed check exits non-zero before the last line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

SECONDS, BATCH, SR = 15, 32, 16000
SERVE_POOL, SERVE_BATCH, SERVE_WARMUP, SERVE_REQUESTS = 256, 32, 2, 64


def check(ok, msg: str) -> None:
    """Print the check; a failed one ends the run with exit code 1."""
    ok = bool(ok)
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        sys.exit(1)


def card() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])            # name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")


def median_ms(fn, iters: int = 20) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def normal(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def kernel_phase(cfg):
    """Each kernel against its plain version at the serving shapes. Returns
    {name: {dtype: (max_abs_err, kernel_ms, plain_ms)}}."""
    from tpu_asr_torch.ops.cuda_attention import (
        fused_relpos_attention_block, relpos_attention_plain)
    from tpu_asr_torch.ops.cuda_features import fused_logmel, logmel_plain
    from tpu_asr_torch.ops.cuda_subsampling import (fused_subsampling,
                                                    out_len, subsampling_plain)
    from tpu_asr_torch.ops.features import FilterbankFeatures
    from tpu_asr_torch.models.conformer import rel_positional_encoding

    gen = torch.Generator(device="cuda").manual_seed(0)
    pre = cfg.preprocessor
    enc = cfg.encoder
    results = {}

    # log-mel: fp32 only
    feat = FilterbankFeatures(pre).cuda()
    audio = normal(gen, BATCH, SECONDS * SR, scale=0.1)
    pad = pre.n_fft // 2
    xp = torch.nn.functional.pad(audio[:, None], (pad, pad),
                                 mode="reflect")[:, 0].contiguous()
    n_frames = (xp.shape[1] - pre.n_fft) // pre.hop_length + 1
    args = (xp, n_frames, feat.basis, feat.fb_t, pre.hop_length,
            pre.log_zero_guard_value)
    got, want = fused_logmel(*args), logmel_plain(*args)
    torch.cuda.synchronize()
    live = want > np.log(pre.log_zero_guard_value) + 8.0
    err = (got - want).abs()[live].max().item()
    check(torch.isfinite(got).all() and live.float().mean() > 0.5,
          "logmel finite, most bins live")
    check(err < 2e-3, f"logmel fp32 (B={BATCH}, T={n_frames}, "
          f"{pre.features} mels): max |err| on live bins {err:.3e} < 2e-3")
    results["logmel"] = {"float32": (
        err, median_ms(lambda: fused_logmel(*args)),
        median_ms(lambda: logmel_plain(*args)))}

    # subsampling
    ch, d = enc.conv_channels, enc.d_model
    t2 = out_len(out_len(n_frames))
    f2 = out_len(out_len(pre.features))
    w = (normal(gen, ch, 1, 3, 3, scale=0.3), normal(gen, ch, scale=0.1),
         normal(gen, ch, ch, 3, 3, scale=0.08), normal(gen, ch, scale=0.1),
         normal(gen, d, ch * f2, scale=0.05))
    feats = normal(gen, BATCH, n_frames, pre.features)
    results["subsampling"] = {}
    for dt in (torch.float32, torch.bfloat16):
        x = feats.to(dt)
        got = fused_subsampling(x, *w).float()
        want = subsampling_plain(x, *w).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        if dt == torch.float32:
            ok = torch.allclose(got, want, rtol=1e-3, atol=1e-3)
            tol = "rtol=atol=1e-3"
        else:
            ok = torch.allclose(got, want, rtol=0.05,
                                atol=0.03 * max(1.0, ref))
            tol = "rtol 0.05, atol 0.03*max(1,|ref|max)"
        check(ok and got.shape == (BATCH, t2, d),
              f"subsampling {str(dt)[6:]} ({BATCH}, {n_frames}, "
              f"{pre.features}) -> ({BATCH}, {t2}, {d}): max |err| "
              f"{err:.3e}, |ref|max {ref:.3e} ({tol})")
        results["subsampling"][str(dt)[6:]] = (
            err, median_ms(lambda: fused_subsampling(x, *w)),
            median_ms(lambda: subsampling_plain(x, *w)))

    # attention at the encoder's width
    h = enc.n_heads
    dk = d // h
    pw = (normal(gen, d, d, scale=d ** -0.5), normal(gen, d, scale=0.1),
          normal(gen, d, d, scale=d ** -0.5), normal(gen, d, scale=0.1),
          normal(gen, d, d, scale=d ** -0.5), normal(gen, d, scale=0.1),
          normal(gen, h, dk, scale=0.1), normal(gen, h, dk, scale=0.1),
          normal(gen, d, d, scale=d ** -0.5), normal(gen, d, d,
                                                      scale=d ** -0.5))
    pos_emb = rel_positional_encoding(t2, d, "cuda")
    lengths = torch.randint(t2 // 4, t2 + 1, (BATCH,), generator=gen,
                            device="cuda")
    lengths[0] = t2
    mask = torch.arange(t2, device="cuda")[None, :] < lengths[:, None]
    xa = normal(gen, BATCH, t2, d, scale=0.5)
    results["attention"] = {}
    for dt in (torch.float32, torch.bfloat16):
        x = xa.to(dt)
        aargs = (x, *pw, pos_emb, mask, h)
        got = fused_relpos_attention_block(*aargs).float()
        want = relpos_attention_plain(*aargs).float()
        torch.cuda.synchronize()
        valid = mask[..., None]
        err = ((got - want).abs() * valid).max().item()
        if dt == torch.float32:
            rtol, atol = 1e-4, 1e-4
        else:
            rtol, atol = 1e-2, 3e-3
        ok = torch.allclose(got * valid, want * valid, rtol=rtol, atol=atol)
        check(ok, f"attention {str(dt)[6:]} (B={BATCH}, T={t2}, D={d}, "
              f"H={h}) valid rows: max |err| {err:.3e} "
              f"(rtol {rtol}, atol {atol})")
        results["attention"][str(dt)[6:]] = (
            err, median_ms(lambda: fused_relpos_attention_block(*aargs)),
            median_ms(lambda: relpos_attention_plain(*aargs)))
    for name, per_dt in results.items():
        for dt, (err, ms, plain_ms) in per_dt.items():
            print(f"time {name} {dt}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (median of 20, CUDA events)")
    return results


def reset_counters():
    from tpu_asr_torch.ops.cuda_attention import fused_relpos_attention_block
    from tpu_asr_torch.ops.cuda_features import fused_logmel
    from tpu_asr_torch.ops.cuda_subsampling import fused_subsampling
    fns = {"logmel": fused_logmel, "subsampling": fused_subsampling,
           "attention": fused_relpos_attention_block}
    for fn in fns.values():
        fn.launches = 0
    return fns


def model_phase(cfg):
    from tpu_asr_torch.profile_forward import (seeded_model, set_backend,
                                               waveforms)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = seeded_model(cfg32, seed=1)
    rng = np.random.default_rng(1)
    clips = waveforms(rng, 8, 5.0, SECONDS)
    sig = np.zeros((len(clips), SECONDS * SR), np.float32)
    for i, c in enumerate(clips):
        sig[i, :len(c)] = c
    sig_t = torch.from_numpy(sig).cuda()
    len_t = torch.tensor([len(c) for c in clips], device="cuda")
    fns = reset_counters()
    with torch.inference_mode():
        got = model(sig_t, len_t)
        counts = {k: f.launches for k, f in fns.items()}
        set_backend(model, "xla")
        want = model(sig_t, len_t)
        set_backend(model, "auto")
    torch.cuda.synchronize()
    check(all(v > 0 for v in counts.values()),
          f"model on kernels launched every kernel: {counts}")
    check(torch.equal(got.encoded_len, want.encoded_len),
          "encoded_len equal")
    valid = (torch.arange(got.log_probs.shape[1], device="cuda")[None, :]
             < want.encoded_len[:, None])
    delta = ((got.log_probs - want.log_probs).abs() * valid[..., None]).max()
    check(bool(torch.isfinite(got.log_probs).all()), "log-probs finite")
    check(delta.item() < 2e-3, f"ModelConfig() fp32, {len(clips)} clips of "
          f"5-{SECONDS} s: max |delta log-prob| kernels vs plain "
          f"{delta.item():.3e} < 2e-3")
    top2 = want.log_probs.topk(2, dim=-1).values
    decided = valid & ((top2[..., 0] - top2[..., 1]) > 1e-3)
    same = (got.greedy == want.greedy) | ~decided
    check(bool(same.all()), f"greedy ids equal on {int(decided.sum())} "
          f"frames with plain top-2 margin > 1e-3 "
          f"(of {int(valid.sum())} valid)")


def serve_phase(cfg):
    from tpu_asr_torch.host import train_bpe
    from tpu_asr_torch.models.transcribe import Transcriber
    from tpu_asr_torch.profile_forward import seeded_model, waveforms

    model = seeded_model(cfg, seed=2)
    corpus = ["the quick brown fox jumps over the lazy dog",
              "speech recognition on a graphics card",
              "conformer encoders with connectionist temporal classification",
              "a hundred and twenty eight pieces of vocabulary"] * 4
    tok = train_bpe(corpus, vocab_size=cfg.decoder.num_classes)
    tr = Transcriber(model, tok, batch_size=SERVE_BATCH, device="cuda")
    rng = np.random.default_rng(2)
    pool = waveforms(rng, SERVE_POOL, 1.0, SECONDS)
    requests = [[pool[i] for i in rng.choice(SERVE_POOL, SERVE_BATCH,
                                             replace=False)]
                for _ in range(SERVE_WARMUP + SERVE_REQUESTS)]
    for r in requests[:SERVE_WARMUP]:       # cuDNN/cuBLAS set-up per bucket
        tr.transcribe(r)
    torch.cuda.synchronize()
    requests = requests[SERVE_WARMUP:]
    fns = reset_counters()
    latency, texts = [], []
    start = time.perf_counter()
    for r in requests:
        t0 = time.perf_counter()
        texts.append(tr.transcribe(r))      # ends in a device-to-host copy
        latency.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = {k: f.launches for k, f in fns.items()}
    audio_s = sum(len(w) for r in requests for w in r) / SR
    flat = [t for r in texts for t in r]
    check(len(flat) == SERVE_REQUESTS * SERVE_BATCH
          and all(isinstance(t, str) for t in flat),
          f"Transcriber ({cfg.compute_dtype}) answered {SERVE_REQUESTS} "
          f"requests of {SERVE_BATCH} waveforms with strings, "
          f"e.g. {flat[0]!r}")
    check(all(v > 0 for v in counts.values()),
          f"serving path launched every kernel: {counts}")
    print(f"serve: {SERVE_REQUESTS} requests x {SERVE_BATCH} clips of "
          f"1-{SECONDS} s, {audio_s:.2f} s of audio in {wall:.4f} s wall: "
          f"RTFx {audio_s / wall:.1f}; per request median "
          f"{1e3 * float(np.median(latency)):.2f} ms, max "
          f"{1e3 * max(latency):.2f} ms (host clock, after "
          f"{SERVE_WARMUP} warm-up requests)")
    return counts


KERNELS = {
    "logmel": ("tpu_asr_torch/csrc/logmel.cu",
               "tpu_asr/ops/pallas_features.py:109", "float32"),
    "subsampling": ("tpu_asr_torch/csrc/subsampling.cu",
                    "tpu_asr/ops/pallas_subsampling.py:96", "bfloat16"),
    "attention": ("tpu_asr_torch/csrc/attention.cu",
                  "tpu_asr/ops/pallas_attention.py:669", "bfloat16"),
}


def main() -> int:
    card()
    from tpu_asr_torch.host import ModelConfig
    from tpu_asr_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()
    lib = _kernels.build()
    _kernels.library()
    print(f"build: {time.perf_counter() - start:.1f} s -> {lib}")

    cfg = ModelConfig()
    measured = kernel_phase(cfg)
    model_phase(cfg)
    counts = serve_phase(cfg)
    rows = []
    for name, (source, replaces, dt) in KERNELS.items():
        err, ms, plain_ms = measured[name][dt]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
