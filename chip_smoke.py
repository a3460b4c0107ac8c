"""Drive the PyTorch port (tpu_asr_torch) once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each on its own output lines:
  1. card: exit non-zero without a CUDA device; print the card's name and
     power limit (nvidia-smi).
  2. build: compile csrc/*.cu with nvcc (seconds printed).
  3. kernels: each hand-written kernel against its plain PyTorch version at
     the flagship serving shapes (B=32 x 15 s), fp32 and bf16: max error
     within its tolerance, median times of kernel and plain (CUDA events)
     and the bound.
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
  6. train kernels: each training kernel against its plain version at the
     student's shapes (make_student_config(ModelConfig()): B=32 x 15 s,
     T'=376, D=88, 2 heads, d_ff 352, 128 tokens + blank, 48 target
     tokens), fp32 and bf16, dropout 0.1 where the kernel has it: attention
     forward and backward, FFN forward and backward, CTC forward and
     backward (fp32; F.ctc_loss forward + backward timed beside it), and
     subsampling at C=88. Max error against a stated tolerance, median
     kernel and plain times (CUDA events) and the bound (bytes over
     3.35 TB/s or operations over the peak rate of the operands' type).
     The backward kernels give bit-equal gradients on two calls (no
     atomics), and the FFN and CTC kernels are also held to their plain
     versions at ragged edges the main path does not reach.
  7. train: one DistilCTCModel train step of the student in fp32 at full
     width (16 layers) on B=8 x 15 s, once on the kernels and once on the
     plain versions, from the same weights and seeds (dropout, dither and
     SpecAugment on): loss, every gradient and the BatchNorm running
     statistics must agree. Then the student at its own bf16 compute dtype
     on B=32 x 15 s with 48 tokens: 2 warm-up steps, counters reset, 10
     timed steps; the loss stays finite, every training kernel (forward and
     backward) launched, and ms per step, audio seconds per second and peak
     memory are printed.
  8. fm kernels: the flow-matching Euler loop forward and backward against
     its plain version at the flagship KD shapes (rows = 32 x 16 layers,
     T'=376, C=88, H=128, 8 steps), fp32 and bf16, with both output
     cotangents nonzero; a ragged case (per-row steps 1..16, max_steps 16,
     fewer rows); two backward calls bit-equal; shapes outside the kernel's
     build refused. Max error per output and per gradient against a stated
     tolerance, median kernel and plain times and the bound.
  9. KD train: one flowkd_mlp8 train step (frozen ModelConfig() teacher,
     logit KD 0.1, FM-KT mlp 8 steps over 16 layers) in fp32 at full width
     on B=8 x 15 s, once on the kernels and once on the plain versions from
     the same weights and seeds (dropout, dither and SpecAugment on): every
     loss component within 1e-4 relative, every student and FM gradient
     within the student step's rule, the teacher's parameters and running
     statistics bit-unchanged. Then the bf16 step at B=32 x 15 s with 48
     tokens: 2 warm-up steps, counters reset, 10 timed steps; losses finite,
     every kernel (the teacher's logmel, subsampling C=176 and attention
     forward included) launched; ms per step, audio s/s and peak memory.
  10. eval kernels: the int8 FFN sublayer and the conv module against their
     plain versions at the int8 teacher's serving shape (B=32 x 15 s,
     T'=376, D=176, d_ff 704, conv k=31, ragged lengths), fp32 and bf16:
     the conv with folded batch norm, layer norm and a causal (30, 0)
     context; both also at an odd T, at the student's D=88, and refusing a
     shape outside their build. The int8 FFN: rows whose every quantized
     value lies more than 1e-4 quanta from a rounding tie match to 1e-5
     (one ulp in bf16); at most 1% of the rows differ beyond it (a quantization step flips
     where the LN sums run in another order; counts printed); max error
     2e-2 in fp32, 3e-2 of max(1, |ref|) in bf16. The conv within 1e-4 of
     the output's scale in fp32, 3e-2 in bf16. Median kernel and plain times, the
     bound, and beside the int8 FFN the bf16 eval FFN sublayer it replaces
     (LN + two cuBLAS products).
  11. int8 model: ModelConfig() with quantization='int8' and
     conv_backend='pallas' in fp32 on 8 clips, kernels against plain:
     every eval kernel launched, equal encoded_len; each layer on the plain
     model's layer input with at most 10% of its rows beyond 1e-4 and none
     beyond half the int8-vs-fp drift of the same weights (a quantization
     step flips where a value lies within rounding of a tie, and the
     flips compound over 16 layers, so the end-to-end max |delta
     log-prob| and the drift are printed, not gated); equal greedy ids on
     at least 99% of the frames whose plain top-2 margin exceeds 1e-2.
  12. int8 serve: the serve phase on the phase-11 configuration in bf16,
     every serving kernel and the int8 FFN and conv module launched; RTFx
     beside phase 5's.
  13. int8-teacher KD: phase 9 for flowkd_mlp8_int8_teacher (the teacher's
     FFN sublayers in int8), the int8 FFN launched 32 times per timed
     step.
Then one JSON line of per-kernel results, and last the JSON device line.
Any failed check exits non-zero before the last line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SECONDS, BATCH, SR = 15, 32, 16000
SERVE_POOL, SERVE_BATCH, SERVE_WARMUP, SERVE_REQUESTS = 256, 32, 2, 64
TOKENS, CHECK_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 48, 8, 2, 10
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM, data sheet
# SIMT fp32, bf16 and int8 tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


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
    {name: {dtype: (max_abs_err, kernel_ms, plain_ms, bound, library_ms)}}."""
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
    with torch.no_grad():
        got, want = fused_logmel(*args), logmel_plain(*args)
    torch.cuda.synchronize()
    live = want > np.log(pre.log_zero_guard_value) + 8.0
    err = (got - want).abs()[live].max().item()
    check(torch.isfinite(got).all() and live.float().mean() > 0.5,
          "logmel finite, most bins live")
    check(err < 2e-3, f"logmel fp32 (B={BATCH}, T={n_frames}, "
          f"{pre.features} mels): max |err| on live bins {err:.3e} < 2e-3")
    nf = pre.n_fft // 2 + 1
    flops = (2 * BATCH * n_frames * pre.n_fft * 2 * nf + 3 * BATCH * n_frames
             * nf + 2 * BATCH * n_frames * nf * pre.features
             + BATCH * n_frames * pre.features)
    results["logmel"] = {"float32": (
        err, median_ms(lambda: fused_logmel(*args)),
        median_ms(lambda: logmel_plain(*args)),
        bound(flops, nbytes(xp, feat.basis, feat.fb_t, got), "float32"),
        None)}

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
        flops = (2 * 9 * BATCH * out_len(n_frames) * out_len(pre.features)
                 * ch + 2 * 9 * BATCH * t2 * f2 * ch * ch
                 + 2 * BATCH * t2 * ch * f2 * d)
        results["subsampling"][str(dt)[6:]] = (
            err, median_ms(lambda: fused_subsampling(x, *w)),
            median_ms(lambda: subsampling_plain(x, *w)),
            bound(flops, nbytes(x, *w) + got.numel() * x.element_size(),
                  str(dt)[6:]), None)

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
            median_ms(lambda: relpos_attention_plain(*aargs)),
            bound(attention_flops(BATCH, t2, d, h),
                  nbytes(x, *pw) + got.numel() * x.element_size(),
                  str(dt)[6:]), None)
    for name, per_dt in results.items():
        for dt, (err, ms, plain_ms, (b_ms, by), _) in per_dt.items():
            print(f"time {name} {dt}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) (median "
                  f"of 20, CUDA events)")
    return results


def reset_counters():
    """Set every kernel wrapper's launch count to 0; {row name: wrapper}."""
    from tpu_asr_torch.ops.cuda_attention import (
        fused_relpos_attention_block, fused_relpos_attention_block_bwd)
    from tpu_asr_torch.ops.cuda_conv import fused_conv_module
    from tpu_asr_torch.ops.cuda_ctc import ctc_nll, ctc_nll_bwd
    from tpu_asr_torch.ops.cuda_features import fused_logmel
    from tpu_asr_torch.ops.cuda_ffn import (fused_ffn_sublayer,
                                            fused_ffn_sublayer_bwd,
                                            fused_ffn_sublayer_int8)
    from tpu_asr_torch.ops.cuda_fm import fused_fm_euler, fused_fm_euler_bwd
    from tpu_asr_torch.ops.cuda_subsampling import fused_subsampling
    fns = {"logmel": fused_logmel, "subsampling": fused_subsampling,
           "attention": fused_relpos_attention_block,
           "attention_bwd": fused_relpos_attention_block_bwd,
           "ffn": fused_ffn_sublayer, "ffn_bwd": fused_ffn_sublayer_bwd,
           "ctc": ctc_nll, "ctc_bwd": ctc_nll_bwd, "fm": fused_fm_euler,
           "fm_bwd": fused_fm_euler_bwd, "ffn_int8": fused_ffn_sublayer_int8,
           "conv_module": fused_conv_module}
    for fn in fns.values():
        fn.launches = 0
    return fns


def model_clips(seed: int):
    """8 seeded clips of 5-15 s, zero-padded: (signal, lengths) on the
    card."""
    from tpu_asr_torch.profile_forward import waveforms
    clips = waveforms(np.random.default_rng(seed), 8, 5.0, SECONDS)
    sig = np.zeros((len(clips), SECONDS * SR), np.float32)
    for i, c in enumerate(clips):
        sig[i, :len(c)] = c
    return (torch.from_numpy(sig).cuda(),
            torch.tensor([len(c) for c in clips], device="cuda"))


def model_phase(cfg):
    from tpu_asr_torch.profile_forward import seeded_model, set_backend
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = seeded_model(cfg32, seed=1)
    sig_t, len_t = model_clips(1)
    fns = reset_counters()
    with torch.inference_mode():
        got = model(sig_t, len_t)
        counts = {k: f.launches for k, f in fns.items()}
        set_backend(model, "xla")
        want = model(sig_t, len_t)
        set_backend(model, "auto")
    torch.cuda.synchronize()
    counts = {k: counts[k] for k in SERVING}
    check(all(v > 0 for v in counts.values()),
          f"model on kernels launched every kernel: {counts}")
    check(torch.equal(got.encoded_len, want.encoded_len),
          "encoded_len equal")
    valid = (torch.arange(got.log_probs.shape[1], device="cuda")[None, :]
             < want.encoded_len[:, None])
    delta = ((got.log_probs - want.log_probs).abs() * valid[..., None]).max()
    check(bool(torch.isfinite(got.log_probs).all()), "log-probs finite")
    check(delta.item() < 2e-3, f"ModelConfig() fp32, {len(sig_t)} clips of "
          f"5-{SECONDS} s: max |delta log-prob| kernels vs plain "
          f"{delta.item():.3e} < 2e-3")
    top2 = want.log_probs.topk(2, dim=-1).values
    decided = valid & ((top2[..., 0] - top2[..., 1]) > 1e-3)
    same = (got.greedy == want.greedy) | ~decided
    check(bool(same.all()), f"greedy ids equal on {int(decided.sum())} "
          f"frames with plain top-2 margin > 1e-3 "
          f"(of {int(valid.sum())} valid)")


def serve_phase(cfg, rows=None):
    """Returns ({row: launches} for `rows` (default SERVING), RTFx)."""
    from tpu_asr_torch.data.tokenizer import train_bpe
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
    counts = {k: fns[k].launches for k in rows or SERVING}
    audio_s = sum(len(w) for r in requests for w in r) / SR
    flat = [t for r in texts for t in r]
    check(len(flat) == SERVE_REQUESTS * SERVE_BATCH
          and all(isinstance(t, str) for t in flat),
          f"Transcriber ({cfg.compute_dtype}) answered {SERVE_REQUESTS} "
          f"requests of {SERVE_BATCH} waveforms with strings, "
          f"e.g. {flat[0]!r}")
    check(all(v > 0 for v in counts.values()),
          f"serving path launched every kernel: {counts}")
    enc = cfg.encoder
    print(f"serve (quantization {enc.quantization}, conv {enc.conv_backend})"
          f": {SERVE_REQUESTS} requests x {SERVE_BATCH} clips of "
          f"1-{SECONDS} s, {audio_s:.2f} s of audio in {wall:.4f} s wall: "
          f"RTFx {audio_s / wall:.1f}; per request median "
          f"{1e3 * float(np.median(latency)):.2f} ms, max "
          f"{1e3 * max(latency):.2f} ms (host clock, after "
          f"{SERVE_WARMUP} warm-up requests)")
    return counts, audio_s / wall


def bound(flops: float, nbytes: float, dtype: str):
    """(least ms the card could take, what binds it): operations over the
    peak rate of the operands' type, or bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def attention_flops(b, t, d, h, backward=False):
    """Multiply-adds x 2. Forward: q/k/v/out projections, P = PE Wpos^T,
    content and position scores, value product. Backward, from the saved
    forward: dctx, dWo, dx (3 products), dWq/k/v, dWpos, and per (b, h) 8
    T x T x dk products (scores recomputed twice, dP = dctx v, dq_u, dq_v,
    dk, dv, the position gradient)."""
    dk = d // h
    if not backward:
        return (2 * b * t * d * d * 4 + 2 * (2 * t - 1) * d * d
                + 2 * b * h * t * t * dk * 3)
    return (2 * b * t * d * d * 8 + 2 * (2 * t - 1) * d * d
            + 2 * b * h * t * t * dk * 8)


def grads_close(got, want, tol, names, floor, verbose=True):
    """Per tensor max |got - want| <= tol * max(max|want|, floor * the
    largest max|want| of the set). The floor is for gradients that are zero
    in exact arithmetic (the key bias: softmax ignores a per-query constant;
    a bias before BatchNorm): they hold the rounding noise of a sum over
    B * T rows at the scale of the other gradients (1e-4 of the largest in
    fp32, 1e-2 in bf16, whose rows carry 2^-9 relative rounding). Returns
    (largest absolute error, largest error over its tensor's scale)."""
    errs = [(a.float() - w.float()).abs().max().item()
            for a, w in zip(got, want)]
    refs = [w.float().abs().max().item() for w in want]
    top = max(refs)
    worst_abs = worst_rel = 0.0
    for name, err, ref in zip(names, errs, refs):
        scale = max(ref, floor * top)
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(scale, 1e-30))
        if verbose or err > tol * scale:
            check(err <= tol * scale,
                  f"  {name}: max |err| {err:.3e} <= {tol} x max(max|ref| "
                  f"{ref:.3e}, {floor:g} x {top:.3e})")
    check(worst_rel <= tol, f"  {len(errs)} gradients: largest error "
          f"{worst_rel:.3e} of its tensor's scale (<= {tol})")
    return worst_abs, worst_rel


def train_kernel_phase(tcfg):
    """Each training kernel against its plain version at the student's
    shapes. Returns {name: (max_abs_err, ms, plain_ms, bound, library_ms)}
    for the kernels new to training, in the main path's dtype (bf16, CTC
    fp32); the student's subsampling and attention forward are printed
    (their JSON rows keep the serving shapes)."""
    import torch.nn.functional as F

    from tpu_asr_torch.config import make_student_config
    from tpu_asr_torch.models.conformer import rel_positional_encoding
    from tpu_asr_torch.ops.cuda_attention import (
        fused_relpos_attention_block, fused_relpos_attention_block_bwd,
        relpos_attention_plain)
    from tpu_asr_torch.ops.cuda_ctc import ctc_nll, ctc_nll_bwd, ctc_nll_plain
    from tpu_asr_torch.ops.cuda_ffn import (ffn_sublayer_plain,
                                            fused_ffn_sublayer,
                                            fused_ffn_sublayer_bwd)
    from tpu_asr_torch.ops.cuda_subsampling import (fused_subsampling,
                                                    out_len, subsampling_plain)

    scfg = make_student_config(tcfg)
    gen = torch.Generator(device="cuda").manual_seed(3)
    enc, pre = scfg.encoder, scfg.preprocessor
    d, h, f = enc.d_model, enc.n_heads, enc.d_ff
    dk = d // h
    n_frames = SECONDS * SR // pre.hop_length + 1
    t = out_len(out_len(n_frames))
    rate, seed = enc.dropout, 2 ** 31 - 5      # streams wrap past int32
    results = {}
    main_dt = {"subsampling": "bfloat16", "attention": "bfloat16",
               "attention_bwd": "bfloat16", "ffn": "bfloat16",
               "ffn_bwd": "bfloat16"}
    per_dt = {k: {} for k in main_dt}

    # subsampling at the student's C = 88
    ch = enc.conv_channels
    f2 = out_len(out_len(pre.features))
    w = (normal(gen, ch, 1, 3, 3, scale=0.3), normal(gen, ch, scale=0.1),
         normal(gen, ch, ch, 3, 3, scale=0.08), normal(gen, ch, scale=0.1),
         normal(gen, d, ch * f2, scale=0.05))
    feats = normal(gen, BATCH, n_frames, pre.features)
    for dt in (torch.float32, torch.bfloat16):
        x = feats.to(dt)
        with torch.no_grad():
            got = fused_subsampling(x, *w).float()
            want = subsampling_plain(x, *w).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        rtol, atol = ((1e-3, 1e-3) if dt == torch.float32
                      else (0.05, 0.03 * max(1.0, ref)))
        check(torch.allclose(got, want, rtol=rtol, atol=atol)
              and got.shape == (BATCH, t, d),
              f"subsampling C={ch} {str(dt)[6:]} -> ({BATCH}, {t}, {d}): "
              f"max |err| {err:.3e} (rtol {rtol}, atol {atol:.3g})")
        flops = (2 * 9 * BATCH * out_len(n_frames) * out_len(pre.features)
                 * ch + 2 * 9 * BATCH * t * f2 * ch * ch
                 + 2 * BATCH * t * ch * f2 * d)
        with torch.no_grad():
            per_dt["subsampling"][str(dt)[6:]] = (
                err, median_ms(lambda: fused_subsampling(x, *w)),
                median_ms(lambda: subsampling_plain(x, *w)),
                bound(flops, nbytes(x, *w) + got.numel() * x.element_size(),
                      str(dt)[6:]), None)

    # attention forward (dropout) and backward
    pw = (normal(gen, d, d, scale=d ** -0.5), normal(gen, d, scale=0.1),
          normal(gen, d, d, scale=d ** -0.5), normal(gen, d, scale=0.1),
          normal(gen, d, d, scale=d ** -0.5), normal(gen, d, scale=0.1),
          normal(gen, h, dk, scale=0.1), normal(gen, h, dk, scale=0.1),
          normal(gen, d, d, scale=d ** -0.5), normal(gen, d, d,
                                                      scale=d ** -0.5))
    pos_emb = rel_positional_encoding(t, d, "cuda")
    lengths = torch.randint(t // 4, t + 1, (BATCH,), generator=gen,
                            device="cuda")
    lengths[0] = t
    mask = torch.arange(t, device="cuda")[None, :] < lengths[:, None]
    valid = mask[..., None]
    xa = normal(gen, BATCH, t, d, scale=0.5)
    ga = normal(gen, BATCH, t, d) * valid
    names = ["dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "d_pos_bias_u",
             "d_pos_bias_v", "dw_pos", "dwo"]
    for dt in (torch.float32, torch.bfloat16):
        dts = str(dt)[6:]
        x = xa.to(dt)
        aargs = (x, *pw, pos_emb, mask, h)
        with torch.no_grad():
            got = fused_relpos_attention_block(
                *aargs, dropout_rate=rate, dropout_seed=seed).float()
            want = relpos_attention_plain(*aargs, rate, seed).float()
        torch.cuda.synchronize()
        err = ((got - want).abs() * valid).max().item()
        rtol, atol = (1e-4, 1e-4) if dt == torch.float32 else (1e-2, 3e-3)
        check(torch.allclose(got * valid, want * valid, rtol=rtol, atol=atol),
              f"attention {dts} dropout {rate} (B={BATCH}, T={t}, D={d}, "
              f"H={h}) valid rows: max |err| {err:.3e} (rtol {rtol}, atol "
              f"{atol})")
        fwd_bytes = nbytes(x, *pw) + got.numel() * x.element_size()
        with torch.no_grad():
            per_dt["attention"][dts] = (
                err, median_ms(lambda: fused_relpos_attention_block(
                    *aargs, dropout_rate=rate, dropout_seed=seed)),
                median_ms(lambda: relpos_attention_plain(*aargs, rate, seed)),
                bound(attention_flops(BATCH, t, d, h), fwd_bytes, dts), None)
        leaves = [z.detach().requires_grad_() for z in (x, *pw)]
        out_k = fused_relpos_attention_block(
            *leaves, pos_emb, mask, h, dropout_rate=rate, dropout_seed=seed)
        g = ga.to(dt)
        got_g = torch.autograd.grad(out_k, leaves, g, retain_graph=True)
        leaves_p = [z.detach().requires_grad_() for z in (x, *pw)]
        out_p = relpos_attention_plain(*leaves_p, pos_emb, mask, h, rate,
                                       seed)
        want_g = torch.autograd.grad(out_p, leaves_p, g, retain_graph=True)
        torch.cuda.synchronize()
        # fp32: sums of up to B*T products in another order; bf16: operands
        # rounded to bf16 at other points than autograd's roundings
        tol, floor = (1e-3, 1e-4) if dt == torch.float32 else (5e-2, 1e-2)
        print(f"attention_bwd {dts} dropout {rate}, kernels vs plain:")
        err_abs, _ = grads_close(got_g, want_g, tol, names, floor)
        saved = out_k.grad_fn.saved_tensors
        bwd = lambda: fused_relpos_attention_block_bwd(g, *saved, h, rate,
                                                       seed)
        check(all(torch.equal(a, b) for a, b in zip(bwd(), bwd())),
              f"attention_bwd {dts}: two calls give bit-equal gradients")
        bwd_bytes = (nbytes(g, *saved) + nbytes(*got_g))
        per_dt["attention_bwd"][dts] = (
            err_abs, median_ms(lambda: fused_relpos_attention_block_bwd(
                g, *saved, h, rate, seed)),
            median_ms(lambda: torch.autograd.grad(out_p, leaves_p, g,
                                                  retain_graph=True)),
            bound(attention_flops(BATCH, t, d, h, backward=True), bwd_bytes,
                  dts), None)

    # FFN forward and backward
    fw = (1.0 + normal(gen, d, scale=0.1), normal(gen, d, scale=0.1),
          normal(gen, f, d, scale=d ** -0.5), normal(gen, f, scale=0.1),
          normal(gen, d, f, scale=f ** -0.5), normal(gen, d, scale=0.1))
    xf = normal(gen, BATCH, t, d)
    gf = normal(gen, BATCH, t, d)
    fnames = ["dx", "d_ln_scale", "d_ln_bias", "dw1", "db1", "dw2", "db2"]
    for dt in (torch.float32, torch.bfloat16):
        dts = str(dt)[6:]
        x = xf.to(dt)
        with torch.no_grad():
            got = fused_ffn_sublayer(x, *fw, rate, seed).float()
            want = ffn_sublayer_plain(x, *fw, rate, seed).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        rtol, atol = ((1e-4, 1e-4 * max(1.0, ref)) if dt == torch.float32
                      else (1e-2, 1e-2 * max(1.0, ref)))
        check(torch.allclose(got, want, rtol=rtol, atol=atol),
              f"ffn {dts} dropout {rate} (B={BATCH}, T={t}, D={d}, "
              f"d_ff={f}): max |err| {err:.3e} (rtol {rtol}, atol "
              f"{atol:.3g})")
        with torch.no_grad():
            per_dt["ffn"][dts] = (
                err, median_ms(lambda: fused_ffn_sublayer(x, *fw, rate, seed)),
                median_ms(lambda: ffn_sublayer_plain(x, *fw, rate, seed)),
                bound(4 * BATCH * t * d * f,
                      nbytes(x, *fw) + got.numel() * x.element_size(), dts),
                None)
        leaves = [z.detach().requires_grad_() for z in (x, *fw)]
        out_k = fused_ffn_sublayer(*leaves, rate, seed)
        g = gf.to(dt)
        got_g = torch.autograd.grad(out_k, leaves, g, retain_graph=True)
        leaves_p = [z.detach().requires_grad_() for z in (x, *fw)]
        out_p = ffn_sublayer_plain(*leaves_p, rate, seed)
        want_g = torch.autograd.grad(out_p, leaves_p, g, retain_graph=True)
        torch.cuda.synchronize()
        tol, floor = (1e-3, 1e-4) if dt == torch.float32 else (5e-2, 1e-2)
        print(f"ffn_bwd {dts} dropout {rate}, kernels vs plain:")
        err_abs, _ = grads_close(got_g, want_g, tol, fnames, floor)
        saved = out_k.grad_fn.saved_tensors
        bwd = lambda: fused_ffn_sublayer_bwd(*saved, g, rate, seed)
        check(all(torch.equal(a, b) for a, b in zip(bwd(), bwd())),
              f"ffn_bwd {dts}: two calls give bit-equal gradients")
        per_dt["ffn_bwd"][dts] = (
            err_abs, median_ms(lambda: fused_ffn_sublayer_bwd(
                *saved, g, rate, seed)),
            median_ms(lambda: torch.autograd.grad(out_p, leaves_p, g,
                                                  retain_graph=True)),
            bound(10 * BATCH * t * d * f,
                  nbytes(x, g, *fw) + nbytes(*got_g), dts), None)

    # CTC forward and backward, fp32
    v = scfg.decoder.num_classes + 1
    blank = v - 1
    lp = torch.log_softmax(normal(gen, BATCH, t, v, scale=2.0), dim=-1)
    tg = torch.randint(0, blank, (BATCH, TOKENS), generator=gen,
                       device="cuda")
    il = torch.full((BATCH,), t, device="cuda")
    tl = torch.full((BATCH,), TOKENS, device="cuda")
    l = 2 * TOKENS + 1
    with torch.no_grad():
        got = ctc_nll(lp, tg, il, tl)
        want = ctc_nll_plain(lp, tg, il, tl)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-3),
          f"ctc fp32 (B={BATCH}, T={t}, V={v}, S={TOKENS}): NLL max |err| "
          f"{err:.3e} (rtol 1e-5, atol 1e-3)")
    lse_flops = 20 * BATCH * t * l       # 3 exp, 1 log, adds, max, select
    lpt = lp.transpose(0, 1).detach().requires_grad_()

    def library(backward: bool):
        loss = F.ctc_loss(lpt, tg, il, tl, blank=blank, reduction="sum",
                          zero_infinity=True)
        if backward:
            torch.autograd.grad(loss, lpt)

    with torch.no_grad():
        results["ctc"] = (
            err, median_ms(lambda: ctc_nll(lp, tg, il, tl)),
            median_ms(lambda: ctc_nll_plain(lp, tg, il, tl), iters=5),
            bound(lse_flops, nbytes(lp) + 4 * BATCH * t * l, "float32"),
            median_ms(lambda: library(False)))
    leaf = lp.detach().requires_grad_()
    nll_k = ctc_nll(leaf, tg, il, tl)
    gk = torch.autograd.grad(nll_k.sum(), leaf, retain_graph=True)[0]
    leaf_p = lp.detach().requires_grad_()
    nll_p = ctc_nll_plain(leaf_p, tg, il, tl)
    gp = torch.autograd.grad(nll_p.sum(), leaf_p, retain_graph=True)[0]
    torch.cuda.synchronize()
    err = (gk - gp).abs().max().item()
    # the analytic posterior exp(alpha + beta - lp + nll) against autograd
    # through the recursion: alpha and beta carry fp32 rounding of their
    # magnitude (~|NLL|) at each of the T steps, a random walk that enters
    # the posterior's exponent: 4 x 2^-24 x max|NLL| x sqrt(T)
    tol = 4 * 2.0 ** -24 * want.abs().max().item() * math.sqrt(t)
    check(err < tol, f"ctc_bwd fp32: d log-probs max |err| {err:.3e} < "
          f"{tol:.3e} (max|NLL| {want.abs().max().item():.1f}, T={t})")
    saved = nll_k.grad_fn.saved_tensors
    ones = torch.ones(BATCH, device="cuda")
    results["ctc_bwd"] = (
        err, median_ms(lambda: ctc_nll_bwd(*saved, ones, blank)),
        median_ms(lambda: torch.autograd.grad(nll_p.sum(), leaf_p,
                                              retain_graph=True), iters=5),
        bound(lse_flops + 4 * BATCH * t * l,
              nbytes(lp) + 2 * 4 * BATCH * t * l, "float32"),
        median_ms(lambda: library(True)))

    ragged_edges(lp, tg, fw, rate, seed)
    for name in ("attention_bwd", "ffn", "ffn_bwd"):
        results[name] = per_dt[name][main_dt[name]]
    for name, dts in per_dt.items():
        for dt, (err, ms, plain_ms, (b_ms, by), _) in dts.items():
            print(f"time {name} {dt}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) "
                  f"(median of 20, CUDA events)")
    for name in ("ctc", "ctc_bwd"):
        err, ms, plain_ms, (b_ms, by), lib = results[name]
        print(f"time {name} float32: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), F.ctc_loss "
              f"{'forward+backward' if name == 'ctc_bwd' else 'forward'} "
              f"{lib:.4f} ms")
    return results


def ragged_edges(lp, tg, fw, rate, seed):
    """Kernels against plain versions where the main path has no ragged
    edge, fp32: the FFN at 3 x 37 rows (not a multiple of its 32-row tile),
    CTC with short inputs, an empty target and an impossible alignment
    (zero_infinity), under the 'mean' reduction."""
    from tpu_asr_torch.ops.ctc import ctc_loss
    from tpu_asr_torch.ops.cuda_ffn import (ffn_sublayer_plain,
                                            fused_ffn_sublayer)

    gen = torch.Generator(device="cuda").manual_seed(11)
    x = normal(gen, 3, 37, fw[0].shape[0])
    g = normal(gen, 3, 37, fw[0].shape[0])
    outs = []
    for run in (fused_ffn_sublayer, ffn_sublayer_plain):
        leaves = [z.detach().requires_grad_() for z in (x, *fw)]
        out = run(*leaves, rate, seed)
        outs.append([out] + list(torch.autograd.grad(out, leaves, g)))
    print("ffn fp32 at 3 x 37 rows, kernels vs plain (output, then grads):")
    grads_close(outs[0], outs[1], 1e-3, ["out", "dx", "d_ln_scale",
                                         "d_ln_bias", "dw1", "db1", "dw2",
                                         "db2"], 1e-4)
    b, t = 4, lp.shape[1]
    il = torch.tensor([t, 200, 30, 5], device="cuda")
    tl = torch.tensor([48, 20, 0, 48], device="cuda")
    got = []
    for backend in ("auto", "scan"):
        leaf = lp[:b].detach().requires_grad_()
        loss = ctc_loss(leaf, tg[:b], il, tl, reduction="mean",
                        backend=backend)
        got.append((loss, torch.autograd.grad(loss, leaf)[0]))
    (lk, gk), (lp_, gp) = got
    err = (gk - gp).abs().max().item()
    check(torch.isfinite(gk).all() and abs(lk.item() - lp_.item())
          <= 1e-5 * abs(lp_.item()) and err < 2e-3,
          f"ctc fp32 input lengths {il.tolist()}, target lengths "
          f"{tl.tolist()}: loss {lk.item():.6f} vs plain {lp_.item():.6f}, "
          f"d log-probs max |err| {err:.3e} < 2e-3, impossible row zeroed "
          f"({gk[3].abs().max().item():.1e})")


def train_batch(batch: int, seed: int):
    rng = np.random.default_rng(seed)
    return {
        "signal": torch.from_numpy(rng.normal(size=(batch, SECONDS * SR))
                                   .astype(np.float32) * 0.1).cuda(),
        "signal_len": torch.full((batch,), SECONDS * SR, device="cuda"),
        "tokens": torch.from_numpy(rng.integers(0, 128, size=(batch, TOKENS))
                                   ).cuda(),
        "token_len": torch.full((batch,), TOKENS, device="cuda")}


def student(scfg, seed: int):
    from tpu_asr_torch.config import ModelConfig
    from tpu_asr_torch.models.distil_model import DistilCTCModel
    from tpu_asr_torch.profile_forward import seed_weights
    return seed_weights(DistilCTCModel(scfg, ModelConfig()), seed).cuda()


def train_phase(tcfg):
    """The fp32 kernels-vs-plain step check, then the timed bf16 steps.
    Returns {counter name: launches} of the timed steps."""
    import copy

    from tpu_asr_torch.config import OptimConfig, make_student_config
    from tpu_asr_torch.profile_forward import set_backend
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step)

    scfg = make_student_config(tcfg)
    model = student(dataclasses.replace(scfg, compute_dtype="float32"), 4)
    init = copy.deepcopy(model.state_dict())
    batch = train_batch(CHECK_BATCH, 5)
    runs = {}
    for backend in ("auto", "xla"):
        model.load_state_dict(init)
        set_backend(model, backend)
        state = DistilTrainState.create(model, OptimConfig())
        state, metrics = make_distil_train_step(model)(state, batch, 7)
        torch.cuda.synchronize()
        runs[backend] = (
            metrics["loss/total"].item(),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()
             if "running" in n},
            {n: p.detach().clone() for n, p in model.named_parameters()})
    (lk, gk, sk, pk), (lp, gp, sp, pp) = runs["auto"], runs["xla"]
    check(math.isfinite(lk) and abs(lk - lp) <= 1e-4 * abs(lp),
          f"fp32 student train step (16 layers, B={CHECK_BATCH} x {SECONDS} "
          f"s, dropout {scfg.encoder.dropout}, SpecAugment, dither): loss "
          f"kernels {lk:.6f} vs plain {lp:.6f}")
    # fp32 sums in another order through 16 layers of backward, and the
    # CTC kernel's analytic posterior against autograd through the scan
    print("fp32 train step gradients, kernels vs plain:")
    _, worst = grads_close(list(gk.values()), list(gp.values()), 1e-2,
                           list(gk), 1e-4, verbose=False)
    err_bn = max((sk[n] - sp[n]).abs().max().item() for n in sk)
    check(err_bn < 1e-4, f"BatchNorm running statistics after the step: max "
          f"|err| {err_bn:.3e} < 1e-4")
    err_p = max((pk[n] - pp[n]).abs().max().item() for n in pk)
    check(err_p < 1e-5, f"parameters after the AdamW step: max |err| "
          f"{err_p:.3e} < 1e-5")

    ms, counts, metrics = timed_steps(student(scfg, 6), train_batch(BATCH, 8),
                                      9)
    counts = {k: v for k, v in counts.items() if k in STUDENT}
    losses = torch.stack([m["loss/total"] for m in metrics]).tolist()
    check(all(math.isfinite(x) for x in losses),
          f"bf16 student train steps: losses finite, first {losses[0]:.4f} "
          f"last {losses[-1]:.4f}")
    check(all(v > 0 for v in counts.values()),
          f"train steps launched every kernel: {counts}")
    print(f"train: student ({scfg.compute_dtype}, 16 layers, d "
          f"{scfg.encoder.d_model}) B={BATCH} x {SECONDS} s, {TOKENS} "
          f"tokens: {timed_summary(ms)}")
    return counts


def timed_steps(model, batch, seed: int):
    """TRAIN_WARMUP steps, then the launch counters and the peak memory
    reset and TRAIN_STEPS steps timed on the host clock up to a final
    synchronize. Returns (ms per step, {row: launches}, [metrics])."""
    from tpu_asr_torch.config import OptimConfig
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step)
    state = DistilTrainState.create(model, OptimConfig())
    step = make_distil_train_step(model)
    for _ in range(TRAIN_WARMUP):
        state, _ = step(state, batch, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fns = reset_counters()
    metrics = []
    start = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch, seed)
        metrics.append(m)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - start) / TRAIN_STEPS
    return ms, {k: f.launches for k, f in fns.items()}, metrics


def timed_summary(ms: float) -> str:
    return (f"{ms:.2f} ms per step, {BATCH * SECONDS / (ms / 1e3):.1f} audio "
            f"s per s (host clock over {TRAIN_STEPS} steps after "
            f"{TRAIN_WARMUP} warm-up), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")


def fm_inputs(gen, rows, t, max_steps, steps=None):
    """x0, steps, w1x, a, c, w2, b2 of the Euler loop at C=88, H=128."""
    c, h = 88, 128
    if steps is None:
        steps = torch.full((rows,), max_steps, device="cuda")
    return (normal(gen, rows, t, c), steps, normal(gen, c, h, scale=c ** -0.5),
            normal(gen, h, scale=0.3), normal(gen, h, scale=0.1),
            normal(gen, h, c, scale=h ** -0.5), normal(gen, c, scale=0.1))


def fm_compare(args, max_steps, dt, label, time_it=False):
    """fused_fm_euler (forward and backward) against fm_euler_plain on the
    same inputs in compute dtype dt; returns (fwd row, bwd row) when
    time_it, as train_kernel_phase's rows."""
    from tpu_asr_torch.ops.cuda_fm import (fm_euler_plain, fused_fm_euler,
                                           fused_fm_euler_bwd)
    dts = str(dt)[6:]
    x0, steps, *w = args
    x0 = x0.to(dt)
    gen = torch.Generator(device="cuda").manual_seed(21)
    gx, gv = normal(gen, *x0.shape).to(dt), normal(gen, *x0.shape).to(dt)
    kw = dict(max_steps=max_steps, compute_dtype=dt)
    runs = []
    for fn in (fused_fm_euler, fm_euler_plain):
        leaves = [z.detach().requires_grad_() for z in (x0, *w)]
        out = fn(leaves[0], steps, *leaves[1:], **kw)
        grads = torch.autograd.grad(out, leaves, (gx, gv), retain_graph=True)
        runs.append((leaves, out, grads))
    torch.cuda.synchronize()
    (_, out_k, g_k), (leaves_p, out_p, g_p) = runs
    # fp32: the same operations summed in another order over up to 16
    # chained steps; bf16: x, h and v round at the same points, but a sum
    # that lands next to a rounding boundary moves one bf16 ulp (2^-8 of
    # the value) and the recurrence carries it on
    tol = 1e-4 if dt == torch.float32 else 3e-2
    errs = []
    for name, a, b in zip(("x_final", "last_v"), out_k, out_p):
        err = (a.float() - b.float()).abs().max().item()
        ref = b.float().abs().max().item()
        errs.append(err)
        check(torch.allclose(a.float(), b.float(), rtol=tol,
                             atol=tol * max(1.0, ref)),
              f"fm {label} {dts} {name}: max |err| {err:.3e}, |ref|max "
              f"{ref:.3e} (rtol {tol}, atol {tol} x max(1, |ref|max))")
    check(gx.abs().max() > 0 and gv.abs().max() > 0,
          f"fm {label} {dts}: both output cotangents nonzero")
    # fp32: sums over every position in another order; bf16: the plain
    # version's autograd rounds each gradient to bf16 where the forward
    # rounds, the kernel carries gx in fp32 (as _fm_bwd_kernel does)
    gtol, floor = (1e-3, 1e-4) if dt == torch.float32 else (5e-2, 1e-2)
    # dx0 per element: where a pre-activation lies within the rounding of
    # 0, sums in another order take the other side of the relu, and that
    # position's gradient moves by a whole dh W1x term; at most 1e-4 of
    # the elements may (the weight gradients sum over all positions)
    dx_k, dx_p = g_k[0].float(), g_p[0].float()
    scale = dx_p.abs().max().item()
    diff = (dx_k - dx_p).abs()
    over = int((diff > gtol * scale).sum())
    check(over <= 1e-4 * diff.numel(),
          f"fm_bwd {label} {dts} dx0: {over} of {diff.numel()} elements "
          f"beyond {gtol} x max|ref| {scale:.3e} (max |err| "
          f"{diff.max().item():.3e}; at most 1e-4 of them)")
    print(f"fm_bwd {label} {dts}, weight gradients, kernels vs plain:")
    err_w, _ = grads_close(g_k[1:], g_p[1:], gtol, ["dw1x", "da", "dc",
                                                    "dw2", "db2"], floor)
    err_bwd = max(err_w, diff.max().item())
    saved = out_k[0].grad_fn.saved_tensors
    bwd = lambda: fused_fm_euler_bwd(*saved, gx, gv, max_steps)
    check(all(torch.equal(a, b) for a, b in zip(bwd(), bwd())),
          f"fm_bwd {label} {dts}: two calls give bit-equal gradients")
    if not time_it:
        return None
    # the work this run's data needs: min(n, max_steps) steps per row
    row_steps = steps.clamp(min=1, max=max_steps).sum().item()
    mac = x0.shape[1] * 88 * 128 * row_steps
    n_bytes = nbytes(x0, *w) + 2 * nbytes(x0)
    fwd = (max(errs), median_ms(lambda: fused_fm_euler(x0, steps, *w, **kw)),
           median_ms(lambda: fm_euler_plain(x0, steps, *w, **kw), iters=5),
           bound(4 * mac, n_bytes, dts), None)
    plain_bwd = lambda: torch.autograd.grad(out_p, leaves_p, (gx, gv),
                                            retain_graph=True)
    bwd_row = (err_bwd, median_ms(bwd), median_ms(plain_bwd, iters=5),
               bound(12 * mac, nbytes(x0, gx, gv, *w) + nbytes(*g_k), dts),
               None)
    return fwd, bwd_row


def fm_kernel_phase():
    """The FM kernels against their plain version at the flagship KD
    shapes, fp32 and bf16, a ragged case, and the refused shapes. Returns
    {"fm": row, "fm_bwd": row} in bf16 (the main path's dtype)."""
    from tpu_asr_torch.ops.cuda_fm import fused_fm_euler

    gen = torch.Generator(device="cuda").manual_seed(20)
    rows, t, ms = BATCH * 16, 376, 8
    args = fm_inputs(gen, rows, t, ms)
    per_dt = {}
    for dt in (torch.float32, torch.bfloat16):
        per_dt[dt] = fm_compare(args, ms, dt, f"rows={rows} T={t} steps={ms}",
                                time_it=True)
    ragged = torch.randint(1, 17, (48,), generator=gen, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        fm_compare(fm_inputs(gen, 48, t, 16, ragged), 16, dt,
                   f"rows=48 T={t} per-row steps 1..16, max_steps 16")
    x0, steps, w1, a, c, w2, b2 = fm_inputs(gen, 4, 9, 8)
    for label, args, ms_ in (
            ("C=64", (x0[..., :64], steps, w1[:64], a, c, w2[:, :64], b2), 8),
            ("max_steps 17", (x0, steps, w1, a, c, w2, b2), 17)):
        refused(lambda: fused_fm_euler(*args, max_steps=ms_,
                                       compute_dtype=torch.bfloat16),
                f"fused_fm_euler at {label}")
    for name, i in (("fm", 0), ("fm_bwd", 1)):
        for dt, rows_ in per_dt.items():
            err, ms_, plain_ms, (b_ms, by), _ = rows_[i]
            print(f"time {name} {str(dt)[6:]}: kernel {ms_:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) (median "
                  f"of 20, plain of 5, CUDA events)")
    return {"fm": per_dt[torch.bfloat16][0],
            "fm_bwd": per_dt[torch.bfloat16][1]}


def kd_model(scfg, tcfg, seed: int):
    from tpu_asr_torch.models.distil_model import DistilCTCModel
    from tpu_asr_torch.profile_forward import seed_weights
    from tpu_asr_torch.profile_train import distill_config
    return seed_weights(DistilCTCModel(scfg, tcfg,
                                       distill_config("flowkd_mlp8")),
                        seed).cuda()


def kd_train_phase(tcfg, name: str = "flowkd_mlp8"):
    """The fp32 KD step (`name`: the flowkd_mlp8 distillation, teacher
    `tcfg`) on kernels against plain, then the timed bf16 steps. Returns
    {row name: launches} of the timed steps."""
    import copy

    from tpu_asr_torch.config import OptimConfig, make_student_config
    from tpu_asr_torch.profile_forward import set_backend
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step)

    f32 = lambda cfg: dataclasses.replace(cfg, compute_dtype="float32")
    scfg = make_student_config(with_encoder(tcfg, quantization="none"))
    model = kd_model(f32(scfg), f32(tcfg), 10)
    init = copy.deepcopy(model.state_dict())
    batch = train_batch(CHECK_BATCH, 11)
    int8 = tcfg.encoder.quantization == "int8"
    # (student and FM, teacher): an int8 teacher's quantization decisions
    # flip where sums run in another order (phase 11), which moves the
    # teacher-dependent losses, so its plain run keeps the teacher on the
    # kernels and a third run, all plain, is printed
    variants = [("auto", "auto"), ("xla", "auto" if int8 else "xla")]
    if int8:
        variants.append(("xla", "xla"))
    runs = {}
    for backend, teacher_backend in variants:
        model.load_state_dict(init)
        set_backend(model, backend)
        set_backend(model.teacher, teacher_backend)
        state = DistilTrainState.create(model, OptimConfig())
        state, metrics = make_distil_train_step(model)(state, batch, 12)
        torch.cuda.synchronize()
        run = runs[backend, teacher_backend] = (
            {k[5:]: v.item() for k, v in metrics.items()
             if k.startswith("loss/")},
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None},
            {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("teacher.")})
        check(all(torch.equal(v, init[k]) for k, v in run[2].items())
              and all(p.grad is None for n, p in model.named_parameters()
                      if n.startswith("teacher.")),
              f"fp32 {name} step ({backend}, teacher {teacher_backend}): "
              f"the teacher's {len(run[2])} parameters and statistics "
              f"bit-unchanged, no teacher gradient")
    set_backend(model, "auto")
    (lk, gk, _), (lp, gp, _) = runs[variants[0]], runs[variants[1]]
    check(set(lk) == {"ctc", "flow_matching", "logit_kd", "total"},
          f"fp32 {name} step losses {sorted(lk)}")
    for loss in sorted(lk):
        check(math.isfinite(lk[loss])
              and abs(lk[loss] - lp[loss]) <= 1e-4 * abs(lp[loss]),
              f"fp32 {name} step (teacher 16 x d{tcfg.encoder.d_model} "
              f"{tcfg.encoder.quantization}, student 16 x "
              f"d{scfg.encoder.d_model}, B={CHECK_BATCH} x {SECONDS} s, "
              f"dropout, SpecAugment, dither) loss/{loss}: kernels "
              f"{lk[loss]:.6f} vs plain {lp[loss]:.6f} (1e-4 rel"
              f"{'; both with the int8 teacher on its kernels' if int8 else ''}"
              f")")
    if int8:
        la = runs["xla", "xla"][0]
        check(abs(lk["ctc"] - la["ctc"]) <= 1e-4 * abs(la["ctc"]),
              f"fp32 {name} step: loss/ctc, which does not read the "
              f"teacher, kernels {lk['ctc']:.6f} vs all plain "
              f"{la['ctc']:.6f} (1e-4 rel)")
        print(f"fp32 {name} step, kernels vs all plain (the int8 teacher's "
              f"flips included): " + ", ".join(
                  f"{k} {lk[k]:.6f} vs {la[k]:.6f} (rel "
                  f"{abs(lk[k] - la[k]) / abs(la[k]):.2e})" for k in sorted(lk)))
    check(set(gk) == set(gp) and any(n.startswith("flow_matching.")
                                     for n in gk),
          f"fp32 {name} step: {len(gk)} student and FM gradients")
    print(f"fp32 {name} step gradients, kernels vs plain:")
    grads_close([gk[n] for n in gk], [gp[n] for n in gk], 1e-2, list(gk),
                1e-4, verbose=False)
    fm_names = [n for n in gk if n.startswith("flow_matching.")]
    grads_close([gk[n] for n in fm_names], [gp[n] for n in fm_names], 1e-2,
                fm_names, 1e-4)

    ms, counts, metrics = timed_steps(kd_model(scfg, tcfg, 13),
                                      train_batch(BATCH, 14), 15)
    names = ("ctc", "flow_matching", "logit_kd", "total")
    losses = torch.stack([torch.stack([m[f"loss/{k}"] for k in names])
                          for m in metrics])
    check(bool(torch.isfinite(losses).all()),
          f"bf16 {name} steps: losses finite; first {names} "
          f"{[round(x, 4) for x in losses[0].tolist()]}, last "
          f"{[round(x, 4) for x in losses[-1].tolist()]}")
    counts = {k: v for k, v in counts.items()
              if k != "conv_module" and (k != "ffn_int8"
                                         or tcfg.encoder.quantization
                                         == "int8")}
    check(all(v > 0 for v in counts.values()),
          f"{name} steps launched every kernel: {counts}")
    if tcfg.encoder.quantization == "int8":
        want = 2 * tcfg.encoder.n_layers * TRAIN_STEPS
        check(counts["ffn_int8"] == want, f"the int8 teacher launched the "
              f"int8 FFN {counts['ffn_int8']} times in {TRAIN_STEPS} steps "
              f"(2 x {tcfg.encoder.n_layers} layers per step: {want})")
    print(f"kd train: {name} ({scfg.compute_dtype}, student 16 x d"
          f"{scfg.encoder.d_model}, teacher 16 x d{tcfg.encoder.d_model}) "
          f"B={BATCH} x {SECONDS} s, {TOKENS} tokens: {timed_summary(ms)}")
    return counts


def with_encoder(cfg, **changes):
    """cfg with its EncoderConfig changed."""
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder,
                                                                **changes))


def refused(fn, label: str) -> None:
    try:
        fn()
        ok = False
    except ValueError:
        ok = True
    check(ok, f"{label} refused on the card")


def int8_decided_rows(x, w, eps: float = 1e-4) -> torch.Tensor:
    """(rows,) bool: rows of x whose every int8 activation of the plain
    chain (the LN output and the SiLU output, in quanta) lies more than
    `eps` from a rounding tie. A sum taken in another order moves them by
    about 1e-5 quanta at most, so on these rows the kernel must take the
    plain version's quantization decisions and give its result."""
    from tpu_asr_torch.ops.cuda_ffn import layer_norm
    from tpu_asr_torch.ops.quant import int8_matmul, quantize_weight
    ln_w, ln_b, w1, b1, _, _ = w

    def quanta(v):
        s = torch.clamp(v.abs().amax(-1, keepdim=True),
                        min=1e-8 * 127.0) * (1.0 / 127.0)
        return v * (1.0 / s), s

    def margin(q):
        return ((q.abs() % 1.0) - 0.5).abs().amin(-1)

    with torch.no_grad():
        v, sx = quanta(layer_norm(x, ln_w, ln_b))
        w1q, s1 = quantize_weight(w1)
        h = (int8_matmul(torch.clamp(torch.round(v), -127, 127), w1q).float()
             * sx * s1[:, 0] + b1.float())
        u, _ = quanta(h * torch.sigmoid(h))
    return (torch.minimum(margin(v), margin(u)) > eps).reshape(-1)


def ffn_int8_compare(x, w, label):
    """fused_ffn_sublayer_int8 against its plain version on x. Rows where a
    quantization decision lies within 1e-4 quanta of a tie may round the
    other way (the LN sums run in another order) and then differ by a few
    quanta's worth; every other row must match to 1e-5 in fp32 and to one
    bf16 ulp in bf16 (the row's scale may move by an fp32 ulp, and the
    output rounds to bf16 after it). Returns the max |error|."""
    from tpu_asr_torch.ops.cuda_ffn import (ffn_sublayer_int8_plain,
                                            fused_ffn_sublayer_int8)
    with torch.no_grad():
        got = fused_ffn_sublayer_int8(x, *w).float()
        want = ffn_sublayer_int8_plain(x, *w).float()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err, ref = diff.max().item(), want.abs().max().item()
    fp32 = x.dtype == torch.float32
    # beyond 1e-5 in fp32, beyond one bf16 ulp (2^-7 of the value) in bf16
    off = diff > (1e-5 if fp32 else 2.0 ** -7 * want.abs() + 1e-6)
    row_off = off.reshape(-1, x.shape[-1]).any(-1)
    decided = int8_decided_rows(x, w)
    rows = row_off.numel()
    flipped = int(row_off.sum())
    bad = int((row_off & decided).sum())
    dts = str(x.dtype)[6:]
    tol = 2e-2 if fp32 else 3e-2 * max(1.0, ref)
    check(bad == 0 and flipped <= 0.01 * rows and err <= tol,
          f"ffn_int8 {dts} {label}: the {int(decided.sum())} of {rows} rows "
          f"whose every quantized value lies > 1e-4 quanta from a tie "
          f"match to {'1e-5' if fp32 else 'one bf16 ulp'} ({bad} do not); "
          f"{flipped} rows differ beyond it (<= 1%: a quantization step "
          f"flipped), {int(off.sum())} of {diff.numel()} elements; max "
          f"|err| {err:.3e} <= {tol:.3g}")
    return err


def conv_compare(x, mask, w, pad, norm, label):
    """fused_conv_module against conv_module_plain; returns the max |error|
    over all frames (masked frames included: no masking after pointwise 2).
    """
    from tpu_asr_torch.ops.cuda_conv import (conv_module_plain,
                                             fused_conv_module)
    with torch.no_grad():
        got = fused_conv_module(x, mask, *w, pad, norm).float()
        want = conv_module_plain(x, mask, *w, pad, norm).float()
    torch.cuda.synchronize()
    err, ref = (got - want).abs().max().item(), want.abs().max().item()
    dts = str(x.dtype)[6:]
    tol = (1e-4 if x.dtype == torch.float32 else 3e-2) * max(1.0, ref)
    check(err <= tol and got.shape == x.shape,
          f"conv_module {dts} {norm} pad {pad} {label}: max |err| "
          f"{err:.3e} <= {tol:.3g} ({'1e-4' if dts == 'float32' else '3e-2'}"
          f" x max(1, |ref|max {ref:.3e}))")
    return err


def eval_kernel_phase(cfg):
    """The int8 FFN and the conv module against their plain versions at the
    int8 teacher's serving shape. Returns {name: row} in bf16 (the main
    path's dtype)."""
    import torch.nn.functional as F

    from tpu_asr_torch.ops.cuda_conv import (conv_module_plain,
                                             fused_conv_module)
    from tpu_asr_torch.ops.cuda_ffn import (ffn_sublayer_int8_plain,
                                            fused_ffn_sublayer_int8,
                                            layer_norm)
    from tpu_asr_torch.ops.cuda_subsampling import out_len

    gen = torch.Generator(device="cuda").manual_seed(30)
    enc = cfg.encoder
    d, f, k = enc.d_model, enc.d_ff, enc.conv_kernel_size
    n_frames = SECONDS * SR // cfg.preprocessor.hop_length + 1
    t = out_len(out_len(n_frames))
    m = BATCH * t
    lengths = torch.randint(t // 4, t + 1, (BATCH,), generator=gen,
                            device="cuda")
    lengths[0] = t
    mask = torch.arange(t, device="cuda")[None, :] < lengths[:, None]

    def ffn_weights(d_, f_):
        return (1.0 + normal(gen, d_, scale=0.1), normal(gen, d_, scale=0.1),
                normal(gen, f_, d_, scale=d_ ** -0.5),
                normal(gen, f_, scale=0.1),
                normal(gen, d_, f_, scale=f_ ** -0.5),
                normal(gen, d_, scale=0.1))

    def conv_weights(d_, k_):
        return (normal(gen, 2 * d_, d_, scale=d_ ** -0.5),
                normal(gen, 2 * d_, scale=0.1),
                normal(gen, d_, k_, scale=k_ ** -0.5),
                normal(gen, d_, scale=0.1), 1.0 + normal(gen, d_, scale=0.1),
                normal(gen, d_, scale=0.1), normal(gen, d_, d_,
                                                   scale=d_ ** -0.5),
                normal(gen, d_, scale=0.1))

    # int8 FFN at D=176, d_ff 704
    fw = ffn_weights(d, f)
    xf = normal(gen, BATCH, t, d)
    per_dt = {}
    for dt in (torch.float32, torch.bfloat16):
        x = xf.to(dt)
        err = ffn_int8_compare(x, fw, f"(B={BATCH}, T={t}, D={d}, d_ff={f})")
        with torch.no_grad():
            per_dt[dt] = (
                err, median_ms(lambda: fused_ffn_sublayer_int8(x, *fw)),
                median_ms(lambda: ffn_sublayer_int8_plain(x, *fw), iters=5),
                bound(4 * m * d * f, nbytes(x, *fw) + nbytes(x), "int8"),
                None)
    ffn_int8_compare(normal(gen, 3, 37, d), fw, "odd T (3 x 37 rows)")
    sw = ffn_weights(88, 352)
    xs = normal(gen, BATCH, t, 88)
    for dt in (torch.float32, torch.bfloat16):
        ffn_int8_compare(xs.to(dt), sw, f"student D=88, d_ff=352 "
                         f"(B={BATCH}, T={t})")
    big = ffn_weights(520, 2048)
    refused(lambda: fused_ffn_sublayer_int8(normal(gen, 1, 4, 520), *big),
            "fused_ffn_sublayer_int8 at D=520")

    # the bf16 eval FFN sublayer int8 replaces: LN + two cuBLAS products
    ln_w, ln_b, w1, b1, w2, b2 = fw
    x16 = xf.to(torch.bfloat16)

    def bf16_ffn():
        y = layer_norm(x16, ln_w, ln_b).to(torch.bfloat16)
        h = F.silu(F.linear(y, w1.to(torch.bfloat16), b1.to(torch.bfloat16)))
        return x16 + 0.5 * F.linear(h, w2.to(torch.bfloat16),
                                    b2.to(torch.bfloat16))

    with torch.no_grad():
        bf16_ms = median_ms(bf16_ffn)

    # conv module at D=176, k=31, ragged mask
    cw = conv_weights(d, k)
    xc = normal(gen, BATCH, t, d)
    pad = enc.conv_context
    conv_dt = {}
    for dt in (torch.float32, torch.bfloat16):
        x = xc.to(dt)
        shape = f"(B={BATCH}, T={t}, D={d}, k={k})"
        for norm, pad_ in (("affine", pad), ("layer_norm", pad),
                           ("layer_norm", (k - 1, 0))):
            err = conv_compare(x, mask, cw, pad_, norm, shape)
            if norm == "affine":
                main_err = err
        flops = 2 * m * (3 * d * d + k * d)
        with torch.no_grad():
            conv_dt[dt] = (
                main_err,
                median_ms(lambda: fused_conv_module(x, mask, *cw, pad)),
                median_ms(lambda: conv_module_plain(x, mask, *cw, pad),
                          iters=5),
                bound(flops, nbytes(x, mask, *cw) + nbytes(x), str(dt)[6:]),
                None)
    odd = torch.arange(37, device="cuda")[None, :] < torch.tensor(
        [37, 20, 3], device="cuda")[:, None]
    conv_compare(normal(gen, 3, 37, d), odd, cw, pad, "affine",
                 "odd T (3 x 37)")
    sw = conv_weights(88, k)
    for dt in (torch.float32, torch.bfloat16):
        conv_compare(normal(gen, BATCH, t, 88).to(dt), mask, sw, pad,
                     "layer_norm", f"student D=88 (B={BATCH}, T={t})")
    refused(lambda: fused_conv_module(
        normal(gen, 1, 8, d), mask[:1, :8], *conv_weights(d, 35), (17, 17)),
        "fused_conv_module at k=35")
    for name, rows in (("ffn_int8", per_dt), ("conv_module", conv_dt)):
        for dt, (err, ms, plain_ms, (b_ms, by), _) in rows.items():
            print(f"time {name} {str(dt)[6:]}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) (median of "
                  f"20, plain of 5, CUDA events)")
    print(f"time bf16 eval FFN sublayer (LN + two cuBLAS products, the "
          f"plain eval path int8 replaces): {bf16_ms:.4f} ms (median of 20)")
    return {"ffn_int8": per_dt[torch.bfloat16],
            "conv_module": conv_dt[torch.bfloat16]}


def int8_model_phase(cfg):
    """The int8 serving model in fp32 on kernels against plain, end to end
    and layer by layer on the plain model's layer inputs, beside the
    int8-vs-fp drift of the same weights."""
    from tpu_asr_torch.profile_forward import seeded_model, set_backend
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = seeded_model(cfg32, seed=16)
    fp_model = seeded_model(with_encoder(cfg32, quantization="none",
                                         conv_backend="auto"), seed=16)
    set_backend(fp_model, "xla")
    sig_t, len_t = model_clips(17)
    fns = reset_counters()
    inputs = []
    with torch.inference_mode():
        got = model(sig_t, len_t)
        counts = {k: fns[k].launches for k in INT8_SERVING}
        set_backend(model, "xla")
        hooks = [layer.register_forward_pre_hook(
            lambda mod, args: inputs.append(args))
            for layer in model.encoder.layers]
        want = model(sig_t, len_t)
        for h in hooks:
            h.remove()
        fp = fp_model(sig_t, len_t)
    torch.cuda.synchronize()
    check(all(v > 0 for v in counts.values()),
          f"int8 model on kernels launched every eval kernel: {counts}")
    check(torch.equal(got.encoded_len, want.encoded_len)
          and bool(torch.isfinite(got.log_probs).all()),
          "int8 model: encoded_len equal, log-probs finite")
    # a quantization decision within rounding of a tie may go the other way
    # when sums run in another order; layer by layer on the same input that
    # moves a few rows by a fraction of the int8-vs-fp drift (attention and
    # conv kernels sum in another order too, so every row's FFN input moves
    # by fp32 rounding: 0.05-3.9% of the rows flipped per layer, at most
    # 0.38 of the drift, NVIDIA H100 80GB HBM3)
    worst = 0.0
    for i, (layer, fp_layer) in enumerate(zip(model.encoder.layers,
                                              fp_model.encoder.layers)):
        args = inputs[i]
        with torch.inference_mode():
            set_backend(layer, "auto")
            out_k = layer(*args)
            set_backend(layer, "xla")
            out_p = layer(*args)
            out_fp = fp_layer(*args)
        valid = args[2]
        row_err = (out_k - out_p).abs().amax(-1)[valid]
        drift = (out_p - out_fp).abs().amax(-1)[valid].max().item()
        flipped = int((row_err > 1e-4).sum())
        worst = max(worst, row_err.max().item() / drift)
        check(flipped <= 0.1 * row_err.numel()
              and row_err.max().item() <= 0.5 * drift,
              f"  int8 layer {i} on the plain layer input: {flipped} of "
              f"{row_err.numel()} rows beyond 1e-4 (<= 10%), max |err| "
              f"{row_err.max().item():.3e} <= half the int8-vs-fp drift "
              f"{drift:.3e}", )
    set_backend(model, "auto")
    valid = (torch.arange(got.log_probs.shape[1], device="cuda")[None, :]
             < want.encoded_len[:, None])
    d = (got.log_probs - want.log_probs).abs()[valid]
    drift = (want.log_probs - fp.log_probs).abs()[valid]
    print(f"int8 model ModelConfig() int8 + conv kernel fp32, {len(sig_t)} "
          f"clips of 5-{SECONDS} s, kernels vs plain: max |delta log-prob| "
          f"{d.max().item():.3e}, mean {d.mean().item():.3e}; int8-vs-fp "
          f"drift max {drift.max().item():.3e}, mean "
          f"{drift.mean().item():.3e}; largest layer error {worst:.3f} of "
          f"its drift")
    top2 = want.log_probs.topk(2, dim=-1).values
    decided = valid & ((top2[..., 0] - top2[..., 1]) > 1e-2)
    same = int(((got.greedy == want.greedy) & decided).sum())
    n = int(decided.sum())
    check(same >= 0.99 * n, f"int8 model: greedy ids equal on {same} of "
          f"{n} frames with plain top-2 margin > 1e-2 (>= 99%; of "
          f"{int(valid.sum())} valid)")


SERVING = ("logmel", "subsampling", "attention")
# row: (source, TPU kernel it replaces, dtype of the main path)
KERNELS = {
    "logmel": ("tpu_asr_torch/csrc/logmel.cu",
               "tpu_asr/ops/pallas_features.py:109", "float32"),
    "subsampling": ("tpu_asr_torch/csrc/subsampling.cu",
                    "tpu_asr/ops/pallas_subsampling.py:96", "bfloat16"),
    "attention": ("tpu_asr_torch/csrc/attention.cu",
                  "tpu_asr/ops/pallas_attention.py:669", "bfloat16"),
    "attention_bwd": ("tpu_asr_torch/csrc/attention.cu",
                      "tpu_asr/ops/pallas_attention.py:717", "bfloat16"),
    "ffn": ("tpu_asr_torch/csrc/ffn.cu", "tpu_asr/ops/pallas_ffn.py:73",
            "bfloat16"),
    "ffn_bwd": ("tpu_asr_torch/csrc/ffn.cu", "tpu_asr/ops/pallas_ffn.py:97",
                "bfloat16"),
    "ctc": ("tpu_asr_torch/csrc/ctc.cu", "tpu_asr/ops/pallas_ctc.py:67",
            "float32"),
    "ctc_bwd": ("tpu_asr_torch/csrc/ctc.cu", "tpu_asr/ops/pallas_ctc.py:107",
                "float32"),
    "fm": ("tpu_asr_torch/csrc/fm.cu", "tpu_asr/ops/pallas_fm.py:85",
           "bfloat16"),
    "fm_bwd": ("tpu_asr_torch/csrc/fm.cu", "tpu_asr/ops/pallas_fm.py:109",
               "bfloat16"),
    "ffn_int8": ("tpu_asr_torch/csrc/ffn_int8.cu",
                 "tpu_asr/ops/pallas_ffn.py:154", "bfloat16"),
    "conv_module": ("tpu_asr_torch/csrc/conv.cu",
                    "tpu_asr/ops/pallas_conv.py:57", "bfloat16"),
}
STUDENT = ("logmel", "subsampling", "attention", "attention_bwd", "ffn",
           "ffn_bwd", "ctc", "ctc_bwd")
INT8_SERVING = SERVING + ("ffn_int8", "conv_module")


def main() -> int:
    card()
    from tpu_asr_torch.config import ModelConfig
    from tpu_asr_torch.ops import _kernels
    from tpu_asr_torch.profile_train import teacher_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()
    lib = _kernels.build()
    _kernels.library()
    print(f"build: {time.perf_counter() - start:.1f} s -> {lib}")

    cfg = ModelConfig()
    measured = {k: v[KERNELS[k][2]] for k, v in kernel_phase(cfg).items()}
    model_phase(cfg)
    counts, rtfx = serve_phase(cfg)
    measured.update(train_kernel_phase(cfg))
    counts.update({k: v for k, v in train_phase(cfg).items()
                   if k not in SERVING})
    measured.update(fm_kernel_phase())
    kd_counts = kd_train_phase(cfg)
    counts.update({k: kd_counts[k] for k in ("fm", "fm_bwd")})
    int8_cfg = with_encoder(cfg, quantization="int8", conv_backend="pallas")
    measured.update(eval_kernel_phase(cfg))
    int8_model_phase(int8_cfg)
    int8_counts, int8_rtfx = serve_phase(int8_cfg, INT8_SERVING)
    print(f"serve RTFx: int8 + conv kernel {int8_rtfx:.1f}, fp (phase 5) "
          f"{rtfx:.1f}, same run")
    counts.update({k: int8_counts[k] for k in ("ffn_int8", "conv_module")})
    kd_train_phase(teacher_config("flowkd_mlp8_int8_teacher"),
                   "flowkd_mlp8_int8_teacher")
    rows = []
    for name, (source, replaces, dt) in KERNELS.items():
        err, ms, plain_ms, (bound_ms, bound_by), library_ms = measured[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
