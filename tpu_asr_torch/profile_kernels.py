"""Per-launch device times of single kernel wrappers on one CUDA card.

    python3 tpu_asr_torch/profile_kernels.py [--root TREE] [--kernels ...]
        [--label NAME] [--out FILE]

For each kernel wrapper named in --kernels, at the shape the main path
gives it: the median of 20 wrapper calls (CUDA events around each call),
the device time per call (the union of the card's busy spans in
torch.profiler, so host work between launches does not count, over the
calls whose marker the profiler kept: profile_forward.mark_call), and the
device time of each kernel a launch (its recorded time over its recorded
launches) with its launches per call.

  logmel               fused_logmel, fp32, B=32 x 15 s of audio
  attention            fused_relpos_attention_block, bf16, the serve
                       model's sublayer (D=176, 4 heads) at the bucketed
                       serve shape (B=32 x 16 s: T=401), ragged lengths
  attention_seg        the same wrapper's segment mode at the packed serve
                       shape (16 rows x 512, profile_forward.packed_seg_map)
  attention_bwd        fused_relpos_attention_block_bwd, bf16, the student's
                       sublayer (B=32, T=376, D=88, 2 heads, dropout 0.1)
  attention_seg_bwd    the same wrapper's segment mode on the plan of
                       chip_smoke.py's phase 17a (a 56-utterance batch of
                       bench_train.py's packed_train in 20 rows x 512, an
                       all-guard row among them; profile_train's
                       packed_batches), the student's sublayer
  attention_heads_bwd  fused_relpos_attention_bwd, bf16, the same shape
  attention_dk128      fused_relpos_attention_block, bf16, conformer-XLarge's
                       sublayer (B=32, T=376, D=1024, 8 heads: dk 128, the
                       DKP-128 kernels core_mma_kernel<128, ...>), ragged
  attention_dk128_bwd  fused_relpos_attention_block_bwd at that shape,
                       dropout 0.1 (dq_mma_kernel<128, ...>,
                       dkv_mma_kernel<128, ...>)
  attention_heads_dk128, attention_heads_dk128_bwd
                       fused_relpos_attention and its backward, bf16, at
                       B=32, 8 heads, T=376, dk 128, dropout 0.1
  ffn                  fused_ffn_sublayer, bf16, the student's sublayer
                       (B=32, T=376, D=88, d_ff 352, dropout 0.1), fp32
                       weights as the model holds them
  ffn_bwd              fused_ffn_sublayer_bwd, bf16, the same shape
  fm                   fused_fm_euler, bf16, the flowkd_mlp8 KD step's call
                       (rows = 32 x 16 layers, T=376, C=88, H=128, 8
                       steps), fp32 weights as the model holds them
  fm_bwd               fused_fm_euler_bwd, bf16, the same shape, both output
                       cotangents nonzero
  ffn_int8             fused_ffn_sublayer_int8, bf16, the int8 serve shape
                       (ModelConfig(): B=32, T=376, D=176, d_ff 704), fp32
                       weights as the model holds them
  conv_module          fused_conv_module, bf16, the same shape (k=31, the
                       folded BatchNorm's affine, symmetric padding), a
                       ragged mask, fp32 weights
  ctc                  ctc_nll, fp32, the student's CTC (B=32, T'=376,
                       V=129, S=48, full lengths, int64 targets)
  ctc_bwd              torch.autograd.grad of the same NLLs' sum with
                       respect to the log-probs (the backward kernel, with
                       whatever the wrapper launches around it)
  conformer_layer      fused_conformer_layer, bf16, chip_smoke.py phase
                       14's shape (ModelConfig(): B=32, T'=376, D=176, 4
                       heads, d_ff 704, k=31, folded batch norm), ragged
                       lengths, a seeded layer's fp32 parameters
  conformer_layer_module  the same layer's eval forward (ConformerLayer:
                       the attention kernel, plain FFN, conv and LNs) on
                       the same input, bf16: the yardstick

--root TREE imports tpu_asr_torch from another checkout (a `git archive`
of an earlier commit), so that two versions can be timed in turns within
one run on one card: it needs only the wrappers' public signatures (a tree
from before the attention kernels took dk 128 refuses the four dk-128 rows:
name the others in --kernels). Output
lines start with the label (default: the tree's directory name).
"""

from __future__ import annotations

import argparse
import os
import sys

KERNELS = ("logmel", "attention", "attention_seg", "attention_bwd",
           "attention_seg_bwd", "attention_heads_bwd", "ffn", "ffn_bwd", "fm", "fm_bwd",
           "ffn_int8", "conv_module", "ctc", "ctc_bwd", "conformer_layer",
           "conformer_layer_module", "attention_dk128", "attention_dk128_bwd",
           "attention_heads_dk128", "attention_heads_dk128_bwd")
XL_D, XL_HEADS = 1024, 8           # conformer-XLarge's attention: dk 128
BATCH, SECONDS, SR = 32, 15, 16000
PACK_ROWS, T_PACK = 16, 512      # the packed serve shape (PackedTranscriber)


def median_ms(torch, fn, iters: int = 20) -> float:
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
    times.sort()
    return times[len(times) // 2]


def own_profile_forward():
    """This script's own profile_forward.py (`device_activity`,
    `mark_call`, `packed_seg_map`), loaded by path: with --root,
    `tpu_asr_torch` is the other checkout's, whose profile_forward may
    predate them."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "profile_kernels_profile_forward",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "profile_forward.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_split(torch, fn, iters: int = 5):
    """(device ms per call, [(kernel, ms a launch, launches per call)])."""
    from torch.profiler import ProfilerActivity, profile

    pf = own_profile_forward()
    device_activity, mark_call = pf.device_activity, pf.mark_call
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            mark_call()
            fn()
        torch.cuda.synchronize()
    busy, _, names = device_activity(prof, iters)
    rows = sorted(((k, ms / n, n) for k, (ms, n) in names.items()),
                  key=lambda r: -r[1] * r[2])
    return busy, rows


def short(name: str) -> str:
    return (name.replace("(anonymous namespace)::", "")
            .removeprefix("void ").split("(")[0])


def logmel_call(torch):
    from tpu_asr_torch.config import PreprocessorConfig
    from tpu_asr_torch.ops.cuda_features import fused_logmel
    from tpu_asr_torch.ops.features import FilterbankFeatures

    pre = PreprocessorConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    feat = FilterbankFeatures(pre).cuda()
    audio = torch.randn(BATCH, SECONDS * SR, generator=gen,
                        device="cuda") * 0.1
    pad = pre.n_fft // 2
    xp = torch.nn.functional.pad(audio[:, None], (pad, pad),
                                 mode="reflect")[:, 0].contiguous()
    n_frames = (xp.shape[1] - pre.n_fft) // pre.hop_length + 1
    args = (xp, n_frames, feat.basis, feat.fb_t, pre.hop_length,
            pre.log_zero_guard_value)
    return lambda: fused_logmel(*args)


def student_shape(torch, gen, teacher=False):
    """(encoder config, T', ragged mask (B, T')) of the student, or of
    ModelConfig() (the int8 serving model) with `teacher`."""
    from tpu_asr_torch.config import ModelConfig, make_student_config

    enc = (ModelConfig() if teacher
           else make_student_config(ModelConfig())).encoder
    t = SECONDS * SR // 160 + 1
    for _ in range(2):                  # two stride-2 convolutions: 376
        t = (t - 1) // 2 + 1
    lengths = torch.randint(t // 4, t + 1, (BATCH,), generator=gen,
                            device="cuda")
    lengths[0] = t
    mask = torch.arange(t, device="cuda")[None, :] < lengths[:, None]
    return enc, t, mask


def serve_attention_args(torch, gen, t):
    """The serve model's attention weights (D=176, 4 heads) and x (B, t, D)
    bf16 with B = 32 or, at t = T_PACK, PACK_ROWS packed rows."""
    from tpu_asr_torch.config import ModelConfig
    from tpu_asr_torch.models.conformer import rel_positional_encoding

    enc = ModelConfig().encoder
    d, h = enc.d_model, enc.n_heads
    dk = d // h
    n = lambda *s, sc=1.0: torch.randn(*s, generator=gen, device="cuda") * sc
    pw = (n(d, d, sc=d ** -0.5), n(d, sc=0.1), n(d, d, sc=d ** -0.5),
          n(d, sc=0.1), n(d, d, sc=d ** -0.5), n(d, sc=0.1),
          n(h, dk, sc=0.1), n(h, dk, sc=0.1), n(d, d, sc=d ** -0.5),
          n(d, d, sc=d ** -0.5))
    b = PACK_ROWS if t == T_PACK else BATCH
    x = n(b, t, d, sc=0.5).to(torch.bfloat16)
    return x, pw, rel_positional_encoding(t, d, "cuda"), h


def attention_call(torch):
    from tpu_asr_torch.ops.cuda_attention import fused_relpos_attention_block

    gen = torch.Generator(device="cuda").manual_seed(4)
    t = 401
    x, pw, pe, h = serve_attention_args(torch, gen, t)
    lengths = torch.randint(t // 4, t + 1, (BATCH,), generator=gen,
                            device="cuda")
    lengths[0] = t
    mask = torch.arange(t, device="cuda")[None, :] < lengths[:, None]
    return lambda: fused_relpos_attention_block(x, *pw, pe, mask, h)


def attention_seg_call(torch):
    from tpu_asr_torch.ops.cuda_attention import fused_relpos_attention_block

    gen = torch.Generator(device="cuda").manual_seed(5)
    x, pw, pe, h = serve_attention_args(torch, gen, T_PACK)
    seg = torch.from_numpy(own_profile_forward().packed_seg_map()).cuda()
    return lambda: fused_relpos_attention_block(x, *pw, pe, seg > 0, h,
                                                seg_id=seg)


def packed_train_seg():
    """(R, 512) int32 segment map of chip_smoke.py's phase 17a: the first
    packed_train batch whose plan holds an all-guard row."""
    from tpu_asr_torch.config import ModelConfig, make_student_config
    from tpu_asr_torch.profile_train import packed_batches

    plans = [p for *_, p in packed_batches(
        make_student_config(ModelConfig()), "cpu")]
    return next(p.seg_id for p in plans if (p.seg_id == 0).all(1).any())


def xlarge_attention(torch, gen):
    """conformer-XLarge's attention weights (fp32), x (B, 376, 1024) bf16 and
    a ragged mask."""
    from tpu_asr_torch.models.conformer import rel_positional_encoding

    d, h = XL_D, XL_HEADS
    _, t, mask = student_shape(torch, gen)
    n = lambda *s, sc=1.0: torch.randn(*s, generator=gen, device="cuda") * sc
    pw = (n(d, d, sc=d ** -0.5), n(d, sc=0.1), n(d, d, sc=d ** -0.5),
          n(d, sc=0.1), n(d, d, sc=d ** -0.5), n(d, sc=0.1),
          n(h, d // h, sc=0.1), n(h, d // h, sc=0.1), n(d, d, sc=d ** -0.5),
          n(d, d, sc=d ** -0.5))
    x = n(BATCH, t, d, sc=0.5).to(torch.bfloat16)
    return x, pw, rel_positional_encoding(t, d, "cuda"), mask


def attention_dk128_call(torch):
    from tpu_asr_torch.ops.cuda_attention import fused_relpos_attention_block

    x, pw, pe, mask = xlarge_attention(torch, torch.Generator(
        device="cuda").manual_seed(60))
    return lambda: fused_relpos_attention_block(x, *pw, pe, mask, XL_HEADS)


def attention_dk128_bwd_call(torch):
    from tpu_asr_torch.ops.cuda_attention import (
        fused_relpos_attention_block, fused_relpos_attention_block_bwd)

    gen = torch.Generator(device="cuda").manual_seed(61)
    x, pw, pe, mask = xlarge_attention(torch, gen)
    leaves = [z.detach().requires_grad_() for z in (x, *pw)]
    rate, seed = 0.1, 2 ** 31 - 9
    out = fused_relpos_attention_block(*leaves, pe, mask, XL_HEADS,
                                       dropout_rate=rate, dropout_seed=seed)
    g = (torch.randn(out.shape, generator=gen, device="cuda")
         * mask[..., None]).to(torch.bfloat16)
    saved = out.grad_fn.saved_tensors
    return lambda: fused_relpos_attention_block_bwd(g, *saved, XL_HEADS,
                                                    rate, seed)


def attention_heads_dk128_args(torch, gen):
    """q_u, q_v, k, v (32, 8, 376, 128) and w_pos bf16 requiring grad, the
    mask."""
    _, t, mask = student_shape(torch, gen)
    leaves = [(torch.randn(BATCH, XL_HEADS, t, XL_D // XL_HEADS,
                           generator=gen, device="cuda") * 0.5).to(
        torch.bfloat16).requires_grad_() for _ in range(4)]
    w_pos = (torch.randn(XL_D, XL_D, generator=gen, device="cuda")
             * XL_D ** -0.5).to(torch.bfloat16).requires_grad_()
    return leaves + [w_pos], mask


def attention_heads_dk128_call(torch):
    from tpu_asr_torch.ops.cuda_attention import fused_relpos_attention

    args, mask = attention_heads_dk128_args(torch, torch.Generator(
        device="cuda").manual_seed(62))
    args = [z.detach() for z in args]
    return lambda: fused_relpos_attention(*args, mask, (-1, -1), 0.1, 7)


def attention_heads_dk128_bwd_call(torch):
    from tpu_asr_torch.ops.cuda_attention import (fused_relpos_attention,
                                                  fused_relpos_attention_bwd)

    gen = torch.Generator(device="cuda").manual_seed(63)
    args, mask = attention_heads_dk128_args(torch, gen)
    out = fused_relpos_attention(*args, mask, (-1, -1), 0.1, 7)
    g = (torch.randn(out.shape, generator=gen, device="cuda")
         * mask[:, None, :, None]).to(torch.bfloat16)
    saved = out.grad_fn.saved_tensors
    return lambda: fused_relpos_attention_bwd(g, *saved, (-1, -1), 0.1, 7)


def attention_bwd_call(torch, seg=None):
    from tpu_asr_torch.models.conformer import rel_positional_encoding
    from tpu_asr_torch.ops.cuda_attention import (
        fused_relpos_attention_block, fused_relpos_attention_block_bwd)

    gen = torch.Generator(device="cuda").manual_seed(3)
    enc, t, mask = student_shape(torch, gen)
    if seg is not None:
        seg = torch.from_numpy(seg).cuda()
        t, mask = seg.shape[1], seg > 0
    d, h = enc.d_model, enc.n_heads
    dk = d // h
    n = lambda *s, sc=1.0: torch.randn(*s, generator=gen, device="cuda") * sc
    pw = (n(d, d, sc=d ** -0.5), n(d, sc=0.1), n(d, d, sc=d ** -0.5),
          n(d, sc=0.1), n(d, d, sc=d ** -0.5), n(d, sc=0.1),
          n(h, dk, sc=0.1), n(h, dk, sc=0.1), n(d, d, sc=d ** -0.5),
          n(d, d, sc=d ** -0.5))
    x = n(mask.shape[0], t, d, sc=0.5).to(torch.bfloat16)
    leaves = [z.detach().requires_grad_() for z in (x, *pw)]
    rate, seed = enc.dropout, 2 ** 31 - 5
    out = fused_relpos_attention_block(
        *leaves, rel_positional_encoding(t, d, "cuda"), mask, h,
        dropout_rate=rate, dropout_seed=seed,
        **({} if seg is None else {"seg_id": seg}))
    g = (n(mask.shape[0], t, d) * mask[..., None]).to(torch.bfloat16)
    saved = out.grad_fn.saved_tensors
    more = () if seg is None else (out.grad_fn.seg,)
    return lambda: fused_relpos_attention_block_bwd(g, *saved, h, rate, seed,
                                                    *more)


def attention_seg_bwd_call(torch):
    return attention_bwd_call(torch, packed_train_seg())


def attention_heads_bwd_call(torch):
    from tpu_asr_torch.ops.cuda_attention import (fused_relpos_attention,
                                                  fused_relpos_attention_bwd)

    gen = torch.Generator(device="cuda").manual_seed(50)
    enc, t, mask = student_shape(torch, gen)
    h = enc.n_heads
    dk = enc.d_model // h
    leaves = [(torch.randn(BATCH, h, t, dk, generator=gen, device="cuda")
               * 0.5).to(torch.bfloat16).requires_grad_() for _ in range(4)]
    w_pos = (torch.randn(h * dk, h * dk, generator=gen, device="cuda")
             * (h * dk) ** -0.5).to(torch.bfloat16).requires_grad_()
    rate, seed = enc.dropout_att, 2 ** 31 - 7
    out = fused_relpos_attention(*leaves, w_pos, mask, (-1, -1), rate, seed)
    g = (torch.randn(out.shape, generator=gen, device="cuda")
         * mask[:, None, :, None]).to(torch.bfloat16)
    saved = out.grad_fn.saved_tensors
    return lambda: fused_relpos_attention_bwd(g, *saved, (-1, -1), rate,
                                              seed)


def ffn_args(torch):
    """(x, LN scale, LN bias, w1, b1, w2, b2, rate, seed) at the student's
    sublayer: x bf16, the parameters fp32."""
    gen = torch.Generator(device="cuda").manual_seed(60)
    enc, t, _ = student_shape(torch, gen)
    d, f = enc.d_model, enc.d_ff
    n = lambda *s, sc=1.0: torch.randn(*s, generator=gen, device="cuda") * sc
    fw = (1.0 + n(d, sc=0.1), n(d, sc=0.1), n(f, d, sc=d ** -0.5),
          n(f, sc=0.1), n(d, f, sc=f ** -0.5), n(d, sc=0.1))
    x = n(BATCH, t, d).to(torch.bfloat16)
    return (x, *fw, enc.dropout, 2 ** 31 - 5)


def ffn_call(torch):
    from tpu_asr_torch.ops.cuda_ffn import fused_ffn_sublayer

    args = ffn_args(torch)
    return lambda: fused_ffn_sublayer(*args)


def ffn_bwd_call(torch):
    from tpu_asr_torch.ops.cuda_ffn import (fused_ffn_sublayer,
                                            fused_ffn_sublayer_bwd)

    x, *fw, rate, seed = ffn_args(torch)
    leaves = [z.detach().requires_grad_() for z in (x, *fw)]
    out = fused_ffn_sublayer(*leaves, rate, seed)
    g = torch.randn(out.shape, generator=torch.Generator(
        device="cuda").manual_seed(61), device="cuda").to(torch.bfloat16)
    saved = out.grad_fn.saved_tensors
    return lambda: fused_ffn_sublayer_bwd(*saved, g, rate, seed)


def fm_args(torch):
    """(x0, steps, w1x, a, c, w2, b2) of the KD step's Euler loop: x0 bf16,
    the weights fp32."""
    gen = torch.Generator(device="cuda").manual_seed(70)
    rows, t, c, h = BATCH * 16, 376, 88, 128
    n = lambda *s, sc=1.0: torch.randn(*s, generator=gen, device="cuda") * sc
    steps = torch.full((rows,), 8, dtype=torch.int32, device="cuda")
    return (n(rows, t, c).to(torch.bfloat16), steps, n(c, h, sc=c ** -0.5),
            n(h, sc=0.3), n(h, sc=0.1), n(h, c, sc=h ** -0.5), n(c, sc=0.1))


def fm_call(torch):
    from tpu_asr_torch.ops.cuda_fm import fused_fm_euler

    args = fm_args(torch)
    return lambda: fused_fm_euler(*args, max_steps=8,
                                  compute_dtype=torch.bfloat16)


def fm_bwd_call(torch):
    from tpu_asr_torch.ops.cuda_fm import fused_fm_euler, fused_fm_euler_bwd

    x0, steps, *w = fm_args(torch)
    leaves = [z.detach().requires_grad_() for z in (x0, *w)]
    xo, _ = fused_fm_euler(leaves[0], steps, *leaves[1:], max_steps=8,
                           compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(71)
    gx, gv = (torch.randn(xo.shape, generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    saved = xo.grad_fn.saved_tensors
    return lambda: fused_fm_euler_bwd(*saved, gx, gv, 8)


def ffn_int8_call(torch):
    from tpu_asr_torch.ops.cuda_ffn import fused_ffn_sublayer_int8

    gen = torch.Generator(device="cuda").manual_seed(80)
    enc, t, _ = student_shape(torch, gen, teacher=True)
    d, f = enc.d_model, enc.d_ff
    n = lambda *s, sc=1.0: torch.randn(*s, generator=gen, device="cuda") * sc
    fw = (1.0 + n(d, sc=0.1), n(d, sc=0.1), n(f, d, sc=d ** -0.5),
          n(f, sc=0.1), n(d, f, sc=f ** -0.5), n(d, sc=0.1))
    x = n(BATCH, t, d).to(torch.bfloat16)
    return lambda: fused_ffn_sublayer_int8(x, *fw)


def conv_module_call(torch):
    from tpu_asr_torch.ops.cuda_conv import fused_conv_module

    gen = torch.Generator(device="cuda").manual_seed(81)
    enc, t, mask = student_shape(torch, gen, teacher=True)
    d, k = enc.d_model, enc.conv_kernel_size
    n = lambda *s, sc=1.0: torch.randn(*s, generator=gen, device="cuda") * sc
    cw = (n(2 * d, d, sc=d ** -0.5), n(2 * d, sc=0.1), n(d, k, sc=k ** -0.5),
          n(d, sc=0.1), 1.0 + n(d, sc=0.1), n(d, sc=0.1),
          n(d, d, sc=d ** -0.5), n(d, sc=0.1))
    x = n(BATCH, t, d).to(torch.bfloat16)
    return lambda: fused_conv_module(x, mask, *cw, enc.conv_context)


def ctc_args(torch):
    """(log-probs, targets, input lengths, target lengths) of the
    student's CTC: fp32 (B=32, T'=376, V=129), 48 tokens, int64."""
    gen = torch.Generator(device="cuda").manual_seed(90)
    t, v, s = 376, 129, 48
    lp = torch.log_softmax(torch.randn(BATCH, t, v, generator=gen,
                                       device="cuda") * 2.0, dim=-1)
    tg = torch.randint(0, v - 1, (BATCH, s), generator=gen, device="cuda")
    return (lp, tg, torch.full((BATCH,), t, device="cuda"),
            torch.full((BATCH,), s, device="cuda"))


def ctc_call(torch):
    from tpu_asr_torch.ops.cuda_ctc import ctc_nll

    args = ctc_args(torch)
    return lambda: ctc_nll(*args)


def ctc_bwd_call(torch):
    from tpu_asr_torch.ops.cuda_ctc import ctc_nll

    lp, *rest = ctc_args(torch)
    leaf = lp.detach().requires_grad_()
    with torch.enable_grad():
        loss = ctc_nll(leaf, *rest).sum()
    return lambda: torch.autograd.grad(loss, leaf, retain_graph=True)


def conformer_layer_args(torch):
    """(layer, x, mask, pos_emb, fused_conformer_layer's arguments) of
    chip_smoke.py's phase 14 shape in bf16."""
    from tpu_asr_torch.config import ModelConfig
    from tpu_asr_torch.models.conformer import (ConformerLayer,
                                                rel_positional_encoding)
    from tpu_asr_torch.ops.cuda_layer import layer_params

    gen = torch.Generator(device="cuda").manual_seed(82)
    enc, t, mask = student_shape(torch, gen, teacher=True)
    layer = own_profile_forward().seed_weights(ConformerLayer(enc), 83)
    layer = layer.cuda().eval()
    x = (torch.randn(BATCH, t, enc.d_model, generator=gen, device="cuda")
         * mask[..., None]).to(torch.bfloat16)
    args = (x, mask, layer_params(layer), enc.n_heads, enc.conv_kernel_size,
            enc.conv_context[0], "affine")
    return layer, x, mask, rel_positional_encoding(t, enc.d_model,
                                                   "cuda"), args


def conformer_layer_call(torch):
    from tpu_asr_torch.ops.cuda_layer import fused_conformer_layer

    *_, args = conformer_layer_args(torch)
    return lambda: fused_conformer_layer(*args)


def conformer_layer_module_call(torch):
    layer, x, mask, pos_emb, _ = conformer_layer_args(torch)
    return lambda: layer(x, pos_emb, mask)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose tpu_asr_torch is timed")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or
                           os.path.join(os.path.dirname(__file__), ".."))
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p) != here]
    import torch

    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device", file=sys.stderr)
        return 2
    label = args.label or os.path.basename(root.rstrip("/"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import tpu_asr_torch
    where = os.path.dirname(tpu_asr_torch.__file__)
    print(f"{label}: tpu_asr_torch from {where}, "
          f"{torch.cuda.get_device_name(0)}")
    makers = {"logmel": logmel_call, "attention": attention_call,
              "attention_seg": attention_seg_call,
              "attention_bwd": attention_bwd_call,
              "attention_seg_bwd": attention_seg_bwd_call,
              "attention_heads_bwd": attention_heads_bwd_call,
              "ffn": ffn_call, "ffn_bwd": ffn_bwd_call, "fm": fm_call,
              "fm_bwd": fm_bwd_call, "ffn_int8": ffn_int8_call,
              "conv_module": conv_module_call, "ctc": ctc_call,
              "ctc_bwd": ctc_bwd_call,
              "conformer_layer": conformer_layer_call,
              "conformer_layer_module": conformer_layer_module_call,
              "attention_dk128": attention_dk128_call,
              "attention_dk128_bwd": attention_dk128_bwd_call,
              "attention_heads_dk128": attention_heads_dk128_call,
              "attention_heads_dk128_bwd": attention_heads_dk128_bwd_call}
    lines = []
    for name in args.kernels.split(","):
        fn = makers[name](torch)
        with torch.no_grad():
            ms = median_ms(torch, fn)
            dev, rows = device_split(torch, fn)
        lines.append(f"{label} {name}: call {ms:.4f} ms (median of 20, CUDA "
                     f"events), device {dev:.4f} ms per call (torch.profiler)")
        for k, kms, calls in rows:
            lines.append(f"{label} {name}:   {short(k)[:60]} {kms:.4f} ms "
                         f"a launch ({calls:g} per call)")
    for line in lines:
        print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
