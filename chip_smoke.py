"""Drive the PyTorch port (tpu_asr_torch) once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each on its own output lines:
  1. card: exit non-zero without a CUDA device; print the card's name and
     power limit (nvidia-smi).
  2. build: compile csrc/*.cu with nvcc (seconds printed).
  3. kernels: each hand-written kernel against its plain PyTorch version at
     the flagship serving shapes (B=32 x 15 s), fp32 and bf16: max error
     within its tolerance, median times of kernel and plain (CUDA events)
     and the bound. Subsampling also at conformer-LARGE's C = D = 512, a
     C % 8 != 0 refused, and beside it the bf16 module path (two F.conv2d,
     ReLUs, flatten, F.linear; timed only); device times (torch.profiler)
     of logmel and the bf16 subsampling and attention. Log-mel's bound
     counts the FFT's operations and the bytes (the DFT-as-matmul count is
     printed beside it), and beside the main shape it checks an odd frame
     count from rows off 16-byte alignment, n_fft = 400 (the DFT kernel),
     n_fft = 1024 (the FFT kernel's radix-4/2 stages), mag_power 1 and log
     False (relative 2e-3 on live bins), each with its device time. The
     attention's segment mode (packed serving) at the packed serve shape,
     16 rows x 512 (segments from plan_packing of serve-window lengths,
     straddling the 64-key tiles; a lone 40-frame segment; an all-guard
     row), fp32 and bf16 at the attention's tolerances on valid rows and
     finite on every row; times, the bound from the within-segment score
     pairs (beside it the pairs the bf16 core's span tiles visit and the
     dense count) and the device time a launch beside
     the unpacked kernel's at B=32 x T=401 (16 s buckets).
  4. model: ModelConfig() in float32 with seeded random weights and
     randomised BatchNorm statistics, run once on the kernels ('auto') and
     once with every backend 'xla': max |delta log-prob| < 2e-3, equal
     greedy ids wherever the plain top-2 margin exceeds 1e-3, and every
     kernel launched. Then in bf16 (the tensor-core paths), the kernels
     and the plain model, both against the fp32 plain model: the kernels'
     max |delta log-prob| at most 2x the plain bf16 model's, greedy ids
     equal to fp32 on >= 99% of the frames whose fp32 top-2 margin exceeds
     1e-1.
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
     versions at ragged edges the main path does not reach. The FFN
     forward and backward also at the teacher's width (B=8 x 15 s, D=176,
     d_ff 704, dropout 0.1, fp32 and bf16, the same rules) and at
     d256/1024 (B=4), whose backward runs on ffn.cu's Small weight ring
     (checked by kernel name); at d320/1280 the forward on the Small ring
     without gradients and autograd through it refused (the backward's
     tiles exceed shared memory); at D=512, d_ff 2048 refused (the
     forward's); the 'auto' route of a training ConformerLayer at the
     teacher's width launching the kernel, and beside each FFN check the
     module path's times
     (LN + two F.linear + SiLU, and autograd through it: the yardstick);
     device times of the bf16 FFN kernels at the student's shape. The bf16
     attention backward's device time per launch (torch.profiler), and the
     backward at T=1100 (B=2, bf16: past the fp32 kernel's shared-memory
     limit of T <= 1024) against plain, bit-equal on two calls. The CTC
     kernels (ctc_kernel_phase): ptxas registers and spills of all six
     templates (none may spill); at the main shape the NLL and d log-probs
     against ctc_nll_plain and autograd through it, then each kernel
     against its own plain version (the alpha lattice on the frames it
     runs and the NLL against ctc_alpha_plain; d log-probs against
     ctc_nll_bwd_plain fed the kernel's saved forward, under a cotangent
     in [0.5, 2); two backward calls bit-equal), the device time of each a
     launch; the same at the packed_train bucket's T'=418, at 2S+1 = 201
     (int32 indices, short inputs, an empty target, an impossible
     alignment whose rows must be exactly 0) and at 2S+1 = 1023
     (T'=1100), each checked by kernel name to run its template; a batch
     with no labels (S = 0) against the plain versions.
  7. train: one DistilCTCModel train step of the student in fp32 at full
     width (16 layers) on B=8 x 15 s, once on the kernels and once on the
     plain versions, from the same weights and seeds (dropout, dither and
     SpecAugment on): loss, every gradient and the BatchNorm running
     statistics must agree. Then the student at its own bf16 compute dtype
     on B=32 x 15 s with 48 tokens: 2 warm-up steps, counters reset, 10
     timed steps; the loss stays finite, every training kernel (forward and
     backward) launched, and ms per step, audio seconds per second and peak
     memory are printed.
  8. fm kernels: ptxas's registers and spills of every FM kernel (the
     build's nvcc.log); the flow-matching Euler loop forward and backward
     against its plain version at the flagship KD shapes (rows = 32 x 16
     layers, T'=376, C=88, H=128, 8 steps), fp32 (the wide SIMT kernels)
     and bf16 (tensor cores), with both output cotangents nonzero; a ragged case (per-row
     steps 1..16, max_steps 16, 48 rows) in both; bf16 at (C, H) = (64,
     64) (64 rows, 8 steps) and (128, 256) (the ragged case); two backward
     calls bit-equal at every shape; bf16 C=520, fp32 C=90, bf16 H=48 and
     max_steps 0 refused (the kernels take C % 8 == 0 and H % 32 == 0 up
     to 512 and any step count, in both types). Max error per output and
     per gradient against a stated tolerance; for the timed shapes median
     kernel and plain times, the device time per launch (torch.profiler),
     the bound, and the memory one backward call allocates.
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
  10. eval kernels: ptxas's registers and spills of the int8 FFN and conv
     module kernels (none may spill); the int8 FFN sublayer and the conv
     module against their
     plain versions at the int8 teacher's serving shape (B=32 x 15 s,
     T'=376, D=176, d_ff 704, conv k=31, ragged lengths), fp32 and bf16:
     the conv with folded batch norm, layer norm and a causal (30, 0)
     context; both also at an odd T, at the student's D=88, at
     conformer-LARGE's D=512 (d_ff 2048; B=4, the largest shared-memory
     tiles), and refusing a shape outside their build. The int8 FFN: rows
     whose every quantized value lies more than 1e-4 quanta from a rounding tie match to 1e-5
     (one ulp in bf16); at most 1% of the rows differ beyond it (a quantization step flips
     where the LN sums run in another order; counts printed); max error
     2e-2 in fp32, 3e-2 of max(1, |ref|) in bf16. The conv within 1e-4 of
     the output's scale in fp32, 3e-2 in bf16. Median kernel and plain times, the
     bound, and beside the int8 FFN the bf16 eval FFN sublayer it replaces
     (LN + two cuBLAS products); beside the bf16 conv kernel the module path
     it replaces (ConformerConvolution with conv_backend='auto': cuBLAS
     products, cuDNN's depthwise conv), timed and its device time; the
     device time a launch of both bf16 kernels (torch.profiler). Also the
     fused FFN (rate 0) at the teacher's D=176, d_ff 704, forward and backward against its plain
     version by phase 6's rules, timed beside the bf16 eval FFN sublayer
     and the module path.
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
  14. layer: ptxas registers and spills of layer_mma_kernel (none may
     spill) and its blocks an SM at D=176 and D=88 (>= 2); the whole eval
     ConformerLayer kernel against its plain version at ModelConfig()
     widths (B=32 x 15 s, T'=376, ragged lengths), fp32 (layer_kernel)
     within 1e-4 and bf16 (layer_mma_kernel) within 5e-2 of the output's
     scale; layer norm, a causal (30, 0) conv, a (32, 16) attention window
     and an odd T (3 x 37), each in fp32 and bf16; the student's width
     (D=88, 2 heads, d_ff 352) in both; a bf16 k=35 on layer_kernel<bf16>;
     two bf16 calls bit-equal; autograd and an fp32 shape past the SIMT
     kernel's shared memory refused; then the whole 16-layer ModelConfig()
     encoder through the kernel layer by layer (forward hooks) against the
     CTCModel on its own kernels, fp32 (max |delta log-prob| < 2e-3, equal
     greedy ids where the top-2 margin exceeds 1e-3) and bf16 (phase 4's
     rule: ids equal on >= 99% of the frames whose margin exceeds 1e-1),
     each layer's error printed. Times: kernel, plain, the port's
     ConformerLayer (the module path) on the same input, the bound, device
     times (torch.profiler) and the call's host gap (call - device).
  15. per-head attention: fused_relpos_attention against its plain version,
     the forward at the teacher's shape (B=32, H=4, T=376, dk=44) in fp32
     and bf16; forward and backward at the student's (H=2, dk=44) with
     dropout 0.1 in fp32 and bf16, a (32, 16) window, ragged lengths
     without a seed; two backward calls bit-equal; the bf16 backward at
     T=1100 (B=2); dk=132 refused; times, bounds and the backward's device
     time per launch. Launch counters are reset before phases 14 and 15
     and must be above 0 after them.
  16. packed serve: ModelConfig() in fp32 on phase 4's 8 clips,
     forward_packed on the kernels (rows of 512, guard 16) unpacked per
     utterance against the per-utterance CTCModel forward on the kernels:
     max |delta log-prob| < 2e-3, and PackedTranscriber.greedy_ids equal to
     its ids wherever the top-2 margin exceeds 1e-3; in bf16 the packed ids
     equal to fp32 on >= 99% of the frames with margin > 1e-1. Then phase
     5's window through PackedTranscriber (bf16): logmel, subsampling and
     the attention's segment mode launched, every result a string, RTFx
     beside phase 5's with the fill ratio and rows a request; and the
     encoder layers' device time a request, packed against bucketed, with
     the whole request's, on the first 2 requests.
  17. packed KD train, on bench_train.py's packed_train batches (512
     utterances of lognormal durations around 6.2 s in 4 linear buckets,
     audio-matched batch sizes: 4 x 56, 2 x 40 and 1 x 32 utterances,
     each bucket's plans padded to one row count in rows of 512): (a)
     ptxas registers and spills of the attention backward's segment
     mode (the tensor-core kernels may not spill; the fp32 check kernels
     printed); the block attention under autograd with the
     segment map of a 56-utterance batch (20 rows x 512, an all-guard row
     among them) at the student's width (D=88, 2 heads), dropout 0.1, fp32
     and bf16, against autograd through the plain version by phase 6's
     rule, every gradient finite, two backward calls bit-equal; the same
     on a map whose ids do not rise along the row (3 x 200); the bf16
     backward's time, plain time, bound (from the within-segment score
     pairs) and device time a launch beside the unpacked backward at the
     bucketed shape of the same utterances (56 x 209). (b) one fp32 packed
     flowkd_mlp8 step on 8 of those utterances, kernels against plain
     (losses 1e-4 relative, gradients by phase 9's rule, the teacher
     unchanged), the segment-mode backward launched. (c) bf16 flowkd_mlp8
     steps over all 7 batches, bucketed and packed
     (profile_train.profile_packed), each after a warm-up pass, counters
     reset before the timed pass: audio s/s, ms a step,
     device ms a step and its groups (torch.profiler), the student
     encoder's forward and backward device time a batch, their ratios, the
     fill ratio and rows a batch; every kernel launched, every packed
     attention backward in its segment mode.
  18. conformer-LARGE (bench.py's large_cfg: d512, 18 layers, 8 heads, dk
     64, d_ff 2048, k=31, no SpecAugment; seeded weights drawn on the card):
     (a) phase 4's checks on the model; (b) phase 5's serve window in bf16,
     then with quantization='int8' and conv_backend='pallas' phase 11's
     row- and layer-level int8 checks (the share of rows that may flip
     scaled by D + d_ff over ModelConfig()'s 880: 29%) and phase 12's
     serve window, RTFx
     beside the fp RTFx; (c) one fp32 CTC step (DistilCTCModel with the CTC
     loss alone, B=8 x 15 s, dropout, dither) on the kernels against plain
     by phase 7's rules, then 10 timed bf16 steps at B=32 x 15 s with 48
     tokens after 2 warm-up: ms a step, audio s/s, peak memory, every
     kernel of the step launched (the training FFN kernel refuses d512).
  19. conformer-XLarge (bench.py's xl_cfg: d1024, 8 heads, dk 128, k=5;
     its model paths (c)-(e) at 8 of its 24 layers): (a) the block attention and the per-head attention at dk
     128 (B=32 x T'=376, D=1024) against their plain versions, fp32 and
     bf16, dropout 0 and 0.1, the forward by phase 3's tolerances, the bf16
     backward by phase 6's rule with two calls bit-equal; the fp32 backward
     at T=160 (B=8), the longest its shared memory takes at dk 128, and
     refused past it; the segment mode in bf16 on the packed serve map
     (16 x 512) by phase 17's rules; dk=132 refused; ptxas registers and
     spills of the
     dk-128 kernels; times, bounds, device times, and the kernels' names
     (core_mma_kernel<128, ...>, dq_mma_kernel<128, ...>,
     dkv_mma_kernel<128, ...>) from the profiler; (b) the subsampling at
     C=1024 against plain, fp32 and bf16; (c) phase 4's checks on the model,
     one attention launch a layer; (d) the model built and seeded on the
     card (seconds printed), one bf16 forward launching the attention once
     a layer through core_mma_kernel<128, ...> and no other core (profiler
     names; beside it the seconds the same build and draw take on the
     CPU), then phase 5's serve window in bf16; (e) one CTC step at B=8 x
     15 s from the same weights: bf16 on the kernels and bf16 plain
     against fp32 plain (the fp32 backward refuses T'=376 at dk 128), the
     kernels' loss and each gradient within 2x the plain bf16 step's
     deviation (floored at 2^-8 of the reference's scale; the key and
     depthwise-conv biases, zero in exact arithmetic, within 5e-2 of 1e-2 x
     the largest gradient), every attention
     backward through dq_mma_kernel<128> and dkv_mma_kernel<128> (profiler
     names and counters); then 2 timed bf16 steps at B=32 x 15 s after 1
     warm-up.
  20. fastconformer_local (NeMo's Fast Conformer Large: d512, 17 layers, 8
     heads, dw_striding x8, k=9, 1024 tokens, window (128, 128); seeded
     weights drawn on the card): (a) the windowed block attention against
     its plain version: (128, 128) at B=32 x T'=188 and B=4 x T'=1024,
     (8, 0) and (-1, 4) at B=8 x T'=300, (128, 128) and (8, 0) with the
     segment mode on the packed serve map; fp32 and bf16, dropout 0 and
     0.1; the forward in fp32 by phase 3's tolerances, in bf16 by phase 4's
     rule against fp32 plain (window_case), finite on every row; the
     backward by phase 6's rule (fp32 up to T'=600), bit-equal calls;
     ptxas of the window kernels; times, bounds over the in-window pairs,
     device times; the windowed bf16 core below 0.25 of the full-context
     core's device time at B=4 x T'=4096; (b) phase 4's checks on 8 clips
     of 60-120 s, every attention launch windowed; (c) long-form serving:
     Transcriber (batch 4) on 16 requests of 4 clips of 5-10 min after 2
     warm-up, RTFx, wall a request, peak memory; (d) an fp32 CTC step at
     B=4 x 45 s (T'=563) by phase 7's rules, the windowed backward once a
     layer, 10 timed bf16 steps at B=32 x 15 s, and the CTC pair at
     V=1025 against its plain versions with its device times.
  21. the rest of KD, at the flagship widths: (a) flowkd_router16
     (profile_train: flowkd_mlp8 with the dynamic step router,
     RouterConfig(max_steps=16, stu_dim=88, tch_dim=176, num_layers=16),
     strategy 'group', up to 16 Euler steps a row) by phase 9's rules: one
     fp32 step at B=8 x 15 s on kernels against plain (every loss of the
     configuration within 1e-4 relative, every gradient by phase 7's rule,
     router.* among them, the teacher bit-unchanged), both runs drawing
     the same Gumbel noise from the step's generators: their step counts
     equal wherever the plain run's top-2 margin of logits + noise
     exceeds 1e-3 (the rows under it and the flips printed); then 10 timed
     bf16 steps at B=32 x 15 s: losses finite, every KD kernel launched
     (the FM pair on ragged per-row counts), the histogram of the drawn
     counts (at least 3 distinct) and the FM launches a step; the FM pair
     against its plain version at the shapes the timed steps give it: 512
     rows x T'=376 at C=88, H=128 on the step counts the router drew in
     the last timed step, fp32 and bf16, and 512 rows at diffm's latent
     C=64, H=128, 8 steps, bf16; (b) kd_menu
     (layerwise KD over all layers, DiffKD, diffm ver 6 with its two latent
     FMs at C=64, H=128, interCTC on layer 7, logit KD) the same, 3 timed
     steps (its fp32 FM falls back to plain: the fp32 kernels take C=88
     only, so (a) holds its bf16 latent FM against plain); (c) flowkd_router16's eval forward in fp32 on phase 4's clips,
     kernels against plain, the teacher running for the router: step
     counts by the margin rule, log-probs within 2e-3, greedy ids where
     the top-2 margin exceeds 1e-3, the FM kernel launched; (d) one bf16
     flowkd step with each other meta encoder (cnn, swin, conformer, unet;
     B=8): losses finite, no FM kernel launch.
  22. the CLI (tpu_asr_torch/cli/): 64 WAV clips of 1-15 s of seeded noise
     with texts from a fixed word list (48 train, 16 val manifests) and a
     full-width `.nemo` in NGC's layout (a seeded ModelConfig() teacher's
     state_dict, a 128-piece BPE tokenizer artifact, model_config.yaml in
     NeMo's block style from this script's own emitter, read by the port's
     YAML reader); asr_train's `main` with the flowkd_mlp8 flags (logit KD
     0.1, flow matching 8 steps), --batch_size 32 --epochs 1 and the val
     manifest, on the card: every logged value finite, launch counters over
     the run above 0 for logmel, subsampling, attention forward and
     backward, FFN forward and backward, CTC forward and backward and the
     FM pair; the first logged loss within 1e-5 relative of the train step
     applied directly to the same first batch from the same initial state;
     checkpoints/last restored bit-equal (its student against the student
     export) and saved again bit-equal; asr_inference on `last` with the
     same flags giving the fit's final evaluate WER and loss (1e-5); on the
     student export (CTC only) --packed_eval in the config's bf16 giving
     the bucketed loss within 1e-4 (both WERs printed: greedy ids flip
     where a random model's top-2 margin is within bf16 rounding) with
     segment-mode attention launches, and in fp32 (the same Trainer
     methods) the bucketed WER and its loss within 1e-5; --resume_ckpt
     with --epochs 2 continuing at the saved step and ending at twice it.
     The fit's seconds and steps/s and evaluate's audio s per s (host
     clock), beside the card's name and power limit.
  23. the serving surface, seeded weights, fp32 unless stated: (a)
     cache-aware streaming of bench.py's streaming configuration
     (ModelConfig() with causal subsampling and conv, chunked_limited
     (108, 3): 16 mel frames a chunk, 4 encoded frames, 108 frames of
     left context): B=1 over a 15 s clip and B=8 over clips of 4-15 s
     (exhausted streams ride along with chunk_len 0), the per-chunk
     log-probs concatenated against the same model's offline forward on
     the same features (max |delta log-prob| < 2e-3, greedy ids equal
     where the offline top-2 margin exceeds 1e-3), in bf16 ids equal on >=
     99% of the frames with margin > 1e-1; CacheAwareStreamer.stream's
     launches (logmel > 0, attention and subsampling 0: a cached step runs
     plain, as in JAX) and its ids against the offline greedy ids; the
     per-chunk step latency at B=1 and B=8 (bench.py's 50 steps after
     warm-up, 3 repeats: median and range) and the device's busy ms a step
     and share; (b) ModelConfig() at B=32 x 15 s on the
     kernels, then beam_batch W=16: the top beam of 2 rows against the
     host prefix search on the same log-probs with each frame cut to its
     top 2W tokens (the host search's own pruning), tokens equal and
     scores within rtol and atol 1e-4; with a seeded 3-gram NgramLM on all
     32 rows against the same call on a CPU copy of the log-probs (the
     same rule); beam RTFx beside greedy RTFx (forward and decode to
     text, host clock), the serving kernels launched; (c) greedy
     CTCDecoding with timestamps, every ConfidenceConfig preserve flag and
     alignments on (b)'s log-probs against their CPU copy (tokens, offsets
     and alignments equal, confidences within 1e-5), and
     ChunkedTranscriber on a 120 s clip (16 s windows, 2 s overlap): the
     same text as on a CPU copy of the model's plain path, and its RTFx.
     Every time beside the card's name and power limit.
  24. data parallelism (tpu_asr_torch/parallel/), flowkd_mlp8 and
     flowkd_router16 at the flagship widths from seeded weights: (a) one
     fp32 step pair at B=8 x 15 s (dropout, SpecAugment, dither) under DDP
     in a one-rank NCCL group against the step without DDP: every loss
     within 1e-5 relative, the BatchNorm running statistics after step 1
     within 1e-5, the parameters after step 2 by tests/test_torch_train.py's
     fp32 rule (elements whose first gradient exceeds 1e-4 x the largest,
     within 1e-5 x |ref| + 2e-2 x the learning rate); last, with the card
     to itself, 10 bf16 steps at B=32 x 15 s after 2 warm-up without DDP,
     then with, host clock, every KD kernel launched by the DDP steps
     (profile_train --ddp times them in turns); (b) two gloo
     ranks sharing the card (parallel/launch.py; NCCL refuses two ranks on
     one device), 4 rows each of the same 8, 2 fp32 steps of each
     configuration, against one rank on all 8: the same rules, the
     router's counts equal wherever its Gumbel margin exceeds 1e-3, and on
     each rank every KD kernel launched (counters reset before its steps);
     (c) the two ranks fit a CTC student 2 steps on 16 seeded clips and
     evaluate 8 bucketed and packed; their checkpoint restored at one rank
     gives the same WER and the loss within 1e-5. The ranks start first and
     run beside (a)'s check and (b)'s one-rank runs. NCCL across cards is
     not exercised (one card).
  26. the serving artifact, int8 streaming and host decoders: (a)
     int8 cache-aware streaming of phase 23's streaming configuration
     (quantization='int8'): 8 fp32 streams of 2-6 s on the kernels (the int8
     FFN kernel, two launches a layer a step, on chunks of a few frames)
     against 'xla' by phase 11's int8 rule, then the bf16 step's latency
     and busy share at B=1 and 8 beside the float step's; (b) ModelConfig()
     in bf16 (phase 5's weights) exported on the card at one bucket (32 x
     16 s; seconds printed), loaded in a fresh process that imports only
     the port's loader: its graph names the serving ops, phase 5's window
     served there with every serving kernel's counter above 0, ids equal
     to the Transcriber's on the first request by phase 4's bf16 rule, RTFx
     beside phase 5's; (c) the codec libraries found on the host, one
     Transcriber request on MP3 clips where libmpg123 and libmp3lame exist,
     and the native FLAC decoder bit-equal to the Python one, both timed.
  27. conformer-LARGE's KD step (profile_train's flowkd_large: the frozen
     LARGE teacher d512 / 18 layers / 8 heads, its d256 / 4-head student,
     logit KD 0.1, FM-KT mlp 8 steps over 18 layers at C=256, H=128): (a)
     the FM kernels at the widths only the wide kernels take: ptxas's
     registers and spills of the four wide kernels (none may spill): the
     fp32 SIMT fm_fwd_wide_kernel<float> and fm_bwd_wide_kernel<float>,
     the bf16 tensor-core fm_fwd_wide_mma_kernel and
     fm_bwd_wide_rows_kernel; then the FM pair against fm_euler_plain by
     phase 8's rules at C=256 (rows 72 = 4 x 18 layers, T'=376, 8 steps,
     and 24 ragged steps) and C=512 (XLarge's student: 8 steps and 24
     ragged steps; fp32 on 24 rows, bf16 on 72; and bf16 at (e)'s shape,
     32 rows x 24 steps), fp32 and bf16, forward and backward, the bf16
     backward also against fm_euler_bwd_plain (the kernels' rounding
     points) by the same rules, and bf16 at C=88, H=512 (the route's edge:
     narrow C, wide H), with kernel, plain and device times and the bound
     of the timed shapes; (b) phase 9's check at flowkd_large:
     one fp32 step at B=4 x 15 s on the kernels against plain, the FM
     kernels launched by it (C=256 runs the wide kernels), then 3 timed
     bf16 steps at B=4 that launch every KD kernel; (c) two gloo ranks
     sharing the card run the fp32 step pipelined (parallel/pipeline.py,
     pp 2, n_micro 2; the student's conv module in layer_norm, which
     pipelined training requires) and (d) tensor-parallel (tp 2: 2 of the
     student's 4 heads and 4 of the teacher's 8 on each rank), against
     the one-rank step of the same configuration from the same weights and
     draws, on the kernels and, as a witness, on the plain versions
     against the one-rank plain step: losses within 1e-5 relative, every
     gradient within 1e-5 + 1e-4 x its tensor's scale (max|ref|, at least
     1e-4 of the largest; tests/test_torch_train.py's fp32 rule), the TP
     step on the kernels within 1e-5 + 2e-3 x it (the attention backward
     kernel sums the positional gradients in an order that depends on the
     heads a launch holds; see `parallel_large_rank` for the readings),
     every KD kernel launched on each rank; (e) the bf16 KD step at XLarge's widths
     (phase 19's 8 of its 24 layers: teacher d1024 / 8 heads, student d512 /
     4 heads) with FM-KT at C=512, H=128 and 24 Euler steps through the
     Trainer's step at B=4 x 15 s: one warm-up and 2 counted steps, losses
     finite, every KD kernel launched but the training FFN's (they refuse
     d512, as JAX's do; the refusal is checked), the FM fed (32, 376, 512)
     at 24 steps; its FM launches are the fm_c512_s24 rows' (timed in (a) at
     that shape).
Each phase's seconds are printed after it, and the whole run's at the end.
Device times (torch.profiler) are busy ms a call over the calls whose
marker the profiler kept, and each kernel's recorded time over its
recorded launches (`device_ms`).
Then one JSON line of per-kernel results, and last the JSON device line.
Any failed check exits non-zero before the last line.
"""

from __future__ import annotations

import dataclasses
import functools
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
LONG_T = 1100          # beyond the fp32 attention backward's T <= 1024
PACK_ROWS, T_PACK = 16, 512    # the packed serve shape (PackedTranscriber)
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM, data sheet
# SIMT fp32, bf16 and int8 tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
FFN_GRADS = ["dx", "d_ln_scale", "d_ln_bias", "dw1", "db1", "dw2", "db2"]
ATT_GRADS = ["dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "d_pos_bias_u",
             "d_pos_bias_v", "dw_pos", "dwo"]
DEVICE = "torch.profiler: busy ms a call, each kernel's ms a launch"


def check(ok, msg: str) -> None:
    """Print the check; a failed one is printed to standard error too and
    ends the run with exit code 1."""
    ok = bool(ok)
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        print("chip_smoke: FAIL " + msg, file=sys.stderr, flush=True)
        sys.exit(1)


@functools.cache
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them; queried
    once a run."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def card() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        sys.exit(2)
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    full_fp32()


def full_fp32() -> None:
    """fp32 references in full fp32: cuDNN convolutions default to TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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


def device_ms(fn, iters: int = 5):
    """(device ms per call, {kernel: ms a launch}) of fn() in
    torch.profiler. Per call: the union of the card's busy spans, so host
    work between launches does not count, over the calls whose marker the
    profiler kept (profile_forward.mark_call); a kernel: its recorded time
    over its recorded launches. Both stay right when the profiler drops
    some of the run's events, which it sometimes does (3 of 5 launches):
    a division by the calls made would then read low."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_asr_torch.profile_forward import device_activity, mark_call
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            mark_call()
            fn()
        torch.cuda.synchronize()
    busy, _, names = device_activity(prof, iters)
    return busy, {k: ms / n for k, (ms, n) in names.items()}


def profiled_kernels(fn, *parts: str, iters: int = 5, tries: int = 5):
    """device_ms(fn, iters), repeated until each of `parts` names a kernel the
    profiler recorded: torch.profiler sometimes drops all of a run's events
    of one kernel. Returns (busy ms a call, {kernel: ms a launch}) of the
    last run."""
    for i in range(tries):
        dev, names = device_ms(fn, iters)
        missing = [p for p in parts if not any(p in k for k in names)]
        if not missing:
            break
        print(f"torch.profiler recorded no launch of {missing} in run "
              f"{i + 1} of at most {tries}")
    return dev, names


def top_kernels(names, n: int = 3) -> str:
    """The n kernels with the most device time, 'name ms' each."""
    top = sorted(names.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{kernel_short(k)[:48]} {v:.4f}" for k, v in top)


def kernel_short(name: str) -> str:
    """A profiler kernel name without namespace, `void` and arguments."""
    return (name.replace("(anonymous namespace)::", "").removeprefix("void ")
            .split("(")[0])


def normal(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def kernel_phase(cfg):
    """Each kernel against its plain version at the serving shapes. Returns
    {name: {dtype: (max_abs_err, kernel_ms, plain_ms, bound, library_ms)}}."""
    from tpu_asr_torch.ops.cuda_attention import (
        fused_relpos_attention_block, relpos_attention_plain)
    from tpu_asr_torch.ops.cuda_features import (_fft_tables, fused_logmel,
                                                 logmel_plain, logmel_route)
    from tpu_asr_torch.ops.cuda_subsampling import fused_subsampling, out_len
    from tpu_asr_torch.ops.features import FilterbankFeatures
    from tpu_asr_torch.models.conformer import rel_positional_encoding

    gen = torch.Generator(device="cuda").manual_seed(0)
    pre = cfg.preprocessor
    enc = cfg.encoder
    results = {}

    # log-mel: fp32 only; the model's n_fft = 512 runs the FFT kernel
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
    route = logmel_route(pre.n_fft, pre.hop_length, feat.fb_t.shape[0])
    check(err < 2e-3, f"logmel fp32 (B={BATCH}, T={n_frames}, "
          f"{pre.features} mels, {route} kernel): max |err| on live bins "
          f"{err:.3e} < 2e-3")
    flops = logmel_flops(BATCH * n_frames, pre.n_fft, feat.fb_t)
    dft = logmel_flops(BATCH * n_frames, pre.n_fft, feat.fb_t, dft=True)
    nb = nbytes(xp, *_fft_tables(feat.basis, feat.fb_t), got)
    results["logmel"] = {"float32": (
        err, median_ms(lambda: fused_logmel(*args)),
        median_ms(lambda: logmel_plain(*args)),
        bound(flops, nb, "float32"), None)}
    dev, names = device_ms(lambda: fused_logmel(*args))
    print(f"time logmel float32: bound from the FFT's {flops / 1e9:.3f} GFLOP "
          f"and {nb / 1e6:.1f} MB; the DFT-as-matmul count was "
          f"{dft / 1e9:.2f} GFLOP ({bound(dft, nb, 'float32')[0]:.4f} ms at "
          f"the fp32 SIMT rate); device time ({DEVICE}) {dev:.4f} "
          f"({top_kernels(names)})")
    logmel_cases(gen, pre)

    # subsampling at the model's C = D = 176 (timed) and at conformer-LARGE's
    # C = D = 512; C % 8 != 0 refused
    f2 = out_len(out_len(pre.features))
    t2 = out_len(out_len(n_frames))
    feats = normal(gen, BATCH, n_frames, pre.features)
    results["subsampling"] = {}
    for ch, d in ((enc.conv_channels, enc.d_model), (512, 512)):
        w = subsampling_weights(gen, ch, d, f2)
        timed = ch == enc.conv_channels
        for dt in (torch.float32, torch.bfloat16):
            row = subsampling_case(feats.to(dt), w, timed)
            if timed:
                results["subsampling"][str(dt)[6:]] = row
        x = feats.to(torch.bfloat16)
        if timed:
            wb = [z.to(torch.bfloat16) for z in w]
            module_ms = median_ms(lambda: subsampling_module_path(x, *wb))
            dev, names = device_ms(lambda: fused_subsampling(x, *w))
            print(f"time subsampling bfloat16 C={ch}: bf16 module path (two "
                  f"F.conv2d, ReLUs, flatten, F.linear; timed only) "
                  f"{module_ms:.4f} ms; kernel device time ({DEVICE}) "
                  f"{dev:.4f} ({top_kernels(names)})")
        else:
            print(f"time subsampling bfloat16 C={ch}: kernel "
                  f"{median_ms(lambda: fused_subsampling(x, *w)):.4f} ms")
    refused(lambda: fused_subsampling(
        feats[:1], normal(gen, 12, 1, 3, 3), normal(gen, 12),
        normal(gen, 12, 12, 3, 3), normal(gen, 12), normal(gen, 16, 12 * f2)),
        "fused_subsampling at C=12")
    d = enc.d_model

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
    dev, names = device_ms(lambda: fused_relpos_attention_block(*aargs))
    print(f"device attention bfloat16 ({DEVICE}): {dev:.4f} "
          f"({top_kernels(names, 4)})")
    results["attention_seg"] = segment_attention(gen, pw, d, h)
    for name, per_dt in results.items():
        for dt, (err, ms, plain_ms, (b_ms, by), _) in per_dt.items():
            print(f"time {name} {dt}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) (median "
                  f"of 20, CUDA events)")
    return results


def subsampling_weights(gen, ch, d, f2):
    """w1, b1, w2, b2, w_out of the subsampling at C channels and D outputs,
    seeded, scaled as at C = 176."""
    return (normal(gen, ch, 1, 3, 3, scale=0.3), normal(gen, ch, scale=0.1),
            normal(gen, ch, ch, 3, 3, scale=0.08 * (176 / ch) ** 0.5),
            normal(gen, ch, scale=0.1),
            normal(gen, d, ch * f2, scale=0.05 * (176 / ch) ** 0.5))


def subsampling_case(x, w, timed: bool):
    """fused_subsampling against its plain version on x (B, T, 80) in its
    dtype: fp32 within rtol = atol = 1e-3, bf16 within rtol 0.05 and 0.03
    of max(1, |ref|max). With `timed`, returns (max_abs_err, kernel ms,
    plain ms, bound, None); else None."""
    from tpu_asr_torch.ops.cuda_subsampling import (fused_subsampling,
                                                    out_len, subsampling_plain)
    b, n_frames, feat = x.shape
    ch, d = w[0].shape[0], w[4].shape[0]
    t2, f2 = out_len(out_len(n_frames)), out_len(out_len(feat))
    dt = x.dtype
    with torch.no_grad():
        got = fused_subsampling(x, *w).float()
        want = subsampling_plain(x, *w).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    if dt == torch.float32:
        ok = torch.allclose(got, want, rtol=1e-3, atol=1e-3)
        tol = "rtol=atol=1e-3"
    else:
        ok = torch.allclose(got, want, rtol=0.05, atol=0.03 * max(1.0, ref))
        tol = "rtol 0.05, atol 0.03*max(1,|ref|max)"
    check(ok and got.shape == (b, t2, d),
          f"subsampling {str(dt)[6:]} C={ch} ({b}, {n_frames}, {feat}) -> "
          f"({b}, {t2}, {d}): max |err| {err:.3e}, |ref|max {ref:.3e} "
          f"({tol})")
    if not timed:
        return None
    flops = (2 * 9 * b * out_len(n_frames) * out_len(feat) * ch
             + 2 * 9 * b * t2 * f2 * ch * ch + 2 * b * t2 * ch * f2 * d)
    with torch.no_grad():
        return (err, median_ms(lambda: fused_subsampling(x, *w)),
                median_ms(lambda: subsampling_plain(x, *w)),
                bound(flops, nbytes(x, *w) + got.numel() * x.element_size(),
                      str(dt)[6:]), None)


def segment_pairs(seg: np.ndarray) -> int:
    """Score pairs (t, s) within one segment, over the rows of a map."""
    return sum(int((np.bincount(r[r > 0]) ** 2).sum()) for r in seg)


def span_pairs(seg: np.ndarray, tile: int = 64) -> int:
    """Score pairs the bf16 segment core visits over the rows of a map:
    per 64-query tile, its span's 64-key tiles (attention.cu's rule)."""
    total = 0
    for r in seg:
        for q0 in range(0, len(r), tile):
            ids = r[q0:q0 + tile]
            ids = ids[ids > 0]
            if len(ids):
                keys = np.nonzero((r >= ids.min()) & (r <= ids.max()))[0]
                total += ((-(-(keys[-1] + 1) // tile) - keys[0] // tile)
                          * tile * min(tile, len(r) - q0))
    return total


def segment_attention(gen, pw, d, h):
    """The block attention's segment mode against its plain version at the
    packed serve shape (16 rows x 512, the serve model's widths), fp32 and
    bf16 at the unpacked check's tolerances on valid rows, finite output on
    every row; times, the device time a launch beside the unpacked
    kernel's at the bucketed serve shape (B=32 x 16 s, T'=401), and the
    bound from the within-segment score pairs. {dtype: result row}."""
    from tpu_asr_torch.ops.cuda_attention import (
        fused_relpos_attention_block, relpos_attention_plain)
    from tpu_asr_torch.ops.positions import rel_positional_encoding
    from tpu_asr_torch.profile_forward import packed_seg_map

    seg_np = packed_seg_map()
    seg = torch.from_numpy(seg_np).cuda()
    mask = seg > 0
    t, dk = T_PACK, d // h
    pos_emb = rel_positional_encoding(t, d, "cuda")
    xs = normal(gen, PACK_ROWS, t, d, scale=0.5)
    pairs, dense = segment_pairs(seg_np), PACK_ROWS * t * t
    flops = (2 * PACK_ROWS * t * d * d * 4 + 2 * (2 * t - 1) * d * d
             + 2 * h * pairs * dk * 3)
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        dts = str(dt)[6:]
        aargs = (xs.to(dt), *pw, pos_emb, mask, h)
        run = lambda: fused_relpos_attention_block(*aargs, seg_id=seg)
        got = run().float()
        want = relpos_attention_plain(*aargs, seg_id=seg).float()
        torch.cuda.synchronize()
        valid = mask[..., None]
        err = ((got - want).abs() * valid).max().item()
        rtol, atol = (1e-4, 1e-4) if dt == torch.float32 else (1e-2, 3e-3)
        check(bool(torch.isfinite(got).all()) and torch.allclose(
            got * valid, want * valid, rtol=rtol, atol=atol),
            f"attention_seg {dts} ({PACK_ROWS} rows x {t}, D={d}, H={h}, "
            f"{int(mask.sum())} valid frames, an all-guard row): finite, "
            f"valid rows max |err| {err:.3e} (rtol {rtol}, atol {atol})")
        rows[dts] = (err, median_ms(run),
                     median_ms(lambda: relpos_attention_plain(*aargs,
                                                              seg_id=seg)),
                     bound(flops, nbytes(aargs[0], *pw, seg)
                           + got.numel() * aargs[0].element_size(), dts),
                     None)
    dev, names = device_ms(run)
    t_b = 401
    lengths = torch.randint(t_b // 4, t_b + 1, (BATCH,), generator=gen,
                            device="cuda")
    lengths[0] = t_b
    xb = normal(gen, BATCH, t_b, d, scale=0.5).to(torch.bfloat16)
    bargs = (xb, *pw, rel_positional_encoding(t_b, d, "cuda"),
             torch.arange(t_b, device="cuda")[None, :] < lengths[:, None], h)
    dev_b, names_b = device_ms(lambda: fused_relpos_attention_block(*bargs))
    err, ms, plain_ms, (b_ms, by), _ = rows["bfloat16"]
    print(f"time attention_seg bfloat16 ({PACK_ROWS} x {t}): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}; "
          f"{pairs} within-segment score pairs a head, {span_pairs(seg_np)} "
          f"visited by the core's span tiles, dense {dense}); "
          f"device {dev:.4f} ms a call ({top_kernels(names, 3)} a launch); "
          f"unpacked at B={BATCH} x T={t_b}: device {dev_b:.4f} ms a call "
          f"({top_kernels(names_b, 3)} a launch; {BATCH * t_b * t_b} score "
          f"pairs a head)")
    return rows


def logmel_flops(frames: int, n_fft: int, fb_t, dft: bool = False) -> float:
    """Operations of the log-mel of `frames` frames. The FFT kernel, per
    frame of n_fft = 2N: the window (2N), an N-point complex FFT
    (5 N log2 N), the real split (10 N), the power (3 (N + 1)), the mel
    bands' multiply-adds (2 x their nonzero bins) and the log (n_mels).
    dft=True: the DFT as a matmul, 2 n_fft 2 (N + 1) per frame, and a dense
    mel product, as the bound before the FFT kernel counted it."""
    n = n_fft // 2
    n_freq, n_mels = fb_t.shape
    if dft:
        per = (2 * n_fft * 2 * n_freq + 3 * n_freq + 2 * n_freq * n_mels
               + n_mels)
    else:
        per = (n_fft + 5 * n * math.log2(n) + 10 * n + 3 * (n + 1)
               + 2 * int((fb_t != 0).sum()) + n_mels)
    return frames * per


def logmel_cases(gen, pre):
    """The log-mel kernels beside the main path's shape, fp32, B=4 x 7.3 s:
    an odd frame count with Lp % 4 == 1, so rows 1.. start off 16-byte
    alignment (the FFT kernel's 4-byte copies), n_fft = 400 (the DFT
    kernel), n_fft = 1024 (the FFT kernel's radix-4/2 stages), mag_power 1
    and log False (relative error 2e-3 on live bins, the log gate's
    equivalent); device times (torch.profiler)."""
    from tpu_asr_torch.ops.cuda_features import (fused_logmel, logmel_plain,
                                                 logmel_route)
    from tpu_asr_torch.ops.features import FilterbankFeatures

    for kw in ({}, {"n_fft": 400}, {"n_fft": 1024, "window_size": 0.05},
               {"mag_power": 1.0}, {"log": False}):
        cfg = dataclasses.replace(pre, **kw)
        feat = FilterbankFeatures(cfg).cuda()
        audio = normal(gen, 4, 116801, scale=0.1)
        pad = cfg.n_fft // 2
        xp = torch.nn.functional.pad(audio[:, None], (pad, pad),
                                     mode="reflect")[:, 0].contiguous()
        n_frames = (xp.shape[1] - cfg.n_fft) // cfg.hop_length + 1
        args = (xp, n_frames, feat.basis, feat.fb_t, cfg.hop_length,
                cfg.log_zero_guard_value, cfg.mag_power, cfg.log)
        with torch.no_grad():
            got, want = fused_logmel(*args), logmel_plain(*args)
        torch.cuda.synchronize()
        route = logmel_route(cfg.n_fft, cfg.hop_length, feat.fb_t.shape[0])
        if cfg.log:
            live = want > np.log(cfg.log_zero_guard_value) + 8.0
            err = (got - want).abs()[live].max().item()
        else:
            live = want > cfg.log_zero_guard_value * math.exp(8.0)
            err = ((got - want).abs() / want)[live].max().item()
        dev, names = device_ms(lambda: fused_logmel(*args))
        check(torch.isfinite(got).all() and live.float().mean() > 0.5
              and err < 2e-3,
              f"logmel fp32 {kw or 'odd frames'} ({route} kernel, B=4, "
              f"T={n_frames}, Lp={xp.shape[1]}): max "
              f"{'|err|' if cfg.log else 'relative err'} on live bins "
              f"{err:.3e} < 2e-3; device {dev:.4f} ms "
              f"({top_kernels(names, 1)})")


def subsampling_module_path(x, w1, b1, w2, b2, w_out):
    """The subsampling as PyTorch modules compute it in x's dtype: two
    F.conv2d with their ReLUs, the channel-major flatten and F.linear
    without its bias. Timed beside the kernel; the port never calls it."""
    F = torch.nn.functional
    h = F.relu(F.conv2d(x[:, None], w1, b1, stride=2, padding=1))
    h = F.relu(F.conv2d(h, w2, b2, stride=2, padding=1))
    b, c, t2, f2 = h.shape
    return F.linear(h.transpose(1, 2).reshape(b, t2, c * f2), w_out)


def reset_counters():
    """Set every kernel wrapper's launch count to 0, both attention
    wrappers' counts of their segment mode (`seg_launches`) and of a
    limited window (`window_launches`); returns a function that reads {row
    name: launches since}."""
    from tpu_asr_torch.ops.cuda_attention import (
        fused_relpos_attention, fused_relpos_attention_block,
        fused_relpos_attention_block_bwd, fused_relpos_attention_bwd)
    from tpu_asr_torch.ops.cuda_conv import fused_conv_module
    from tpu_asr_torch.ops.cuda_ctc import ctc_nll, ctc_nll_bwd
    from tpu_asr_torch.ops.cuda_features import fused_logmel
    from tpu_asr_torch.ops.cuda_ffn import (fused_ffn_sublayer,
                                            fused_ffn_sublayer_bwd,
                                            fused_ffn_sublayer_int8)
    from tpu_asr_torch.ops.cuda_fm import fused_fm_euler, fused_fm_euler_bwd
    from tpu_asr_torch.ops.cuda_layer import fused_conformer_layer
    from tpu_asr_torch.ops.cuda_subsampling import fused_subsampling
    fns = {"logmel": fused_logmel, "subsampling": fused_subsampling,
           "attention": fused_relpos_attention_block,
           "attention_bwd": fused_relpos_attention_block_bwd,
           "ffn": fused_ffn_sublayer, "ffn_bwd": fused_ffn_sublayer_bwd,
           "ctc": ctc_nll, "ctc_bwd": ctc_nll_bwd, "fm": fused_fm_euler,
           "fm_bwd": fused_fm_euler_bwd, "ffn_int8": fused_ffn_sublayer_int8,
           "conv_module": fused_conv_module,
           "conformer_layer": fused_conformer_layer,
           "attention_heads": fused_relpos_attention,
           "attention_heads_bwd": fused_relpos_attention_bwd}
    for fn in fns.values():
        fn.launches = 0
    fused_relpos_attention_block.seg_launches = 0
    fused_relpos_attention_block_bwd.seg_launches = 0
    fused_relpos_attention_block.window_launches = 0
    fused_relpos_attention_block_bwd.window_launches = 0
    return lambda: {**{k: fn.launches for k, fn in fns.items()},
                    "attention_seg":
                        fused_relpos_attention_block.seg_launches,
                    "attention_seg_bwd":
                        fused_relpos_attention_block_bwd.seg_launches,
                    "attention_window":
                        fused_relpos_attention_block.window_launches,
                    "attention_window_bwd":
                        fused_relpos_attention_block_bwd.window_launches}


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


def model_phase(cfg, name: str = "ModelConfig()", rows=None,
                clips=None, span: str = f"5-{SECONDS} s"):
    """Phase 4's checks on `cfg` (`name` in the messages) on `clips`
    ((signal, lengths) on the card; model_clips(1) by default, whose
    durations `span` names), every kernel of `rows` launched; returns the
    fp32 kernel forward's {row: launches}."""
    from tpu_asr_torch.profile_forward import seeded_model, set_backend
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = seeded_model(cfg32, seed=1)
    sig_t, len_t = model_clips(1) if clips is None else clips
    read = reset_counters()
    with torch.inference_mode():
        got = model(sig_t, len_t)
        counts = read()
        set_backend(model, "xla")
        want = model(sig_t, len_t)
        set_backend(model, "auto")
    torch.cuda.synchronize()
    counts = {k: counts[k] for k in rows or SERVING}
    check(all(v > 0 for v in counts.values()),
          f"model on kernels launched every kernel: {counts}")
    check(torch.equal(got.encoded_len, want.encoded_len),
          "encoded_len equal")
    valid = (torch.arange(got.log_probs.shape[1], device="cuda")[None, :]
             < want.encoded_len[:, None])
    delta = ((got.log_probs - want.log_probs).abs() * valid[..., None]).max()
    check(bool(torch.isfinite(got.log_probs).all()), "log-probs finite")
    check(delta.item() < 2e-3, f"{name} fp32, {len(sig_t)} clips of "
          f"{span}: max |delta log-prob| kernels vs plain "
          f"{delta.item():.3e} < 2e-3")
    top2 = want.log_probs.topk(2, dim=-1).values
    decided = valid & ((top2[..., 0] - top2[..., 1]) > 1e-3)
    same = (got.greedy == want.greedy) | ~decided
    check(bool(same.all()), f"greedy ids equal on {int(decided.sum())} "
          f"frames with plain top-2 margin > 1e-3 "
          f"(of {int(valid.sum())} valid)")

    # bf16, where the subsampling and attention run on the tensor cores:
    # the kernels and the plain model in bf16, both against the fp32 plain
    # model above, from the same weights
    model16 = seeded_model(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                           seed=1)
    with torch.inference_mode():
        got16 = model16(sig_t, len_t)
        set_backend(model16, "xla")
        plain16 = model16(sig_t, len_t)
    torch.cuda.synchronize()
    check(torch.equal(got16.encoded_len, want.encoded_len)
          and bool(torch.isfinite(got16.log_probs).all()),
          "bf16 on kernels: encoded_len equal, log-probs finite")
    drift = lambda out: ((out.log_probs.float() - want.log_probs).abs()
                         * valid[..., None]).max().item()
    d_k, d_p = drift(got16), drift(plain16)
    check(d_k <= 2 * d_p, f"{name} bf16 against the fp32 plain model: "
          f"max |delta log-prob| kernels {d_k:.3e} <= 2 x plain bf16 "
          f"{d_p:.3e}")
    decided = valid & ((top2[..., 0] - top2[..., 1]) > 1e-1)
    agree = ((got16.greedy == want.greedy) & decided).sum().item()
    n_dec = int(decided.sum())
    check(agree >= 0.99 * n_dec, f"bf16 on kernels: greedy ids equal to "
          f"fp32 plain on {agree} of {n_dec} frames with fp32 top-2 margin "
          f"> 1e-1 (>= 99%)")
    return counts


def serve_tokenizer(cfg):
    """A BPE tokenizer of cfg's vocabulary (port's train_bpe): up to 128
    pieces from four sentences; a larger vocabulary (fastconformer_local's
    1024) from a seeded corpus of 700 lines over 1,400 random words, which
    holds enough pair merges to reach it."""
    from tpu_asr_torch.data.tokenizer import train_bpe
    n = cfg.decoder.num_classes
    corpus = ["the quick brown fox jumps over the lazy dog",
              "speech recognition on a graphics card",
              "conformer encoders with connectionist temporal classification",
              "a hundred and twenty eight pieces of vocabulary"] * 4
    if n > 128:
        rng = np.random.default_rng(7)
        letters = list("abcdefghijklmnopqrstuvwxyz")
        words = ["".join(rng.choice(letters, size=rng.integers(2, 9)))
                 for _ in range(1400)]
        corpus = [" ".join(rng.choice(words, size=12)) for _ in range(700)]
    tok = train_bpe(corpus, vocab_size=n)
    check(tok.vocab_size == n, f"tokenizer: {tok.vocab_size} pieces, the "
          f"model's {n} classes")
    return tok


def serve_requests():
    """The serve window: SERVE_WARMUP + SERVE_REQUESTS requests of
    SERVE_BATCH seeded waveforms of 1-15 s, drawn from a pool."""
    from tpu_asr_torch.profile_forward import waveforms
    rng = np.random.default_rng(2)
    pool = waveforms(rng, SERVE_POOL, 1.0, SECONDS)
    return [[pool[i] for i in rng.choice(SERVE_POOL, SERVE_BATCH,
                                         replace=False)]
            for _ in range(SERVE_WARMUP + SERVE_REQUESTS)]


def serve_phase(cfg, rows=None, packed=False):
    """Returns ({row: launches} for `rows` (default SERVING), RTFx). With
    `packed`, the window goes through PackedTranscriber, and the fill
    ratio and rows a request are printed."""
    from tpu_asr_torch.models.transcribe import (PackedTranscriber,
                                                 Transcriber)
    from tpu_asr_torch.profile_forward import seeded_model

    model = seeded_model(cfg, seed=2)
    tok = serve_tokenizer(cfg)
    tr = (PackedTranscriber(model, tok, pre_batch=SERVE_BATCH, device="cuda")
          if packed else
          Transcriber(model, tok, batch_size=SERVE_BATCH, device="cuda"))
    requests = serve_requests()
    for r in requests[:SERVE_WARMUP]:       # cuDNN/cuBLAS set-up per bucket
        tr.transcribe(r)
    torch.cuda.synchronize()
    requests = requests[SERVE_WARMUP:]
    read = reset_counters()
    latency, texts, plans = [], [], []
    start = time.perf_counter()
    for r in requests:
        t0 = time.perf_counter()
        texts.append(tr.transcribe(r))      # ends in a device-to-host copy
        latency.append(time.perf_counter() - t0)
        if packed:
            plans.append(tr.last_plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = {k: n for k, n in read().items() if k in (rows or SERVING)}
    audio_s = sum(len(w) for r in requests for w in r) / SR
    flat = [t for r in texts for t in r]
    check(len(flat) == SERVE_REQUESTS * SERVE_BATCH
          and all(isinstance(t, str) for t in flat),
          f"{type(tr).__name__} ({cfg.compute_dtype}) answered "
          f"{SERVE_REQUESTS} requests of {SERVE_BATCH} waveforms with "
          f"strings, e.g. {flat[0]!r}")
    check(all(v > 0 for v in counts.values()),
          f"serving path launched every kernel: {counts}")
    enc = cfg.encoder
    fill = ""
    if packed:
        fill = (f"; packed rows of {T_PACK}: fill ratio "
                f"{np.mean([p.fill_ratio for p in plans]):.4f}, rows a "
                f"request {np.mean([p.n_rows for p in plans]):.2f} "
                f"({min(p.n_rows for p in plans)}-"
                f"{max(p.n_rows for p in plans)})")
    print(f"serve{' packed' if packed else ''} (quantization "
          f"{enc.quantization}, conv {enc.conv_backend}): {SERVE_REQUESTS} "
          f"requests x {SERVE_BATCH} clips of 1-{SECONDS} s, {audio_s:.2f} s "
          f"of audio in {wall:.4f} s wall: RTFx {audio_s / wall:.1f}; per "
          f"request median {1e3 * float(np.median(latency)):.2f} ms, max "
          f"{1e3 * max(latency):.2f} ms (host clock, after "
          f"{SERVE_WARMUP} warm-up requests){fill}")
    return counts, audio_s / wall


def packed_model_phase(cfg):
    """Phase 16's checks: ModelConfig() in fp32 on 8 clips, forward_packed
    on the kernels unpacked per utterance against the per-utterance
    CTCModel forward on the kernels, and PackedTranscriber.greedy_ids;
    then in bf16 the packed ids against fp32."""
    from tpu_asr_torch.data.packing import unpack_rows
    from tpu_asr_torch.models.transcribe import PackedTranscriber
    from tpu_asr_torch.profile_forward import seeded_model

    sig_t, len_t = model_clips(1)
    clips = [sig_t[i, :int(n)].cpu().numpy() for i, n in enumerate(len_t)]
    tok = serve_tokenizer(cfg)

    def packed(model):
        tr = PackedTranscriber(model, tok, t_pack=T_PACK, device="cuda")
        plan, logp, _ = tr.packed_outputs(clips)
        return tr, plan, unpack_rows(logp.float(), plan)

    model = seeded_model(dataclasses.replace(cfg, compute_dtype="float32"),
                         seed=1)
    read = reset_counters()
    tr, plan, got = packed(model)
    counts = {k: n for k, n in read().items() if k in SERVING}
    with torch.inference_mode():
        ref = model(sig_t, len_t)
    torch.cuda.synchronize()
    check(all(v > 0 for v in counts.values()),
          f"packed forward on kernels launched every kernel: {counts}")
    lens = ref.encoded_len.cpu().numpy()
    ref_lp = ref.log_probs.cpu().numpy()
    check(np.array_equal(plan.length, lens)
          and all(np.isfinite(g).all() for g in got),
          f"{len(lens)} clips packed into {plan.n_rows} rows of {T_PACK} "
          f"(fill {plan.fill_ratio:.3f}): lengths equal, log-probs finite")
    delta = max(float(np.abs(g - ref_lp[i, :n]).max())
                for i, (g, n) in enumerate(zip(got, lens)))
    check(delta < 2e-3, f"ModelConfig() fp32 forward_packed on kernels, "
          f"unpacked, against the per-utterance forward on kernels: max "
          f"|delta log-prob| {delta:.3e} < 2e-3")
    ids = tr.greedy_ids(clips)
    top2 = np.sort(ref_lp, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    n_dec = same = 0
    for i, n in enumerate(lens):
        dec = margin[i, :n] > 1e-3
        n_dec += int(dec.sum())
        same += int((ids[i] == ref_lp[i, :n].argmax(-1))[dec].sum())
    check(same == n_dec, f"PackedTranscriber.greedy_ids equal to the "
          f"per-utterance ids on all {n_dec} frames with top-2 margin > 1e-3 "
          f"(of {int(lens.sum())})")
    model16 = seeded_model(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                           seed=1)
    _, _, got16 = packed(model16)
    n_dec = agree = 0
    for i, n in enumerate(lens):
        dec = margin[i, :n] > 1e-1
        n_dec += int(dec.sum())
        agree += int((got16[i].argmax(-1) == ref_lp[i, :n].argmax(-1))[dec]
                     .sum())
    check(agree >= 0.99 * n_dec, f"bf16 forward_packed on kernels: greedy "
          f"ids equal to fp32 on {agree} of {n_dec} frames with fp32 top-2 "
          f"margin > 1e-1 (>= 99%)")


def encoder_device_times(cfg, n_requests: int = 2):
    """The encoder layers' device time (torch.profiler), packed against
    bucketed, on the first requests of the serve window after the warm-up:
    the bucketed (32, T') batch of pre-encoded frames (the Transcriber's
    single batch of the request) and the same frames packed into rows of
    T_PACK; and each transcriber's whole request."""
    from tpu_asr_torch.data.packing import (guard_frames, pack_frames,
                                            plan_packing)
    from tpu_asr_torch.models.transcribe import (PackedTranscriber,
                                                 Transcriber, _buckets)
    from tpu_asr_torch.profile_forward import seeded_model

    model = seeded_model(cfg, seed=2)
    tok = serve_tokenizer(cfg)
    trs = (Transcriber(model, tok, batch_size=SERVE_BATCH, device="cuda"),
           PackedTranscriber(model, tok, pre_batch=SERVE_BATCH,
                             device="cuda"))
    guard = guard_frames(cfg.encoder.conv_kernel_size)
    tot = np.zeros(4)
    frames = np.zeros(2)
    pairs = np.zeros(2)
    for req in serve_requests()[SERVE_WARMUP:SERVE_WARMUP + n_requests]:
        (_, sig, ln), = _buckets(req, SERVE_BATCH, trs[0].bucket_seconds, SR)
        with torch.inference_mode():
            feats, feat_len = model.featurizer(torch.from_numpy(sig).cuda(),
                                               torch.from_numpy(ln).cuda())
            pre, pre_len = model.pre_encode(feats, feat_len)
            plan = plan_packing(pre_len.cpu().numpy(), T_PACK, guard,
                                row_multiple=4)
            packed = pack_frames(pre, plan)
            seg = torch.from_numpy(plan.seg_id).cuda()
            tot[0] += device_ms(lambda: model.encoder.encode_frames(
                pre, pre_len), iters=3)[0]
            tot[1] += device_ms(lambda: model.encoder.encode_frames(
                packed, None, seg_id=seg), iters=3)[0]
            for j, tr in enumerate(trs):
                tot[2 + j] += device_ms(lambda: tr.transcribe(req),
                                        iters=2)[0]
        frames += (pre.shape[0] * pre.shape[1], plan.n_rows * T_PACK)
        pairs += (pre.shape[0] * pre.shape[1] ** 2,
                  segment_pairs(plan.seg_id))
    tot /= n_requests
    print(f"device (torch.profiler, ms a request, mean of {n_requests} "
          f"serve requests, {cfg.compute_dtype}): encoder layers bucketed "
          f"{tot[0]:.4f}, packed {tot[1]:.4f} ({tot[1] / tot[0]:.3f}x); "
          f"whole request Transcriber {tot[2]:.4f}, PackedTranscriber "
          f"{tot[3]:.4f} ({tot[3] / tot[2]:.3f}x); encoder frames "
          f"{frames[0] / n_requests:.0f} vs {frames[1] / n_requests:.0f} "
          f"({frames[1] / frames[0]:.3f}x), score pairs a head "
          f"{pairs[0] / n_requests:.0f} vs {pairs[1] / n_requests:.0f} "
          f"({pairs[1] / pairs[0]:.3f}x)")


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


def ffn_weights(gen, d, f):
    """LN scale and bias, w1 (f, d), b1, w2 (d, f), b2: fp32, seeded."""
    return (1.0 + normal(gen, d, scale=0.1), normal(gen, d, scale=0.1),
            normal(gen, f, d, scale=d ** -0.5), normal(gen, f, scale=0.1),
            normal(gen, d, f, scale=f ** -0.5), normal(gen, d, scale=0.1))


def ffn_module_path(x, ln_w, ln_b, w1, b1, w2, b2):
    """The FFN sublayer as the port's modules compute it in x's dtype:
    LayerNorm in fp32, F.linear, SiLU, F.linear with the weights cast at
    use, the 0.5 residual; no dropout. The kernels' yardstick, timed
    beside them (forward, and autograd through it for the backward); the
    port never calls it."""
    F = torch.nn.functional
    dt = x.dtype
    y = F.layer_norm(x.float(), (x.shape[-1],), ln_w, ln_b, 1e-6).to(dt)
    h = F.silu(F.linear(y, w1.to(dt), b1.to(dt)))
    return x + 0.5 * F.linear(h, w2.to(dt), b2.to(dt))


def ffn_forward_check(x, fw, rate, seed, label):
    """fused_ffn_sublayer without gradients against the plain version on x
    (B, T, D): within fp32 1e-4 / bf16 1e-2, relative and absolute of
    max(1, |ref|). Returns (the kernel's output in fp32, max |err|)."""
    from tpu_asr_torch.ops.cuda_ffn import (ffn_sublayer_plain,
                                            fused_ffn_sublayer)
    dt = x.dtype
    with torch.no_grad():
        got = fused_ffn_sublayer(x, *fw, rate, seed).float()
        want = ffn_sublayer_plain(x, *fw, rate, seed).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    rtol, atol = ((1e-4, 1e-4 * max(1.0, ref)) if dt == torch.float32
                  else (1e-2, 1e-2 * max(1.0, ref)))
    check(torch.allclose(got, want, rtol=rtol, atol=atol),
          f"ffn {str(dt)[6:]} dropout {rate} {label}: max |err| {err:.3e} "
          f"(rtol {rtol}, atol {atol:.3g})")
    return got, err


def ffn_small_ring(fn, kernel, label):
    """Every launch of `kernel` in fn() ran on ffn.cu's Small weight ring
    (Cfg<64, 64, 2>, taken where the row tiles leave no room for Big);
    prints fn's device time."""
    dev, names = profiled_kernels(fn, kernel, iters=2)
    rings = {"Small" if "Cfg<64, 64, 2>" in k else "Big"
             for k in names if kernel in k}
    check(rings == {"Small"}, f"{label}: {kernel} ran on the Small ring "
          f"({DEVICE}: {dev:.4f}, {top_kernels(names, 3)})")


def ffn_compare(x, g, fw, rate, seed, label):
    """fused_ffn_sublayer and its backward against the plain version on x
    (B, T, D) for the cotangent g: the output within fp32 1e-4 / bf16 1e-2
    (relative, and absolute of max(1, |ref|)), the gradients by
    grads_close at 1e-3 / 1e-4 (fp32) or 5e-2 / 1e-2 (bf16), two backward
    calls bit-equal. Returns (forward row, backward row, the backward
    call) with rows (max_abs_err, ms, plain_ms, bound, None); prints the
    module path's times beside the kernels'."""
    from tpu_asr_torch.ops.cuda_ffn import (ffn_sublayer_plain,
                                            fused_ffn_sublayer,
                                            fused_ffn_sublayer_bwd)
    dt = x.dtype
    dts = str(dt)[6:]
    b, t, d = x.shape
    f = fw[2].shape[0]
    got, err = ffn_forward_check(x, fw, rate, seed, label)
    leaves = [z.detach().requires_grad_() for z in (x, *fw)]
    out_k = fused_ffn_sublayer(*leaves, rate, seed)
    got_g = torch.autograd.grad(out_k, leaves, g, retain_graph=True)
    leaves_p = [z.detach().requires_grad_() for z in (x, *fw)]
    out_p = ffn_sublayer_plain(*leaves_p, rate, seed)
    want_g = torch.autograd.grad(out_p, leaves_p, g, retain_graph=True)
    torch.cuda.synchronize()
    tol, floor = (1e-3, 1e-4) if dt == torch.float32 else (5e-2, 1e-2)
    print(f"ffn_bwd {dts} dropout {rate} {label}, kernels vs plain:")
    err_abs, _ = grads_close(got_g, want_g, tol, FFN_GRADS, floor)
    saved = out_k.grad_fn.saved_tensors
    bwd = lambda: fused_ffn_sublayer_bwd(*saved, g, rate, seed)
    check(all(torch.equal(a, b_) for a, b_ in zip(bwd(), bwd())),
          f"ffn_bwd {dts} {label}: two calls give bit-equal gradients")
    with torch.no_grad():
        fwd_row = (err, median_ms(lambda: fused_ffn_sublayer(x, *fw, rate,
                                                             seed)),
                   median_ms(lambda: ffn_sublayer_plain(x, *fw, rate, seed)),
                   bound(4 * b * t * d * f,
                         nbytes(x, *fw) + got.numel() * x.element_size(),
                         dts), None)
        module_ms = median_ms(lambda: ffn_module_path(x, *fw))
    bwd_row = (err_abs, median_ms(bwd),
               median_ms(lambda: torch.autograd.grad(out_p, leaves_p, g,
                                                     retain_graph=True)),
               bound(10 * b * t * d * f, nbytes(x, g, *fw) + nbytes(*got_g),
                     dts), None)
    leaves_m = [z.detach().requires_grad_() for z in (x, *fw)]
    out_m = ffn_module_path(*leaves_m)
    module_bwd_ms = median_ms(lambda: torch.autograd.grad(
        out_m, leaves_m, g, retain_graph=True))
    print(f"time ffn {dts} {label}: kernel {fwd_row[1]:.4f} ms, module path "
          f"(LN + two F.linear + SiLU) {module_ms:.4f} ms; ffn_bwd kernel "
          f"{bwd_row[1]:.4f} ms, autograd through the module path "
          f"{module_bwd_ms:.4f} ms (median of 20, CUDA events)")
    return fwd_row, bwd_row, bwd


def train_kernel_phase(tcfg):
    """Each training kernel against its plain version at the student's
    shapes. Returns {name: (max_abs_err, ms, plain_ms, bound, library_ms)}
    for the kernels new to training, in the main path's dtype (bf16, CTC
    fp32); the student's subsampling and attention forward are printed
    (their JSON rows keep the serving shapes)."""
    from tpu_asr_torch.config import make_student_config
    from tpu_asr_torch.models.conformer import (ConformerLayer,
                                                rel_positional_encoding)
    from tpu_asr_torch.ops.cuda_attention import (
        fused_relpos_attention_block, fused_relpos_attention_block_bwd,
        relpos_attention_plain)
    from tpu_asr_torch.ops.cuda_ffn import fused_ffn_sublayer
    from tpu_asr_torch.ops.cuda_subsampling import (fused_subsampling,
                                                    out_len, subsampling_plain)

    scfg = make_student_config(tcfg)
    gen = torch.Generator(device="cuda").manual_seed(3)
    enc, pre = scfg.encoder, scfg.preprocessor
    d, h, f = enc.d_model, enc.n_heads, enc.d_ff
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
    pw = attention_weights(gen, d, h)
    pos_emb = rel_positional_encoding(t, d, "cuda")
    lengths = torch.randint(t // 4, t + 1, (BATCH,), generator=gen,
                            device="cuda")
    lengths[0] = t
    mask = torch.arange(t, device="cuda")[None, :] < lengths[:, None]
    valid = mask[..., None]
    xa = normal(gen, BATCH, t, d, scale=0.5)
    ga = normal(gen, BATCH, t, d) * valid
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
        err_abs, _ = grads_close(got_g, want_g, tol, ATT_GRADS, floor)
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

    dev, names = device_ms(bwd)
    print(f"device attention_bwd bfloat16 ({DEVICE}): {dev:.4f} "
          f"({top_kernels(names, 9)})")
    long_attention_bwd(pw, h, rate, seed)

    # FFN forward and backward: the student's width at B=32, the teacher's
    # (d176/704) at B=8, and a width the kernels refuse in training
    fw = ffn_weights(gen, d, f)
    xf = normal(gen, BATCH, t, d)
    gf = normal(gen, BATCH, t, d)
    for dt in (torch.float32, torch.bfloat16):
        dts = str(dt)[6:]
        per_dt["ffn"][dts], per_dt["ffn_bwd"][dts], bwd = ffn_compare(
            xf.to(dt), gf.to(dt), fw, rate, seed,
            f"(B={BATCH}, T={t}, D={d}, d_ff={f})")
    xb = xf.to(torch.bfloat16)
    dev, names = device_ms(lambda: fused_ffn_sublayer(xb, *fw, rate, seed))
    dev_b, names_b = device_ms(bwd)
    print(f"device ffn bfloat16 ({DEVICE}): {dev:.4f} "
          f"({top_kernels(names, 1)}); ffn_bwd {dev_b:.4f} "
          f"({top_kernels(names_b, 3)})")
    tw = ffn_weights(gen, 2 * d, 2 * f)
    xt, gt = normal(gen, 8, t, 2 * d), normal(gen, 8, t, 2 * d)
    for dt in (torch.float32, torch.bfloat16):
        ffn_compare(xt.to(dt), gt.to(dt), tw, rate, seed,
                    f"teacher width (B=8, T={t}, D={2 * d}, d_ff={2 * f})")
    # d256/1024, the widest JAX's ffn_train_kernel_fits admits: the
    # backward's row tiles leave no room for the Big ring, so it runs on
    # Small; at d320/1280 the forward runs on Small too, and autograd is
    # refused (only the backward's tiles exceed shared memory)
    ww = ffn_weights(gen, 256, 1024)
    xw, gw = normal(gen, 4, t, 256), normal(gen, 4, t, 256)
    nw = ffn_weights(gen, 320, 1280)
    xn = normal(gen, 4, t, 320)
    for dt in (torch.float32, torch.bfloat16):
        dts = str(dt)[6:]
        label = f"(B=4, T={t}, D=256, d_ff=1024)"
        _, _, bwd_w = ffn_compare(xw.to(dt), gw.to(dt), ww, rate, seed,
                                  label)
        ffn_small_ring(bwd_w, "ffn_bwd_rows_kernel",
                       f"ffn_bwd {dts} {label}")
        xnd = xn.to(dt)
        label = f"(B=4, T={t}, D=320, d_ff=1280)"
        ffn_forward_check(xnd, nw, rate, seed, label)
        ffn_small_ring(lambda: fused_ffn_sublayer(xnd, *nw, rate, seed),
                       "ffn_fwd_kernel", f"ffn {dts} {label}")
        xg = xnd[:1, :4].clone().requires_grad_()
        refused(lambda: fused_ffn_sublayer(xg, *nw, rate, seed),
                f"autograd through fused_ffn_sublayer {dts} at D=320, "
                f"d_ff=1280 (the backward's tiles exceed shared memory)")
    big = ffn_weights(gen, 512, 2048)
    refused(lambda: fused_ffn_sublayer(
        normal(gen, 1, 4, 512).to(torch.bfloat16).requires_grad_(), *big,
        rate, seed), "autograd through fused_ffn_sublayer at D=512, "
        "d_ff=2048 (the forward's tiles exceed shared memory)")
    # the 'auto' route of a training ConformerLayer at the teacher's width
    # takes the kernel, as JAX's ffn_train_kernel_fits admits d176/704
    layer = ConformerLayer(tcfg.encoder).cuda().to(torch.bfloat16)
    xl = normal(gen, 2, t, tcfg.encoder.d_model).to(
        torch.bfloat16).requires_grad_()
    before = fused_ffn_sublayer.launches
    layer._ffn(layer.norm_feed_forward1, layer.feed_forward1, xl, seed)
    check(tcfg.encoder.ffn_backend == "auto"
          and layer.ffn_train_uses_kernel(xl, layer.feed_forward1)
          and fused_ffn_sublayer.launches == before + 1,
          f"'auto' training route at D={tcfg.encoder.d_model}, d_ff="
          f"{tcfg.encoder.d_ff} takes the FFN kernel")

    # CTC forward and backward, fp32
    ctc_rows, lp, tg = ctc_kernel_phase(gen)
    results.update(ctc_rows)

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


def ctc_case(lp, tg, il, tl, blank, label, gen):
    """The CTC kernels against their own plain versions on one input, fp32:
    the forward's alpha lattice (the frames it runs, positions < 2S+1) and
    NLL against ctc_alpha_plain; the backward's d log-probs against
    ctc_nll_bwd_plain fed the kernel's own saved alpha and NLL, under a
    cotangent g in [0.5, 2); two backward calls bit-equal; an impossible
    alignment's rows exactly 0. Returns (d log-probs max |err|, NLL max
    |err|, the saved forward, g)."""
    from tpu_asr_torch.ops.cuda_ctc import (ctc_alpha_plain, ctc_nll,
                                            ctc_nll_bwd, ctc_nll_bwd_plain)

    b, t, _ = lp.shape
    l = 2 * tg.shape[1] + 1
    before = ctc_nll.launches
    leaf = lp.detach().requires_grad_()
    nll_k = ctc_nll(leaf, tg, il, tl, blank)
    saved = nll_k.grad_fn.saved_tensors
    with torch.no_grad():
        alpha_p, nll_p = ctc_alpha_plain(lp, tg, il, tl, blank)
    torch.cuda.synchronize()
    rows = (torch.arange(t, device="cuda")[None, :]
            < il.clamp(min=1, max=t)[:, None])
    ak, ap = saved[4][:, :, :l][rows], alpha_p[rows]
    nll_k = nll_k.detach()
    a_err = (ak - ap).abs().max().item()
    n_err = (nll_k - nll_p).abs().max().item()
    # the kernel's log-sum-exp rounds another way (ex2/lg2.approx, ~2 ulp,
    # and the largest term's exp taken as 1): each step adds fp32 rounding
    # of the lattice's magnitude, the NLL check's rule
    check(ctc_nll.launches == before + 1
          and torch.allclose(ak, ap, rtol=1e-5, atol=1e-3)
          and torch.allclose(nll_k, nll_p, rtol=1e-5, atol=1e-3),
          f"ctc fp32 {label}: the kernel launched; alpha (t < ilen) max "
          f"|err| {a_err:.3e}, NLL {n_err:.3e} against ctc_alpha_plain "
          f"(rtol 1e-5, atol 1e-3)")
    g = torch.rand(b, generator=gen, device="cuda") * 1.5 + 0.5
    got = ctc_nll_bwd(*saved, g, blank)
    want = ctc_nll_bwd_plain(lp, tg, il, tl, saved[4], nll_k, g, blank)
    again = ctc_nll_bwd(*saved, g, blank)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    # the same algorithm: beta carries fp32 rounding of its magnitude
    # (~|NLL|) at each of the T steps into the posterior's exponent, as in
    # the check against autograd, times the largest cotangent
    fin = nll_p[nll_p < 1e29]
    tol = 4 * 2.0 ** -24 * fin.abs().max().item() * math.sqrt(t) * 2.0
    dead = nll_p >= 1e29
    check(torch.isfinite(got).all() and err < tol
          and torch.equal(got, again)
          and bool((got[dead] == 0).all()),
          f"ctc_bwd fp32 {label}: d log-probs max |err| {err:.3e} < "
          f"{tol:.3e} against ctc_nll_bwd_plain, two calls bit-equal, "
          f"{int(dead.sum())} impossible row(s) exactly 0")
    return err, n_err, saved, g


def ctc_route(lp, tg, il, tl, blank, label, gen):
    """ctc_case, then the device time a launch of each kernel, checked to
    be the template its 2S+1 picks (P = 4, 8 or 32 positions a lane)."""
    from tpu_asr_torch.ops.cuda_ctc import ctc_nll, ctc_nll_bwd

    l = 2 * tg.shape[1] + 1
    p = 4 if l <= 128 else 8 if l <= 256 else 32
    *_, saved, g = ctc_case(lp, tg, il, tl, blank, label, gen)
    pick = lambda names, k: [ms for n, ms in names.items() if k in n]
    with torch.no_grad():
        _, fwd = profiled_kernels(lambda: ctc_nll(lp, tg, il, tl, blank),
                                  "ctc_fwd_kernel")
    _, bwd = profiled_kernels(lambda: ctc_nll_bwd(*saved, g, blank),
                              "ctc_bwd_kernel")
    f = pick(fwd, f"ctc_fwd_kernel<{p}>")
    b = pick(bwd, f"ctc_bwd_kernel<{p}>")
    check(len(f) == 1 and len(b) == 1,
          f"ctc {label}: 2S+1 = {l} runs ctc_fwd_kernel<{p}> "
          f"{f[0] if f else float('nan'):.4f} ms and ctc_bwd_kernel<{p}> "
          f"{b[0] if b else float('nan'):.4f} ms a launch ({DEVICE})")


def ctc_kernel_phase(gen=None):
    """The CTC kernels, fp32: ptxas registers and spills of each template
    (none may spill); at the student's main shape (B=32, T'=376, V=129,
    S=48) the NLL against ctc_nll_plain and d log-probs against autograd
    through it (the analytic posterior against autograd: the bound below),
    then each kernel against its own plain version (ctc_case); the same at
    the packed_train bucket's T'=418, at 2S+1 = 201 (P = 8; int32 indices,
    short inputs, an empty target, an impossible alignment) and at 2S+1 =
    1023 (P = 32, T'=1100), each through the template its 2S+1 picks, and
    a batch with no labels (S = 0).
    Returns ({"ctc": row, "ctc_bwd": row}, the main log-probs, targets)."""
    import torch.nn.functional as F

    from tpu_asr_torch.config import ModelConfig, make_student_config
    from tpu_asr_torch.ops.cuda_ctc import (ctc_nll, ctc_nll_bwd,
                                            ctc_nll_bwd_plain, ctc_nll_plain)
    from tpu_asr_torch.ops.cuda_subsampling import out_len

    gen = gen or torch.Generator(device="cuda").manual_seed(3)
    scfg = make_student_config(ModelConfig())
    t = out_len(out_len(SECONDS * SR // scfg.preprocessor.hop_length + 1))
    v = scfg.decoder.num_classes + 1
    blank = v - 1
    regs = nvcc_registers("ctc_")
    check(len(regs) == 6 and all(st == 0 and ld == 0
                                 for _, st, ld in regs.values()),
          f"ptxas: the 6 CTC kernels (fwd and bwd at P = 4, 8, 32) do not "
          f"spill: {regs}")

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

    results = {}
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
          f"{tol:.3e} against autograd through ctc_nll_plain (max|NLL| "
          f"{want.abs().max().item():.1f}, T={t})")
    bwd_err, _, saved, g = ctc_case(
        lp, tg, il, tl, blank, f"(B={BATCH}, T={t}, S={TOKENS})", gen)
    ones = torch.ones(BATCH, device="cuda")
    # bytes: lp and the alpha lattice read once, d log-probs written once
    results["ctc_bwd"] = (
        bwd_err, median_ms(lambda: ctc_nll_bwd(*saved, ones, blank)),
        median_ms(lambda: ctc_nll_bwd_plain(lp, tg, il, tl, saved[4],
                                            saved[5], ones, blank), iters=5),
        bound(lse_flops + 4 * BATCH * t * l,
              2 * nbytes(lp) + 4 * BATCH * t * l, "float32"),
        median_ms(lambda: library(True)))
    auto_ms = median_ms(lambda: torch.autograd.grad(
        nll_p.sum(), leaf_p, retain_graph=True), iters=5)
    print(f"time ctc_bwd float32: autograd through ctc_nll_plain "
          f"{auto_ms:.4f} ms (median of 5, CUDA events)")
    with torch.no_grad():
        dev_f, names_f = device_ms(lambda: ctc_nll(lp, tg, il, tl))
    dev_b, names_b = device_ms(lambda: ctc_nll_bwd(*saved, ones, blank))
    print(f"device ctc float32 ({DEVICE}): {dev_f:.4f} "
          f"({top_kernels(names_f, 2)}); ctc_bwd {dev_b:.4f} "
          f"({top_kernels(names_b, 2)}); {t - 1} dependent steps")

    # the packed_train bucket's T' (16.7 s), then the other templates
    tp = out_len(out_len(int(16.7 * SR) // scfg.preprocessor.hop_length + 1))
    lp2 = torch.log_softmax(normal(gen, BATCH, tp, v, scale=2.0), dim=-1)
    tg2 = torch.randint(0, blank, (BATCH, TOKENS), generator=gen,
                        device="cuda")
    ctc_route(lp2, tg2, torch.full((BATCH,), tp, device="cuda"),
              torch.full((BATCH,), TOKENS, device="cuda"), blank,
              f"packed_train bucket (B={BATCH}, T={tp}, S={TOKENS})", gen)
    s = 100
    tg3 = torch.randint(0, blank, (4, s), generator=gen, device="cuda",
                        dtype=torch.int32)
    tg3[0, 5] = tg3[0, 4]                              # a repeated label
    ctc_route(lp2[:4].contiguous(), tg3,
              torch.tensor([tp, 300, 60, tp], device="cuda",
                           dtype=torch.int32),
              torch.tensor([s, 90, s, 0], device="cuda", dtype=torch.int32),
              blank, f"2S+1 = {2 * s + 1} (B=4, T={tp}, input lengths "
              f"[{tp}, 300, 60, {tp}], target lengths [{s}, 90, {s}, 0], "
              f"int32)", gen)
    ctc_case(lp2[:4].contiguous(), tg3[:, :0], torch.tensor(
        [tp, 300, 60, 1], device="cuda"), torch.zeros(4, device="cuda",
                                                     dtype=torch.int64),
             blank, f"S=0 (B=4, T={tp}, no labels)", gen)
    s, tlong = 511, LONG_T
    lp4 = torch.log_softmax(normal(gen, 3, tlong, v, scale=2.0), dim=-1)
    tg4 = torch.randint(0, blank, (3, s), generator=gen, device="cuda")
    ctc_route(lp4, tg4, torch.tensor([tlong, 700, tlong], device="cuda"),
              torch.tensor([s, 300, 1], device="cuda"), blank,
              f"2S+1 = {2 * s + 1} (B=3, T={tlong}, input lengths [{tlong}, "
              f"700, {tlong}], target lengths [{s}, 300, 1])", gen)
    return results, lp, tg


def long_attention_bwd(pw, h, rate, seed, t=LONG_T):
    """The block attention backward at a T beyond the fp32 kernel's
    shared-memory limit (T <= 1024 at dk 44), which the bf16 kernels take:
    bf16, B=2 (one row padded), dropout, against the plain version by phase
    6's gradient rule, and bit-equal on two calls."""
    from tpu_asr_torch.models.conformer import rel_positional_encoding
    from tpu_asr_torch.ops.cuda_attention import (
        attention_refusal, fused_relpos_attention_block,
        fused_relpos_attention_block_bwd, relpos_attention_plain)

    d = pw[0].shape[0]
    check(attention_refusal(torch.float32, d, h, t, True) is not None
          and attention_refusal(torch.bfloat16, d, h, t, True) is None,
          f"attention_bwd at T={t}: refused in fp32 (shared memory), taken "
          f"in bf16")
    gen = torch.Generator(device="cuda").manual_seed(8)
    mask = torch.arange(t, device="cuda")[None, :] < torch.tensor(
        [[t], [t - 173]], device="cuda")
    valid = mask[..., None]
    x = normal(gen, 2, t, d, scale=0.5).to(torch.bfloat16)
    g = (normal(gen, 2, t, d) * valid).to(torch.bfloat16)
    pos_emb = rel_positional_encoding(t, d, "cuda")
    leaves = [z.detach().requires_grad_() for z in (x, *pw)]
    out_k = fused_relpos_attention_block(*leaves, pos_emb, mask, h,
                                         dropout_rate=rate, dropout_seed=seed)
    got = torch.autograd.grad(out_k, leaves, g, retain_graph=True)
    leaves_p = [z.detach().requires_grad_() for z in (x, *pw)]
    out_p = relpos_attention_plain(*leaves_p, pos_emb, mask, h, rate, seed)
    want = torch.autograd.grad(out_p, leaves_p, g)
    torch.cuda.synchronize()
    print(f"attention_bwd bfloat16 T={t} (B=2) dropout {rate}, kernels vs "
          f"plain:")
    grads_close(got, want, 5e-2, ATT_GRADS, 1e-2, verbose=False)
    saved = out_k.grad_fn.saved_tensors
    bwd = lambda: fused_relpos_attention_block_bwd(g, *saved, h, rate, seed)
    check(all(torch.equal(a, b) for a, b in zip(bwd(), bwd())),
          f"attention_bwd bfloat16 T={t}: two calls give bit-equal gradients")


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


def train_batch(batch: int, seed: int, seconds: int = SECONDS):
    rng = np.random.default_rng(seed)
    return {
        "signal": torch.from_numpy(rng.normal(size=(batch, seconds * SR))
                                   .astype(np.float32) * 0.1).cuda(),
        "signal_len": torch.full((batch,), seconds * SR, device="cuda"),
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
    from tpu_asr_torch.config import make_student_config

    scfg = make_student_config(tcfg)
    model = student(dataclasses.replace(scfg, compute_dtype="float32"), 4)
    fp32_step_check(model, train_batch(CHECK_BATCH, 5), 7,
                    f"fp32 student train step (16 layers, B={CHECK_BATCH} x "
                    f"{SECONDS} s, dropout {scfg.encoder.dropout}, "
                    f"SpecAugment, dither)")

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


def step_run(model, batch, seed: int):
    """One train step of `model` from a fresh AdamW state: (metrics,
    {parameter: grad}, {BatchNorm running statistic}, {parameter after the
    step})."""
    from tpu_asr_torch.config import OptimConfig
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step)
    state = DistilTrainState.create(model, OptimConfig())
    state, metrics = make_distil_train_step(model)(state, batch, seed)
    torch.cuda.synchronize()
    return (metrics,
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: b.clone() for n, b in model.named_buffers()
             if "running" in n},
            {n: p.detach().clone() for n, p in model.named_parameters()})


def fp32_step_check(model, batch, seed: int, label: str) -> None:
    """One fp32 train step of `model` on the kernels and on the plain
    versions from the same weights and seeds: the loss within 1e-4
    relative, every gradient within 1e-2 of its tensor's scale (floor 1e-4
    of the largest), the BatchNorm running statistics within 1e-4 and the
    parameters after AdamW within 1e-5."""
    import copy

    from tpu_asr_torch.profile_forward import set_backend

    init = copy.deepcopy(model.state_dict())
    runs = {}
    for backend in ("auto", "xla"):
        model.load_state_dict(init)
        set_backend(model, backend)
        metrics, *rest = step_run(model, batch, seed)
        runs[backend] = (metrics["loss/total"].item(), *rest)
    set_backend(model, "auto")
    (lk, gk, sk, pk), (lp, gp, sp, pp) = runs["auto"], runs["xla"]
    check(math.isfinite(lk) and abs(lk - lp) <= 1e-4 * abs(lp),
          f"{label}: loss kernels {lk:.6f} vs plain {lp:.6f}")
    # fp32 sums in another order through every layer's backward, and the
    # CTC kernel's analytic posterior against autograd through the scan
    print("fp32 train step gradients, kernels vs plain:")
    grads_close(list(gk.values()), list(gp.values()), 1e-2, list(gk), 1e-4,
                verbose=False)
    err_bn = max((sk[n] - sp[n]).abs().max().item() for n in sk)
    check(err_bn < 1e-4, f"BatchNorm running statistics after the step: max "
          f"|err| {err_bn:.3e} < 1e-4")
    err_p = max((pk[n] - pp[n]).abs().max().item() for n in pk)
    check(err_p < 1e-5, f"parameters after the AdamW step: max |err| "
          f"{err_p:.3e} < 1e-5")


def timed_steps(model, batch, seed: int, steps: int = TRAIN_STEPS,
                warmup: int = TRAIN_WARMUP, device: bool = False):
    """`warmup` steps, then the launch counters and the peak memory reset
    and `steps` steps timed on the host clock up to a final synchronize.
    Returns (ms per step, {row: launches}, [metrics]); with `device`, then
    (device ms, {kernel: ms}) of one more step in torch.profiler after the
    counters are read (profile_forward.device_activity), as a fourth
    element."""
    from tpu_asr_torch.config import OptimConfig
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step)
    state = DistilTrainState.create(model, OptimConfig())
    step = make_distil_train_step(model)
    for _ in range(warmup):
        state, _ = step(state, batch, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = reset_counters()
    metrics = []
    start = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch, seed)
        metrics.append(m)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - start) / steps
    counts = read()
    if not device:
        return ms, counts, metrics
    from torch.profiler import ProfilerActivity, profile

    from tpu_asr_torch.profile_forward import device_activity, mark_call
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mark_call()
        step(state, batch, seed)
        torch.cuda.synchronize()
    busy, _, names = device_activity(prof, 1)
    return ms, counts, metrics, (busy, {k: v for k, (v, _) in names.items()})


def timed_summary(ms: float, steps: int = TRAIN_STEPS,
                  warmup: int = TRAIN_WARMUP, rows: int = BATCH) -> str:
    return (f"{ms:.2f} ms per step, {rows * SECONDS / (ms / 1e3):.1f} audio "
            f"s per s (host clock over {steps} steps after {warmup} "
            f"warm-up), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")


def fm_inputs(gen, rows, t, max_steps, steps=None, c=88, h=128):
    """x0, steps, w1x, a, c, w2, b2 of the Euler loop at C features and H
    hidden units (the flagship's C=88, H=128 by default)."""
    if steps is None:
        steps = torch.full((rows,), max_steps, device="cuda")
    return (normal(gen, rows, t, c), steps, normal(gen, c, h, scale=c ** -0.5),
            normal(gen, h, scale=0.3), normal(gen, h, scale=0.1),
            normal(gen, h, c, scale=h ** -0.5), normal(gen, c, scale=0.1))


def fm_dx_close(dx_k, dx_p, gtol, what):
    """Phase 8's rule for dx0: at most 1e-4 of the elements beyond gtol x
    max|ref| (where a pre-activation lies within the rounding of 0, sums in
    another order take the other side of the relu, and that position's
    gradient moves by a whole dh W1x term; the weight gradients sum over
    all positions). Returns the largest |err|."""
    dx_k, dx_p = dx_k.float(), dx_p.float()
    scale = dx_p.abs().max().item()
    diff = (dx_k - dx_p).abs()
    over = int((diff > gtol * scale).sum())
    check(over <= 1e-4 * diff.numel(),
          f"{what} dx0: {over} of {diff.numel()} elements beyond {gtol} x "
          f"max|ref| {scale:.3e} (max |err| {diff.max().item():.3e}; at "
          f"most 1e-4 of them)")
    return diff.max().item()


def fm_compare(args, max_steps, dt, label, time_it=False, explicit=False):
    """fused_fm_euler (forward and backward) against fm_euler_plain on the
    same inputs in compute dtype dt; returns (fwd row, bwd row) when
    time_it, as train_kernel_phase's rows, and prints the device time per
    launch of each beside them. `explicit`: the backward also against
    fm_euler_bwd_plain (the kernels' rounding points), by the same rules."""
    from tpu_asr_torch.ops.cuda_fm import (fm_euler_bwd_plain, fm_euler_plain,
                                           fused_fm_euler,
                                           fused_fm_euler_bwd)
    dts = str(dt)[6:]
    x0, steps, *w = args
    x0 = x0.to(dt)
    c, h = w[0].shape
    label = f"{label} C={c} H={h}"
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
    names = ["dw1x", "da", "dc", "dw2", "db2"]
    err_dx = fm_dx_close(g_k[0], g_p[0], gtol, f"fm_bwd {label} {dts}")
    print(f"fm_bwd {label} {dts}, weight gradients, kernels vs plain:")
    err_w, _ = grads_close(g_k[1:], g_p[1:], gtol, names, floor)
    err_bwd = max(err_w, err_dx)
    saved = out_k[0].grad_fn.saved_tensors
    bwd = lambda: fused_fm_euler_bwd(*saved, gx, gv, max_steps)
    got = bwd()
    check(all(torch.equal(a, b) for a, b in zip(got, bwd())),
          f"fm_bwd {label} {dts}: two calls give bit-equal gradients")
    if explicit:
        want = fm_euler_bwd_plain(*saved, gx, gv, max_steps)
        what = f"fm_bwd {label} {dts} vs fm_euler_bwd_plain"
        err_dx = fm_dx_close(got[0], want[0], gtol, what)
        print(f"{what}, weight gradients:")
        err_w, _ = grads_close(got[1:], want[1:], gtol, names, floor)
        err_bwd = max(err_bwd, err_w, err_dx)
    if not time_it:
        return None
    # the work this run's data needs: min(n, max_steps) steps per row
    row_steps = steps.clamp(min=1, max=max_steps).sum().item()
    mac = x0.shape[1] * c * h * row_steps
    n_bytes = nbytes(x0, *w) + 2 * nbytes(x0)
    fwd_call = lambda: fused_fm_euler(x0, steps, *w, **kw)
    fwd = (max(errs), median_ms(fwd_call),
           median_ms(lambda: fm_euler_plain(x0, steps, *w, **kw), iters=5),
           bound(4 * mac, n_bytes, dts), None)
    plain_bwd = lambda: torch.autograd.grad(out_p, leaves_p, (gx, gv),
                                            retain_graph=True)
    bwd_row = (err_bwd, median_ms(bwd), median_ms(plain_bwd, iters=5),
               bound(12 * mac, nbytes(x0, gx, gv, *w) + nbytes(*g_k), dts),
               None)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bwd()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    # retried while the profiler drops every event of the kernels
    with torch.no_grad():
        fwd_dev = profiled_kernels(fwd_call, "fm_fwd")
    bwd_dev = profiled_kernels(bwd, "fm_bwd")
    for name, row, (dev_ms, names) in (("fm", fwd, fwd_dev),
                                       ("fm_bwd", bwd_row, bwd_dev)):
        print(f"time {name} {dts} ({label}): kernel {row[1]:.4f} ms, device "
              f"{dev_ms:.4f} ms a call ({top_kernels(names, 4)} a launch), "
              f"plain "
              f"{row[2]:.4f} ms, bound {row[3][0]:.4f} ms ({row[3][1]}) "
              f"(median of 20, plain of 5, CUDA events; torch.profiler)")
    print(f"fm_bwd {dts} ({label}): {peak:.1f} MiB allocated by one call "
          f"beyond its inputs (scratch and outputs)")
    return fwd, bwd_row


def nvcc_registers(prefix: str):
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    ptxas (nvcc.log of the built library, -Xptxas -v) for each kernel whose
    name starts with `prefix`, each printed."""
    import re

    from tpu_asr_torch.ops import _kernels
    from tpu_asr_torch.profile_forward import short_symbol
    log = (_kernels.build().parent / "nvcc.log").read_text()
    out, name, spills = {}, None, (-1, -1)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = short_symbol(m.group(1)), (-1, -1)
            continue
        if name is None or not name.startswith(prefix):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name] = (int(m.group(1)), *spills)
            print(f"ptxas {name}: {m.group(1)} registers, spill stores "
                  f"{spills[0]} B, loads {spills[1]} B")
            name = None
    return out


def fm_kernel_phase():
    """The FM kernels against their plain version at the flagship KD
    shapes, fp32 and bf16, a ragged case, bf16 at two other widths, and
    the refused shapes. Returns {"fm": row, "fm_bwd": row} in bf16 (the
    main path's dtype)."""
    from tpu_asr_torch.ops.cuda_fm import fused_fm_euler

    regs = nvcc_registers("fm_")
    check(len(regs) >= 7 and all(st == 0 and ld == 0
                                 for _, st, ld in regs.values()),
          f"ptxas: {len(regs)} FM kernels, none spills")
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
    fm_compare(fm_inputs(gen, 64, t, ms, c=64, h=64), ms, torch.bfloat16,
               f"rows=64 T={t} steps={ms}", time_it=True)
    fm_compare(fm_inputs(gen, 48, t, 16, ragged, c=128, h=256), 16,
               torch.bfloat16,
               f"rows=48 T={t} per-row steps 1..16, max_steps 16",
               time_it=True)
    x0, steps, w1, a, c, w2, b2 = fm_inputs(gen, 4, 9, 8)
    x520, _, w520, _, _, w2_520, b520 = fm_inputs(gen, 4, 9, 8, c=520)
    x90, _, w90, _, _, w2_90, b90 = fm_inputs(gen, 4, 9, 8, c=90)
    for label, dt, args, ms_ in (
            ("fp32 C=90", torch.float32,
             (x90, steps, w90, a, c, w2_90, b90), 8),
            ("bf16 C=520", torch.bfloat16,
             (x520, steps, w520, a, c, w2_520, b520), 8),
            ("bf16 H=48", torch.bfloat16,
             (x0, steps, w1[:, :48], a[:48], c[:48], w2[:48], b2), 8),
            ("bf16 max_steps 0", torch.bfloat16,
             (x0, steps, w1, a, c, w2, b2), 0)):
        refused(lambda: fused_fm_euler(*args, max_steps=ms_,
                                       compute_dtype=dt),
                f"fused_fm_euler at {label}")
    for name, i in (("fm", 0), ("fm_bwd", 1)):
        for dt, rows_ in per_dt.items():
            err, ms_, plain_ms, (b_ms, by), _ = rows_[i]
            print(f"time {name} {str(dt)[6:]}: kernel {ms_:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) (median "
                  f"of 20, plain of 5, CUDA events)")
    return {"fm": per_dt[torch.bfloat16][0],
            "fm_bwd": per_dt[torch.bfloat16][1]}


def kd_model(scfg, tcfg, seed: int, distill):
    """DistilCTCModel with the DistillationConfig `distill`, seeded
    weights, on the card."""
    from tpu_asr_torch.models.distil_model import DistilCTCModel
    from tpu_asr_torch.profile_forward import seed_weights
    return seed_weights(DistilCTCModel(scfg, tcfg, distill), seed).cuda()


def loss_names(d) -> set:
    """The losses a DistillationConfig `d` gives in training."""
    from tpu_asr_torch.kd.diffm import LOSSES
    names = {"ctc", "total"}
    names |= {"flow_matching"} if d.use_flow_matching else set()
    names |= ({"router"} if d.use_flow_matching and d.flow.use_dynamic_steps
              else set())
    names |= {"logit_kd"} if d.use_logit_distillation else set()
    names |= {"layer_kd"} if d.use_layerwise_distillation else set()
    names |= {"diffkd"} if d.use_diffkd else set()
    names |= {f"diffm/{k}" for k in LOSSES} if d.use_diffm else set()
    return names


def router_steps(model):
    """A forward hook on model.router keeping each call's (steps, logits);
    returns (the list, the hook's handle)."""
    calls = []
    handle = model.router.register_forward_hook(
        lambda m, args, out: calls.append((out[0].detach(),
                                           out[2]["logits"].detach())))
    return calls, handle


def router_flips(steps_k, steps_p, scores_p, label: str) -> None:
    """Step counts of a kernels run against a plain run drawn from the
    same generators: equal wherever the plain run's top-2 margin of the
    scores (logits + Gumbel noise in training, logits in eval) exceeds
    1e-3; the rows under that margin are printed."""
    top2 = scores_p.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 1e-3
    differ = steps_k != steps_p
    check(not bool((differ & decided).any()),
          f"{label}: router step counts of kernels and plain equal on all "
          f"{int(decided.sum())} of {decided.numel()} rows whose plain top-2 "
          f"margin exceeds 1e-3")
    print(f"{label}: {int((~decided).sum())} rows under the 1e-3 margin, "
          f"{int(differ.sum())} step counts differ (flips)")


def kd_train_phase(tcfg, name: str = "flowkd_mlp8",
                   steps: int = TRAIN_STEPS, check_rows: int = CHECK_BATCH,
                   rows: int = BATCH):
    """The fp32 KD step (`name`: a profile_train distillation, teacher
    `tcfg`) on kernels against plain at B=`check_rows`, then `steps` timed
    bf16 steps at B=`rows`. Returns ({row name: launches} of the timed
    steps, [router steps of each timed step] when the configuration
    routes)."""
    import copy

    from tpu_asr_torch.config import OptimConfig, make_student_config
    from tpu_asr_torch.convert.from_jax import KD_MODULES
    from tpu_asr_torch.kd.router import gumbel_noise
    from tpu_asr_torch.profile_forward import set_backend
    from tpu_asr_torch.profile_train import distill_config
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step,
                                             step_rngs)

    f32 = lambda cfg: dataclasses.replace(cfg, compute_dtype="float32")
    scfg = make_student_config(with_encoder(tcfg, quantization="none"))
    distill = distill_config(name)
    routed = distill.use_flow_matching and distill.flow.use_dynamic_steps
    model = kd_model(f32(scfg), f32(tcfg), 10, distill)
    init = copy.deepcopy(model.state_dict())
    batch = train_batch(check_rows, 11)
    n_t, n_s = tcfg.encoder.n_layers, scfg.encoder.n_layers
    int8 = tcfg.encoder.quantization == "int8"
    # (student and KD modules, teacher): an int8 teacher's quantization
    # decisions flip where sums run in another order (phase 11), which
    # moves the teacher-dependent losses, so its plain run keeps the
    # teacher on the kernels and a third run, all plain, is printed
    variants = [("auto", "auto"), ("xla", "auto" if int8 else "xla")]
    if int8:
        variants.append(("xla", "xla"))
    runs, routes = {}, {}
    for backend, teacher_backend in variants:
        model.load_state_dict(init)
        set_backend(model, backend)
        set_backend(model.teacher, teacher_backend)
        if routed:
            calls, hook = router_steps(model)
        state = DistilTrainState.create(model, OptimConfig())
        read = reset_counters()
        state, metrics = make_distil_train_step(model)(state, batch, 12)
        torch.cuda.synchronize()
        if backend == "auto" and distill.use_flow_matching:
            fm = {k: v for k, v in read().items() if k.startswith("fm")}
            check(all(v > 0 for v in fm.values()),
                  f"fp32 {name} step on the kernels launched the FM "
                  f"kernels: {fm}")
        if routed:
            hook.remove()
            routes[backend] = calls[0]
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
    if routed:
        # both runs drew the same Gumbel noise: the step's generator
        (steps_k, _), (steps_p, logits_p) = routes["auto"], routes["xla"]
        g = gumbel_noise(logits_p.shape, step_rngs(12, 0, "cuda")["gumbel"],
                         "cuda")
        router_flips(steps_k, steps_p, logits_p + g, f"fp32 {name} step")
        hist = torch.bincount(steps_k.reshape(-1).long(), minlength=17)
        print(f"fp32 {name} step: drawn step counts (layers x rows) "
              f"{hist[1:].tolist()} of 1..16")
    (lk, gk, _), (lp, gp, _) = runs[variants[0]], runs[variants[1]]
    check(set(lk) == loss_names(distill),
          f"fp32 {name} step losses {sorted(lk)}")
    for loss in sorted(lk):
        check(math.isfinite(lk[loss])
              and abs(lk[loss] - lp[loss]) <= 1e-4 * abs(lp[loss]),
              f"fp32 {name} step (teacher {n_t} x d{tcfg.encoder.d_model} "
              f"{tcfg.encoder.quantization}, student {n_s} x "
              f"d{scfg.encoder.d_model}, B={check_rows} x {SECONDS} s, "
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
    kd_mods = [m for m in KD_MODULES if hasattr(model, m)]
    check(set(gk) == set(gp) and all(any(n.startswith(m + ".") for n in gk)
                                     for m in kd_mods),
          f"fp32 {name} step: {len(gk)} student and KD-module gradients "
          f"({', '.join(kd_mods)} among them)")
    print(f"fp32 {name} step gradients, kernels vs plain:")
    grads_close([gk[n] for n in gk], [gp[n] for n in gk], 1e-2, list(gk),
                1e-4, verbose=False)
    kd_names = [n for n in gk if n.split(".")[0] in kd_mods]
    grads_close([gk[n] for n in kd_names], [gp[n] for n in kd_names], 1e-2,
                kd_names, 1e-4)
    del model

    model = kd_model(scfg, tcfg, 13, distill)
    calls, hook = router_steps(model) if routed else ([], None)
    ms, counts, metrics = timed_steps(model, train_batch(rows, 14), 15,
                                      steps)
    if hook is not None:
        hook.remove()
    names = sorted(loss_names(distill))
    losses = torch.stack([torch.stack([m[f"loss/{k}"] for k in names])
                          for m in metrics])
    rounded = lambda row: [round(x, 4) for x in row.tolist()]
    check(bool(torch.isfinite(losses).all()),
          f"bf16 {name} steps: losses finite; first "
          f"{dict(zip(names, rounded(losses[0])))}, last "
          f"{rounded(losses[-1])}")
    counts = {k: v for k, v in counts.items()
              if k in KD or (k == "ffn_int8" and int8)}
    check(all(v > 0 for v in counts.values()),
          f"{name} steps launched every kernel: {counts}")
    if tcfg.encoder.quantization == "int8":
        want = 2 * tcfg.encoder.n_layers * steps
        check(counts["ffn_int8"] == want, f"the int8 teacher launched the "
              f"int8 FFN {counts['ffn_int8']} times in {steps} steps "
              f"(2 x {tcfg.encoder.n_layers} layers per step: {want})")
    print(f"kd train: {name} ({scfg.compute_dtype}, student {n_s} x d"
          f"{scfg.encoder.d_model}, teacher {n_t} x d{tcfg.encoder.d_model}) "
          f"B={rows} x {SECONDS} s, {TOKENS} tokens: "
          f"{timed_summary(ms, steps, rows=rows)}; fm kernel launches a step "
          f"{counts['fm'] / steps:g}, fm_bwd {counts['fm_bwd'] / steps:g}")
    # the timed steps' router calls (the warm-up's first)
    timed = [s for s, _ in calls[-steps:]]
    return counts, timed


def router_eval_check(tcfg) -> None:
    """flowkd_router16's eval forward in fp32 on phase 4's clips, kernels
    against plain: the teacher runs for the router's input; step counts
    equal where the plain logits' top-2 margin exceeds 1e-3, max |delta
    log-prob| < 2e-3, greedy ids equal where the top-2 margin exceeds 1e-3,
    the FM kernel launched."""
    from tpu_asr_torch.config import make_student_config
    from tpu_asr_torch.profile_forward import set_backend
    from tpu_asr_torch.profile_train import distill_config

    f32 = lambda cfg: dataclasses.replace(cfg, compute_dtype="float32")
    model = kd_model(f32(make_student_config(tcfg)), f32(tcfg), 16,
                     distill_config("flowkd_router16")).eval()
    sig, lens = model_clips(1)
    outs = {}
    for backend in ("auto", "xla"):
        set_backend(model, backend)
        calls, hook = router_steps(model)
        read = reset_counters()
        with torch.no_grad():
            out = model(sig, lens)
        torch.cuda.synchronize()
        hook.remove()
        outs[backend] = (out, calls[0], read())
        check(out.tch_feats is not None, f"router eval ({backend}): the "
              f"teacher ran for the router's input")
    (ok, (sk, _), ck), (op, (sp, lp), _) = outs["auto"], outs["xla"]
    router_flips(sk, sp, lp, "router eval forward (fp32)")
    err = (ok.log_probs - op.log_probs).abs().max().item()
    check(err < 2e-3, f"router eval forward: max |delta log-prob| kernels "
          f"vs plain {err:.3e} < 2e-3")
    top2 = op.log_probs.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 1e-3
    check(bool((ok.greedy == op.greedy)[sure].all()),
          f"router eval forward: greedy ids equal on all {int(sure.sum())} "
          f"frames whose top-2 margin exceeds 1e-3")
    check(ck["fm"] > 0 and ck["attention"] > 0,
          f"router eval forward launched the FM kernel ({ck['fm']}) and "
          f"the attention ({ck['attention']})")


def meta_encoder_steps(tcfg) -> None:
    """One bf16 flowkd_mlp8 step with each of the other meta encoders at
    B=8 x 15 s: losses finite, the FM kernel not launched (the generic
    Euler loop, per layer)."""
    from tpu_asr_torch.config import make_student_config
    from tpu_asr_torch.profile_train import distill_config

    scfg = make_student_config(tcfg)
    base = distill_config("flowkd_mlp8")
    for kind in ("cnn", "swin", "conformer", "unet"):
        distill = dataclasses.replace(base, flow=dataclasses.replace(
            base.flow, meta_encoder_type=kind))
        model = kd_model(scfg, tcfg, 17, distill)
        t0 = time.perf_counter()
        _, counts, metrics = timed_steps(model, train_batch(CHECK_BATCH, 18),
                                         19, steps=1, warmup=0)
        loss = {k[5:]: round(v.item(), 4) for k, v in metrics[0].items()
                if k.startswith("loss/")}
        check(all(math.isfinite(v) for v in loss.values())
              and counts["fm"] == 0 and counts["fm_bwd"] == 0,
              f"bf16 flowkd step, meta encoder {kind} (16 layers, 8 steps, "
              f"B={CHECK_BATCH}): losses finite {loss}, fm launches "
              f"{counts['fm']}, fm_bwd {counts['fm_bwd']}; "
              f"{time.perf_counter() - t0:.2f} s")
        del model


def kd_fm_shapes(drawn):
    """The FM pair against its plain version at the shapes phase 21's
    timed steps give it: flowkd_router16's 16 x B rows at C=88, H=128 on
    the (layers, B) step counts its router drew (rows B-major, as the model
    stacks them; ragged 1..16 at max_steps 16), fp32 and bf16; kd_menu's
    diffm latent FMs, 16 x B rows at the latent width, in bf16 (the fp32
    kernel takes only C=88)."""
    from tpu_asr_torch.config import DiffmConfig
    from tpu_asr_torch.kd.diffm import latent_fm_config

    gen = torch.Generator(device="cuda").manual_seed(22)
    rows, t = BATCH * 16, 376
    steps = drawn.t().reshape(-1)
    check(steps.numel() == rows, f"flowkd_router16's router gave {rows} "
          f"row step counts ({steps.numel()})")
    for dt in (torch.float32, torch.bfloat16):
        fm_compare(fm_inputs(gen, rows, t, 16, steps), 16, dt,
                   f"rows={rows} T={t} flowkd_router16's drawn steps "
                   f"{int(steps.min())}..{int(steps.max())}, max_steps 16")
    lat = latent_fm_config(DiffmConfig())
    n = lat.training_sampling
    fm_compare(fm_inputs(gen, rows, t, n, c=lat.student_dim,
                         h=lat.hidden_dim), n, torch.bfloat16,
               f"rows={rows} T={t} steps={n} (kd_menu's diffm latent FM)")


def kd_rest_phase(tcfg):
    """Phase 21: flowkd_router16 and kd_menu (kd_train_phase), the step
    count histogram, the FM pair at both configurations' shapes
    (kd_fm_shapes), the router's eval forward, the other meta encoders.
    Returns {row: launches} of flowkd_router16's timed steps."""
    counts, timed = kd_train_phase(tcfg, "flowkd_router16")
    hist = torch.bincount(torch.stack(timed).reshape(-1).long(),
                          minlength=17)[1:].tolist()
    check(sum(1 for n in hist if n) >= 3,
          f"flowkd_router16: at least 3 distinct step counts drawn")
    print(f"flowkd_router16: drawn step counts 1..16 over {len(timed)} "
          f"timed steps x 16 layers x {BATCH} rows: {hist}")
    kd_fm_shapes(timed[-1])
    kd_train_phase(tcfg, "kd_menu", steps=3)
    router_eval_check(tcfg)
    meta_encoder_steps(tcfg)
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


def conv_module_path(enc, w):
    """The port's ConformerConvolution with conv_backend='auto' on the card,
    holding the conv kernel's weights w (the folded affine as a BatchNorm of
    mean 0, variance 1 - eps), in eval."""
    from tpu_asr_torch.models.conformer import ConformerConvolution
    w1, b1, wd, bd, nw, nb, w2, b2 = w
    mod = ConformerConvolution(dataclasses.replace(
        enc, conv_backend="auto", conv_norm_type="batch_norm"))
    bn = mod.batch_norm
    sd = {"pointwise_conv1.weight": w1[..., None],
          "pointwise_conv1.bias": b1, "depthwise_conv.weight": wd[:, None],
          "depthwise_conv.bias": bd, "pointwise_conv2.weight": w2[..., None],
          "pointwise_conv2.bias": b2, "batch_norm.weight": nw,
          "batch_norm.bias": nb,
          "batch_norm.running_mean": torch.zeros_like(nw),
          "batch_norm.running_var": torch.full_like(nw, 1.0 - bn.eps),
          "batch_norm.num_batches_tracked": torch.tensor(0)}
    mod.load_state_dict(sd, strict=True)
    return mod.cuda().eval()


def eval_kernel_phase(cfg):
    """The int8 FFN and the conv module against their plain versions at the
    int8 teacher's serving shape. Returns {name: row} in bf16 (the main
    path's dtype)."""
    import torch.nn.functional as F

    from tpu_asr_torch.ops.cuda_conv import (conv_module_plain,
                                             fused_conv_module)
    from tpu_asr_torch.ops.cuda_ffn import (ffn_sublayer_int8_plain,
                                            ffn_sublayer_plain,
                                            fused_ffn_sublayer,
                                            fused_ffn_sublayer_int8,
                                            layer_norm)
    from tpu_asr_torch.ops.cuda_subsampling import out_len

    regs = {**nvcc_registers("ffn_int8"), **nvcc_registers("conv_module")}
    check(len(regs) >= 4 and all(st == 0 and ld == 0
                                 for _, st, ld in regs.values()),
          f"ptxas: {len(regs)} int8 FFN and conv module kernels, none "
          f"spills")
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

    def conv_weights(d_, k_, g=gen):
        return (normal(g, 2 * d_, d_, scale=d_ ** -0.5),
                normal(g, 2 * d_, scale=0.1),
                normal(g, d_, k_, scale=k_ ** -0.5),
                normal(g, d_, scale=0.1), 1.0 + normal(g, d_, scale=0.1),
                normal(g, d_, scale=0.1), normal(g, d_, d_, scale=d_ ** -0.5),
                normal(g, d_, scale=0.1))

    # the D=512 checks draw from their own generator, so that every other
    # check of the phase sees the inputs it saw before they were added
    gl = torch.Generator(device="cuda").manual_seed(31)

    # int8 FFN at D=176, d_ff 704
    fw = ffn_weights(gen, d, f)
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
    sw = ffn_weights(gen, 88, 352)
    xs = normal(gen, BATCH, t, 88)
    for dt in (torch.float32, torch.bfloat16):
        ffn_int8_compare(xs.to(dt), sw, f"student D=88, d_ff=352 "
                         f"(B={BATCH}, T={t})")
    # conformer-LARGE's widths: the largest hq and yq tiles
    lw = ffn_weights(gl, 512, 2048)
    xl = normal(gl, 4, t, 512)
    for dt in (torch.float32, torch.bfloat16):
        ffn_int8_compare(xl.to(dt), lw, f"D=512, d_ff=2048 (B=4, T={t})")
    big = ffn_weights(gen, 520, 2048)
    refused(lambda: fused_ffn_sublayer_int8(normal(gen, 1, 4, 520), *big),
            "fused_ffn_sublayer_int8 at D=520")

    # the fused FFN at the teacher's width, rate 0: the forward in eval and
    # autograd through it, by phase 6's rules (ffn_compare)
    gt = normal(gen, BATCH, t, d)
    for dt in (torch.float32, torch.bfloat16):
        fwd_row, bwd_row, _ = ffn_compare(
            xf.to(dt), gt.to(dt), fw, 0.0, 0,
            f"teacher width (B={BATCH}, T={t}, D={d}, d_ff={f})")
    ffn_ms, ffn_plain_ms = fwd_row[1], fwd_row[2]
    x = xf.to(torch.bfloat16)

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
    lw = conv_weights(512, k, gl)
    xl = normal(gl, 4, t, 512)
    for dt in (torch.float32, torch.bfloat16):
        for norm in ("affine", "layer_norm"):
            conv_compare(xl.to(dt), mask[:4], lw, pad, norm,
                         f"D=512 (B=4, T={t}, k={k})")
    refused(lambda: fused_conv_module(
        normal(gen, 1, 8, d), mask[:1, :8], *conv_weights(d, 35), (17, 17)),
        "fused_conv_module at k=35")

    # the bf16 module path the conv kernel replaces, as ConformerConvolution
    # runs it with conv_backend='auto' (cuBLAS products, cuDNN's depthwise
    # conv), on the same input and weights (the folded affine as a
    # BatchNorm of mean 0 and variance 1 - eps)
    conv_mod = conv_module_path(enc, cw)
    xc16 = xc.to(torch.bfloat16)
    with torch.no_grad():
        mod_ms = median_ms(lambda: conv_mod(xc16, mask))
        mod_dev = device_ms(lambda: conv_mod(xc16, mask))
        conv_dev = device_ms(lambda: fused_conv_module(xc16, mask, *cw, pad))
        ffn_dev = device_ms(lambda: fused_ffn_sublayer_int8(x16, *fw))
        err = (conv_mod(xc16, mask).float()
               - fused_conv_module(xc16, mask, *cw, pad).float()).abs().max()
    print(f"conv module path (bf16, 'auto') against the bf16 kernel: max "
          f"|diff| {err.item():.3e} (each rounds to bf16 at other places)")
    print(f"time conv module bfloat16 (B={BATCH}, T={t}, D={d}, k={k}): "
          f"kernel {conv_dt[torch.bfloat16][1]:.4f} ms, device a launch "
          f"{top_kernels(conv_dev[1], 1)}; module path (conv_backend="
          f"'auto') {mod_ms:.4f} ms, device {mod_dev[0]:.4f} ms a call, a "
          f"launch {top_kernels(mod_dev[1], 4)} (median of 20, CUDA events; "
          f"torch.profiler)")
    print(f"time ffn_int8 bfloat16 (B={BATCH}, T={t}, D={d}, d_ff={f}): "
          f"kernel {per_dt[torch.bfloat16][1]:.4f} ms, device a launch "
          f"{top_kernels(ffn_dev[1], 1)} (median of 20, CUDA events; "
          f"torch.profiler)")
    for name, rows in (("ffn_int8", per_dt), ("conv_module", conv_dt)):
        for dt, (err, ms, plain_ms, (b_ms, by), _) in rows.items():
            print(f"time {name} {str(dt)[6:]}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) (median of "
                  f"20, plain of 5, CUDA events)")
    print(f"time bf16 eval FFN sublayer (LN + two cuBLAS products, the "
          f"plain eval path int8 replaces): {bf16_ms:.4f} ms (median of 20)")
    ffn_bound, _ = bound(4 * m * d * f, 2 * nbytes(x) + nbytes(*fw),
                         "bfloat16")
    print(f"time ffn (eval) bfloat16 at D={d}, d_ff={f}: kernel {ffn_ms:.4f} "
          f"ms, plain {ffn_plain_ms:.4f} ms, bound {ffn_bound:.4f} ms, the "
          f"bf16 eval FFN sublayer (its yardstick) {bf16_ms:.4f} ms (median "
          f"of 20, CUDA events); ffn_bwd bfloat16 kernel {bwd_row[1]:.4f} ms, "
          f"plain {bwd_row[2]:.4f} ms, bound {bwd_row[3][0]:.4f} ms")
    return {"ffn_int8": per_dt[torch.bfloat16],
            "conv_module": conv_dt[torch.bfloat16]}


def int8_model_phase(cfg, name: str = "ModelConfig()"):
    """The int8 serving model in fp32 on kernels against plain, end to end
    and layer by layer on the plain model's layer inputs, beside the
    int8-vs-fp drift of the same weights (`name` in the messages)."""
    from tpu_asr_torch.profile_forward import seeded_model, set_backend
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = seeded_model(cfg32, seed=16)
    fp_model = seeded_model(with_encoder(cfg32, quantization="none",
                                         conv_backend="auto"), seed=16)
    set_backend(fp_model, "xla")
    sig_t, len_t = model_clips(17)
    read = reset_counters()
    inputs = []
    with torch.inference_mode():
        got = model(sig_t, len_t)
        counts = {k: n for k, n in read().items() if k in INT8_SERVING}
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
    # a row flips where any of its FFN sublayers' quantized activations (D
    # after the LN, d_ff after SiLU, two sublayers) lies within rounding of
    # a tie, so the share of rows that may flip grows with D + d_ff: 10% at
    # ModelConfig()'s 176 + 704, in proportion above it (conformer-LARGE's
    # 512 + 2048: 29%)
    enc = cfg.encoder
    budget = 0.1 * max(1.0, (enc.d_model + enc.d_ff) / 880)
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
        check(flipped <= budget * row_err.numel()
              and row_err.max().item() <= 0.5 * drift,
              f"  int8 layer {i} on the plain layer input: {flipped} of "
              f"{row_err.numel()} rows beyond 1e-4 (<= {100 * budget:.0f}%), "
              f"max |err| "
              f"{row_err.max().item():.3e} <= half the int8-vs-fp drift "
              f"{drift:.3e}", )
    set_backend(model, "auto")
    valid = (torch.arange(got.log_probs.shape[1], device="cuda")[None, :]
             < want.encoded_len[:, None])
    d = (got.log_probs - want.log_probs).abs()[valid]
    drift = (want.log_probs - fp.log_probs).abs()[valid]
    print(f"int8 model {name} int8 + conv kernel fp32, {len(sig_t)} "
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

def layer_flops(b, t, d, h, dff, k):
    """Multiply-adds x 2 of one eval Conformer layer: the FFN halves, the
    q/k/v/o projections, content and (gathered) position scores and the
    value product, pointwise 1 and 2, the depthwise taps and P = PE Wpos^T.
    """
    m, dk = b * t, d // h
    return (8 * m * d * dff + 8 * m * d * d + 6 * b * h * t * t * dk
            + 6 * m * d * d + 2 * m * d * k + 2 * (2 * t - 1) * d * d)


def layer_compare(x, mask, prm, enc, label, norm=None, pad_l=None,
                  window=(-1, -1)):
    """fused_conformer_layer against conformer_layer_plain on x (valid and
    masked rows: the output is masked). fp32 within 1e-4 of the output's
    scale (sums in another order); bf16 within 5e-2 of it: both round the
    same operands to bf16, but a sum taken in another order moves an
    operand across a rounding boundary (2^-8 relative), and the layer
    chains ten products and four LayerNorms. The label names the kernel
    the call takes (layer_route). Returns the max |error|."""
    from tpu_asr_torch.ops.cuda_layer import (conformer_layer_plain,
                                              fused_conformer_layer,
                                              layer_route)
    norm = norm or ("affine" if enc.conv_norm_type == "batch_norm"
                    else "layer_norm")
    pad_l = enc.conv_context[0] if pad_l is None else pad_l
    h, k = enc.n_heads, enc.conv_kernel_size
    args = (prm, h, k, pad_l, norm, window)
    with torch.no_grad():
        got = fused_conformer_layer(x, mask, *args).float()
        want = conformer_layer_plain(x, mask, *args).float()
    torch.cuda.synchronize()
    err, ref = (got - want).abs().max().item(), want.abs().max().item()
    fp32 = x.dtype == torch.float32
    tol = (1e-4 if fp32 else 5e-2) * max(1.0, ref)
    kernel = LAYER_ROUTES[layer_route(x.dtype, x.shape[-1], h, k)]
    check(err <= tol and bool(torch.isfinite(got).all()),
          f"conformer_layer {str(x.dtype)[6:]} ({kernel}) {norm} pad_l "
          f"{pad_l} window {window} {label}: max |err| {err:.3e} <= "
          f"{tol:.3g} ({'1e-4' if fp32 else '5e-2'} x max(1, |ref|max "
          f"{ref:.3e}))")
    return err


LAYER_ROUTES = ("layer_kernel<float>", "layer_kernel<bf16>",
                "layer_mma_kernel")


def layer_encoder_check(cfg, dtype):
    """The 16-layer encoder of `cfg` in `dtype`, each layer's output
    replaced by fused_conformer_layer's on the same input (forward hooks),
    against the CTCModel on its own kernels. fp32: max |delta log-prob| <
    2e-3 and equal greedy ids where the top-2 margin exceeds 1e-3. bf16
    (phase 4's rule): greedy ids equal on >= 99% of the frames whose top-2
    margin exceeds 1e-1; the max |delta log-prob| printed. Each layer's
    error is printed."""
    from tpu_asr_torch.ops.cuda_layer import (fused_conformer_layer,
                                              layer_params)
    from tpu_asr_torch.profile_forward import seeded_model

    enc = cfg.encoder
    model = seeded_model(dataclasses.replace(cfg, compute_dtype=str(
        dtype)[6:]), seed=43)
    sig_t, len_t = model_clips(43)
    layer_errs = []

    def through_kernel(mod, args, out):
        x, _, m = args
        got = fused_conformer_layer(x, m, layer_params(mod), enc.n_heads,
                                    enc.conv_kernel_size,
                                    mod.cfg.conv_context[0], "affine")
        layer_errs.append(((got - out).float().abs() * m[..., None])
                          .max().item())
        return got

    with torch.inference_mode():
        want = model(sig_t, len_t)
        hooks = [layer.register_forward_hook(through_kernel)
                 for layer in model.encoder.layers]
        got = model(sig_t, len_t)
        for hook in hooks:
            hook.remove()
    torch.cuda.synchronize()
    name = str(dtype)[6:]
    print(f"  {name} encoder layer by layer, max |kernel - module| on the "
          f"same input: " + ", ".join(f"{e:.2e}" for e in layer_errs))
    valid = (torch.arange(got.log_probs.shape[1], device="cuda")[None, :]
             < want.encoded_len[:, None])
    delta = ((got.log_probs.float() - want.log_probs.float()).abs()
             * valid[..., None]).max().item()
    fp32 = dtype == torch.float32
    check(len(layer_errs) == enc.n_layers
          and bool(torch.isfinite(got.log_probs).all())
          and (delta < 2e-3 or not fp32),
          f"ModelConfig() encoder {name} through fused_conformer_layer "
          f"({len(layer_errs)} layers), {len(sig_t)} clips of 5-{SECONDS} s:"
          f" max |delta log-prob| against the CTCModel on its kernels "
          f"{delta:.3e}" + (" < 2e-3" if fp32 else " (printed)"))
    top2 = want.log_probs.float().topk(2, dim=-1).values
    margin = 1e-3 if fp32 else 1e-1
    decided = valid & ((top2[..., 0] - top2[..., 1]) > margin)
    same = ((got.greedy == want.greedy) & decided).sum().item()
    n = int(decided.sum())
    check(same == n if fp32 else same >= 0.99 * n,
          f"{name} encoder through the layer kernel: greedy ids equal on "
          f"{same} of {n} frames with top-2 margin > {margin:g} "
          f"({'all' if fp32 else '>= 99%'}; of {int(valid.sum())} valid)")


def layer_kernel_phase(cfg):
    """Phase 14: the whole eval layer kernel against its plain version at
    the teacher's serving shape and the student's width, its variants in
    fp32 and bf16, bit-equal bf16 calls, ptxas and occupancy of the
    tensor-core kernel, the 16-layer encoder through it in fp32 and bf16,
    refusals and times. Returns {"conformer_layer": row} in bf16."""
    from tpu_asr_torch.config import make_student_config
    from tpu_asr_torch.models.conformer import (ConformerLayer,
                                                rel_positional_encoding)
    from tpu_asr_torch.ops.cuda_layer import (conformer_layer_plain,
                                              fused_conformer_layer,
                                              layer_blocks_per_sm,
                                              layer_params)
    from tpu_asr_torch.ops.cuda_subsampling import out_len
    from tpu_asr_torch.profile_forward import seeded_model

    regs = nvcc_registers("layer_mma_kernel")
    check(regs and all(st == 0 and ld == 0 for _, st, ld in regs.values()),
          f"layer_mma_kernel: {len(regs)} instantiations "
          f"({', '.join(regs)}), none spills")
    gen = torch.Generator(device="cuda").manual_seed(40)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    enc = cfg.encoder
    d, h, dff, k = enc.d_model, enc.n_heads, enc.d_ff, enc.conv_kernel_size
    for dd, hh, ff in ((d, h, dff), (88, 2, 352)):
        blocks = layer_blocks_per_sm(torch.bfloat16, dd, hh, ff, k)
        check(blocks >= 2, f"layer_mma_kernel at D={dd}, {hh} heads, d_ff "
              f"{ff}, k={k}: {blocks} blocks an SM resident (>= 2)")
    t = out_len(out_len(SECONDS * SR // cfg.preprocessor.hop_length + 1))
    lengths = torch.randint(t // 4, t + 1, (BATCH,), generator=gen,
                            device="cuda")
    lengths[0] = t
    mask = torch.arange(t, device="cuda")[None, :] < lengths[:, None]
    xf = normal(gen, BATCH, t, d) * mask[..., None]

    def one_layer(seed, base=cfg32, **changes):
        lcfg = with_encoder(base, n_layers=1, **changes)
        return seeded_model(lcfg, seed).encoder.layers[0], lcfg.encoder

    layer, lenc = one_layer(41)
    prm = layer_params(layer)
    shape = f"(B={BATCH}, T={t}, D={d}, H={h}, d_ff={dff}, k={k})"
    errs = {dt: layer_compare(xf.to(dt), mask, prm, lenc, shape)
            for dt in (torch.float32, torch.bfloat16)}
    ln_layer, ln_enc = one_layer(42, conv_norm_type="layer_norm")
    ln_prm = layer_params(ln_layer)
    odd = torch.arange(37, device="cuda")[None, :] < torch.tensor(
        [37, 20, 3], device="cuda")[:, None]
    x_odd = normal(gen, 3, 37, d) * odd[..., None]
    for dt in (torch.float32, torch.bfloat16):
        layer_compare(xf.to(dt), mask, ln_prm, ln_enc, shape)
        layer_compare(xf.to(dt), mask, ln_prm, ln_enc, shape, pad_l=k - 1)
        layer_compare(xf.to(dt), mask, prm, lenc, shape, window=(32, 16))
        layer_compare(x_odd.to(dt), odd, prm, lenc, "odd T (3 x 37)")
    # the student's width: D=88, 2 heads, d_ff 352 (K = 88 padded to 96)
    scfg = make_student_config(cfg32)
    s_layer, s_enc = one_layer(44, base=scfg)
    x_s = normal(gen, BATCH, t, s_enc.d_model) * mask[..., None]
    for dt in (torch.float32, torch.bfloat16):
        layer_compare(x_s.to(dt), mask, layer_params(s_layer), s_enc,
                      f"student (D={s_enc.d_model}, H={s_enc.n_heads}, d_ff="
                      f"{s_enc.d_ff})")
    # a bf16 shape the tensor-core tiles do not take (k = 35 > 33) runs on
    # layer_kernel<bf16>
    k35, k35_enc = one_layer(45, conv_kernel_size=35)
    layer_compare(x_odd.to(torch.bfloat16), odd, layer_params(k35), k35_enc,
                  "odd T (3 x 37), k=35")
    x16 = xf.to(torch.bfloat16)
    args = (x16, mask, prm, h, k, lenc.conv_context[0], "affine")
    with torch.no_grad():
        first, second = (fused_conformer_layer(*args) for _ in range(2))
    check(torch.equal(first, second), "conformer_layer bfloat16: two calls "
          "bit-equal")
    try:
        fused_conformer_layer(xf.detach().requires_grad_(), mask, prm, h, k,
                              lenc.conv_context[0], "affine")
        ok = False
    except RuntimeError:
        ok = True
    check(ok, "fused_conformer_layer refuses autograd on the card")
    wide = ConformerLayer(dataclasses.replace(
        lenc, d_model=192, ff_expansion_factor=8)).cuda().eval()
    refused(lambda: fused_conformer_layer(
        normal(gen, 2, 8, 192), torch.ones(2, 8, dtype=torch.bool,
                                           device="cuda"),
        layer_params(wide), h, k, lenc.conv_context[0], "affine"),
        "conformer_layer fp32 D=192, d_ff 1536 (layer_kernel's shared "
        "memory)")

    # the 16-layer encoder, layer by layer through the kernel
    layer_encoder_check(cfg, torch.float32)
    layer_encoder_check(cfg, torch.bfloat16)

    # times in bf16 on the main input; the module path: the port's
    # ConformerLayer in eval (attention kernel, plain FFN, conv and LNs)
    pos_emb = rel_positional_encoding(t, d, "cuda")
    with torch.no_grad():
        ms = median_ms(lambda: fused_conformer_layer(*args))
        plain_ms = median_ms(lambda: conformer_layer_plain(*args), iters=5)
        module_ms = median_ms(lambda: layer(x16, pos_emb, mask))
    # the kernel reads its weight matrices in bf16, vectors and taps in fp32
    wbytes = sum(z.numel() * (2 if z.dim() == 2 and key != "wd" else 4)
                 for key, z in prm.items())
    b_ms, by = bound(layer_flops(BATCH, t, d, h, dff, k),
                     2 * nbytes(x16) + nbytes(mask) + wbytes, "bfloat16")
    with torch.no_grad():
        dev_ms, names = profiled_kernels(
            lambda: fused_conformer_layer(*args), "layer_mma_kernel")
        mod_dev_ms, mod_names = device_ms(lambda: layer(x16, pos_emb, mask))
    print(f"device conformer_layer bfloat16 ({DEVICE}): kernel "
          f"{dev_ms:.4f} ({top_kernels(names)}); module path "
          f"{mod_dev_ms:.4f} ({top_kernels(mod_names, 5)})")
    print(f"conformer_layer bfloat16: the kernel's device time "
          f"{'below' if dev_ms < mod_dev_ms else 'NOT below'} the module "
          f"path's ({dev_ms / mod_dev_ms:.3f}x)")
    print(f"time conformer_layer bfloat16 {shape}: kernel {ms:.4f} ms "
          f"(call - device {ms - dev_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"module path (ConformerLayer, attention kernel + plain FFN/conv/"
          f"LN) {module_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) (median of "
          f"20, plain of 5, CUDA events); fp32 max |err| "
          f"{errs[torch.float32]:.3e}")
    return {"conformer_layer": (errs[torch.bfloat16], ms, plain_ms,
                                (b_ms, by), None)}


def heads_compare(args, window, rate, seed, label, grads=True):
    """fused_relpos_attention (and its backward) against the plain version
    on valid query rows. Forward tolerances of phase 3's attention check;
    gradients phase 6's rule. Returns (forward error, gradient error, saved
    tensors, cotangent, plain leaves and output)."""
    from tpu_asr_torch.ops.cuda_attention import (
        fused_relpos_attention, relpos_attention_heads_plain)
    q_u, q_v, k, v, w_pos, mask = args
    dt = q_u.dtype
    dts = str(dt)[6:]
    valid = mask[:, None, :, None]
    with torch.no_grad():
        got = fused_relpos_attention(*args, window, rate, seed).float()
        want = relpos_attention_heads_plain(*args, window, rate,
                                            seed).float()
    torch.cuda.synchronize()
    err = ((got - want).abs() * valid).max().item()
    rtol, atol = (1e-4, 1e-4) if dt == torch.float32 else (1e-2, 3e-3)
    check(torch.allclose(got * valid, want * valid, rtol=rtol, atol=atol),
          f"attention_heads {dts} {label} window {window} dropout {rate} "
          f"seed {seed}: valid rows max |err| {err:.3e} (rtol {rtol}, atol "
          f"{atol})")
    if not grads:
        return err, None, None, None, None
    gen = torch.Generator(device="cuda").manual_seed(51)
    g = (normal(gen, *q_u.shape) * valid).to(dt)
    leaves = [z.detach().requires_grad_() for z in args[:5]]
    out_k = fused_relpos_attention(*leaves, mask, window, rate, seed)
    got_g = torch.autograd.grad(out_k, leaves, g, retain_graph=True)
    leaves_p = [z.detach().requires_grad_() for z in args[:5]]
    out_p = relpos_attention_heads_plain(*leaves_p, mask, window, rate, seed)
    want_g = torch.autograd.grad(out_p, leaves_p, g, retain_graph=True)
    torch.cuda.synchronize()
    tol, floor = (1e-3, 1e-4) if dt == torch.float32 else (5e-2, 1e-2)
    print(f"attention_heads_bwd {dts} {label} window {window} dropout {rate}"
          f" seed {seed}, kernels vs plain:")
    gerr, _ = grads_close(got_g, want_g, tol,
                          ["dq_u", "dq_v", "dk", "dv", "dw_pos"], floor)
    return err, gerr, out_k.grad_fn.saved_tensors, g, (leaves_p, out_p)


def heads_kernel_phase(cfg):
    """Phase 15: the per-head attention kernels against their plain
    version: the forward at the teacher's serving shape, forward and
    backward at the student's, a window, ragged lengths without a seed,
    determinism, refusals and times. Returns the attention_heads rows in
    bf16."""
    from tpu_asr_torch.config import make_student_config
    from tpu_asr_torch.ops.cuda_attention import (
        fused_relpos_attention, fused_relpos_attention_bwd,
        relpos_attention_heads_plain)
    from tpu_asr_torch.ops.cuda_subsampling import out_len

    gen = torch.Generator(device="cuda").manual_seed(50)
    t = out_len(out_len(SECONDS * SR // cfg.preprocessor.hop_length + 1))
    lengths = torch.randint(t // 4, t + 1, (BATCH,), generator=gen,
                            device="cuda")
    lengths[0] = t
    mask = torch.arange(t, device="cuda")[None, :] < lengths[:, None]

    def inputs(h, dk):
        d = h * dk
        return [normal(gen, BATCH, h, t, dk, scale=0.5) for _ in range(4)] \
            + [normal(gen, d, d, scale=d ** -0.5)]

    def fwd_cost(args, dt):
        b, h, t_, dk = args[0].shape
        d = h * dk
        flops = 6 * b * h * t_ * t_ * dk + 2 * (2 * t_ - 1) * d * d
        return bound(flops, nbytes(*args, mask) + nbytes(args[0]), dt)

    rows = {}
    enc = cfg.encoder
    teacher = inputs(enc.n_heads, enc.d_model // enc.n_heads)
    for dt in (torch.float32, torch.bfloat16):
        args = [z.to(dt) for z in teacher] + [mask]
        err, *_ = heads_compare(args, (-1, -1), 0.0, None,
                                f"teacher (B={BATCH}, H={enc.n_heads}, "
                                f"T={t}, dk={enc.d_model // enc.n_heads})",
                                grads=False)
        if dt == torch.bfloat16:
            teacher16 = args
            with torch.no_grad():
                rows["attention_heads"] = (
                    err, median_ms(lambda: fused_relpos_attention(*args)),
                    median_ms(lambda: relpos_attention_heads_plain(*args)),
                    fwd_cost(args[:5], "bfloat16"), None)

    senc = make_student_config(cfg).encoder
    sh, sdk = senc.n_heads, senc.d_model // senc.n_heads
    student = inputs(sh, sdk)
    rate, seed = senc.dropout_att, 2 ** 31 - 7
    label = f"student (B={BATCH}, H={sh}, T={t}, dk={sdk})"
    for dt in (torch.float32, torch.bfloat16):
        args = [z.to(dt) for z in student] + [mask]
        _, gerr, saved, g, (leaves_p, out_p) = heads_compare(
            args, (-1, -1), rate, seed, label)
        window = (-1, -1)
        bwd = lambda: fused_relpos_attention_bwd(g, *saved, window, rate,
                                                 seed)
        check(all(torch.equal(a, b) for a, b in zip(bwd(), bwd())),
              f"attention_heads_bwd {str(dt)[6:]}: two calls give "
              f"bit-equal gradients")
        if dt == torch.bfloat16:
            b_, h_, t_, dk_ = args[0].shape
            d_ = h_ * dk_
            flops = 16 * b_ * h_ * t_ * t_ * dk_ + 2 * (2 * t_ - 1) * d_ * d_
            rows["attention_heads_bwd"] = (
                gerr, median_ms(bwd),
                median_ms(lambda: torch.autograd.grad(out_p, leaves_p, g,
                                                      retain_graph=True)),
                bound(flops, nbytes(g, *saved) + nbytes(*args[:5]),
                      "bfloat16"), None)
    long_mask = torch.arange(LONG_T, device="cuda")[None, :] < torch.tensor(
        [[LONG_T], [LONG_T - 173]], device="cuda")
    long_args = [normal(gen, 2, sh, LONG_T, sdk, scale=0.5).to(torch.bfloat16)
                 for _ in range(4)] + [student[4].to(torch.bfloat16),
                                       long_mask]
    heads_compare(long_args, (-1, -1), rate, seed,
                  f"T={LONG_T} (B=2, beyond the fp32 backward's limit)")
    args32 = [z.float() for z in student] + [mask]
    heads_compare(args32, (32, 16), rate, seed, label)
    heads_compare(args32, (-1, -1), rate, None, label + ", ragged, no seed")
    refused(lambda: fused_relpos_attention(
        *[normal(gen, 1, 2, 8, 132) for _ in range(4)],
        normal(gen, 264, 264), mask[:1, :8]),
        "fused_relpos_attention at dk=132")
    with torch.no_grad():
        fwd_dev = device_ms(lambda: fused_relpos_attention(*teacher16))
    bwd_dev = device_ms(bwd)
    print(f"device attention_heads bfloat16 teacher forward ({DEVICE}): "
          f"{fwd_dev[0]:.4f} ({top_kernels(fwd_dev[1])})"
          f"; student backward {bwd_dev[0]:.4f} "
          f"({top_kernels(bwd_dev[1], 6)})")
    for name, (err, ms, plain_ms, (b_ms, by), _) in rows.items():
        print(f"time {name} bfloat16: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) (median of 20, "
              f"CUDA events)")
    return rows


def attention_weights(gen, d, h):
    """wq, bq, wk, bk, wv, bv, pos_bias_u, pos_bias_v, w_pos, wo: fp32,
    seeded, matrices scaled by fan-in."""
    dk = d // h
    return (normal(gen, d, d, scale=d ** -0.5), normal(gen, d, scale=0.1),
            normal(gen, d, d, scale=d ** -0.5), normal(gen, d, scale=0.1),
            normal(gen, d, d, scale=d ** -0.5), normal(gen, d, scale=0.1),
            normal(gen, h, dk, scale=0.1), normal(gen, h, dk, scale=0.1),
            normal(gen, d, d, scale=d ** -0.5),
            normal(gen, d, d, scale=d ** -0.5))


def seg_bwd_compare(seg, x, g, pw, h, rate, seed, label):
    """The block attention with `seg` (B, T) under autograd, kernels
    against autograd through the plain version, x's dtype: the output on
    valid rows and finite on every row, every gradient finite and within
    phase 6's rule, two backward calls bit-equal. Returns (largest
    gradient error, the kernel's gradients, the backward's closure, the
    tensors it reads, the plain output and its leaves)."""
    from tpu_asr_torch.ops.cuda_attention import (
        fused_relpos_attention_block, fused_relpos_attention_block_bwd,
        relpos_attention_plain)
    from tpu_asr_torch.ops.positions import rel_positional_encoding

    dts = str(x.dtype)[6:]
    t, d = x.shape[1:]
    mask = seg > 0
    pos_emb = rel_positional_encoding(t, d, "cuda")
    leaves = [z.detach().requires_grad_() for z in (x, *pw)]
    out_k = fused_relpos_attention_block(*leaves, pos_emb, mask, h,
                                         dropout_rate=rate,
                                         dropout_seed=seed, seg_id=seg)
    got = torch.autograd.grad(out_k, leaves, g, retain_graph=True)
    leaves_p = [z.detach().requires_grad_() for z in (x, *pw)]
    out_p = relpos_attention_plain(*leaves_p, pos_emb, mask, h, rate, seed,
                                   seg)
    want = torch.autograd.grad(out_p, leaves_p, g, retain_graph=True)
    torch.cuda.synchronize()
    valid = mask[..., None]
    rtol, atol = (1e-4, 1e-4) if x.dtype == torch.float32 else (1e-2, 3e-3)
    err = ((out_k.float() - out_p.float()).abs() * valid).max().item()
    check(bool(torch.isfinite(out_k).all()) and torch.allclose(
        out_k.float() * valid, out_p.float() * valid, rtol=rtol, atol=atol),
        f"attention_seg {dts} {label} forward under autograd: finite, valid "
        f"rows max |err| {err:.3e} (rtol {rtol}, atol {atol})")
    check(all(bool(torch.isfinite(z).all()) for z in got),
          f"attention_seg_bwd {dts} {label}: every gradient finite")
    tol, floor = (1e-3, 1e-4) if x.dtype == torch.float32 else (5e-2, 1e-2)
    print(f"attention_seg_bwd {dts} {label} dropout {rate}, kernels vs "
          f"plain:")
    err_abs, _ = grads_close(got, want, tol, ATT_GRADS, floor)
    saved, seg_saved = out_k.grad_fn.saved_tensors, out_k.grad_fn.seg
    bwd = lambda: fused_relpos_attention_block_bwd(g, *saved, h, rate, seed,
                                                   seg_saved)
    check(all(torch.equal(a, c) for a, c in zip(bwd(), bwd())),
          f"attention_seg_bwd {dts} {label}: two calls give bit-equal "
          f"gradients")
    return err_abs, got, bwd, (*saved, seg_saved), out_p, leaves_p


def shuffled_seg_map(t: int = 200) -> np.ndarray:
    """(3, t) segment map whose ids do not rise along a row: 2, 1, 3, 1
    with guards; 2, 1, 2 end to end (a segment around another); one
    segment of id 4 off both ends."""
    seg = np.zeros((3, t), np.int32)
    seg[0, :40], seg[0, 48:100], seg[0, 108:150], seg[0, 158:] = 2, 1, 3, 1
    seg[1, :70], seg[1, 70:140], seg[1, 140:] = 2, 1, 2
    seg[2, 30:t - 30] = 4
    return seg


def seg_bwd_kernel_check(scfg, plan, bucketed):
    """Phase 17a: the segment-mode backward against autograd through the
    plain version at the student's width on `plan`'s rows (an all-guard
    row among them), fp32 and bf16, dropout 0.1; a shuffled map at a small
    size; ptxas registers and spills; times, the bound from the
    within-segment pairs and the device time a launch beside the unpacked
    backward at the bucketed shape of the same audio (`bucketed`: its
    (B,) subsampled lengths and T'). Returns the bf16 row."""
    from tpu_asr_torch.ops.cuda_attention import (
        fused_relpos_attention_block, fused_relpos_attention_block_bwd)
    from tpu_asr_torch.ops.positions import rel_positional_encoding

    regs = {k: v for k, v in {**nvcc_registers("dq_mma"),
                              **nvcc_registers("dkv_mma")}.items()
            if k.endswith(", true, false>")}
    check(regs and all(v[1:] == (0, 0) for v in regs.values()),
          f"ptxas: the segment mode's tensor-core backward kernels "
          f"{sorted(regs)} spill nothing")
    nvcc_registers("dq_kernel")       # the fp32 check kernels, printed
    nvcc_registers("dkv_kernel")
    enc = scfg.encoder
    d, h = enc.d_model, enc.n_heads
    dk = d // h
    rate, seed = enc.dropout, 2 ** 31 - 5
    gen = torch.Generator(device="cuda").manual_seed(17)
    pw = attention_weights(gen, d, h)
    seg_np = plan.seg_id
    r, t = seg_np.shape
    check((seg_np == 0).all(axis=1).any(), f"the plan's {r} rows of {t} "
          f"hold an all-guard row")
    seg = torch.from_numpy(seg_np).cuda()
    valid = (seg > 0)[..., None]
    xa = normal(gen, r, t, d, scale=0.5)
    ga = normal(gen, r, t, d) * valid
    label = f"({r} rows x {t}, D={d}, H={h}, {int(valid.sum())} valid)"
    for dt in (torch.float32, torch.bfloat16):
        err, got, bwd, reads, out_p, leaves_p = seg_bwd_compare(
            seg, xa.to(dt), ga.to(dt), pw, h, rate, seed, label)
    g = ga.to(torch.bfloat16)
    pairs = segment_pairs(seg_np)
    # as attention_flops(backward=True), the T x T products over the
    # within-segment pairs
    flops = (2 * r * t * d * d * 8 + 2 * (2 * t - 1) * d * d
             + 2 * h * pairs * dk * 8)
    nb = nbytes(g, *reads) + nbytes(*got)
    ms = median_ms(bwd)
    plain_ms = median_ms(lambda: torch.autograd.grad(out_p, leaves_p, g,
                                                     retain_graph=True))
    b_ms, by = bound(flops, nb, "bfloat16")
    dev, names = device_ms(bwd)
    # the unpacked backward on the same utterances, bucketed
    lens, tb = bucketed
    nb_rows = len(lens)
    lens = torch.as_tensor(lens, device="cuda")
    mask_b = torch.arange(tb, device="cuda")[None, :] < lens[:, None]
    xb = normal(gen, nb_rows, tb, d, scale=0.5).to(torch.bfloat16)
    leaves_b = [z.detach().requires_grad_() for z in (xb, *pw)]
    out_b = fused_relpos_attention_block(
        *leaves_b, rel_positional_encoding(tb, d, "cuda"), mask_b, h,
        dropout_rate=rate, dropout_seed=seed)
    gb = (normal(gen, nb_rows, tb, d) * mask_b[..., None]).to(torch.bfloat16)
    saved_b = out_b.grad_fn.saved_tensors
    dev_b, names_b = device_ms(lambda: fused_relpos_attention_block_bwd(
        gb, *saved_b, h, rate, seed))
    print(f"time attention_seg_bwd bfloat16 {label}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}; {pairs} "
          f"within-segment score pairs over the heads' rows, "
          f"{span_pairs(seg_np)} visited by the span tiles, dense "
          f"{r * t * t}); device {dev:.4f} ms a call "
          f"({top_kernels(names, 6)} a launch); unpacked at the bucketed "
          f"shape B={nb_rows} x T={tb} (the same utterances): device "
          f"{dev_b:.4f} ms a call ({top_kernels(names_b, 6)} a launch; "
          f"{nb_rows * tb * tb} score pairs, "
          f"{nb_rows * (-(-tb // 64) * 64) ** 2} in its 64-key tiles)")
    row = (err, ms, plain_ms, (b_ms, by), None)

    # a map whose ids do not rise along a row, fp32 and bf16
    seg_s = torch.from_numpy(shuffled_seg_map()).cuda()
    xs = normal(gen, 3, seg_s.shape[1], d, scale=0.5)
    gs = normal(gen, 3, seg_s.shape[1], d) * (seg_s > 0)[..., None]
    for dt in (torch.float32, torch.bfloat16):
        seg_bwd_compare(seg_s, xs.to(dt), gs.to(dt), pw, h, rate, seed,
                        "(shuffled ids, 3 rows x 200)")
    return row


def packed_kd_check(scfg, tcfg, batch):
    """Phase 17b: one fp32 packed flowkd_mlp8 step (`batch`: CHECK_BATCH
    utterances with their plan) on the kernels against the plain versions,
    the same weights and seeds: each loss within 1e-4 relative, every
    student and FM gradient by phase 9's rule, the teacher's parameters and
    statistics bit-unchanged, and the segment-mode backward launched."""
    import copy

    from tpu_asr_torch.config import OptimConfig
    from tpu_asr_torch.profile_forward import set_backend
    from tpu_asr_torch.profile_train import distill_config
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step)

    f32 = lambda cfg: dataclasses.replace(cfg, compute_dtype="float32")
    model = kd_model(f32(scfg), f32(tcfg), 20,
                     distill_config("flowkd_mlp8"))
    init = copy.deepcopy(model.state_dict())
    runs = {}
    for backend in ("auto", "xla"):
        model.load_state_dict(init)
        set_backend(model, backend)
        read = reset_counters()
        state = DistilTrainState.create(model, OptimConfig())
        state, metrics = make_distil_train_step(model, packed=True)(
            state, batch, 21)
        torch.cuda.synchronize()
        runs[backend] = (
            {k[5:]: v.item() for k, v in metrics.items()
             if k.startswith("loss/")},
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None},
            read())
        check(all(torch.equal(v, init[k]) for k, v in
                  model.state_dict().items() if k.startswith("teacher.")),
              f"fp32 packed flowkd_mlp8 step ({backend}): the teacher's "
              f"parameters and statistics bit-unchanged")
    set_backend(model, "auto")
    (lk, gk, ck), (lp, gp, cp) = runs["auto"], runs["xla"]
    n_utt = batch["signal"].shape[0]
    rows = batch["pk_seg"].shape
    check(ck["attention_seg_bwd"] > 0 and cp["attention_seg_bwd"] == 0,
          f"fp32 packed step: the segment-mode backward launched "
          f"{ck['attention_seg_bwd']} times on the kernels, "
          f"{cp['attention_seg_bwd']} on the plain versions")
    check(set(lk) == {"ctc", "flow_matching", "logit_kd", "total"},
          f"fp32 packed step losses {sorted(lk)}")
    for loss in sorted(lk):
        check(math.isfinite(lk[loss])
              and abs(lk[loss] - lp[loss]) <= 1e-4 * abs(lp[loss]),
              f"fp32 packed flowkd_mlp8 step ({n_utt} utterances in "
              f"{rows[0]} rows of {rows[1]}, dropout, SpecAugment, dither) "
              f"loss/{loss}: kernels {lk[loss]:.6f} vs plain {lp[loss]:.6f} "
              f"(1e-4 rel)")
    check(set(gk) == set(gp), f"fp32 packed step: {len(gk)} student and FM "
          f"gradients")
    print("fp32 packed flowkd_mlp8 step gradients, kernels vs plain:")
    grads_close([gk[n] for n in gk], [gp[n] for n in gk], 1e-2, list(gk),
                1e-4, verbose=False)


def encoder_step_ms(model, batches, packed: bool) -> float:
    """Device ms (torch.profiler) of the student encoder's training forward
    and backward a batch, on the pre-encoded frames of each batch: packed
    rows (encode_packed with the plan) or the bucketed batch
    (encode_frames); mean over the batches."""
    total = 0.0
    for batch in batches:
        with torch.no_grad():
            x, lens = model.student.pre_encode_aug(batch["signal"],
                                                   batch["signal_len"])
            if packed:
                seg = batch["pk_seg"].long()
                x = torch.where((seg > 0)[..., None],
                                x[batch["pk_src_utt"].long(),
                                  batch["pk_src_pos"].long()], 0)
        gen = torch.Generator().manual_seed(0)

        def run():
            if packed:
                out = model.student.encode_packed(x, seg, True,
                                                  {"dropout": gen})[0]
            else:
                out = model.student.encoder.encode_frames(x, lens, True,
                                                          gen)[0]
            out.float().square().mean().backward()

        total += device_ms(run, iters=2)[0]
    return total / len(batches)


def packed_train_phase(tcfg):
    """Phase 17, packed KD training. Returns ({'attention_seg_bwd': the
    bf16 row of 17a}, {'attention_seg_bwd': its launches in 17c's timed
    packed pass})."""
    from tpu_asr_torch.config import make_student_config
    from tpu_asr_torch.data.packing import train_pack_arrays
    from tpu_asr_torch.models.conformer import subsampled_length
    from tpu_asr_torch.ops.features import stft_seq_len
    from tpu_asr_torch.profile_train import (T_PACK as TP, packed_batches,
                                             profile_packed)

    scfg = make_student_config(tcfg)
    batches = packed_batches(scfg)
    plans = [p for *_, p in batches]
    # 17a on the largest batch whose rows hold an all-guard row
    i = next(k for k, (b, _, _, p) in enumerate(batches)
             if (p.seg_id == 0).all(axis=1).any())
    big = max(b["signal"].shape[0] for b, *_ in batches)
    check(batches[i][0]["signal"].shape[0] == big,
          f"17a takes a batch of the largest size ({big} utterances)")
    t_bucket = lambda b: int(subsampled_length(stft_seq_len(
        b["signal"].shape[1], scfg.preprocessor.n_fft,
        scfg.preprocessor.hop_length)))
    row = seg_bwd_kernel_check(scfg, plans[i],
                               (plans[i].length, t_bucket(batches[i][0])))

    # 17b: CHECK_BATCH utterances of that batch, packed without padding
    b0 = batches[i][0]
    cb = {k: v[:CHECK_BATCH] for k, v in b0.items()}
    cb["signal"] = cb["signal"][:, :int(cb["signal_len"].max())]
    pre, enc = scfg.preprocessor, scfg.encoder
    pk, _ = train_pack_arrays(cb["signal_len"].cpu().numpy(), pre.n_fft,
                              pre.hop_length, enc.subsampling_factor,
                              enc.subsampling, enc.conv_kernel_size, TP)
    cb.update({k: torch.from_numpy(v).cuda() for k, v in pk.items()})
    packed_kd_check(scfg, tcfg, cb)

    # 17c: bench_train.py's packed_train, bucketed and packed, bf16, on
    # 17a's batch alone: one packed step launches every kernel of the path
    # and every attention backward in its segment mode, which is all 17c
    # checks (the other six batches added time and no check)
    batches = [batches[i]]
    plans = [plans[i]]
    res = profile_packed(batches=batches, counters=reset_counters)
    for tag, r in res.items():
        check(all(math.isfinite(x) for x in r.losses),
              f"bf16 flowkd_mlp8 {tag} steps: losses finite")
    enc_ms = {tag: encoder_step_ms(r.model, r.batches, tag == "packed")
              for tag, r in res.items()}
    pk_counts = res["packed"].counts
    want = ("logmel", "subsampling", "attention", "attention_bwd",
            "attention_seg_bwd", "ffn", "ffn_bwd", "ctc", "ctc_bwd", "fm",
            "fm_bwd")
    check(all(pk_counts[k] > 0 for k in want)
          and pk_counts["attention_seg_bwd"]
          == pk_counts["attention_bwd"]
          and res["bucketed"].counts["attention_seg_bwd"] == 0,
          f"packed steps launched every kernel, every attention backward in "
          f"its segment mode: { {k: pk_counts[k] for k in want} }")
    print(f"student encoder's forward and backward, device ms a batch, "
          f"packed over bucketed (same run): {enc_ms['packed']:.4f} / "
          f"{enc_ms['bucketed']:.4f} = "
          f"{enc_ms['packed'] / enc_ms['bucketed']:.3f}x; "
          f"rows a batch {[p.n_rows for p in plans]} of {TP} against "
          f"bucketed (rows, T') "
          f"{[(b['signal'].shape[0], t_bucket(b)) for b, *_ in batches]}")
    return ({"attention_seg_bwd": row},
            {"attention_seg_bwd": pk_counts["attention_seg_bwd"]})


# ---------------------------------------------------------------------------
# Phases 18 and 19: conformer-LARGE and conformer-XLarge
# ---------------------------------------------------------------------------

XL_FP32_T = 160     # the fp32 attention backward's longest T at dk 128
XL_LAYERS = 8       # phase 19's depth (its widths are XLarge's own)
DK128 = ("core_mma_kernel<128", "dq_mma_kernel<128", "dkv_mma_kernel<128")


def names_check(fn, parts, absent, label: str, iters: int = 5):
    """Profile `iters` calls of fn() (profiled_kernels) and check that each
    of `parts` names a recorded kernel and none of `absent` does. Returns
    (busy ms a call, {kernel: ms a launch})."""
    dev, names = profiled_kernels(fn, *parts, iters=iters)
    short = sorted({kernel_short(k) for k in names})
    shown = [k for k in short if any(p.split("<")[0] in k
                                     for p in (*parts, *absent))]
    check(all(any(p in k for k in short) for p in parts)
          and not any(a in k for a in absent for k in short),
          f"{label}: the profiler's attention kernels {shown} hold "
          f"{list(parts)} and none of {list(absent)}")
    return dev, names


def dk128_kernel_phase():
    """Phase 19a: the block and per-head attention kernels at dk 128
    (conformer-XLarge: B=32 x T'=376, D=1024, 8 heads) against their plain
    versions in fp32 and bf16, dropout 0 and 0.1: the forward by phase
    3's tolerances, the bf16 backward by phase 6's gradient rule with two
    calls bit-equal; the fp32 backward at T = XL_FP32_T (B=8), its limit,
    and refused one frame past it and at T'=376; the segment mode in bf16
    on the packed serve map by phase 17's rules. ptxas registers and
    spills, times, bounds and device times. Returns the four dk-128 rows
    in bf16."""
    from tpu_asr_torch.models.conformer import rel_positional_encoding
    from tpu_asr_torch.ops.cuda_attention import (
        attention_refusal, fused_relpos_attention,
        fused_relpos_attention_block, fused_relpos_attention_block_bwd,
        fused_relpos_attention_bwd, relpos_attention_heads_plain,
        relpos_attention_plain)
    from tpu_asr_torch.ops.cuda_subsampling import out_len

    for prefix in (*DK128, "core_kernel<float", "dq_kernel<float",
                   "dkv_kernel<float"):
        regs = nvcc_registers(prefix)
        check(regs, f"ptxas built {prefix}: {sorted(regs)}")
    gen = torch.Generator(device="cuda").manual_seed(60)
    d, h = 1024, 8
    t = out_len(out_len(SECONDS * SR // 160 + 1))
    seed = 2 ** 31 - 9

    def ragged(b, t_):
        lengths = torch.randint(t_ // 4, t_ + 1, (b,), generator=gen,
                                device="cuda")
        lengths[0] = t_
        return torch.arange(t_, device="cuda")[None, :] < lengths[:, None]

    rows = {}
    pw = attention_weights(gen, d, h)
    for b, t_ in ((BATCH, t), (8, XL_FP32_T)):
        mask = ragged(b, t_)
        valid = mask[..., None]
        pos_emb = rel_positional_encoding(t_, d, "cuda")
        xa = normal(gen, b, t_, d, scale=0.5)
        ga = normal(gen, b, t_, d) * valid
        label = f"dk 128 (B={b}, T={t_}, D={d}, H={h})"
        for dt in (torch.float32, torch.bfloat16):
            dts = str(dt)[6:]
            x = xa.to(dt)
            aargs = (x, *pw, pos_emb, mask, h)
            grads = dt == torch.bfloat16 or t_ <= XL_FP32_T
            main = b == BATCH and dt == torch.bfloat16
            for rate in (0.0, 0.1):
                with torch.no_grad():
                    got = fused_relpos_attention_block(
                        *aargs, dropout_rate=rate, dropout_seed=seed).float()
                    want = relpos_attention_plain(*aargs, rate, seed).float()
                torch.cuda.synchronize()
                err = ((got - want).abs() * valid).max().item()
                rtol, atol = ((1e-4, 1e-4) if dt == torch.float32
                              else (1e-2, 3e-3))
                check(torch.allclose(got * valid, want * valid, rtol=rtol,
                                     atol=atol),
                      f"attention {dts} {label} dropout {rate}: valid rows "
                      f"max |err| {err:.3e} (rtol {rtol}, atol {atol})")
                if main and rate == 0.0:
                    with torch.no_grad():
                        fwd = lambda: fused_relpos_attention_block(*aargs)
                        rows["attention_dk128"] = (
                            err, median_ms(fwd),
                            median_ms(lambda: relpos_attention_plain(*aargs)),
                            bound(attention_flops(b, t_, d, h),
                                  nbytes(x, *pw) + got.numel()
                                  * x.element_size(), dts), None)
                        dev, names = names_check(
                            fwd, DK128[:1], ("core_mma_kernel<64",
                                             "core_kernel"),
                            f"attention bf16 {label}")
                    print(f"device attention bfloat16 {label} ({DEVICE}): "
                          f"{dev:.4f} ({top_kernels(names)})")
                if not grads:
                    continue
                leaves = [z.detach().requires_grad_() for z in (x, *pw)]
                out_k = fused_relpos_attention_block(
                    *leaves, pos_emb, mask, h, dropout_rate=rate,
                    dropout_seed=seed)
                g = ga.to(dt)
                got_g = torch.autograd.grad(out_k, leaves, g,
                                            retain_graph=True)
                leaves_p = [z.detach().requires_grad_() for z in (x, *pw)]
                out_p = relpos_attention_plain(*leaves_p, pos_emb, mask, h,
                                               rate, seed)
                want_g = torch.autograd.grad(out_p, leaves_p, g,
                                             retain_graph=True)
                torch.cuda.synchronize()
                tol, floor = ((1e-3, 1e-4) if dt == torch.float32
                              else (5e-2, 1e-2))
                print(f"attention_bwd {dts} {label} dropout {rate}, kernels "
                      f"vs plain:")
                err_abs, _ = grads_close(got_g, want_g, tol, ATT_GRADS,
                                         floor, verbose=False)
                saved = out_k.grad_fn.saved_tensors
                bwd = lambda: fused_relpos_attention_block_bwd(
                    g, *saved, h, rate, seed)
                check(all(torch.equal(a, b_) for a, b_ in zip(bwd(), bwd())),
                      f"attention_bwd {dts} {label} dropout {rate}: two "
                      f"calls give bit-equal gradients")
                if main and rate > 0:
                    rows["attention_bwd_dk128"] = (
                        err_abs, median_ms(bwd),
                        median_ms(lambda: torch.autograd.grad(
                            out_p, leaves_p, g, retain_graph=True)),
                        bound(attention_flops(b, t_, d, h, backward=True),
                              nbytes(g, *saved) + nbytes(*got_g), dts), None)
                    dev, names = names_check(bwd, DK128[1:], (
                        "dq_mma_kernel<64", "dq_kernel"),
                        f"attention_bwd bf16 {label}")
                    print(f"device attention_bwd bfloat16 {label} "
                          f"({DEVICE}): {dev:.4f} ({top_kernels(names, 6)})")
    # the segment mode (packed rows) at dk 128: bf16 on the packed serve
    # map (16 rows x 512), dropout 0.1, the cotangent zero on guard frames
    from tpu_asr_torch.profile_forward import packed_seg_map
    seg = torch.from_numpy(packed_seg_map()).cuda()
    xs = normal(gen, *seg.shape, d, scale=0.5).to(torch.bfloat16)
    gs = (normal(gen, *seg.shape, d) * (seg > 0)[..., None]).to(torch.bfloat16)
    seg_bwd_compare(seg, xs, gs, pw, h, 0.1, seed,
                    f"dk 128 ({seg.shape[0]} x {seg.shape[1]}, D={d}, H={h})")
    check(attention_refusal(torch.float32, d, h, XL_FP32_T, True) is None
          and attention_refusal(torch.float32, d, h, XL_FP32_T + 1, True)
          and attention_refusal(torch.bfloat16, d, h, t, True) is None,
          f"fp32 attention backward at dk 128 takes T <= {XL_FP32_T}; bf16 "
          f"takes T={t}")
    xg = normal(gen, 1, t, d).requires_grad_()
    refused(lambda: fused_relpos_attention_block(
        xg, *pw, rel_positional_encoding(t, d, "cuda"), ragged(1, t), h),
        f"autograd through the fp32 block attention at dk 128, T={t}")

    # the per-head function at dk 128
    w_pos = normal(gen, d, d, scale=d ** -0.5)
    for b, t_ in ((BATCH, t), (8, XL_FP32_T)):
        mask = ragged(b, t_)
        heads = [normal(gen, b, h, t_, 128, scale=0.5) for _ in range(4)]
        label = f"dk 128 (B={b}, H={h}, T={t_})"
        for dt in (torch.float32, torch.bfloat16):
            args = [z.to(dt) for z in heads] + [w_pos.to(dt), mask]
            grads = dt == torch.bfloat16 or t_ <= XL_FP32_T
            main = b == BATCH and dt == torch.bfloat16
            for rate in (0.0, 0.1):
                err, gerr, saved, g, plain = heads_compare(
                    args, (-1, -1), rate, seed, label, grads=grads)
                if main and rate == 0.0:
                    flops = (6 * b * h * t_ * t_ * 128
                             + 2 * (2 * t_ - 1) * d * d)
                    with torch.no_grad():
                        rows["attention_heads_dk128"] = (
                            err, median_ms(lambda: fused_relpos_attention(
                                *args)),
                            median_ms(lambda: relpos_attention_heads_plain(
                                *args)),
                            bound(flops, nbytes(*args[:5]) + nbytes(args[0]),
                                  "bfloat16"), None)
                        dev, names = names_check(
                            lambda: fused_relpos_attention(*args), DK128[:1],
                            ("core_mma_kernel<64", "core_kernel"),
                            f"attention_heads bf16 {label}")
                    print(f"device attention_heads bfloat16 {label} "
                          f"({DEVICE}): {dev:.4f} ({top_kernels(names)})")
                if not grads:
                    continue
                bwd = lambda: fused_relpos_attention_bwd(g, *saved, (-1, -1),
                                                         rate, seed)
                check(all(torch.equal(a, b_) for a, b_ in zip(bwd(), bwd())),
                      f"attention_heads_bwd {str(dt)[6:]} {label} dropout "
                      f"{rate}: two calls give bit-equal gradients")
                if main and rate > 0:
                    leaves_p, out_p = plain
                    flops = (16 * b * h * t_ * t_ * 128
                             + 2 * (2 * t_ - 1) * d * d)
                    rows["attention_heads_bwd_dk128"] = (
                        gerr, median_ms(bwd),
                        median_ms(lambda: torch.autograd.grad(
                            out_p, leaves_p, g, retain_graph=True)),
                        bound(flops, nbytes(g, *saved) + nbytes(*args[:5]),
                              "bfloat16"), None)
                    dev, names = names_check(bwd, DK128[1:], (
                        "dq_mma_kernel<64", "dq_kernel"),
                        f"attention_heads_bwd bf16 {label}")
                    print(f"device attention_heads_bwd bfloat16 {label} "
                          f"({DEVICE}): {dev:.4f} ({top_kernels(names, 6)})")
    refused(lambda: fused_relpos_attention(
        *[normal(gen, 1, 2, 8, 132) for _ in range(4)],
        normal(gen, 264, 264), ragged(1, 8)),
        "fused_relpos_attention at dk=132")
    for name, (err, ms, plain_ms, (b_ms, by), _) in rows.items():
        print(f"time {name} bfloat16: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) (median of 20, "
              f"CUDA events)")
    return rows


def ctc_train_model(cfg, seed: int):
    """DistilCTCModel(cfg, ModelConfig(), DistillationConfig()) on the card,
    seeded: bench_train.py's CTC-only step of a model (the teacher gated
    off)."""
    from tpu_asr_torch.config import DistillationConfig, ModelConfig
    from tpu_asr_torch.models.distil_model import DistilCTCModel
    from tpu_asr_torch.profile_forward import built_on, seed_weights
    model = built_on(DistilCTCModel, cfg, ModelConfig(), DistillationConfig())
    return seed_weights(model, seed).cuda()


def model_label(name: str, cfg) -> str:
    enc = cfg.encoder
    return (f"{name} ({enc.n_layers} x d{enc.d_model}, {enc.n_heads} heads, "
            f"d_ff {enc.d_ff}, k={enc.conv_kernel_size})")


def timed_ctc_steps(cfg, name: str, steps: int, warmup: int, seed: int,
                    rows=None):
    """`steps` timed bf16 CTC steps of `cfg` at B=32 x 15 s with 48 tokens
    after `warmup`: losses finite, every kernel of `rows` (CTC_STEP by
    default) launched. Returns {row: launches}."""
    ms, counts, metrics = timed_steps(ctc_train_model(cfg, seed),
                                      train_batch(BATCH, seed + 1), seed + 2,
                                      steps, warmup)
    counts = {k: v for k, v in counts.items() if k in (rows or CTC_STEP)}
    losses = torch.stack([m["loss/total"] for m in metrics]).tolist()
    check(all(math.isfinite(x) for x in losses),
          f"bf16 {name} CTC steps: losses finite, first {losses[0]:.4f} "
          f"last {losses[-1]:.4f}")
    check(all(v > 0 for v in counts.values()),
          f"{name} CTC steps launched every kernel: {counts}")
    print(f"train: {model_label(name, cfg)} ({cfg.compute_dtype}) CTC step "
          f"B={BATCH} x {SECONDS} s, {TOKENS} tokens: "
          f"{timed_summary(ms, steps, warmup)}")
    return counts


def large_phase():
    """Phase 18: conformer-LARGE. Returns (RTFx fp, RTFx int8)."""
    from tpu_asr_torch.profile_forward import model_config

    cfg = model_config("large")
    name = "conformer-LARGE"
    t0 = time.perf_counter()
    model_phase(cfg, model_label(name, cfg))
    print(f"phase 18a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, rtfx = serve_phase(cfg)
    int8_cfg = with_encoder(cfg, quantization="int8", conv_backend="pallas")
    int8_model_phase(int8_cfg, model_label(name, cfg))
    _, int8_rtfx = serve_phase(int8_cfg, INT8_SERVING)
    print(f"serve RTFx {name}: int8 + conv kernel {int8_rtfx:.1f}, fp "
          f"{rtfx:.1f}, same run")
    print(f"phase 18b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fp32_step_check(ctc_train_model(dataclasses.replace(
        cfg, compute_dtype="float32"), 20), train_batch(CHECK_BATCH, 21), 22,
        f"fp32 {model_label(name, cfg)} CTC step (B={CHECK_BATCH} x "
        f"{SECONDS} s, dropout {cfg.encoder.dropout}, dither)")
    timed_ctc_steps(cfg, name, TRAIN_STEPS, TRAIN_WARMUP, 23)
    print(f"phase 18c: {time.perf_counter() - t0:.1f} s")
    return rtfx, int8_rtfx


def bf16_step_check(cfg, name: str, seed: int) -> None:
    """One CTC step at B=CHECK_BATCH x 15 s from the same weights and
    seeds: fp32 on the plain versions (the reference), bf16 on the kernels
    and bf16 plain. The kernels' loss and each parameter's gradient may
    deviate from the reference by at most 2x the plain bf16 step's
    deviation, floored at bf16's unit roundoff (2^-8) of the reference's
    scale (the loss, each gradient tensor's max |g|): the plain bf16 step
    can land within rounding of fp32 by chance, and a scalar or a small
    tensor has no spread to average that over. The gradients that are zero
    in exact arithmetic (key biases, the depthwise conv bias) within 5e-2 of
    1e-2 x the largest gradient, grads_close's bf16 rule for them. Every
    attention backward of the kernel step launches dq_mma_kernel<128> and
    dkv_mma_kernel<128> (profiled), one a layer (counter)."""
    from tpu_asr_torch.config import OptimConfig
    from tpu_asr_torch.profile_forward import set_backend
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step)

    batch = train_batch(CHECK_BATCH, seed + 1)
    runs = {}
    for dt, backend in (("float32", "xla"), ("bfloat16", "auto"),
                        ("bfloat16", "xla")):
        t0 = time.perf_counter()
        model = ctc_train_model(dataclasses.replace(cfg, compute_dtype=dt),
                                seed)
        set_backend(model, backend)
        read = reset_counters()
        metrics, grads, *_ = step_run(model, batch, seed + 2)
        runs[dt, backend] = (metrics["loss/total"].item(), grads, read())
        print(f"{name} CTC step {dt} {backend} (B={CHECK_BATCH}): "
              f"{time.perf_counter() - t0:.1f} s with the model's build")
        if backend == "auto":
            state = DistilTrainState.create(model, OptimConfig())
            step = make_distil_train_step(model)
            names_check(lambda: step(state, batch, seed + 2), DK128,
                        ("core_mma_kernel<64", "dq_mma_kernel<64",
                         "core_kernel", "dq_kernel"),
                        f"bf16 {name} CTC step on the kernels", iters=1)
        del model
        torch.cuda.empty_cache()
    (l_ref, g_ref, _), (l_k, g_k, counts), (l_p, g_p, _) = runs.values()
    n_layers = cfg.encoder.n_layers
    runs_fwd = 2 if cfg.encoder.remat else 1   # a checkpointed layer twice
    check(counts["attention_bwd"] == n_layers
          and counts["attention"] == runs_fwd * n_layers,
          f"bf16 {name} CTC step on the kernels: attention forward "
          f"{counts['attention']} ({runs_fwd} x {n_layers} layers), backward "
          f"{counts['attention_bwd']} ({n_layers})")
    unit = 2.0 ** -8
    dl_k, dl_p = abs(l_k - l_ref), abs(l_p - l_ref)
    check(math.isfinite(l_k) and dl_k <= 2 * max(dl_p, unit * abs(l_ref)),
          f"bf16 {name} CTC step (B={CHECK_BATCH} x {SECONDS} s): loss "
          f"kernels {l_k:.6f}, plain bf16 {l_p:.6f}, fp32 plain {l_ref:.6f}: "
          f"|delta| {dl_k:.3e} <= 2 x max({dl_p:.3e}, 2^-8 x |ref|)")
    # the key biases (softmax ignores a per-query constant) and the
    # depthwise conv bias before BatchNorm have gradient zero in exact
    # arithmetic (tests/test_torch_train.py names them too): they hold only
    # the rounding noise of a sum over B x T rows, which the kernels take
    # over bf16 rows, so they have no deviation of their own to compare and
    # are held as grads_close holds them in bf16 (5e-2 of 1e-2 x the
    # largest gradient)
    top = max(g.abs().max().item() for g in g_ref.values())
    worst, floored, zero = 0.0, 0, []
    for n in g_ref:
        ref = g_ref[n].float()
        scale = ref.abs().max().item()
        dk_ = (g_k[n].float() - ref).abs().max().item()
        dp_ = (g_p[n].float() - ref).abs().max().item()
        if n.endswith(("linear_k.bias", "depthwise_conv.bias")):
            zero.append((dk_, dp_, n))
            continue
        allow = max(dp_, unit * scale)
        floored += dp_ < unit * scale
        worst = max(worst, dk_ / max(allow, 1e-30))
        if dk_ > 2 * allow:
            check(False, f"  {n}: kernels' |delta| {dk_:.3e} > 2 x max("
                  f"plain bf16's {dp_:.3e}, 2^-8 x {scale:.3e})")
    check(worst <= 2.0, f"bf16 {name} CTC step: {len(g_ref) - len(zero)} "
          f"gradients, the kernels' deviation from fp32 at most "
          f"{worst:.3f} x the plain bf16 step's (<= 2; {floored} floored at "
          f"2^-8 of the scale)")
    zk, zp, zn = max(zero, default=(0.0, 0.0, "none"))
    check(zk <= 5e-2 * 1e-2 * top, f"bf16 {name} CTC step: {len(zero)} "
          f"key and depthwise-conv biases (gradient zero in exact "
          f"arithmetic), the kernels' largest deviation {zk:.3e} ({zn}; "
          f"plain bf16's {zp:.3e}) <= 5e-2 x 1e-2 x the largest gradient "
          f"{top:.3e}")


def xlarge_phase():
    """Phase 19: conformer-XLarge. Returns ({row: measured}, {row:
    launches})."""
    from tpu_asr_torch.models.ctc_model import CTCModel
    from tpu_asr_torch.ops.cuda_subsampling import out_len
    from tpu_asr_torch.profile_forward import (model_config, seed_weights,
                                               seeded_model)

    cfg = with_encoder(model_config("xlarge"), n_layers=XL_LAYERS)
    name = f"conformer-XLarge ({XL_LAYERS} of its 24 layers)"
    read = reset_counters()
    t0 = time.perf_counter()
    rows = dk128_kernel_phase()
    heads_counts = read()
    print(f"phase 19a: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(61)
    pre = cfg.preprocessor
    n_frames = SECONDS * SR // pre.hop_length + 1
    feats = normal(gen, BATCH, n_frames, pre.features)
    w = subsampling_weights(gen, 1024, 1024, out_len(out_len(pre.features)))
    for dt in (torch.float32, torch.bfloat16):
        row = subsampling_case(feats.to(dt), w, dt == torch.bfloat16)
    rows["subsampling_c1024"] = row
    err, ms, plain_ms, (b_ms, by), _ = row
    print(f"time subsampling_c1024 bfloat16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) (median of 20, CUDA "
          f"events)")
    print(f"phase 19b: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    counts = model_phase(cfg, model_label(name, cfg))
    check(counts["attention"] == cfg.encoder.n_layers,
          f"{name} fp32 forward on the kernels: {counts['attention']} "
          f"attention launches, one a layer ({cfg.encoder.n_layers}): "
          f"'auto' takes the kernel at dk 128")
    print(f"phase 19c: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    start = time.perf_counter()
    seed_weights(CTCModel(cfg), 2)
    on_cpu = time.perf_counter() - start
    start = time.perf_counter()
    model = seeded_model(cfg, seed=2)
    torch.cuda.synchronize()
    print(f"{name}: {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"parameters built and seeded on the card in "
          f"{time.perf_counter() - start:.2f} s (on the CPU: {on_cpu:.2f} s)")
    sig_t, len_t = model_clips(1)
    read = reset_counters()
    with torch.inference_mode():
        model(sig_t, len_t)
        n = read()["attention"]
        names_check(lambda: model(sig_t, len_t), DK128[:1],
                    ("core_mma_kernel<64", "core_kernel"),
                    f"{name} bf16 forward")
    check(n == cfg.encoder.n_layers, f"{name} bf16 forward: {n} attention "
          f"launches, one a layer")
    del model
    serve_counts, rtfx = serve_phase(cfg)
    print(f"phase 19d: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    bf16_step_check(cfg, name, 30)
    train_counts = timed_ctc_steps(cfg, name, 2, 1, 33)
    print(f"phase 19e: {time.perf_counter() - t0:.1f} s")
    launches = {"attention_dk128": serve_counts["attention"],
                "attention_bwd_dk128": train_counts["attention_bwd"],
                "attention_heads_dk128": heads_counts["attention_heads"],
                "attention_heads_bwd_dk128":
                    heads_counts["attention_heads_bwd"],
                "subsampling_c1024": serve_counts["subsampling"]}
    return rows, launches, rtfx


FC_WINDOW = (128, 128)       # fastconformer_local's att_context_size
FP32_BWD_T = 600             # the fp32 backward takes T <= 608 at dk 64
NARROW_T, NARROW_MAX = 4096, 0.25   # windowed core / full-context core
LONG_POOL, LONG_CLIPS, LONG_WARMUP, LONG_REQUESTS = 12, 4, 2, 16


def window_pairs(t: int, left: int, right: int) -> int:
    """Score pairs (t, s) of one (batch row, head) inside the window
    -left <= s - t <= right (-1: unlimited) over T keys."""
    q = np.arange(t)
    lo = np.maximum(q - left, 0) if left >= 0 else np.zeros(t, np.int64)
    hi = np.minimum(q + right, t - 1) if right >= 0 else np.full(t, t - 1)
    return int((hi - lo + 1).sum())


def window_tile_pairs(t: int, left: int, right: int, tile: int = 64) -> int:
    """Score pairs the bf16 windowed core visits for one (batch row, head):
    per 64-query tile, the 64-key tiles of its window (core_mma.cuh's
    window_tiles)."""
    n, total = -(-t // tile), 0
    for q0 in range(0, t, tile):
        lo = max(q0 - left, 0) // tile if left >= 0 else 0
        hi = min(n, (q0 + tile - 1 + right) // tile + 1) if right >= 0 else n
        total += (hi - lo) * tile * min(tile, t - q0)
    return total


def window_flops(b, t, d, h, pairs, backward=False):
    """attention_flops with the T x T score products over `pairs` in-window
    pairs a (batch row, head) instead of T^2."""
    dk = d // h
    if not backward:
        return (2 * b * t * d * d * 4 + 2 * (2 * t - 1) * d * d
                + 2 * b * h * pairs * dk * 3)
    return (2 * b * t * d * d * 8 + 2 * (2 * t - 1) * d * d
            + 2 * b * h * pairs * dk * 8)


def window_case(gen, pw, h, b, t, window, seg=None, timed=()):
    """The block attention with `window` (and the segment map `seg`, (B, T)
    int32, or ragged lengths) against its plain version, fp32 and bf16,
    dropout 0 and 0.1: the forward finite on every row, in fp32 on valid
    rows by phase 3's tolerances; in bf16 by phase 4's rule, against the
    plain version in fp32 on the same bf16 operands, the kernel's largest
    deviation at most 2x the plain bf16 version's: a narrow window (9 keys
    at (8, 0)) leaves context rows near |v|, where the two bf16 orders land
    on bf16 values up to 2 ulps apart on either side of the fp32 value
    (4 of 784,384 elements beyond phase 3's tolerance, both 4.7e-3 from
    fp32 at most, on NVIDIA H100 80GB HBM3, 700 W); the count beyond
    phase 3's tolerance is printed. The backward (fp32 only up to
    FP32_BWD_T) by phase 6's gradient rule, finite, two calls bit-equal.
    Returns the bf16
    rows named in `timed`, "attention_window" (the forward, dropout 0)
    and "attention_window_bwd" (the backward, dropout 0.1): (error, kernel
    ms, plain ms, bound over the in-window pairs, None), each printed with
    its device time a launch and the pairs the visited tiles cover."""
    from tpu_asr_torch.ops.cuda_attention import (
        bwd_refusal, fused_relpos_attention_block,
        fused_relpos_attention_block_bwd, relpos_attention_plain)
    from tpu_asr_torch.ops.positions import rel_positional_encoding

    d = pw[0].shape[0]
    if seg is None:
        lengths = torch.randint(t // 4, t + 1, (b,), generator=gen,
                                device="cuda")
        lengths[0] = t
        mask = torch.arange(t, device="cuda")[None, :] < lengths[:, None]
    else:
        mask = seg > 0
    valid = mask[..., None]
    pos_emb = rel_positional_encoding(t, d, "cuda")
    xa = normal(gen, b, t, d, scale=0.5)
    ga = normal(gen, b, t, d) * valid
    seed = 2 ** 31 - 11
    pairs = b * window_pairs(t, *window)
    visited = b * window_tile_pairs(t, *window)
    label = (f"window {window} (B={b}, T={t}, D={d}, H={h}"
             f"{', segments' if seg is not None else ''})")
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        dts_ = str(dt)[6:]
        x = xa.to(dt)
        aargs = (x, *pw, pos_emb, mask, h)
        fwd = lambda rate=0.0: fused_relpos_attention_block(
            *aargs, att_context_size=window, dropout_rate=rate,
            dropout_seed=seed, seg_id=seg)
        plain = lambda rate=0.0: relpos_attention_plain(*aargs, rate, seed,
                                                        seg, window)
        for rate in (0.0, 0.1):
            with torch.no_grad():
                got, want = fwd(rate).float(), plain(rate).float()
                ref = relpos_attention_plain(
                    x.float(), *(z.to(dt).float() if z.shape == (d, d)
                                 else z for z in pw), pos_emb, mask, h, rate,
                    seed, seg, window)
            torch.cuda.synchronize()
            err = ((got - want).abs() * valid).max().item()
            finite = bool(torch.isfinite(got).all())
            if dt == torch.float32:
                check(finite and torch.allclose(got * valid, want * valid,
                                                rtol=1e-4, atol=1e-4),
                      f"attention_window {dts_} {label} dropout {rate}: "
                      f"finite, valid rows max |err| {err:.3e} (rtol 1e-4, "
                      f"atol 1e-4)")
            else:
                e_k = ((got - ref).abs() * valid).max().item()
                e_p = ((want - ref).abs() * valid).max().item()
                beyond = int((((got - want).abs() > 3e-3 + 1e-2 * want.abs())
                              & valid).sum())
                check(finite and e_k <= 2 * e_p,
                      f"attention_window {dts_} {label} dropout {rate}: "
                      f"finite; against fp32 plain, valid rows max |err| "
                      f"kernel {e_k:.3e} <= 2 x plain bf16 {e_p:.3e}; "
                      f"kernel vs plain bf16 {err:.3e}, {beyond} of "
                      f"{int(valid.sum()) * d} beyond phase 3's rtol 1e-2, "
                      f"atol 3e-3")
            if ("attention_window" in timed and dt == torch.bfloat16
                    and rate == 0.0):
                with torch.no_grad():
                    rows["attention_window"] = (
                        err, median_ms(fwd), median_ms(plain),
                        bound(window_flops(b, t, d, h, pairs // b),
                              nbytes(x, *pw) + got.numel()
                              * x.element_size(), dts_), None)
                    dev, names = device_ms(fwd)
                print(f"device attention_window bfloat16 {label} ({DEVICE}):"
                      f" {dev:.4f} ({top_kernels(names, 3)}); score pairs "
                      f"{pairs} a head in the window, {visited} visited by "
                      f"the core's tiles, dense {b * t * t}")
            if bwd_refusal(dt, t, d // h):
                continue
            leaves = [z.detach().requires_grad_() for z in (x, *pw)]
            out_k = fused_relpos_attention_block(
                *leaves, pos_emb, mask, h, att_context_size=window,
                dropout_rate=rate, dropout_seed=seed, seg_id=seg)
            g = ga.to(dt)
            got_g = torch.autograd.grad(out_k, leaves, g, retain_graph=True)
            leaves_p = [z.detach().requires_grad_() for z in (x, *pw)]
            out_p = relpos_attention_plain(*leaves_p, pos_emb, mask, h, rate,
                                           seed, seg, window)
            want_g = torch.autograd.grad(out_p, leaves_p, g,
                                         retain_graph=True)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(z).all()) for z in got_g),
                  f"attention_window_bwd {dts_} {label} dropout {rate}: "
                  f"every gradient finite")
            tol, floor = ((1e-3, 1e-4) if dt == torch.float32
                          else (5e-2, 1e-2))
            print(f"attention_window_bwd {dts_} {label} dropout {rate}, "
                  f"kernels vs plain:")
            err_abs, _ = grads_close(got_g, want_g, tol, ATT_GRADS, floor,
                                     verbose=False)
            saved = out_k.grad_fn.saved_tensors
            bwd = lambda: fused_relpos_attention_block_bwd(
                g, *saved, h, rate, seed, seg, window)
            check(all(torch.equal(a, c) for a, c in zip(bwd(), bwd())),
                  f"attention_window_bwd {dts_} {label} dropout {rate}: two "
                  f"calls give bit-equal gradients")
            if ("attention_window_bwd" in timed and dt == torch.bfloat16
                    and rate > 0):
                rows["attention_window_bwd"] = (
                    err_abs, median_ms(bwd),
                    median_ms(lambda: torch.autograd.grad(
                        out_p, leaves_p, g, retain_graph=True)),
                    bound(window_flops(b, t, d, h, pairs // b, True),
                          nbytes(g, *saved) + nbytes(*got_g), dts_), None)
                dev, names = device_ms(bwd)
                print(f"device attention_window_bwd bfloat16 {label} "
                      f"({DEVICE}): {dev:.4f} ({top_kernels(names, 4)})")
    return rows


def window_kernel_phase():
    """Phase 20a: the windowed block attention kernels (D=512, 8 heads,
    fastconformer_local's widths) against their plain versions: window
    (128, 128) at B=32 x T'=188 (15 s at x8) and B=4 x T'=1024, (8, 0) and
    (-1, 4) at B=8 x T'=300, the window with the segment mode on the
    packed serve map; ptxas of the window kernels; then the narrowing: at
    B=4 x T'=NARROW_T the windowed bf16 core's device time below
    NARROW_MAX of the full-context core's. Returns the two KERNELS rows."""
    gen = torch.Generator(device="cuda").manual_seed(70)
    d, h = 512, 8
    for prefix in ("core_mma_kernel", "dq_mma_kernel", "dkv_mma_kernel"):
        regs = {k: v for k, v in nvcc_registers(prefix).items()
                if k.endswith(", true>")}
        check(regs, f"ptxas built the window kernels {sorted(regs)}")
    pw = attention_weights(gen, d, h)
    # the forward's row at the longer T', the backward's at the CTC step's
    rows = window_case(gen, pw, h, BATCH, 188, FC_WINDOW,
                       timed=("attention_window_bwd",))
    rows.update(window_case(gen, pw, h, 4, 1024, FC_WINDOW,
                            timed=("attention_window",)))
    for window in ((8, 0), (-1, 4)):
        window_case(gen, pw, h, 8, 300, window)
    from tpu_asr_torch.profile_forward import packed_seg_map
    seg = torch.from_numpy(packed_seg_map()).cuda()
    for window in (FC_WINDOW, (8, 0)):
        window_case(gen, pw, h, seg.shape[0], seg.shape[1], window, seg=seg)

    from tpu_asr_torch.ops.cuda_attention import fused_relpos_attention_block
    from tpu_asr_torch.ops.positions import rel_positional_encoding
    b, t = 4, NARROW_T
    x = normal(gen, b, t, d, scale=0.5).to(torch.bfloat16)
    args = (x, *pw, rel_positional_encoding(t, d, "cuda"),
            torch.ones(b, t, dtype=torch.bool, device="cuda"), h)
    full_name, win_name = ("core_mma_kernel<64, false, false>",
                           "core_mma_kernel<64, false, true>")
    with torch.no_grad():
        _, full = profiled_kernels(
            lambda: fused_relpos_attention_block(*args), full_name)
        _, win = profiled_kernels(lambda: fused_relpos_attention_block(
            *args, att_context_size=FC_WINDOW), win_name)
    pick = lambda names, k: sum(ms for n, ms in names.items() if k in n)
    f_ms, w_ms = pick(full, full_name), pick(win, win_name)
    ideal = window_tile_pairs(t, *FC_WINDOW) / (t * t)
    check(0 < w_ms < NARROW_MAX * f_ms,
          f"window narrowing (bf16, B={b}, T={t}, D={d}, H={h}): the "
          f"windowed core {w_ms:.4f} ms a launch, full context {f_ms:.4f} "
          f"ms: ratio {w_ms / f_ms:.4f} < {NARROW_MAX} (visited tiles "
          f"{ideal:.4f} of the dense pairs, in-window pairs "
          f"{window_pairs(t, *FC_WINDOW) / (t * t):.4f}) ({DEVICE})")
    for name, (err, ms, plain_ms, (b_ms, by), _) in rows.items():
        print(f"time {name} bfloat16: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) (median of 20, "
              f"CUDA events)")
    return rows


def long_clips(seed: int, n: int, lo: float, hi: float):
    """n seeded clips of lo-hi s, zero-padded: (signal, lengths) on the
    card."""
    from tpu_asr_torch.profile_forward import waveforms
    clips = waveforms(np.random.default_rng(seed), n, lo, hi)
    sig = np.zeros((n, max(len(c) for c in clips)), np.float32)
    for i, c in enumerate(clips):
        sig[i, :len(c)] = c
    return (torch.from_numpy(sig).cuda(),
            torch.tensor([len(c) for c in clips], device="cuda"))


def longform_serve(cfg):
    """Phase 20c: Transcriber (bf16, batch 4) on LONG_REQUESTS requests of
    LONG_CLIPS clips of 5-10 min drawn from a seeded pool, after
    LONG_WARMUP warm-up requests, counters and peak memory reset around the
    window. Returns ({row: launches}, RTFx)."""
    from tpu_asr_torch.models.transcribe import Transcriber
    from tpu_asr_torch.profile_forward import seeded_model, waveforms

    rng = np.random.default_rng(9)
    pool = waveforms(rng, LONG_POOL, 300.0, 600.0)
    requests = [[pool[i] for i in rng.choice(LONG_POOL, LONG_CLIPS,
                                             replace=False)]
                for _ in range(LONG_WARMUP + LONG_REQUESTS)]
    tr = Transcriber(seeded_model(cfg, seed=2), serve_tokenizer(cfg),
                     batch_size=LONG_CLIPS, device="cuda")
    for r in requests[:LONG_WARMUP]:
        tr.transcribe(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = reset_counters()
    latency, texts = [], []
    start = time.perf_counter()
    for r in requests[LONG_WARMUP:]:
        t0 = time.perf_counter()
        texts.append(tr.transcribe(r))
        latency.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = {k: n for k, n in read().items() if k in FC_SERVING}
    audio_s = sum(len(w) for r in requests[LONG_WARMUP:] for w in r) / SR
    flat = [t for r in texts for t in r]
    t_max = int(max(len(w) for w in pool) // 160 + 1)
    check(len(flat) == LONG_REQUESTS * LONG_CLIPS
          and all(isinstance(t, str) for t in flat),
          f"Transcriber ({cfg.compute_dtype}) answered {LONG_REQUESTS} "
          f"long-form requests of {LONG_CLIPS} clips with strings, e.g. "
          f"{flat[0][:40]!r}")
    check(all(v > 0 for v in counts.values())
          and counts["attention_window"] == counts["attention"],
          f"long-form serving launched every kernel, every attention with "
          f"its window: {counts}")
    print(f"serve long-form ({cfg.compute_dtype}): {LONG_REQUESTS} requests "
          f"x {LONG_CLIPS} clips of 5-10 min (up to {t_max} frames, T' "
          f"{int(subsampled(cfg, t_max))}), {audio_s:.2f} s of audio in "
          f"{wall:.4f} s wall: RTFx {audio_s / wall:.1f}; per request median "
          f"{1e3 * float(np.median(latency)):.2f} ms, max "
          f"{1e3 * max(latency):.2f} ms (host clock, after {LONG_WARMUP} "
          f"warm-up requests); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    return counts, audio_s / wall


def subsampled(cfg, frames: int) -> int:
    from tpu_asr_torch.models.conformer import subsampled_length
    enc = cfg.encoder
    return int(subsampled_length(torch.tensor(frames), enc.subsampling_factor,
                                 enc.subsampling))


def fastconformer_phase():
    """Phase 20: FastConformer-Large with limited context
    (profile_forward.model_config('fastconformer_local')). Returns
    ({row: measured}, {row: launches}, long-form RTFx)."""
    from tpu_asr_torch.ops.cuda_ctc import ctc_nll
    from tpu_asr_torch.profile_forward import model_config

    cfg = model_config("fastconformer_local")
    enc = cfg.encoder
    name = "fastconformer_local"
    t0 = time.perf_counter()
    rows = window_kernel_phase()
    print(f"phase 20a: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    counts = model_phase(cfg, model_label(name, cfg), FC_SERVING,
                         long_clips(11, 8, 60.0, 120.0), "60-120 s")
    check(counts["attention_window"] == counts["attention"] == enc.n_layers
          and counts["attention"] > 0,
          f"{name} fp32 forward on the kernels: {counts['attention']} "
          f"attention launches, one a layer ({enc.n_layers}), each with the "
          f"window {tuple(enc.att_context_size)}")
    print(f"phase 20b: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    serve_counts, rtfx = longform_serve(cfg)
    print(f"phase 20c: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    read = reset_counters()
    fp32_step_check(ctc_train_model(dataclasses.replace(
        cfg, compute_dtype="float32"), 80), train_batch(4, 81, 45), 82,
        f"fp32 {model_label(name, cfg)} CTC step (B=4 x 45 s, T' "
        f"{subsampled(cfg, 45 * 100 + 1)}, dropout {enc.dropout}, dither)")
    step = read()
    check(step["attention_window_bwd"] == enc.n_layers,
          f"the fp32 step on the kernels ran the windowed backward once a "
          f"layer: {step['attention_window_bwd']}")
    train_counts = timed_ctc_steps(cfg, name, TRAIN_STEPS, TRAIN_WARMUP, 83,
                                   FC_STEP)
    gen = torch.Generator(device="cuda").manual_seed(84)
    t = subsampled(cfg, SECONDS * 100 + 1)
    v = cfg.decoder.num_classes + 1
    lp = torch.log_softmax(normal(gen, BATCH, t, v, scale=2.0), dim=-1)
    tg = torch.randint(0, v - 1, (BATCH, TOKENS), generator=gen,
                       device="cuda")
    il = torch.full((BATCH,), t, device="cuda")
    tl = torch.full((BATCH,), TOKENS, device="cuda")
    before = ctc_nll.launches
    ctc_route(lp, tg, il, tl, v - 1, f"(B={BATCH}, T={t}, V={v}, "
              f"S={TOKENS})", gen)
    check(ctc_nll.launches > before, f"ctc at V={v} launched")
    print(f"phase 20d: {time.perf_counter() - t0:.1f} s")
    launches = {"attention_window": serve_counts["attention_window"],
                "attention_window_bwd": train_counts["attention_window_bwd"]}
    return rows, launches, rtfx


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
    "conformer_layer": ("tpu_asr_torch/csrc/layer.cu",
                        "tpu_asr/ops/pallas_layer.py:76", "bfloat16"),
    "attention_heads": ("tpu_asr_torch/csrc/attention.cu",
                        "tpu_asr/ops/pallas_attention.py:179", "bfloat16"),
    "attention_heads_bwd": ("tpu_asr_torch/csrc/attention.cu",
                            "tpu_asr/ops/pallas_attention.py:208",
                            "bfloat16"),
    "attention_seg": ("tpu_asr_torch/csrc/attention.cu",
                      "tpu_asr/ops/pallas_attention.py:669", "bfloat16"),
    "attention_seg_bwd": ("tpu_asr_torch/csrc/attention.cu",
                          "tpu_asr/ops/pallas_attention.py:717", "bfloat16"),
    "attention_dk128": ("tpu_asr_torch/csrc/attention.cu",
                        "tpu_asr/ops/pallas_attention.py:669", "bfloat16"),
    "attention_bwd_dk128": ("tpu_asr_torch/csrc/attention.cu",
                            "tpu_asr/ops/pallas_attention.py:717",
                            "bfloat16"),
    "attention_heads_dk128": ("tpu_asr_torch/csrc/attention.cu",
                              "tpu_asr/ops/pallas_attention.py:179",
                              "bfloat16"),
    "attention_heads_bwd_dk128": ("tpu_asr_torch/csrc/attention.cu",
                                  "tpu_asr/ops/pallas_attention.py:208",
                                  "bfloat16"),
    "subsampling_c1024": ("tpu_asr_torch/csrc/subsampling.cu",
                          "tpu_asr/ops/pallas_subsampling.py:96",
                          "bfloat16"),
    "attention_window": ("tpu_asr_torch/csrc/attention.cu",
                         "tpu_asr/ops/pallas_attention.py:646", "bfloat16"),
    "attention_window_bwd": ("tpu_asr_torch/csrc/attention.cu",
                             "tpu_asr/ops/pallas_attention.py:646",
                             "bfloat16"),
    "fm_c256": ("tpu_asr_torch/csrc/fm.cu", "tpu_asr/ops/pallas_fm.py:85",
                "bfloat16"),
    "fm_c256_bwd": ("tpu_asr_torch/csrc/fm.cu",
                    "tpu_asr/ops/pallas_fm.py:109", "bfloat16"),
    "fm_c512_s24": ("tpu_asr_torch/csrc/fm.cu",
                    "tpu_asr/ops/pallas_fm.py:85", "bfloat16"),
    "fm_c512_s24_bwd": ("tpu_asr_torch/csrc/fm.cu",
                        "tpu_asr/ops/pallas_fm.py:109", "bfloat16"),
}
STUDENT = ("logmel", "subsampling", "attention", "attention_bwd", "ffn",
           "ffn_bwd", "ctc", "ctc_bwd")
# the CTC step of conformer-LARGE and XLarge: the training FFN kernel
# refuses d512 and d1024 (as JAX's ffn_train_kernel_fits does)
CTC_STEP = ("logmel", "subsampling", "attention", "attention_bwd", "ctc",
            "ctc_bwd")
# fastconformer_local: dw_striding x8 runs plain (JAX's fused_ok takes
# striding x4 only), every attention launch with its window
FC_SERVING = ("logmel", "attention", "attention_window")
FC_STEP = ("logmel", "attention", "attention_bwd", "attention_window",
           "attention_window_bwd", "ctc", "ctc_bwd")
KD = STUDENT + ("fm", "fm_bwd")
INT8_SERVING = SERVING + ("ffn_int8", "conv_module")


CLI_WORDS = (
    "the of and to in a is that for it as was with be by on not he this are "
    "or his from at which but have an they you were her she there one all "
    "we their has been if more when will would who so no time may out up "
    "about said what its into than them only some could new these two also "
    "first any like over such our after most made many people").split()
CLI_CLIPS, CLI_VAL = 64, 16
CLI_DEVICE = "cuda"


def nemo_yaml(obj, indent: int = 0) -> str:
    """Block-style YAML of a config dict, as NeMo's model_config.yaml is
    written: sequences at their key's indent, strings single-quoted, floats
    with a dot (1.0e-05), null, true / false."""
    def scalar(v):
        if v is None:
            return "null"
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, int):
            return str(v)
        if isinstance(v, float):
            r = repr(v)
            mant, _, exp = r.partition("e")
            return (mant if "." in mant else mant + ".0") + (
                "e" + exp if exp else "")
        return "'" + str(v).replace("'", "''") + "'"

    pad, lines = " " * indent, []
    for k, v in obj.items():
        if isinstance(v, dict) and v:
            lines += [f"{pad}{k}:", nemo_yaml(v, indent + 2)]
        elif isinstance(v, list) and v:
            lines += [f"{pad}{k}:"] + [f"{pad}- {scalar(x)}" for x in v]
        else:
            lines.append(f"{pad}{k}: " + ("{}" if isinstance(v, dict) else
                                          "[]" if isinstance(v, list) else
                                          scalar(v)))
    return "\n".join(lines)


def cli_corpus(root):
    """64 WAV clips of 1-15 s of seeded noise with texts from CLI_WORDS,
    written as a train (48) and a val (16) manifest, and a full-width
    `.nemo`: a seeded ModelConfig() teacher's state_dict, its tokenizer
    (BPE, 128 pieces, as `<uniq>_tokenizer.model`) and model_config.yaml
    from `nemo_yaml`. Returns (train, val, nemo, val audio seconds)."""
    import tarfile

    from tpu_asr_torch.config import ModelConfig
    from tpu_asr_torch.data.audio import write_wav
    from tpu_asr_torch.data.manifest import ManifestEntry, write_manifest
    from tpu_asr_torch.data.tokenizer import train_bpe
    from tpu_asr_torch.models.ctc_model import CTCModel
    from tpu_asr_torch.profile_forward import seed_weights

    rng = np.random.default_rng(22)
    entries = []
    for i in range(CLI_CLIPS):
        dur = float(np.round(rng.uniform(1.0, 15.0), 3))
        x = (rng.normal(size=int(SR * dur)) * 0.1).astype(np.float32)
        write_wav(root / f"clip{i}.wav", x, SR)
        words = rng.choice(CLI_WORDS, size=max(1, int(dur * 1.5)))
        entries.append(ManifestEntry(str(root / f"clip{i}.wav"), dur,
                                     " ".join(words)))
    write_manifest(root / "train.jsonl", entries[CLI_VAL:])
    write_manifest(root / "val.jsonl", entries[:CLI_VAL])
    cfg = ModelConfig()
    tok = train_bpe([e.text for e in entries] + [" ".join(CLI_WORDS)],
                    cfg.decoder.num_classes)
    pack = root / "nemo"
    pack.mkdir()
    tok_name = "5e1f0c0de0c1_tokenizer.model"
    tok.save_proto(pack / tok_name)
    teacher = seed_weights(CTCModel(cfg), 22)
    torch.save(teacher.state_dict(), pack / "model_weights.ckpt")
    enc, pre = cfg.encoder, cfg.preprocessor
    (pack / "model_config.yaml").write_text(nemo_yaml({
        "sample_rate": cfg.sample_rate,
        "tokenizer": {"dir": None, "type": "bpe",
                      "model_path": f"nemo:{tok_name}"},
        "preprocessor": {
            "_target_": "nemo.collections.asr.modules."
                        "AudioToMelSpectrogramPreprocessor",
            "sample_rate": pre.sample_rate, "normalize": pre.normalize,
            "window_size": pre.window_size,
            "window_stride": pre.window_stride, "window": pre.window,
            "features": pre.features, "n_fft": pre.n_fft,
            "dither": pre.dither, "pad_to": pre.pad_to},
        "spec_augment": {"freq_masks": 2, "time_masks": 10,
                         "freq_width": 27, "time_width": 0.05},
        "encoder": {
            "_target_": "nemo.collections.asr.modules.ConformerEncoder",
            "feat_in": enc.feat_in, "feat_out": -1,
            "n_layers": enc.n_layers, "d_model": enc.d_model,
            "subsampling": enc.subsampling,
            "subsampling_factor": enc.subsampling_factor,
            "subsampling_conv_channels": -1, "ff_expansion_factor": 4,
            "self_attention_model": "rel_pos", "n_heads": enc.n_heads,
            "att_context_size": [-1, -1], "xscaling": True,
            "untie_biases": True, "pos_emb_max_len": 5000,
            "conv_kernel_size": enc.conv_kernel_size,
            "conv_norm_type": "batch_norm", "dropout": 0.1,
            "dropout_pre_encoder": 0.1, "dropout_emb": 0.0,
            "dropout_att": 0.1},
        "decoder": {"_target_": "nemo.collections.asr.modules."
                                "ConvASRDecoder",
                    "feat_in": enc.d_model,
                    "num_classes": cfg.decoder.num_classes,
                    "vocabulary": list(tok.vocab)},
        "optim": {"name": "adamw", "lr": 2.0, "betas": [0.9, 0.98],
                  "weight_decay": 0.001,
                  "sched": {"name": "NoamAnnealing", "warmup_steps": 10000,
                            "min_lr": 1.0e-06}},
        "target": "nemo.collections.asr.models.ctc_bpe_models."
                  "EncDecCTCModelBPE"}) + "\n")
    nemo = root / "teacher.nemo"
    with tarfile.open(nemo, "w:") as tar:       # NGC's layout: "./" members
        tar.add(pack, arcname=".")
    return (str(root / "train.jsonl"), str(root / "val.jsonl"), str(nemo),
            sum(e.duration for e in entries[:CLI_VAL]))


def timing(cls, name: str, log: list):
    """Wrap cls.name so each call appends (seconds, result) to `log`;
    returns a function that restores it."""
    orig = getattr(cls, name)

    sync = torch.cuda.synchronize if CLI_DEVICE == "cuda" else lambda: None

    def wrapped(self, *a, **kw):
        sync()
        t0 = time.perf_counter()
        out = orig(self, *a, **kw)
        sync()
        log.append((time.perf_counter() - t0, out))
        return out

    setattr(cls, name, wrapped)
    return lambda: setattr(cls, name, orig)


def eval_log_probs(log: list):
    """Record in `log`, per utterance, the log-probs over its own frames
    that an evaluation takes its per-utterance CTC NLL of: the bucketed
    eval step's (train/trainer.py) and `Trainer.evaluate_packed`'s. Returns
    a function that undoes it."""
    import tpu_asr_torch.ops.ctc as ctc_ops
    import tpu_asr_torch.train.trainer as trainer_mod

    orig = ctc_ops.ctc_loss

    def wrapped(lp, tokens, lens, *a, **kw):
        log.extend(lp[i, :n].float().cpu()
                   for i, n in enumerate(lens.tolist()))
        return orig(lp, tokens, lens, *a, **kw)

    trainer_mod.ctc_loss = ctc_ops.ctc_loss = wrapped

    def undo():
        trainer_mod.ctc_loss = ctc_ops.ctc_loss = orig

    return undo


def frame_flips(ref: list, got: list, label: str) -> None:
    """Greedy ids per frame of `got` against `ref` (lists of per-utterance
    (T, V) log-probs): equal on at least 99% of the frames whose top-2
    margin in `ref` exceeds 1e-1, as phase 16 holds bf16 packed ids. The
    frames whose ids differ are printed with their margins."""
    same_shape = len(ref) == len(got) and all(
        a.shape == b.shape for a, b in zip(ref, got))
    check(same_shape, f"{label}: {len(got)} utterances with the frames and "
          f"classes of the reference's {len(ref)}")
    frames = decided = agree = 0
    flipped = []
    for a, b in zip(ref, got):
        top2 = a.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        same = a.argmax(-1) == b.argmax(-1)
        flipped += margin[~same].tolist()
        dec = margin > 1e-1
        frames += len(margin)
        decided += int(dec.sum())
        agree += int(same[dec].sum())
    flipped.sort(reverse=True)
    print(f"{label}: ids differ on {len(flipped)} of {frames} frames; "
          f"their top-2 margins (reference), largest first: "
          f"{[float(f'{m:.3e}') for m in flipped[:12]]}"
          f"{' ...' if len(flipped) > 12 else ''}")
    check(agree >= 0.99 * decided,
          f"{label}: greedy ids equal on {agree} of {decided} frames whose "
          f"top-2 margin exceeds 1e-1 (>= 99%)")


def cli_phase():
    """Phase 22: the port's CLIs at the flagship widths (asr_train with the
    flowkd_mlp8 flags from a full-width `.nemo`, then asr_inference).
    Returns {counter: launches} of the fit window."""
    import shutil
    import tempfile
    from pathlib import Path

    from tpu_asr_torch.cli import asr_inference, asr_train, common
    from tpu_asr_torch.config import DistillationConfig
    from tpu_asr_torch.data.dataset import (AudioToBPEDataset,
                                            make_dataloader, to_device)
    from tpu_asr_torch.models.distil_model import DistilCTCModel
    from tpu_asr_torch.train.loop import Trainer
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step)
    from tpu_asr_torch.utils.checkpoint import (load_student,
                                                restore_train_state,
                                                save_train_state)

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        t0 = time.perf_counter()
        train, val, nemo, val_audio = cli_corpus(root)
        print(f"cli: corpus of {CLI_CLIPS} clips and the .nemo written in "
              f"{time.perf_counter() - t0:.1f} s")
        out = root / "out"
        kd = ["--use_logit_distillation", "true", "--kd_alpha", "0.1",
              "--use_flow_matching", "true", "--flow_steps", "8"]
        argv = ["--train_manifest", train, "--val_manifest", val,
                "--teacher_nemo", nemo, "--output_dir", str(out),
                "--batch_size", str(BATCH), "--epochs", "1", *kd]
        if CLI_DEVICE == "cpu":
            argv += ["--platform", "cpu"]
        fits, evals = [], []
        undo = [timing(Trainer, "fit", fits),
                timing(Trainer, "evaluate", evals)]
        read = reset_counters()
        results = asr_train.main(argv)
        counts = read()
        fit_s, state = fits[0]
        steps = state.step
        ckpt = out / "run" / "checkpoints"
        rows = [json.loads(line) for line in open(out / "run" /
                                                  "metrics.jsonl")]
        losses = [r["loss/total"] for r in rows if "loss/total" in r]
        check(steps > 0 and all(math.isfinite(x) for x in losses)
              and all(math.isfinite(r[k]) for r in rows for k in r),
              f"cli fit: {steps} steps, every logged value finite, "
              f"first loss {losses[0]:.6f}")
        fit_rows = ("logmel", "subsampling", "attention", "attention_bwd",
                    "ffn", "ffn_bwd", "ctc", "ctc_bwd", "fm", "fm_bwd")
        check(all(counts[k] > 0 for k in fit_rows),
              f"cli fit launched every kernel of its path: "
              f"{ {k: counts[k] for k in fit_rows} }")
        print(f"cli: fit {fit_s:.2f} s, {steps} steps, "
              f"{steps / fit_s:.3f} steps/s (host clock, one epoch of "
              f"{CLI_CLIPS - CLI_VAL} clips at B<={BATCH}, the val pass "
              "included)")

        # the first logged loss against the train step applied directly
        args = asr_train.build_train_parser("x").parse_args(argv)
        manifests = common.prepare_manifests(args, "librispeech")
        scfg, _, model, teacher_sd, tok = common._build(args, manifests,
                                                        False, None)
        cfg = common._train_config(args, scfg, model.distill, train=True)
        model = model.to(CLI_DEVICE)
        model.teacher.load_state_dict(teacher_sd)
        ref_state = DistilTrainState.create(model, cfg.optim)
        first = next(to_device(make_dataloader(
            AudioToBPEDataset(train, tok), cfg.train_ds, epoch=0),
            CLI_DEVICE))
        first.pop("texts"), first.pop("utt_idx")
        _, m = make_distil_train_step(model)(ref_state, first, cfg.seed)
        want = m["loss/total"].item()
        check(abs(losses[0] - want) <= 1e-5 * abs(want),
              f"cli fit's first logged loss {losses[0]:.6f} = the train "
              f"step on the same first batch {want:.6f} (1e-5 relative)")

        # the checkpoint restores bit-equal (the student export was written
        # from the same in-memory state), and saves again the same
        restore_train_state(ckpt, ref_state)
        student = torch.load(ckpt / "student", map_location=CLI_DEVICE,
                             weights_only=True)
        got = model.student.state_dict()
        check(ref_state.step == steps and all(
            torch.equal(got[k], v) for k, v in student.items()),
            f"checkpoints/last restores bit-equal at step {steps} "
            f"({len(student)} student tensors)")
        save_train_state(root, ref_state, name="again")
        a = torch.load(ckpt / "last", weights_only=True)
        b = torch.load(root / "again", weights_only=True)
        check(all(torch.equal(a["model"][k], v) for k, v in
                  b["model"].items()) and a["step"] == b["step"],
              "a restored checkpoint saves again bit-equal")
        del model, ref_state

        # asr_inference on `last` with the training's flags
        base = ["--test_manifest", val, "--teacher_nemo", nemo,
                "--output_dir", str(out), "--batch_size", str(BATCH)]
        if CLI_DEVICE == "cpu":
            base += ["--platform", "cpu"]
        evals.clear()
        inf = asr_inference.main(["--ckpt_path", str(ckpt / "last"), *base,
                                  *kd])["test"]
        eval_s = evals[0][0]
        fit_val = results["val"]
        check(inf["wer"] == fit_val["wer"] and abs(inf["loss"] - fit_val[
            "loss"]) <= 1e-5 * abs(fit_val["loss"]),
            f"asr_inference on checkpoints/last: wer {inf['wer']:.4f} loss "
            f"{inf['loss']:.6f} = the fit's final evaluate wer "
            f"{fit_val['wer']:.4f} loss {fit_val['loss']:.6f}")
        print(f"cli: evaluate {eval_s:.2f} s for {val_audio:.1f} s of "
              f"audio, {val_audio / eval_s:.1f} audio s per s (host clock, "
              f"{CLI_VAL} clips, B<={BATCH}, flowkd_mlp8 eval path)")

        # the student export, CTC only: bucketed against packed, through
        # the CLI in the config's bf16 (loss, WER, and the greedy ids of
        # every frame) and through the same Trainer methods in fp32
        lp_plain, lp_packed = [], []
        undo_lp = eval_log_probs(lp_plain)
        plain = asr_inference.main(["--ckpt_path", str(ckpt / "student"),
                                    *base])["test"]
        undo_lp()
        undo_lp = eval_log_probs(lp_packed)
        read = reset_counters()
        packed = asr_inference.main(["--ckpt_path", str(ckpt / "student"),
                                     *base, "--packed_eval"])["test"]
        seg = read()["attention_seg"]
        undo_lp()
        check(abs(packed["loss"] - plain["loss"]) <= 1e-4 * abs(
            plain["loss"]) and seg > 0,
            f"--packed_eval on the student export (bf16): loss "
            f"{packed['loss']:.6f} vs bucketed {plain['loss']:.6f} (1e-4), "
            f"wer {packed['wer']:.4f} vs {plain['wer']:.4f}, {seg} "
            f"segment-mode attention launches")
        frame_flips(lp_plain, lp_packed,
                    "--packed_eval on the student export (bf16), per frame")
        fp32 = DistilCTCModel(dataclasses.replace(scfg,
                                                  compute_dtype="float32"),
                              scfg, DistillationConfig())
        load_student(ckpt / "student", fp32.student)
        trainer = Trainer(fp32, dataclasses.replace(
            cfg, distillation=fp32.distill), tok, root / "fp32",
            device=CLI_DEVICE)
        trainer.init_state()
        read = reset_counters()
        p32, b32 = trainer.evaluate_packed(val), trainer.evaluate(val)
        check(p32["wer"] == b32["wer"] and abs(p32["loss"] - b32["loss"])
              <= 1e-5 * abs(b32["loss"]) and read()["attention_seg"] > 0,
              f"fp32 evaluate_packed on the student export: wer "
              f"{p32['wer']:.4f} loss {p32['loss']:.6f} = evaluate wer "
              f"{b32['wer']:.4f} loss {b32['loss']:.6f} (1e-5)")
        del fp32, trainer

        # --resume_ckpt continues at the saved step
        saved = torch.load(ckpt / "last", weights_only=True)
        fits.clear()
        argv[argv.index("--epochs") + 1] = "2"
        asr_train.main(argv + ["--resume_ckpt", str(ckpt / "last")])
        resumed = fits[0][1]
        check(saved["step"] == steps and saved["epoch"] == 1
              and resumed.step == 2 * steps and resumed.epoch == 2,
              f"--resume_ckpt continued at step {saved['step']} (epoch 1) "
              f"and ended at step {resumed.step} (epoch 2)")
        for u in undo:
            u()
        print(f"cli ({card_line()}): fit {fit_s:.2f} s, "
              f"{steps / fit_s:.3f} steps/s;"
              f" evaluate {val_audio / eval_s:.1f} audio s per s")
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


STREAM_STEPS, STREAM_REPEATS, STREAM_WARMUP = 50, 3, 3
BEAM_WIDTH, BEAM_ITERS, CHUNKED_SECONDS = 16, 3, 120


def scores_close(got: float, want: float) -> bool:
    """tests/test_beam_search.py's score bound: rtol and atol 1e-4."""
    return abs(got - want) <= 1e-4 + 1e-4 * abs(want)


def streaming_config(cfg):
    """bench.py's streaming configuration of cfg: causal subsampling and
    conv, chunked_limited attention of 4-frame chunks (16 mel frames, 160
    ms) with 108 frames (about 4.3 s) of left context."""
    return with_encoder(cfg, causal_downsampling=True,
                        conv_context_size="causal",
                        att_context_style="chunked_limited",
                        att_context_size=(108, 3))


def stream_batch(streamer, feats, feat_len):
    """Stream (B, F, T) mel features of B streams of unequal length in
    lockstep chunks (an exhausted stream rides along with chunk_len 0);
    returns each stream's (frames, V+1) log-probs, concatenated."""
    sc = streamer.stream_cfg
    dev, n = feats.device, feat_len.tolist()
    state = streamer.init_state(len(n))
    steps = []
    with torch.inference_mode():
        for pos in range(0, max(n), sc.chunk_size):
            takes = torch.tensor([max(0, min(sc.chunk_size, k - pos))
                                  for k in n], device=dev)
            chunk = feats[:, :, pos:pos + sc.chunk_size]
            chunk = torch.nn.functional.pad(
                chunk, (0, sc.chunk_size - chunk.shape[2]))
            keep = (torch.arange(sc.chunk_size, device=dev)[None, :]
                    < takes[:, None])
            lp, enc_len, state = streamer.step(state, chunk * keep[:, None],
                                               takes)
            steps.append((lp, enc_len))
    lens = torch.stack([e for _, e in steps]).tolist()      # (steps, B)
    return [torch.cat([lp[i, :lens[k][i]] for k, (lp, _) in
                       enumerate(steps)]) for i in range(len(n))]


def stream_vs_offline(streamer, feats, feat_len, label):
    """The streamed log-probs of every stream against the same model's
    offline forward on the same features (phase 4's fp32 rule); returns
    (streamed ids, offline ids, offline top-2 margins), per stream."""
    streamed = stream_batch(streamer, feats, feat_len)
    with torch.inference_mode():
        off = streamer.model.forward_features(feats, feat_len)
    delta, n_dec, same, out = 0.0, 0, True, []
    for i, got in enumerate(streamed):
        n = int(off.encoded_len[i])
        check(got.shape[0] == n, f"{label} stream {i}: {got.shape[0]} "
              f"streamed frames, the offline forward's {n}")
        want = off.log_probs[i, :n]
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        out.append((got.argmax(-1), want.argmax(-1), margin))
        delta = max(delta, (got.float() - want).abs().max().item())
        decided = margin > 1e-3
        n_dec += int(decided.sum())
        same &= bool(((got.argmax(-1) == want.argmax(-1)) | ~decided).all())
    return delta, n_dec, same, out


def streaming_latency(streamer, b: int, gen, steps: int = None,
                      repeats: int = None):
    """bench.py's per-chunk step latency at B=b: `steps` (STREAM_STEPS)
    full chunks after STREAM_WARMUP, host clock to a synchronize, `repeats`
    (STREAM_REPEATS) times; and the device's busy ms a step
    (torch.profiler)."""
    steps, repeats = steps or STREAM_STEPS, repeats or STREAM_REPEATS
    sc = streamer.stream_cfg
    chunk = torch.randn(b, streamer.cfg.preprocessor.features, sc.chunk_size,
                        generator=gen, device="cuda")
    clen = torch.full((b,), sc.chunk_size, device="cuda")
    state = [streamer.init_state(b)]

    def one():
        _, _, state[0] = streamer.step(state[0], chunk, clen)

    with torch.inference_mode():
        for _ in range(STREAM_WARMUP):
            one()
        torch.cuda.synchronize()
        reps = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(steps):
                one()
            torch.cuda.synchronize()
            reps.append(1e3 * (time.perf_counter() - t0) / steps)
        busy, _ = device_ms(one, iters=3)
    return reps, busy


def streaming_phase(cfg):
    """Phase 23a: cache-aware streaming of bench.py's streaming
    configuration of cfg."""
    from tpu_asr_torch.models.streaming import CacheAwareStreamer
    from tpu_asr_torch.profile_forward import seeded_model, waveforms

    scfg = streaming_config(cfg)
    rng = np.random.default_rng(23)
    clips = [waveforms(rng, 1, SECONDS, SECONDS)[0]] + waveforms(
        rng, 7, 4.0, SECONDS)
    sig = np.zeros((len(clips), max(len(c) for c in clips)), np.float32)
    for i, c in enumerate(clips):
        sig[i, :len(c)] = c
    sig_t = torch.from_numpy(sig).to("cuda")
    len_t = torch.tensor([len(c) for c in clips], device="cuda")

    model = seeded_model(dataclasses.replace(scfg, compute_dtype="float32"),
                         seed=23, device="cuda")
    streamer = CacheAwareStreamer(model, device="cuda")
    sc = streamer.stream_cfg
    print(f"streaming: chunk {sc.chunk_size} mel frames "
          f"({sc.chunk_size * 10} ms), {sc.valid_out_len} encoded frames a "
          f"step, attention cache {sc.last_channel_cache_size} frames, conv "
          f"cache {sc.last_time_cache_size}, pre-encode tail "
          f"{sc.pre_encode_cache_size} mel frames")
    with torch.inference_mode():
        feats, feat_len = model.featurizer(sig_t, len_t)
    t0 = time.perf_counter()
    for label, idx in (("B=1, 15 s", [0]),
                       ("B=8, 4-15 s", list(range(len(clips))))):
        delta, n_dec, same, ref = stream_vs_offline(
            streamer, feats[idx], feat_len[idx], f"fp32 {label}")
        check(delta < 2e-3, f"streaming fp32 {label}: max |delta log-prob| "
              f"streamed vs offline {delta:.3e} < 2e-3")
        check(same, f"streaming fp32 {label}: greedy ids equal on {n_dec} "
              f"frames with offline top-2 margin > 1e-3")

    # the entry point a user calls: featurize (log-mel kernel), then the
    # chunk steps, which take no kernel (the route is plain with a cache)
    read = reset_counters()
    ids = streamer.stream(clips[0], return_ids=True)
    counts = {k: v for k, v in read().items() if v}
    check(counts.get("logmel", 0) > 0 and not counts.get("attention")
          and not counts.get("subsampling"),
          f"CacheAwareStreamer.stream launches: {counts} (logmel > 0; "
          f"attention and subsampling 0: cached steps run plain, as in JAX)")
    with torch.inference_mode():
        off = model(sig_t[:1], len_t[:1])
    n = int(off.encoded_len[0])
    top2 = off.log_probs[0, :n].topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 1e-3
    off_ids = off.greedy[0, :n]
    got_ids = torch.tensor(ids, device="cuda")
    check(len(ids) == n and bool(((got_ids == off_ids) | ~decided).all()),
          f"CacheAwareStreamer.stream (15 s): {len(ids)} frame ids, equal "
          f"to the offline greedy ids on {int(decided.sum())} frames with "
          f"top-2 margin > 1e-3")

    # bf16, the config's own dtype: per frame, phase 16's rule
    model16 = seeded_model(scfg, seed=23, device="cuda")
    streamer16 = CacheAwareStreamer(model16, device="cuda")
    streamed16 = stream_batch(streamer16, feats, feat_len)
    agree = n_dec = 0
    for (_, want_ids, margin), got in zip(ref, streamed16):
        decided = margin > 1e-1
        n_dec += int(decided.sum())
        agree += int(((got.argmax(-1) == want_ids) & decided).sum())
    check(agree >= 0.99 * n_dec, f"streaming bf16 B=8: ids equal to the fp32 "
          f"offline forward on {agree} of {n_dec} frames with top-2 margin "
          f"> 1e-1 (>= 99%); the streamed checks took "
          f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(23)
    lat = {}
    for b in (1, 8):
        t0 = time.perf_counter()
        reps, busy = streaming_latency(streamer, b, gen)
        lat[b] = float(np.median(reps))
        print(f"streaming step latency (fp32, B={b}, {card_line()}): median "
              f"{lat[b]:.3f} ms, {min(reps):.3f}-{max(reps):.3f} over "
              f"{STREAM_REPEATS} repeats of {STREAM_STEPS} steps after "
              f"{STREAM_WARMUP} warm-up (host clock); device busy "
              f"{busy:.3f} ms a step, busy share {busy / lat[b]:.3f}; "
              f"real-time budget 160 ms a chunk "
              f"({time.perf_counter() - t0:.1f} s)")
    return lat


def beam_phase(cfg):
    """Phase 23b: cfg in fp32 at B=32 x 15 s on the kernels, then
    beam_batch W=16: the host oracle on 2 rows, the n-gram LM on the card
    against the CPU, beam and greedy RTFx. Returns (log-probs, lengths,
    tokenizer, {decoding: RTFx}) for 23c."""
    from tpu_asr_torch.ops.beam_search import NEG_INF
    from tpu_asr_torch.ops.decoding import CTCDecoding, ctc_prefix_beam_search
    from tpu_asr_torch.ops.ngram_lm import NgramLM
    from tpu_asr_torch.profile_forward import seeded_model

    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = seeded_model(cfg, seed=24, device="cuda")
    tok = serve_tokenizer(cfg)
    rng = np.random.default_rng(24)
    sig = torch.from_numpy((rng.normal(size=(BATCH, SECONDS * SR)) * 0.1)
                           .astype(np.float32)).to("cuda")
    lens = torch.full((BATCH,), SECONDS * SR, device="cuda")
    with torch.inference_mode():
        out = model(sig, lens)
    lp, enc_len = out.log_probs, out.encoded_len
    beam = CTCDecoding(tok, "beam_batch", beam_width=BEAM_WIDTH)
    # the host search keeps each frame's top 2W tokens, the device search
    # all V: the same candidates only where every frame has 2W finite ones
    top = lp[:2].topk(2 * BEAM_WIDTH, dim=-1)
    cut = torch.full_like(lp[:2], NEG_INF).scatter(-1, top.indices,
                                                    top.values)
    hyps = beam.ctc_decoder_predictions_tensor(cut, enc_len[:2], True)
    lp_host = cut.cpu().numpy()
    for i in range(2):
        ref = ctc_prefix_beam_search(lp_host[i], int(enc_len[i]),
                                     BEAM_WIDTH)[0]
        check(hyps[i].y_sequence == ref.y_sequence
              and scores_close(hyps[i].score, ref.score),
              f"beam_batch W={BEAM_WIDTH} row {i}, each frame cut to its "
              f"top {2 * BEAM_WIDTH} tokens: top beam "
              f"({len(ref.y_sequence)} tokens) = the host prefix search's, "
              f"score {hyps[i].score:.5f} vs {ref.score:.5f} (rtol and atol "
              f"1e-4)")

    seqs = [rng.integers(0, cfg.decoder.num_classes,
                         size=rng.integers(5, 16)).tolist()
            for _ in range(60)]
    lm = NgramLM.train(seqs, order=3)
    t0 = time.perf_counter()
    ng = CTCDecoding(tok, "beam_batch", beam_width=BEAM_WIDTH, ngram_lm=lm,
                     lm_weight=0.5)
    got = ng.ctc_decoder_predictions_tensor(lp, enc_len, True)
    n_states = ng.ngram_tables[0].shape[0]
    want = ng.ctc_decoder_predictions_tensor(lp.cpu(), enc_len.cpu(), True)
    worst = max(abs(g.score - w.score) for g, w in zip(got, want))
    check(all(g.y_sequence == w.y_sequence
              and scores_close(g.score, w.score) for g, w in zip(got, want)),
          f"beam_batch W={BEAM_WIDTH} with a 3-gram LM ({n_states} automaton "
          f"states, weight 0.5) on the card = on a CPU copy of the log-probs "
          f"for {len(got)} rows: tokens equal, scores within rtol and atol "
          f"1e-4 (max |delta| {worst:.2e}; {time.perf_counter() - t0:.1f} s)")

    audio_s = BATCH * SECONDS

    def serve(decode):
        with torch.inference_mode():
            o = model(sig, lens)
            return decode(o)

    greedy = CTCDecoding(tok)
    # greedy twice: the Transcribers' ids path and the log-probs path, so
    # that the ids path's saving is measured, not assumed
    runs = {"greedy": lambda o: greedy.greedy_ids_predictions(
                o.greedy, o.encoded_len, o.log_probs.shape[-1] - 1),
            "greedy_log_probs":
                lambda o: greedy.ctc_decoder_predictions_tensor(
                    o.log_probs, o.encoded_len),
            "beam": lambda o: beam.ctc_decoder_predictions_tensor(
                o.log_probs, o.encoded_len)}
    rtfx, counts, texts_of = {}, {}, {}
    for name, decode in runs.items():
        serve(decode)
        torch.cuda.synchronize()
        read = reset_counters()
        t0 = time.perf_counter()
        for _ in range(BEAM_ITERS):
            texts = serve(decode)
        wall = (time.perf_counter() - t0) / BEAM_ITERS
        launched = read()
        counts[name] = {k: launched[k] for k in SERVING}
        rtfx[name] = audio_s / wall
        texts_of[name] = texts
        check(len(texts) == BATCH and all(isinstance(t, str) for t in texts),
              f"{name} at B={BATCH} x {SECONDS} s answered with strings")
    check(all(v > 0 for v in counts["beam"].values()),
          f"beam serving launched the serving kernels: {counts['beam']}")
    check(texts_of["greedy"] == texts_of["greedy_log_probs"],
          f"greedy at B={BATCH}: the ids path's texts = the log-probs "
          f"path's")
    print(f"beam ({card_line()}): B={BATCH} x {SECONDS} s, W={BEAM_WIDTH}, "
          f"{cfg.compute_dtype} forward: beam RTFx {rtfx['beam']:.1f}, greedy "
          f"RTFx {rtfx['greedy']:.1f} on the model's ids, "
          f"{rtfx['greedy_log_probs']:.1f} on its log-probs (host clock, "
          f"mean of {BEAM_ITERS} after 1 warm-up, text out)")
    return lp, enc_len, tok, rtfx


def decoding_phase(cfg, lp, enc_len, tok):
    """Phase 23c: the greedy decoding layer with every payload on the
    card's log-probs against their CPU copy, and ChunkedTranscriber on a
    120 s clip against a CPU copy of the model."""
    import copy

    from tpu_asr_torch.models.transcribe import ChunkedTranscriber
    from tpu_asr_torch.ops.confidence import ConfidenceConfig
    from tpu_asr_torch.ops.decoding import CTCDecoding
    from tpu_asr_torch.profile_forward import seeded_model, waveforms

    dec = CTCDecoding(tok, compute_timestamps=True, preserve_alignments=True,
                      confidence_cfg=ConfidenceConfig(
                          preserve_frame_confidence=True,
                          preserve_token_confidence=True,
                          preserve_word_confidence=True))
    got = dec.ctc_decoder_predictions_tensor(lp, enc_len, True)
    want = dec.ctc_decoder_predictions_tensor(lp.cpu(), enc_len.cpu(), True)
    same, worst = True, 0.0
    for g, w in zip(got, want, strict=True):
        same &= (g.y_sequence == w.y_sequence and g.timestamp == w.timestamp
                 and np.array_equal(g.alignments[0], w.alignments[0])
                 and np.array_equal(g.alignments[1], w.alignments[1]))
        for field in ("frame_confidence", "token_confidence",
                      "word_confidence"):
            a, b = getattr(g, field), getattr(w, field)
            same &= len(a) == len(b)
            if a and len(a) == len(b):
                worst = max(worst, float(np.abs(np.subtract(a, b)).max()))
    check(same, f"greedy with timestamps, confidence and alignments, "
          f"{len(got)} rows: tokens, offsets, alignments and the number of "
          f"confidences on the card equal to the CPU's")
    words = sum(len(h.timestamp["word"]) for h in got)
    check(worst < 1e-5, f"greedy payload for {len(got)} rows ({words} word "
          f"offsets): frame, token and word confidences within {worst:.2e} "
          f"of the CPU's (< 1e-5)")

    model = seeded_model(dataclasses.replace(cfg, compute_dtype="float32"),
                         seed=25, device="cuda")
    cpu_model = copy.deepcopy(model).cpu()
    clip = waveforms(np.random.default_rng(25), 1, CHUNKED_SECONDS,
                     CHUNKED_SECONDS)[0]
    card = ChunkedTranscriber(model, tok, device="cuda")
    card.transcribe(clip)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = card.transcribe(clip)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_text = ChunkedTranscriber(cpu_model, tok,
                                  device="cpu").transcribe(clip)
    cpu_s = time.perf_counter() - t0
    check(text == cpu_text and len(text) > 0,
          f"ChunkedTranscriber ({CHUNKED_SECONDS} s, fp32, 16 s windows, 2 s "
          f"overlap): {len(text.split())} words, the same text on the card "
          f"as on a CPU copy of the model's plain path ({cpu_s:.1f} s)")
    print(f"chunked ({card_line()}): RTFx {CHUNKED_SECONDS / wall:.1f} "
          f"({wall:.3f} s wall for {CHUNKED_SECONDS} s of audio, host clock)")


def serving_surface_phase(cfg):
    """Phase 23: streaming, beam search, the decoding layer and
    ChunkedTranscriber."""
    lat = timed_phase("23a", streaming_phase, cfg)
    lp, enc_len, tok, rtfx = timed_phase("23b", beam_phase, cfg)
    timed_phase("23c", decoding_phase, cfg, lp, enc_len, tok)
    print(f"serving surface ({card_line()}): fp32 streaming step B=1 "
          f"{lat[1]:.3f} ms, B=8 {lat[8]:.3f} ms; beam RTFx "
          f"{rtfx['beam']:.1f}, greedy {rtfx['greedy']:.1f} (ids) / "
          f"{rtfx['greedy_log_probs']:.1f} (log-probs)")


DDP_ROWS, DDP_STEPS = 8, 2       # 24a's check and 24b: the global batch
DDP_CONFIGS = ("flowkd_mlp8", "flowkd_router16")
DDP_EVAL_CLIPS, DDP_EVAL_VAL = 16, 8


def ddp_step_runs(model, batch, seed: int, steps: int = DDP_STEPS,
                  packed: bool = False):
    """`steps` train steps of `model` from a fresh AdamW state on this
    rank's rows of `batch` (all of it without a process group), counters
    reset just before and read just after. Returns numpy / host values:
    per step the losses summed over the ranks, the gradients of the first
    step, the BatchNorm running statistics after it, the router's counts
    and Gumbel margins of each step gathered over the ranks, the
    parameters after the last step, the launches, the learning rates.
    `packed`: packed steps on the plan `batch` carries, each rank on its
    part of it (mesh.packed_rank_block)."""
    from tpu_asr_torch.config import OptimConfig
    from tpu_asr_torch.parallel import mesh
    from tpu_asr_torch.train.loop import global_metrics
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step)

    if packed:
        local = (mesh.packed_rank_block(batch) if mesh.process_count() > 1
                 else batch)
    else:
        n = batch["signal"].shape[0] // mesh.process_count()
        r = mesh.row_offset(n)
        local = {k: v[r:r + n] for k, v in batch.items()}
    routes, hook = [], None
    if model.routed:
        def keep(mod, args, out):
            top2 = out[2]["scores"].detach().topk(2, dim=-1).values
            routes.append((mesh.all_gather_rows(out[0], 1).cpu().numpy(),
                           mesh.all_gather_rows(top2[..., 0] - top2[..., 1],
                                                1).cpu().numpy()))
        hook = model.router.register_forward_hook(keep)
    state = DistilTrainState.create(model, OptimConfig())
    step = make_distil_train_step(model, packed=packed)
    out = {"losses": [], "lr": []}
    read = reset_counters()
    for i in range(steps):
        out["lr"].append(float(state.schedule(state.step)))
        state, metrics = step(state, local, seed)
        out["losses"].append({k[5:]: v for k, v in
                              global_metrics(metrics).items()
                              if k.startswith("loss/")})
        if i == 0:
            out["grads"] = {k: p.grad.cpu().numpy() for k, p in
                            model.named_parameters() if p.grad is not None}
            out["stats1"] = {k: b.cpu().numpy() for k, b in
                             model.named_buffers() if "running" in k}
    torch.cuda.synchronize()
    out["launches"] = read()
    out["params"] = {k: p.detach().cpu().numpy()
                     for k, p in model.named_parameters()}
    out["routes"] = routes
    if hook is not None:
        hook.remove()
    return out


def ddp_compare(got, want, label: str, min_share: float = 0.9) -> None:
    """24a and 24b's gates: every loss of every step within 1e-5 relative;
    the BatchNorm running statistics after the first step within 1e-5;
    the parameters after the last step by tests/test_torch_train.py's fp32
    rule (the elements whose first gradient exceeds 1e-4 x the largest,
    within 1e-5 x |ref| + 2e-2 x the learning rate: Adam turns a
    gradient's rounding into a step at the learning rate's scale; the
    running statistics after the second step carry that noise through the
    depthwise-conv bias, whose gradient is zero in exact arithmetic), at
    least `min_share` of the elements decided; the router's counts equal
    where their Gumbel margin exceeds 1e-3."""
    for i, (lg, lw) in enumerate(zip(got["losses"], want["losses"])):
        check(set(lg) == set(lw) and all(
            math.isfinite(lg[k]) and abs(lg[k] - lw[k]) <= 1e-5 * abs(lw[k])
            for k in lw), f"{label} step {i + 1}: losses " + ", ".join(
                f"{k} {lg[k]:.6f} vs {lw[k]:.6f}" for k in sorted(lw))
            + " (1e-5 rel)")
    err = max(float(np.abs(got["stats1"][k] - w).max())
              for k, w in want["stats1"].items())
    check(err <= 1e-5, f"{label}: BatchNorm running statistics after step "
          f"1, max |err| {err:.3e} <= 1e-5")
    grads = want["grads"]
    top = max(float(np.abs(g).max()) for g in grads.values())
    lr = want["lr"][-1]
    worst, kept, total = 0.0, 0, 0
    for k, g in grads.items():
        mask = np.abs(g) > 1e-4 * top
        w, p = want["params"][k][mask], got["params"][k][mask]
        excess = np.abs(p - w) - (1e-5 * np.abs(w) + 2e-2 * lr)
        worst = max(worst, float(excess.max(initial=-np.inf)))
        kept, total = kept + int(mask.sum()), total + mask.size
    check(worst <= 0 and kept >= min_share * total,
          f"{label}: parameters after {len(got['losses'])} steps within "
          f"1e-5 x |ref| + 2e-2 x lr ({lr:.3e}) on {kept} of {total} "
          f"elements (decided: |grad| > 1e-4 x {top:.3e}); worst excess "
          f"{worst:.3e}")
    for i, ((sg, _), (sw, mw)) in enumerate(zip(got["routes"],
                                                  want["routes"])):
        sure = mw > 1e-3
        check(bool((sg[sure] == sw[sure]).all()),
              f"{label} step {i + 1}: router counts equal on all "
              f"{int(sure.sum())} of {sure.size} (layer, row) pairs whose "
              f"Gumbel margin exceeds 1e-3; {int((sg != sw).sum())} differ")


def flowkd_model(name: str, seed: int, dtype: str = "float32"):
    """The flowkd configuration `name` (profile_train) at the flagship
    widths with seeded weights on the card, in `dtype`: dropout 0.1,
    SpecAugment and dither on (ModelConfig()'s own)."""
    from tpu_asr_torch.config import ModelConfig, make_student_config
    from tpu_asr_torch.profile_train import distill_config

    cast = lambda cfg: dataclasses.replace(cfg, compute_dtype=dtype)
    tcfg = ModelConfig()
    return kd_model(cast(make_student_config(tcfg)), cast(tcfg), seed,
                    distill_config(name))


def ddp_eval_setup(root):
    """24c: DDP_EVAL_CLIPS seeded WAV clips of 1-15 s (train and val
    manifests), a BPE tokenizer, a fp32 CTC student of ModelConfig() and its
    TrainConfig with global batches of DDP_ROWS."""
    from tpu_asr_torch.config import (DataConfig, DistillationConfig,
                                      ModelConfig, OptimConfig, TrainConfig,
                                      make_student_config)
    from tpu_asr_torch.data.audio import write_wav
    from tpu_asr_torch.data.manifest import ManifestEntry, write_manifest
    from tpu_asr_torch.data.tokenizer import train_bpe

    rng = np.random.default_rng(24)
    entries = []
    for i in range(DDP_EVAL_CLIPS):
        dur = float(np.round(rng.uniform(1.0, 15.0), 3))
        write_wav(root / f"clip{i}.wav", (rng.normal(size=int(SR * dur))
                                          * 0.1).astype(np.float32), SR)
        entries.append(ManifestEntry(str(root / f"clip{i}.wav"), dur, " ".join(
            rng.choice(CLI_WORDS, size=max(1, int(dur * 1.5))))))
    write_manifest(root / "train.jsonl", entries[DDP_EVAL_VAL:])
    write_manifest(root / "val.jsonl", entries[:DDP_EVAL_VAL])
    tcfg = ModelConfig()
    tok = train_bpe([e.text for e in entries] + [" ".join(CLI_WORDS)],
                    tcfg.decoder.num_classes)
    scfg = dataclasses.replace(make_student_config(tcfg),
                               compute_dtype="float32")
    ds = dict(batch_size=DDP_ROWS, max_duration=16.7)
    cfg = TrainConfig(model=scfg, distillation=DistillationConfig(),
                      optim=OptimConfig(d_model=scfg.encoder.d_model),
                      train_ds=DataConfig(shuffle=True, **ds),
                      test_ds=DataConfig(shuffle=False, **ds), max_epochs=1)
    return (str(root / "train.jsonl"), str(root / "val.jsonl"), tok, scfg,
            tcfg, cfg)


def ddp_trainer(setup, workdir):
    from tpu_asr_torch.config import DistillationConfig
    from tpu_asr_torch.train.loop import Trainer

    _, _, tok, scfg, tcfg, cfg = setup
    model = kd_model(scfg, tcfg, 46, DistillationConfig())
    return Trainer(model, cfg, tok, workdir, device="cuda")


def ddp_rank(batch, eval_setup, workdir, packed=None, cli_argv=None):
    """One gloo rank of 24b, 24c, 25d and 25e (parallel/launch.py):
    ddp_step_runs of each DDP_CONFIGS on this rank's rows of `batch`
    (numpy), and of flowkd_mlp8's packed step on its part of the plan of
    `packed`; then a fit of 2 steps, its checkpoint (rank 0's), evaluate
    and evaluate_packed of the val manifest, each rank on its own rows;
    last asr_inference with `cli_argv` on this rank (its results and what
    it printed). Also the seconds of each part."""
    import contextlib
    import io

    full_fp32()
    seconds, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        seconds[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    runs = {}
    for name in DDP_CONFIGS:
        runs[name] = ddp_step_runs(flowkd_model(name, 47), batch, 48)
        torch.cuda.empty_cache()
        lap(name)
    if packed is not None:
        plan = {k: torch.from_numpy(v).cuda() for k, v in packed.items()}
        runs["packed"] = ddp_step_runs(flowkd_model("flowkd_mlp8", 47), plan,
                                       48, packed=True)
        torch.cuda.empty_cache()
        lap("25d packed")
    tr = ddp_trainer(eval_setup, workdir)
    tr.fit(eval_setup[0], max_steps=2)
    lap("fit")
    bucketed = tr.evaluate(eval_setup[1])
    lap("evaluate")
    packed = tr.evaluate_packed(eval_setup[1])
    lap("evaluate_packed")
    cli = None
    if cli_argv is not None:
        from tpu_asr_torch.cli import asr_inference
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            results = asr_inference.main(cli_argv)
        cli = (results, printed.getvalue())
        lap("25e asr_inference")
    return runs, bucketed, packed, seconds, cli


def packed_ddp_batch(rows: int, seed: int) -> dict:
    """25d: `rows` clips of 1-15 s (SECONDS-padded, TOKENS tokens) with
    their training plan in rows of profile_train.T_PACK frames at
    row_multiple 2, as numpy."""
    from tpu_asr_torch.config import ModelConfig, make_student_config
    from tpu_asr_torch.data.packing import train_pack_arrays
    from tpu_asr_torch.profile_train import T_PACK

    rng = np.random.default_rng(seed)
    lens = (rng.uniform(1.0, SECONDS, rows) * SR).astype(np.int32)
    sig = (rng.normal(size=(rows, SECONDS * SR)) * 0.1).astype(np.float32)
    sig[np.arange(SECONDS * SR)[None, :] >= lens[:, None]] = 0.0
    scfg = make_student_config(ModelConfig())
    pre, enc = scfg.preprocessor, scfg.encoder
    pk, _ = train_pack_arrays(lens, pre.n_fft, pre.hop_length,
                              enc.subsampling_factor, enc.subsampling,
                              enc.conv_kernel_size, T_PACK, row_multiple=2)
    return {"signal": sig, "signal_len": lens,
            "tokens": rng.integers(0, 128, size=(rows, TOKENS)),
            "token_len": np.full((rows,), TOKENS), **pk}


def packed_launched(n, label: str) -> None:
    want = KD + ("attention_seg_bwd",)
    check(all(n[k] > 0 for k in want)
          and n["attention_seg_bwd"] == n["attention_bwd"],
          f"{label}: the packed steps launched every KD kernel, every "
          f"attention backward in its segment mode: "
          f"{ {k: n[k] for k in want} }")


def cli_eval_setup(root, setup) -> list:
    """25e: a student export of the model asr_inference builds from
    configs/conformer_ctc_small.yaml (ModelConfig()'s widths, bf16) with
    setup's tokenizer as its sidecar, its weights seeded; the argv of one
    rank over setup's val manifest with global batches of DDP_ROWS."""
    from tpu_asr_torch.cli.common import _build, build_inference_parser
    from tpu_asr_torch.config import OptimConfig
    from tpu_asr_torch.profile_forward import seed_weights
    from tpu_asr_torch.train.trainer import DistilTrainState
    from tpu_asr_torch.utils.checkpoint import export_student

    ckpt = root / "checkpoints"
    ckpt.mkdir(parents=True)
    setup[2].save(ckpt / "tokenizer.model")
    argv = ["--test_manifest", setup[1], "--config",
            "configs/conformer_ctc_small.yaml", "--ckpt_path",
            str(ckpt / "student"), "--batch_size", str(DDP_ROWS),
            "--output_dir", str(root / "out")]
    args = build_inference_parser("25e").parse_args(argv)
    scfg, _, model, _, _ = _build(args, {"test": setup[1]}, False, None,
                                  ckpt / "tokenizer.model")
    seed_weights(model.student, 51)
    export_student(ckpt, DistilTrainState.create(model, OptimConfig()),
                   scfg)
    return argv


def ddp_phase():
    """Phase 24, data parallelism: (b) two gloo ranks sharing the card
    against one rank, the ranks started first; while they run, (a)'s check
    of NCCL at world 1 against the step without DDP; (c) their distributed
    evaluation and the restore of their checkpoint at one rank; last, with
    the card to itself, (a)'s timed steps without and with DDP. The same
    ranks and the same layout run phase 25's packed step at N ranks (25d:
    NCCL at world 1 against no DDP, 2 gloo ranks on their parts of one plan
    against one rank) and asr_inference on 2 ranks against one (25e)."""
    import copy
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from tpu_asr_torch.parallel import launch, mesh
    from tpu_asr_torch.utils.checkpoint import restore_train_state

    def nccl_world_1(fn, *args):
        mesh.init_distributed(1, 0, "nccl", "cuda:0",
                              f"tcp://127.0.0.1:{launch.free_port()}", 300)
        try:
            return fn(*args)
        finally:
            mesh.shutdown()

    parts, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        parts[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ddp_"))
    try:
        setup = ddp_eval_setup(root)
        batch = train_batch(DDP_ROWS, 41)
        host = {k: v.cpu().numpy() for k, v in batch.items()}
        packed_host = packed_ddp_batch(DDP_ROWS, 49)
        packed = {k: torch.from_numpy(v).cuda()
                  for k, v in packed_host.items()}
        pk_rows, pk_t = packed_host["pk_seg"].shape
        cli_argv = cli_eval_setup(root / "cli", setup)
        lap("setup")
        with ThreadPoolExecutor(1) as pool:
            started = pool.submit(
                launch.launch, ddp_rank,
                (host, setup, str(root / "fit"), packed_host,
                 cli_argv + ["--gpus", "2"]),
                ["cuda:0", "cuda:0"], timeout=600,
                coll_timeout=300)
            # (a) the DDP step in a one-rank NCCL group against the step
            # without, from the same weights and seeds
            model = flowkd_model("flowkd_mlp8", 40)
            init = copy.deepcopy(model.state_dict())
            plain = ddp_step_runs(model, batch, 42)
            model.load_state_dict(init)
            ddp_compare(nccl_world_1(ddp_step_runs, model, batch, 42), plain,
                        f"24a: flowkd_mlp8 fp32 B={DDP_ROWS} x {SECONDS} s, "
                        f"DDP over NCCL at world 1 vs no DDP")
            # 25d: the packed step the same way
            model = flowkd_model("flowkd_mlp8", 40)
            init = copy.deepcopy(model.state_dict())
            plain = ddp_step_runs(model, packed, 42, packed=True)
            model.load_state_dict(init)
            got = nccl_world_1(ddp_step_runs, model, packed, 42, DDP_STEPS,
                               True)
            # the fp32 rule: its decided elements are 86% of the packed
            # step's parameters, 90% of the bucketed step's; at world 1 the
            # packed step's parameters are not bit-equal to the step's
            # without DDP, its losses and BatchNorm statistics are
            ddp_compare(got, plain, f"25d: packed flowkd_mlp8 fp32, "
                        f"{DDP_ROWS} utterances in {pk_rows} rows of "
                        f"{pk_t}, DDP over NCCL at world 1 vs no DDP",
                        min_share=0.8)
            packed_launched(got["launches"], "25d: NCCL world 1")
            del model, init
            want = {}
            for name in DDP_CONFIGS:
                want[name] = ddp_step_runs(flowkd_model(name, 47), batch, 48)
                torch.cuda.empty_cache()
            want["packed"] = ddp_step_runs(flowkd_model("flowkd_mlp8", 47),
                                           packed, 48, packed=True)
            torch.cuda.empty_cache()
            lap("24a/25d checks and 24b/25d's one-rank runs, beside the "
                "ranks")
            ranks = started.result()
        lap("the rest of the ranks' run")
        print(f"24b/c: 2 gloo ranks on cuda:0; rank 0's parts (s): "
              f"{ranks[0][3]}")
        for name in DDP_CONFIGS:
            got = ranks[0][0][name]
            ddp_compare(got, want[name], f"24b: {name} fp32, 2 gloo ranks "
                        f"x {DDP_ROWS // 2} rows vs 1 rank x {DDP_ROWS} (x "
                        f"{SECONDS} s, dropout 0.1, SpecAugment, dither)")
            for r, rank in enumerate(ranks):
                n = rank[0][name]["launches"]
                check(all(n[k] > 0 for k in KD), f"24b: {name} rank {r} "
                      f"launched every KD kernel: { {k: n[k] for k in KD} }")
        split = [len(mesh.packed_rank_block(packed_host, 2, r)["pk_utt"])
                 for r in range(2)]
        ddp_compare(ranks[0][0]["packed"], want["packed"], f"25d: packed "
                    f"flowkd_mlp8 fp32, 2 gloo ranks x "
                    f"{pk_rows // 2} packed rows ({split} "
                    f"utterances) vs 1 rank on the same plan (dropout 0.1, "
                    f"SpecAugment, dither)", min_share=0.8)
        for r, rank in enumerate(ranks):
            packed_launched(rank[0]["packed"]["launches"], f"25d: rank {r}")
        # 25e: asr_inference on the 2 ranks against one rank
        from tpu_asr_torch.cli import asr_inference
        one = asr_inference.main(cli_argv)["test"]
        (two, printed), (two1, printed1) = ranks[0][4], ranks[1][4]
        got = two["test"]
        check(two == two1 and printed.count("wer=") == 1 and printed1 == "",
              "25e: both ranks return the same (summed) evaluation, rank 0 "
              "alone prints")
        check(got["num_utts"] == one["num_utts"] == DDP_EVAL_VAL
              and got["wer"] == one["wer"]
              and abs(got["loss"] - one["loss"]) <= 1e-4 * abs(one["loss"]),
              f"25e: asr_inference --gpus 2 (2 gloo ranks on cuda:0, bf16 "
              f"student export of ModelConfig()) on {DDP_EVAL_VAL} clips wer "
              f"{got['wer']:.4f} loss {got['loss']:.6f} vs 1 rank wer "
              f"{one['wer']:.4f} loss {one['loss']:.6f} (wer equal, loss "
              f"1e-4 rel: bf16)")
        # (c) the ranks' evaluation against one rank's restore
        (_, bucketed, packed, *_), tr = ranks[0], ddp_trainer(setup,
                                                              root / "one")
        check(ranks[1][1] == bucketed and ranks[1][2] == packed,
              "24c: both ranks report the same (summed) evaluation")
        tr.init_state()
        tr.state = restore_train_state(root / "fit" / "checkpoints",
                                       tr.state)
        check(tr.state.step == 2, f"24c: the 2-rank checkpoint restored at "
              f"step {tr.state.step}")
        for label, got, one in (("bucketed", bucketed,
                                 tr.evaluate(setup[1])),
                                ("packed", packed,
                                 tr.evaluate_packed(setup[1]))):
            check(got["num_utts"] == one["num_utts"] == DDP_EVAL_VAL
                  and got["wer"] == one["wer"]
                  and abs(got["loss"] - one["loss"]) <= 1e-5 * abs(
                      one["loss"]),
                  f"24c: {label} evaluation of {DDP_EVAL_VAL} clips, 2 ranks "
                  f"wer {got['wer']:.4f} loss {got['loss']:.6f} vs the "
                  f"checkpoint restored at 1 rank wer {one['wer']:.4f} loss "
                  f"{one['loss']:.6f} (wer equal, loss 1e-5 rel)")
        del tr
        lap("24c at one rank")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # (a) timed, from the same state: without DDP, then with
    timed = flowkd_model("flowkd_mlp8", 43, "bfloat16")
    timed_init = copy.deepcopy(timed.state_dict())
    big = train_batch(BATCH, 44)
    plain_ms, _, _ = timed_steps(timed, big, 45)
    timed.load_state_dict(timed_init)
    ddp_ms, counts, _ = nccl_world_1(timed_steps, timed, big, 45)
    check(all(counts[k] > 0 for k in KD), f"24a: the DDP steps launched "
          f"every KD kernel: { {k: counts[k] for k in KD} }")
    print(f"24a: flowkd_mlp8 bf16 B={BATCH} x {SECONDS} s on {card_line()}: "
          f"DDP (NCCL, world 1) {ddp_ms:.2f} ms a step, without DDP "
          f"{plain_ms:.2f} ms (host clock, {TRAIN_STEPS} steps after "
          f"{TRAIN_WARMUP} warm-up each, in one call; ratio "
          f"{ddp_ms / plain_ms:.3f}; turns and device time: profile_train "
          f"--ddp)")
    lap("24a timed")
    print(f"24: parts (s) {parts}")
    print("24: NCCL between two or more cards is not exercised here: one "
          "card (NCCL refuses two ranks on one device)")


# ---------------------------------------------------------------------------
# Phase 25: the teacher feature caches and steps_per_dispatch
# ---------------------------------------------------------------------------

CACHE_TURNS = "HCCH"            # harvest and cached steps in turns
CACHE_ITERS = 3                 # steps a turn


def bf16_kd_model(distill, seed: int):
    """ModelConfig()'s teacher and its d88 student in bf16 with `distill`
    and seeded weights on the card."""
    from tpu_asr_torch.config import ModelConfig, make_student_config
    tcfg = ModelConfig()
    return kd_model(make_student_config(tcfg), tcfg, seed, distill)


def step_outcome(step, model, init, batch, seed: int):
    """One step of `step` from the weights `init` and a fresh AdamW state,
    counters reset just before and read just after: (metrics, parameters
    after it, launches, extra outputs)."""
    from tpu_asr_torch.config import OptimConfig
    from tpu_asr_torch.train.trainer import DistilTrainState
    model.load_state_dict(init)
    state = DistilTrainState.create(model, OptimConfig())
    read = reset_counters()
    out = step(state, batch, seed)
    torch.cuda.synchronize()
    return (out[1], {n: p.detach().clone()
                     for n, p in model.named_parameters()}, read(),
            out[2] if len(out) > 2 else None)


def max_rel(a: dict, b: dict) -> float:
    """The largest |a - b| / max(|b|, tiny) over every element of the
    tensors of two dicts of one layout (0 where bit-equal)."""
    worst = 0.0
    for k, w in b.items():
        d = (a[k].float() - w.float()).abs()
        worst = max(worst, float((d / w.float().abs().clamp(
            min=1e-30)).max()))
    return worst


def turns(fns: dict, order: str = CACHE_TURNS, iters: int = CACHE_ITERS):
    """Each fn of `fns` (by letter): the wall ms of a call over `iters`
    calls ending in a synchronize, per turn of `order`, then the device ms
    of one call (device_ms, torch.profiler, once a letter: a full-width
    step's device time moves by < 0.5% from turn to turn, while a profiled
    pass of 3 of them costs ~19 s of host time). Returns {letter: (device
    ms, wall ms list)}."""
    wall = {k: [] for k in fns}
    for k in order:
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(iters):
            fns[k]()
        torch.cuda.synchronize()
        wall[k].append(1e3 * (time.perf_counter() - start) / iters)
    return {k: (device_ms(fn, iters=1)[0], wall[k])
            for k, fn in fns.items()}


def deterministic():
    """cuDNN restricted to its deterministic algorithms (the plain
    backward of the subsampling's convolutions), for the runs that are
    compared bit for bit; timings keep the defaults."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def cache_case(label: str, distill, all_layers: bool, seed: int) -> dict:
    """25a / 25b: the harvest step, then from the same weights, state and
    draws the cached step fed the harvested features stored in a
    TeacherFeatureCache (bf16 storage of bf16 compute, read back); losses,
    grad_norm and the parameters after the step compared, the launches of
    the two steps against the teacher forward's; both steps timed in
    turns. Returns the timings."""
    import copy

    from tpu_asr_torch.train.loop import TeacherFeatureCache
    from tpu_asr_torch.config import OptimConfig
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_train_step)

    model = bf16_kd_model(distill, seed)
    init = copy.deepcopy(model.state_dict())
    batch = train_batch(BATCH, seed + 1)
    harvest = make_distil_train_step(model, harvest_teacher=True,
                                     harvest_all=all_layers)
    cached = make_distil_train_step(model, cached_teacher=not all_layers,
                                    cached_all_layers=all_layers)
    read = reset_counters()
    with torch.no_grad():
        _, _, tch = model.teacher.encode(batch["signal"],
                                         batch["signal_len"])
    torch.cuda.synchronize()
    teacher = read()
    with deterministic():
        m_h, p_h, n_h, (last, feats, enc_len) = step_outcome(
            harvest, model, init, batch, seed + 2)
        m_h2, p_h2, _, _ = step_outcome(harvest, model, init, batch,
                                        seed + 2)
    check(torch.equal(feats[-1] if all_layers else last, tch[-1]),
          f"{label}: the harvested teacher features are the teacher "
          f"forward's, bit for bit")
    cache = TeacherFeatureCache(torch.bfloat16, all_layers=all_layers)
    idx = list(range(BATCH))
    l_pad = batch["signal"].shape[1]
    cache.put_batch(idx, feats if all_layers else last, enc_len.cpu(),
                    l_pad)
    d_t = model.teacher_cfg.encoder.d_model
    stored = cache.assemble(idx, cache.tprime[l_pad], d_t).cuda()
    harvested = feats.transpose(0, 1) if all_layers else last
    frames = torch.arange(stored.shape[-2], device=stored.device)
    mask = frames[None, :] < enc_len[:, None]             # (B, T')
    mask = mask[:, None, :, None] if all_layers else mask[..., None]
    check(torch.equal(stored, torch.where(mask, harvested, 0)),
          f"{label}: the cache gives the harvested features back bit for "
          f"bit (bf16 bits, {tuple(stored.shape)}, frames past each "
          f"utterance 0)")
    key = "tch_all_feat" if all_layers else "tch_last_feat"
    cb = {**batch, key: stored}
    with deterministic():
        m_c, p_c, n_c, _ = step_outcome(cached, model, init, cb, seed + 2)
    run_to_run = max(max_rel(m_h2, m_h), max_rel(p_h2, p_h))
    err = max(max_rel(m_c, m_h), max_rel(p_c, p_h))
    names = sorted(k for k in m_h if k.startswith("loss/")) + ["grad_norm"]
    check(set(m_c) == set(m_h) and (err == 0.0 or (
        run_to_run > 0 and err <= 1e-6)),
          f"{label}: cached step vs harvest step, max relative difference "
          f"{err:.3e} over " + ", ".join(
              f"{k} {m_c[k].item():.6f} / {m_h[k].item():.6f}"
              for k in names) + f" and the parameters after the step "
          f"(bit-equal required; two harvest steps differ by "
          f"{run_to_run:.3e}, and a difference is then bounded at 1e-6)")
    drop = {k: n_h[k] - n_c[k] for k in n_h}
    check(drop == teacher and any(teacher.values()),
          f"{label}: launches dropped by exactly the teacher forward's: "
          f"{ {k: v for k, v in drop.items() if v} } vs "
          f"{ {k: v for k, v in teacher.items() if v} }")
    # timed in turns, both steps on one model and state
    model.load_state_dict(init)
    del init
    state = DistilTrainState.create(model, OptimConfig())
    res = turns({"H": lambda: harvest(state, batch, seed + 2),
                 "C": lambda: cached(state, cb, seed + 2)})
    (hd, hw), (cd, cw) = res["H"], res["C"]
    print(f"{label}: bf16 B={BATCH} x {SECONDS} s on {card_line()}: device "
          f"ms a step harvest {hd:.3f}, cached {cd:.3f} (cached / harvest "
          f"{cd / hd:.3f}); wall ms a step harvest {np.median(hw):.2f} "
          f"{[round(x, 2) for x in hw]}, cached {np.median(cw):.2f} "
          f"{[round(x, 2) for x in cw]} (turns {CACHE_TURNS}, "
          f"{CACHE_ITERS} steps a turn; cached / harvest "
          f"{np.median(cw) / np.median(hw):.3f}); launches a step harvest "
          f"{sum(n_h.values())}, cached {sum(n_c.values())}")
    del model, state
    torch.cuda.empty_cache()
    return {"harvest_device_ms": hd, "cached_device_ms": cd,
            "harvest_wall_ms": hw, "cached_wall_ms": cw}


def multi_step_case(seed: int, k: int = 4) -> None:
    """25c: make_distil_multi_step at K=`k` against `k` train_step calls on
    the same stacked batches, from the same weights: state (parameters,
    optimizer moments, BatchNorm statistics, step) and metrics bit-equal;
    launches and ms a step both ways."""
    import copy

    from tpu_asr_torch.config import OptimConfig
    from tpu_asr_torch.profile_train import distill_config
    from tpu_asr_torch.train.trainer import (DistilTrainState,
                                             make_distil_multi_step,
                                             make_distil_train_step)

    model = bf16_kd_model(distill_config("flowkd_mlp8"), seed)
    init = copy.deepcopy(model.state_dict())
    parts = [train_batch(BATCH, seed + 1 + i) for i in range(k)]
    stacked = {n: torch.stack([p[n] for p in parts]) for n in parts[0]}
    step, multi = (make_distil_train_step(model),
                   make_distil_multi_step(model))

    def run(use_multi):
        model.load_state_dict(init)
        state = DistilTrainState.create(model, OptimConfig())
        read = reset_counters()
        torch.cuda.synchronize()
        start = time.perf_counter()
        if use_multi:
            state, metrics = multi(state, stacked, seed)
        else:
            per = []
            for i in range(k):
                state, m = step(state, {n: v[i] for n, v in
                                        stacked.items()}, seed)
                per.append(m)
            metrics = {n: torch.stack([m[n] for m in per]) for n in per[0]}
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - start) / k
        opt = {f"{i}.{n}": v.clone() for i, st in
               enumerate(state.optimizer.state.values())
               for n, v in st.items() if torch.is_tensor(v)}
        return (state.step, metrics, {**{n: t.clone() for n, t in
                                         model.state_dict().items()},
                                      **opt}, read(), ms)

    with deterministic():
        s1, m1, sd1, n1, _ = run(False)
        s2, m2, sd2, n2, _ = run(True)
    differ = sorted(n for n in sd1 if not torch.equal(sd1[n], sd2[n]))
    check(s1 == s2 == k and set(m1) == set(m2)
          and all(torch.equal(m1[n], m2[n]) for n in m1)
          and set(sd1) == set(sd2) and not differ,
          f"25c: flowkd_mlp8 bf16 multi-step K={k} vs {k} train_step calls "
          f"on the same stacked batches (cuDNN deterministic): state "
          f"(parameters, optimizer moments, BatchNorm statistics, step "
          f"{s2}) and metrics bit-equal; losses "
          f"{[round(x, 4) for x in m2['loss/total'].tolist()]} vs "
          f"{[round(x, 4) for x in m1['loss/total'].tolist()]}; "
          f"{len(differ)} of {len(sd1)} state tensors differ "
          f"{differ[:4]}")
    check(n1 == n2, "25c: launches of the K steps equal both ways")
    wall = {False: [], True: []}
    for use_multi in (False, True, True, False):       # in turns
        wall[use_multi].append(run(use_multi)[4])
    print(f"25c: flowkd_mlp8 bf16 B={BATCH} x {SECONDS} s on "
          f"{card_line()}: wall ms a step as {k} train_step calls "
          f"{[round(x, 2) for x in wall[False]]}, in one multi-step "
          f"{[round(x, 2) for x in wall[True]]} (host clock over the {k} "
          f"steps of a pass, passes in turns C M M C after the checked "
          f"ones; the device runs the same launches either way); "
          f"launches a step "
          f"{sum(n2.values()) / k:.0f} both ways: "
          f"{ {n: v // k for n, v in n2.items() if v} }")
    del model, init
    torch.cuda.empty_cache()


def cache_phase() -> None:
    """Phase 25 (25d and 25e run within phase 24's ranks): the all-layer
    cache under flowkd_mlp8 (25a), the last-layer cache under logit KD
    (25b), the multi-step (25c)."""
    from tpu_asr_torch.config import DistillationConfig
    from tpu_asr_torch.profile_train import distill_config

    timed_phase("25a", cache_case, "25a: flowkd_mlp8, cache_teacher_all",
                distill_config("flowkd_mlp8"), True, 60)
    timed_phase("25b", cache_case, "25b: logit_kd, cache_teacher",
                DistillationConfig(use_logit_distillation=True,
                                   kd_alpha=0.1), False, 70)
    timed_phase("25c", multi_step_case, 80)


INT8_STREAM_STEPS, INT8_STREAM_REPEATS = 20, 2     # phase 26a's timing


def int8_streaming_phase(cfg):
    """Phase 26a: int8 cache-aware streaming of bench.py's streaming
    configuration of cfg. fp32: 8 streams of 2-6 s on the kernels ('auto':
    the int8 FFN kernel in every cached layer) against the same model with
    every route 'xla', by phase 11's int8 rule (ids on >= 99% of the frames
    whose top-2 margin exceeds 1e-2; the largest log-prob difference at most
    half the int8-vs-fp drift of the same weights); then the bf16 step's
    latency and busy share at B=1 and 8 beside the float step's."""
    from tpu_asr_torch.models.streaming import CacheAwareStreamer
    from tpu_asr_torch.profile_forward import (seeded_model, set_backend,
                                               waveforms)

    fcfg = streaming_config(cfg)
    qcfg = streaming_config(with_encoder(cfg, quantization="int8"))
    f32 = lambda c: dataclasses.replace(c, compute_dtype="float32")
    clips = waveforms(np.random.default_rng(26), 8, 2.0, 6.0)
    sig = np.zeros((len(clips), max(len(c) for c in clips)), np.float32)
    for i, c in enumerate(clips):
        sig[i, :len(c)] = c
    model = seeded_model(f32(qcfg), seed=26)
    fp_model = seeded_model(f32(fcfg), seed=26)
    set_backend(fp_model, "xla")
    streamer = CacheAwareStreamer(model, device="cuda")
    with torch.inference_mode():
        feats, feat_len = model.featurizer(
            torch.from_numpy(sig).cuda(),
            torch.tensor([len(c) for c in clips], device="cuda"))
    read = reset_counters()
    got = stream_batch(streamer, feats, feat_len)
    counts = read()
    set_backend(model, "xla")
    want = stream_batch(streamer, feats, feat_len)
    set_backend(model, "auto")
    fp = stream_batch(CacheAwareStreamer(fp_model, device="cuda"), feats,
                      feat_len)
    steps = -(-int(feat_len.max()) // streamer.stream_cfg.chunk_size)
    n_ffn = 2 * qcfg.encoder.n_layers * steps
    check(counts["ffn_int8"] == n_ffn and counts["attention"] == 0,
          f"int8 streaming fp32 B=8: {counts['ffn_int8']} ffn_int8 launches "
          f"in {steps} steps (two a layer a step: {n_ffn}); attention 0 "
          f"(cached steps run it plain, as in JAX)")
    delta = max((g - w).abs().max().item() for g, w in zip(got, want))
    drift = max((w - f).abs().max().item() for w, f in zip(want, fp))
    agree = n_dec = 0
    for g, w in zip(got, want):
        top2 = w.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 1e-2
        n_dec += int(decided.sum())
        agree += int(((g.argmax(-1) == w.argmax(-1)) & decided).sum())
    check(0 < drift and delta <= 0.5 * drift,
          f"int8 streaming fp32 B=8 (2-6 s): max |delta log-prob| kernels "
          f"vs 'xla' {delta:.3e} <= half the int8-vs-fp drift {drift:.3e}")
    check(agree >= 0.99 * n_dec, f"int8 streaming fp32: ids equal on "
          f"{agree} of {n_dec} frames with top-2 margin > 1e-2 (>= 99%)")

    gen = torch.Generator(device="cuda").manual_seed(26)
    s_q = CacheAwareStreamer(seeded_model(qcfg, seed=26), device="cuda")
    s_f = CacheAwareStreamer(seeded_model(fcfg, seed=26), device="cuda")
    lat = {}
    for b in (1, 8):
        for name, st in (("int8", s_q), ("float", s_f)):
            read = reset_counters()
            reps, busy = streaming_latency(st, b, gen, INT8_STREAM_STEPS,
                                           INT8_STREAM_REPEATS)
            n = read()["ffn_int8"]
            check((n > 0) == (name == "int8"), f"{name} bf16 streaming "
                  f"B={b}: {n} ffn_int8 launches in the timed window")
            lat[name, b] = float(np.median(reps))
            print(f"streaming step ({name}, bf16, B={b}, {card_line()}): "
                  f"median {lat[name, b]:.3f} ms, {min(reps):.3f}-"
                  f"{max(reps):.3f} over {INT8_STREAM_REPEATS} repeats of "
                  f"{INT8_STREAM_STEPS} steps (host clock); device busy "
                  f"{busy:.3f} ms a step, busy share "
                  f"{busy / lat[name, b]:.3f}")
    return lat


EXPORT_BUCKET = (SERVE_BATCH, 16.0)    # phase 26b's one bucket
EXPORT_CHILD = """
import json, sys, time
import numpy as np
from tpu_asr_torch.convert import export
reqs = np.load(sys.argv[2])
requests = [[reqs[f"r{i}_{j}"] for j in range(int(reqs[f"n{i}"]))]
            for i in range(int(reqs["count"]))]
t0 = time.perf_counter()
ex = export.load_exported(sys.argv[1])
load_s = time.perf_counter() - t0
prog = ex.buckets[0][1]
ops = sorted({str(n.target) for n in prog.graph.nodes
              if str(n.target).startswith("tpu_asr_torch.")})
import torch
wrappers = {"logmel": export.cuda_features.fused_logmel,
            "subsampling": export.cuda_subsampling.fused_subsampling,
            "attention": export.cuda_attention.fused_relpos_attention_block}
warm = int(reqs["warmup"])
for r in requests[:warm]:
    ex.transcribe(r)
torch.cuda.synchronize()
for w in wrappers.values():
    w.launches = 0
texts = []
t0 = time.perf_counter()
for r in requests[warm:]:
    texts.append(ex.transcribe(r))
torch.cuda.synchronize()
wall = time.perf_counter() - t0
counts = {k: w.launches for k, w in wrappers.items()}
ids = []
for idxs, sig, ln, p in ex.batches(requests[warm]):
    with torch.inference_mode():
        lp, enc_len = p(torch.from_numpy(sig).cuda(),
                        torch.from_numpy(ln).cuda())
    for j, i in enumerate(idxs):
        ids.append((int(i), lp[j, :int(enc_len[j])].argmax(-1).tolist()))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "tpu_asr"))
print(json.dumps({"load_s": load_s, "ops": ops, "counts": counts,
                  "wall": wall, "texts": texts, "ids": ids, "bad": bad}))
"""


def export_phase(cfg, rtfx: float):
    """Phase 26b: the serving artifact (convert/export.py) of ModelConfig()
    in bf16 from phase 5's weights, one bucket (32 x 16 s), exported on
    the card; loaded in a fresh process that imports only the port's
    loader, which serves phase 5's window there (launch counters reset
    just before, read just after); its graph's ops, its ids against the
    Transcriber's on the first request by phase 4's bf16 rule, and its
    RTFx beside phase 5's Transcriber's (`rtfx`)."""
    import os
    import tempfile

    from tpu_asr_torch.convert.export import export_inference
    from tpu_asr_torch.models.transcribe import Transcriber
    from tpu_asr_torch.profile_forward import seeded_model

    model = seeded_model(cfg, seed=2)
    tok = serve_tokenizer(cfg)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    path = os.path.join(tmp, "model.tasrx")
    t0 = time.perf_counter()
    export_inference(model, tok, path, buckets=[EXPORT_BUCKET])
    export_s = time.perf_counter() - t0
    print(f"export: ModelConfig() bf16, bucket {EXPORT_BUCKET[0]} x "
          f"{EXPORT_BUCKET[1]:.0f} s, exported on the card in {export_s:.1f} "
          f"s, {os.path.getsize(path) / 2**20:.1f} MiB ({card_line()})")
    requests = serve_requests()
    arrays = {"count": len(requests), "warmup": SERVE_WARMUP}
    for i, r in enumerate(requests):
        arrays[f"n{i}"] = len(r)
        arrays.update({f"r{i}_{j}": w for j, w in enumerate(r)})
    np.savez(os.path.join(tmp, "requests.npz"), **arrays)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, path,
                           os.path.join(tmp, "requests.npz")],
                          capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the fresh process served the artifact "
          f"(exit {proc.returncode}): {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    check(out["bad"] == [], f"the fresh process loaded no JAX or tpu_asr "
          f"module: {out['bad']}")
    want_ops = {"tpu_asr_torch.logmel.default",
                "tpu_asr_torch.subsampling.default",
                "tpu_asr_torch.relpos_attention_block.default"}
    check(set(out["ops"]) == want_ops, f"the loaded program's graph names "
          f"the serving path's ops: {out['ops']}")
    check(all(v > 0 for v in out["counts"].values()),
          f"every serving kernel launched inside the exported program's "
          f"window: {out['counts']}")
    window = requests[SERVE_WARMUP:]
    flat = [t for r in out["texts"] for t in r]
    check(len(flat) == SERVE_REQUESTS * SERVE_BATCH
          and all(isinstance(t, str) for t in flat),
          f"ExportedTranscriber answered {SERVE_REQUESTS} requests of "
          f"{SERVE_BATCH} waveforms with strings, e.g. {flat[0]!r}")

    # the first request's ids: the Transcriber's bf16 forward and the fp32
    # plain model's margins, on the Transcriber's padding
    from tpu_asr_torch.models.transcribe import _buckets
    from tpu_asr_torch.profile_forward import set_backend
    tr = Transcriber(model, tok, batch_size=SERVE_BATCH, device="cuda")
    texts = tr.transcribe(window[0])
    model32 = seeded_model(dataclasses.replace(cfg, compute_dtype="float32"),
                           seed=2)
    set_backend(model32, "xla")
    got = dict(out["ids"])
    agree = n_dec = 0
    for idxs, sig, ln in _buckets(window[0], SERVE_BATCH, tr.bucket_seconds,
                                  SR):
        with torch.inference_mode():
            s_t, l_t = torch.from_numpy(sig).cuda(), torch.from_numpy(ln).cuda()
            ref = model(s_t, l_t)
            f32 = model32(s_t, l_t)
        for j, i in enumerate(idxs):
            n = int(ref.encoded_len[j])
            top2 = f32.log_probs[j, :n].topk(2, dim=-1).values
            decided = ((top2[:, 0] - top2[:, 1]) > 1e-1).cpu()
            mine = torch.tensor(got[int(i)])
            check(len(mine) == n, f"request clip {i}: {len(mine)} frames, "
                  f"the Transcriber's {n}")
            n_dec += int(decided.sum())
            agree += int(((mine == ref.greedy[j, :n].cpu())
                          & decided).sum())
    same_text = sum(a == b for a, b in zip(texts, out["texts"][0]))
    check(agree >= 0.99 * n_dec, f"exported program: ids equal to the "
          f"Transcriber's on {agree} of {n_dec} frames with fp32 top-2 "
          f"margin > 1e-1 (>= 99%); texts equal on {same_text} of "
          f"{len(texts)} clips of the request")
    audio_s = sum(len(w) for r in window for w in r) / SR
    print(f"serve ExportedTranscriber (fresh process, {card_line()}): "
          f"{SERVE_REQUESTS} requests x {SERVE_BATCH} clips, {audio_s:.2f} s "
          f"of audio in {out['wall']:.4f} s wall: RTFx "
          f"{audio_s / out['wall']:.1f}, Transcriber (phase 5, same run) "
          f"{rtfx:.1f}; load {out['load_s']:.1f} s, the process "
          f"{child_s:.1f} s; launches {out['counts']}")
    return out["counts"], model, tok


def codec_native_phase(model, tok):
    """Phase 26c: the codec libraries of this host (data/codecs.py), one
    Transcriber request on decoded MP3 clips where libmpg123 and
    libmp3lame are present, and the native FLAC decoder (tpu_asr_torch/
    native, built with the host C compiler) on a generated clip, bit-equal
    to the Python decoder, both timed."""
    import ctypes.util
    import os
    import tempfile

    from tpu_asr_torch import native
    from tpu_asr_torch.data import codecs
    from tpu_asr_torch.data.flac import decode_flac
    from tpu_asr_torch.models.transcribe import Transcriber

    libs = {n: ctypes.util.find_library(n) for n in ("mpg123", "mp3lame",
                                                     "opus")}
    print(f"codec libraries on this host: {libs}; HAVE_MP3 "
          f"{codecs.HAVE_MP3}, HAVE_MP3_ENCODE {codecs.HAVE_MP3_ENCODE}, "
          f"HAVE_OPUS {codecs.HAVE_OPUS}")
    t0 = time.perf_counter()
    lib = native.build()
    print(f"native library: {lib} ({time.perf_counter() - t0:.2f} s)")
    if codecs.HAVE_MP3 and codecs.HAVE_MP3_ENCODE:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_mp3_")
        paths = []
        for i, w in enumerate(serve_requests()[SERVE_WARMUP]):
            paths.append(os.path.join(tmp, f"clip{i}.mp3"))
            with open(paths[-1], "wb") as f:
                f.write(codecs.encode_mp3(w, SR))
        tr = Transcriber(model, tok, batch_size=SERVE_BATCH, device="cuda")
        read = reset_counters()
        t0 = time.perf_counter()
        texts = tr.transcribe(paths)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read().items() if k in SERVING}
        check(len(texts) == len(paths) and all(isinstance(t, str)
                                               for t in texts)
              and all(v > 0 for v in counts.values()),
              f"Transcriber on {len(paths)} MP3 clips (decoded by "
              f"libmpg123): strings, e.g. {texts[0]!r}, launches {counts}, "
              f"{time.perf_counter() - t0:.2f} s with the decode")
    else:
        print("MP3: libmpg123 or libmp3lame missing on this host; the MP3 "
              "request is not run")
    import importlib.util
    spec = importlib.util.spec_from_file_location(   # the tests' encoder
        "chip_smoke_flac_writer",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                     "flac_writer.py"))
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)
    rng = np.random.default_rng(26)
    t = np.arange(2 * SR)
    x = np.clip(np.round(8000 * np.sin(t / 13.0)) + rng.integers(
        -400, 400, t.size), -32768, 32767).astype(np.int64)
    data = writer.encode_flac(x, SR, subframe_mode="fixed2")
    got, sr = native.flac_decode(data)
    want, sr_p = decode_flac(data)
    check(sr == sr_p and np.array_equal(got, want),
          f"native FLAC decode of a {len(x) / SR:.0f} s clip bit-equal to the "
          f"Python decoder ({len(got)} samples)")
    times = {}
    for name, fn, reps in (("native", native.flac_decode, 5),
                           ("python", decode_flac, 1)):
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(data)
            ms.append(1e3 * (time.perf_counter() - t0))
        times[name] = float(np.median(ms))
    print(f"FLAC decode of {len(x) / SR:.0f} s (host, {card_line()}): native "
          f"{times['native']:.3f} ms (median of 5), Python "
          f"{times['python']:.1f} ms (one call), host clock")


# phase 27: flowkd_large at B = 4 x 15 s (rows 4 x 18 layers to the FM);
# 27e the KD step at XLarge's widths (phase 19's XL_LAYERS layers) with
# FM-KT at C = 512 and 24 Euler steps, B = 4 x 15 s (rows 4 x XL_LAYERS)
LARGE_KD_ROWS, LARGE_KD_STEPS, LARGE_KD_SEED = 4, 3, 70
XL_KD_ROWS, XL_KD_FM_STEPS, XL_KD_STEPS, XL_KD_SEED = 4, 24, 2, 72


def fm_wide_phase():
    """Phase 27a: the wide FM kernels (see the module docstring). Returns
    {row: (err, ms, plain_ms, bound, None)} of the bf16 rows of the KERNELS
    line at the shapes their main paths give them: flowkd_large's (27b:
    C=256, 8 steps) and the XLarge KD step's (27e: C=512, 24 steps)."""
    regs = nvcc_registers("fm_")
    names = {"fm_fwd_wide_kernel<float>", "fm_bwd_wide_kernel<float>",
             "fm_fwd_wide_mma_kernel", "fm_bwd_wide_rows_kernel"}
    wide = {k: v for k, v in regs.items() if "wide" in k}
    check(set(wide) == names and all(st == 0 and ld == 0
                                     for _, st, ld in wide.values()),
          f"ptxas: the 4 wide FM kernels ({sorted(wide)}; fp32 SIMT, bf16 "
          f"tensor cores), none spills")
    gen = torch.Generator(device="cuda").manual_seed(27)
    t, rows = 376, LARGE_KD_ROWS * 18
    ragged = lambda n: torch.randint(1, 25, (n,), generator=gen,
                                     device="cuda")
    out = {}
    args = fm_inputs(gen, rows, t, 8, c=256)
    for dt in (torch.float32, torch.bfloat16):
        timed = fm_compare(args, 8, dt, f"rows={rows} T={t} steps=8",
                           time_it=True, explicit=dt == torch.bfloat16)
    out["fm_c256"], out["fm_c256_bwd"] = timed
    args = fm_inputs(gen, rows, t, 24, ragged(rows), c=256)
    for dt in (torch.float32, torch.bfloat16):
        fm_compare(args, 24, dt, f"rows={rows} T={t} per-row steps 1..24, "
                   f"max_steps 24", explicit=dt == torch.bfloat16)
    # the route's edge: C <= 128 with H > 256 takes the wide kernels
    args = fm_inputs(gen, 8, t, 8, ragged(8).clamp(max=8), c=88, h=512)
    fm_compare(args, 8, torch.bfloat16, f"rows=8 T={t} per-row steps 1..8",
               explicit=True)
    # C=512: fp32 on 24 rows (at 72 rows x 24 steps one pre-activation
    # within fp32 rounding of 0 takes the other side of the relu in the
    # kernel and in plain, and that position's x_j dp term alone moves
    # dW1x by 6.5e-3 of its scale, measured on an H100)
    args32 = fm_inputs(gen, 24, t, 24, ragged(24), c=512)
    fm_compare(args32, 24, torch.float32,
               f"rows=24 T={t} per-row steps 1..24, max_steps 24")
    args = fm_inputs(gen, rows, t, 8, c=512)
    fm_compare(args, 8, torch.float32, f"rows={rows} T={t} steps=8")
    fm_compare(args, 8, torch.bfloat16, f"rows={rows} T={t} steps=8",
               explicit=True)
    args = fm_inputs(gen, rows, t, 24, ragged(rows), c=512)
    fm_compare(args, 24, torch.bfloat16,
               f"rows={rows} T={t} per-row steps 1..24, max_steps 24",
               explicit=True)
    xl_rows = XL_KD_ROWS * XL_LAYERS
    args = fm_inputs(gen, xl_rows, t, XL_KD_FM_STEPS, c=512)
    out["fm_c512_s24"], out["fm_c512_s24_bwd"] = fm_compare(
        args, XL_KD_FM_STEPS, torch.bfloat16,
        f"rows={xl_rows} T={t} steps={XL_KD_FM_STEPS}", time_it=True,
        explicit=True)
    for name, row in out.items():
        err, ms_, plain_ms, (b_ms, by), _ = row
        print(f"time {name} bf16: kernel {ms_:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {b_ms:.4f} ms ({by}) (median of 20, plain of 5, "
              f"CUDA events; {card_line()})")
    return out


def xlarge_kd_phase():
    """Phase 27e: the bf16 KD step at XLarge's widths through
    make_distil_train_step: the teacher profile_forward.model_config(
    'xlarge') at phase 19's XL_LAYERS of its 24 layers (d1024, 8 heads),
    its student make_student_config of it (d512, 4 heads), flowkd_large's
    losses with FM-KT at C = 512, teacher 1024, H = 128 and XL_KD_FM_STEPS
    Euler steps; B = XL_KD_ROWS x 15 s. One warm-up step, the counters
    reset, XL_KD_STEPS steps: losses finite, every KD kernel but the
    training FFN's launched (those refuse d512, as JAX's do), the FM module
    fed (rows, T', 512) at XL_KD_FM_STEPS steps. Returns {row: launches}
    of the fm_c512_s24 rows."""
    from tpu_asr_torch.config import make_student_config
    from tpu_asr_torch.ops.cuda_ffn import ffn_refusal
    from tpu_asr_torch.profile_forward import model_config
    from tpu_asr_torch.profile_train import distill_config

    tcfg = with_encoder(model_config("xlarge"), n_layers=XL_LAYERS)
    scfg = make_student_config(tcfg)
    d = distill_config("flowkd_large")
    distill = dataclasses.replace(d, flow=dataclasses.replace(
        d.flow, student_dim=scfg.encoder.d_model,
        teacher_dim=tcfg.encoder.d_model,
        student_head_num=scfg.encoder.n_heads,
        training_sampling=XL_KD_FM_STEPS, inference_sampling=XL_KD_FM_STEPS))
    model = kd_model(scfg, tcfg, XL_KD_SEED, distill)
    seen = []
    hook = model.flow_matching.register_forward_pre_hook(
        lambda m, args: seen.append(tuple(args[0].shape)))
    ms, counts, metrics, (dev, names) = timed_steps(
        model, train_batch(XL_KD_ROWS, XL_KD_SEED + 1), XL_KD_SEED + 2,
        XL_KD_STEPS, 1, device=True)
    hook.remove()
    shape = (XL_KD_ROWS * XL_LAYERS, seen[0][1], 512)
    check(seen[-XL_KD_STEPS:] == [shape] * XL_KD_STEPS
          and model.flow_matching.cfg.training_sampling == XL_KD_FM_STEPS,
          f"27e: the FM module fed {seen[-1]} at "
          f"{model.flow_matching.cfg.training_sampling} steps in each step")
    losses = torch.stack([m["loss/total"] for m in metrics])
    check(bool(torch.isfinite(losses).all()),
          f"27e: losses finite ({losses.tolist()})")
    # the training FFN kernels refuse d512 as JAX's ffn_train_kernel_fits
    # does (ROADMAP, Queue 2): that sublayer runs its plain version here
    enc = scfg.encoder
    why = ffn_refusal(torch.bfloat16, enc.d_model, enc.d_ff, True)
    check(why is not None and counts["ffn"] == counts["ffn_bwd"] == 0,
          f"27e: the student's FFN (d{enc.d_model}, d_ff {enc.d_ff}) on its "
          f"plain version: {why}")
    launched = {k: counts[k] for k in KD if not k.startswith("ffn")}
    check(all(v > 0 for v in launched.values()),
          f"27e: the XLarge KD steps launched every other KD kernel: "
          f"{launched}")
    print(f"kd train: XLarge widths (bfloat16, student {XL_LAYERS} x d"
          f"{scfg.encoder.d_model}, teacher {XL_LAYERS} x d"
          f"{tcfg.encoder.d_model}, FM C=512 at {XL_KD_FM_STEPS} steps) "
          f"B={XL_KD_ROWS} x {SECONDS} s: "
          f"{timed_summary(ms, XL_KD_STEPS, 1, XL_KD_ROWS)} ({card_line()})")
    fm = {k: v for k, v in names.items() if "fm_" in k}
    print(f"kd train: XLarge widths, device {dev:.3f} ms of one more step "
          f"(torch.profiler), the FM kernels {sum(fm.values()):.3f} ms of "
          f"it ({top_kernels(fm, 4)} ms)")
    return {"fm_c512_s24": counts["fm"], "fm_c512_s24_bwd": counts["fm_bwd"]}


def flowkd_large_cfgs(layer_norm: bool = False):
    """(student, teacher, DistillationConfig) of profile_train's
    flowkd_large in fp32; `layer_norm`: the student's conv module in
    layer_norm (pipelined training refuses BatchNorm)."""
    from tpu_asr_torch.config import make_student_config
    from tpu_asr_torch.profile_train import distill_config, teacher_config
    f32 = lambda cfg: dataclasses.replace(cfg, compute_dtype="float32")
    tcfg = f32(teacher_config("flowkd_large"))
    scfg = make_student_config(tcfg)
    if layer_norm:
        scfg = with_encoder(scfg, conv_norm_type="layer_norm")
    return scfg, tcfg, distill_config("flowkd_large")


# 27c/d: the gradient rules, a share of each tensor's scale: the fp32 rule
# of tests/test_torch_train.py, and the TP step's on the kernels (see
# parallel_large_rank)
FP32_GRAD_RULE, TP_KERNELS_GRAD_RULE = 1e-4, 2e-3


def parallel_large_rank(kind: str, batch_host, ref_path: str):
    """On each of 2 ranks sharing the card: the fp32 flowkd_large step
    (student conv in layer_norm) from LARGE_KD_SEED's weights, pipelined
    (kind 'pp': pp 2, n_micro 2) or tensor-parallel ('tp': tp 2), one
    forward and backward with step_rngs(LARGE_KD_SEED, 0), on the kernels
    and then on the plain versions; each run's gradients (the rank's
    slices and stage) against the one-rank step's of the same backend at
    `ref_path` (written by the parent meanwhile). A gradient passes within
    1e-5 + r x its tensor's scale (max|ref|, at least 1e-4 of the largest,
    as grads_close takes it), r the fp32 rule FP32_GRAD_RULE, but for the
    TP step on the kernels TP_KERNELS_GRAD_RULE. Readings on an H100
    behind it: the pipelined ranks on either backend, and the TP ranks on
    the plain versions, stay within 1.6e-5 of the one-rank step; the TP
    ranks on the kernels reach 9.0e-4, in the attention's positional
    gradients (linear_pos.weight, pos_bias_v), which the attention backward
    kernel sums in an order that depends on the heads a launch holds; the
    one-rank step's own kernels-vs-plain difference is largest in the same
    tensors, 1.4e-3. A planted fault (the dropout streams of a rank's
    heads taken from head 0, on the CPU with tests/ddp_cases.py's model)
    moves gradients by 0.58 of their scale. Returns (losses on the kernels,
    launches, local heads of the student's and the teacher's attention,
    {backend: (r, [(name, err / scale)] beyond it, the 3 largest (name,
    err / scale))})."""
    from tpu_asr_torch.parallel import mesh, pipeline, sharding
    from tpu_asr_torch.profile_forward import set_backend
    from tpu_asr_torch.train.trainer import step_rngs

    full_fp32()          # as the parent: cuDNN's convolutions without TF32
    scfg, tcfg, distill = flowkd_large_cfgs(layer_norm=True)
    model = kd_model(scfg, tcfg, LARGE_KD_SEED, distill).train()
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_host.items()}
    args = (batch["signal"], batch["signal_len"], batch["tokens"],
            batch["token_len"])
    if kind == "pp":
        pipeline.apply_pp_sharding(model, mesh.make_pp_mesh(1, 2, 1))
    else:
        sharding.shard_module(model, mesh.make_mesh(1, 2))
    ref = None
    import os
    readings = {}
    for backend in ("kernels", "plain"):
        set_backend(model, "auto" if backend == "kernels" else "xla")
        model.zero_grad(set_to_none=True)
        rngs = step_rngs(LARGE_KD_SEED, 0, "cuda")
        read = reset_counters()
        if kind == "pp":
            out = pipeline.distil_forward_pipelined(model, *args, n_micro=2,
                                                    rngs=rngs)
        else:
            out = model(*args, train=True, rngs=rngs)
        out.losses["total"].backward()
        torch.cuda.synchronize()
        if backend == "kernels":
            counts = read()
            losses = {k: v.item() for k, v in out.losses.items()}
        while ref is None:
            if os.path.exists(ref_path):
                ref = torch.load(ref_path, weights_only=True)
            else:
                time.sleep(0.2)
        rule = (TP_KERNELS_GRAD_RULE if (kind, backend) == ("tp", "kernels")
                else FP32_GRAD_RULE)
        bad, errs = [], []
        for name, p in model.named_parameters():
            if p.grad is None:
                continue
            w = ref["grads"][backend][sharding.global_key(model, name)]
            dim = getattr(p, "tp_dim", None)
            if dim is not None:
                k = w.shape[dim] // mesh.axis_size("model")
                w_part = w.narrow(dim, mesh.axis_index("model") * k, k)
            else:
                w_part = w
            scale = max(w.abs().max().item(), ref["floor"])
            err = (p.grad.float().cpu() - w_part).abs().max().item()
            errs.append((name, err / scale))
            if err > 1e-5 + rule * scale:
                bad.append((name, err / scale))
        readings[backend] = (rule, bad,
                             sorted(errs, key=lambda e: -e[1])[:3])
    heads = {who: sorted({m.local_heads() for m in getattr(
        model, who).modules() if hasattr(m, "local_heads")})
        for who in ("student", "teacher")}
    return losses, counts, heads, readings


def parallel_large_phase():
    """Phase 27c/d (see the module docstring): the ranks start first, each
    launch on 2 gloo ranks sharing cuda:0, while the one-rank step runs
    here and writes its gradients for them."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from tpu_asr_torch.parallel import launch
    from tpu_asr_torch.train.trainer import step_rngs

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_pp_tp_"))
    ref_path = root / "grads.pt"
    batch = train_batch(LARGE_KD_ROWS, LARGE_KD_SEED + 1)
    host = {k: v.cpu().numpy() for k, v in batch.items()}
    try:
        with ThreadPoolExecutor(2) as pool:
            runs = {kind: pool.submit(
                launch.launch, parallel_large_rank, (kind, host,
                                                     str(ref_path)),
                ["cuda:0", "cuda:0"], timeout=600, coll_timeout=300)
                for kind in ("pp", "tp")}
            from tpu_asr_torch.profile_forward import set_backend
            scfg, tcfg, distill = flowkd_large_cfgs(layer_norm=True)
            model = kd_model(scfg, tcfg, LARGE_KD_SEED, distill).train()
            grads = {}
            for backend in ("auto", "xla"):
                set_backend(model, backend)
                model.zero_grad(set_to_none=True)
                read = reset_counters()
                out = model(batch["signal"], batch["signal_len"],
                            batch["tokens"], batch["token_len"], train=True,
                            rngs=step_rngs(LARGE_KD_SEED, 0, "cuda"))
                out.losses["total"].backward()
                torch.cuda.synchronize()
                if backend == "auto":
                    one_counts = read()
                    want = {k: v.item() for k, v in out.losses.items()}
                grads["kernels" if backend == "auto" else "plain"] = {
                    n: p.grad.detach().float().cpu()
                    for n, p in model.named_parameters()
                    if p.grad is not None}
            # each tensor's scale as grads_close takes it: max|ref|, at
            # least 1e-4 of the largest (gradients zero in exact arithmetic
            # hold only rounding noise)
            floor = 1e-4 * max(g.abs().max().item()
                               for g in grads["kernels"].values())
            noise = sorted(((n, (grads["kernels"][n] - grads["plain"][n])
                             .abs().max().item()
                             / max(g.abs().max().item(), floor))
                            for n, g in grads["kernels"].items()),
                           key=lambda e: -e[1])[:3]
            print("27: the one-rank fp32 flowkd_large step's gradients, "
                  "kernels vs plain, largest differences (of the tensor's "
                  "scale): " + ", ".join(f"{n} {e:.3e}" for n, e in noise))
            torch.save({"grads": grads, "floor": floor},
                       str(ref_path) + ".tmp")
            Path(str(ref_path) + ".tmp").rename(ref_path)
            del model, out
            torch.cuda.empty_cache()      # the ranks share the card
            got = {kind: f.result() for kind, f in runs.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(all(one_counts[k] > 0 for k in KD),
          f"27: the one-rank fp32 flowkd_large step launched every KD "
          f"kernel: { {k: one_counts[k] for k in KD} }")
    for kind, label in (("pp", "27c pipelined (pp 2, n_micro 2)"),
                        ("tp", "27d tensor-parallel (tp 2)")):
        for r, (losses, counts, heads, readings) in enumerate(got[kind]):
            for k, v in want.items():
                check(abs(losses[k] - v) <= 1e-5 * abs(v),
                      f"{label} rank {r}: loss/{k} {losses[k]:.6f} vs one "
                      f"rank {v:.6f} (1e-5 rel)")
            for backend, (rule, bad, top) in readings.items():
                check(not bad, f"{label} rank {r} on the {backend}: every "
                      f"gradient within 1e-5 + {rule:g} x its "
                      f"tensor's scale of the one-rank step's on the "
                      f"{backend}; largest (of the scale) " + ", ".join(
                          f"{n} {e:.3e}" for n, e in top)
                      + (f"; beyond: {bad[:3]}" if bad else ""))
            launched = {k: counts[k] for k in KD}
            check(all(v > 0 for v in launched.values()),
                  f"{label} rank {r}: every KD kernel launched: {launched}")
            if kind == "tp":
                check(heads == {"student": [(2, 2 * r)],
                                "teacher": [(4, 4 * r)]},
                      f"{label} rank {r}: the attention kernels ran "
                      f"(heads, first head) {heads} of the student's 4 and "
                      f"the teacher's 8")


def timed_phase(label: str, fn, *args):
    """fn(*args), then the phase's seconds on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    begin = time.perf_counter()
    card()
    from tpu_asr_torch.config import ModelConfig
    from tpu_asr_torch.ops import _kernels
    from tpu_asr_torch.profile_train import teacher_config

    start = time.perf_counter()
    lib = _kernels.build()
    _kernels.library()
    print(f"build: {time.perf_counter() - start:.1f} s -> {lib}")

    cfg = ModelConfig()
    measured = {k: v[KERNELS[k][2]]
                for k, v in timed_phase("3", kernel_phase, cfg).items()}
    timed_phase("4", model_phase, cfg)
    counts, rtfx = timed_phase("5", serve_phase, cfg)
    measured.update(timed_phase("6", train_kernel_phase, cfg))
    counts.update({k: v for k, v in timed_phase("7", train_phase, cfg).items()
                   if k not in SERVING})
    measured.update(timed_phase("8", fm_kernel_phase))
    kd_counts, _ = timed_phase("9", kd_train_phase, cfg)
    counts.update({k: kd_counts[k] for k in ("fm", "fm_bwd")})
    int8_cfg = with_encoder(cfg, quantization="int8", conv_backend="pallas")
    measured.update(timed_phase("10", eval_kernel_phase, cfg))
    timed_phase("11", int8_model_phase, int8_cfg)
    int8_counts, int8_rtfx = timed_phase("12", serve_phase, int8_cfg,
                                         INT8_SERVING)
    print(f"serve RTFx: int8 + conv kernel {int8_rtfx:.1f}, fp (phase 5) "
          f"{rtfx:.1f}, same run")
    counts.update({k: int8_counts[k] for k in ("ffn_int8", "conv_module")})
    timed_phase("13", kd_train_phase,
                teacher_config("flowkd_mlp8_int8_teacher"),
                "flowkd_mlp8_int8_teacher")
    read = reset_counters()
    measured.update(timed_phase("14", layer_kernel_phase, cfg))
    counts["conformer_layer"] = read()["conformer_layer"]
    read = reset_counters()
    measured.update(timed_phase("15", heads_kernel_phase, cfg))
    counts.update({k: n for k, n in read().items()
                   if k in ("attention_heads", "attention_heads_bwd")})
    new = {k: counts[k] for k in ("conformer_layer", "attention_heads",
                                  "attention_heads_bwd")}
    check(all(v > 0 for v in new.values()),
          f"phases 14 and 15 launched their kernels: {new}")
    timed_phase("16", packed_model_phase, cfg)
    packed_counts, packed_rtfx = timed_phase(
        "16 serve", serve_phase, cfg, SERVING + ("attention_seg",), True)
    print(f"serve RTFx: packed (phase 16) {packed_rtfx:.1f}, bucketed "
          f"(phase 5) {rtfx:.1f}, same run")
    counts["attention_seg"] = packed_counts["attention_seg"]
    timed_phase("16 device", encoder_device_times, cfg)
    seg_rows, seg_counts = timed_phase("17", packed_train_phase, cfg)
    measured.update(seg_rows)
    counts.update(seg_counts)
    large_rtfx, large_int8_rtfx = timed_phase("18", large_phase)
    xl_rows, xl_counts, xl_rtfx = timed_phase("19", xlarge_phase)
    measured.update(xl_rows)
    counts.update(xl_counts)
    fc_rows, fc_counts, fc_rtfx = timed_phase("20", fastconformer_phase)
    measured.update(fc_rows)
    counts.update(fc_counts)
    timed_phase("21", kd_rest_phase, cfg)
    timed_phase("22", cli_phase)
    timed_phase("23", serving_surface_phase, cfg)
    timed_phase("24", ddp_phase)
    timed_phase("25", cache_phase)
    timed_phase("26a", int8_streaming_phase, cfg)
    _, model, tok = timed_phase("26b", export_phase, cfg, rtfx)
    timed_phase("26c", codec_native_phase, model, tok)
    del model
    measured.update(timed_phase("27a", fm_wide_phase))
    large_counts, _ = timed_phase(
        "27b", kd_train_phase, teacher_config("flowkd_large"),
        "flowkd_large", LARGE_KD_STEPS, LARGE_KD_ROWS, LARGE_KD_ROWS)
    # the wide kernels' rows: the FM wrappers' launches in the timed steps
    # of the path that runs each shape (every FM launch there runs them)
    counts["fm_c256"] = large_counts["fm"]
    counts["fm_c256_bwd"] = large_counts["fm_bwd"]
    timed_phase("27cd", parallel_large_phase)
    counts.update(timed_phase("27e", xlarge_kd_phase))
    print(f"serve RTFx (bf16, 64 requests x {SERVE_BATCH} clips, same run): "
          f"ModelConfig() {rtfx:.1f}, conformer-LARGE {large_rtfx:.1f} (int8 "
          f"+ conv kernel {large_int8_rtfx:.1f}), conformer-XLarge "
          f"{xl_rtfx:.1f}; fastconformer_local long-form ({LONG_REQUESTS} "
          f"requests x {LONG_CLIPS} clips of 5-10 min) {fc_rtfx:.1f}")
    rows = []
    for name, (source, replaces, dt) in KERNELS.items():
        err, ms, plain_ms, (bound_ms, bound_by), library_ms = measured[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms})
    print(f"chip_smoke: {time.perf_counter() - begin:.1f} s, the build "
          f"included ({card_line()})")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
