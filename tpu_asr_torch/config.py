"""Configuration tree of tpu_asr_torch: the port's own copy of the JAX
package's tpu_asr/config.py, with the same dataclass names, fields and
defaults (tests/test_torch_contract.py holds them equal), so a config
written for one package reads the same in the other.

Some field comments describe the TPU package's backends ('pallas', VMEM,
prng_impl); the port reads 'pallas' and 'auto' as its CUDA kernels and
raises for options outside its slice (models/conformer.check_supported).

Defaults reproduce the `stt_en_conformer_ctc_small` teacher configuration
(conformer_ctc_bpe.yaml:7-18 size table; preprocessor defaults :96-111).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple


def _asdict(obj):
    return dataclasses.asdict(obj)


@dataclass
class PreprocessorConfig:
    """AudioToMelSpectrogramPreprocessor equivalent (conformer_ctc_bpe.yaml:96-111)."""

    sample_rate: int = 16000
    window_size: float = 0.025       # 25 ms  -> win_length 400
    window_stride: float = 0.01      # 10 ms  -> hop 160
    window: str = "hann"
    features: int = 80               # n_mels
    n_fft: int = 512
    log: bool = True
    frame_splicing: int = 1
    dither: float = 1.0e-5
    pad_to: int = 0
    pad_value: float = 0.0
    normalize: str = "per_feature"
    preemph: float = 0.97
    mag_power: float = 2.0
    log_zero_guard_value: float = 2.0 ** -24
    lowfreq: float = 0.0
    highfreq: Optional[float] = None  # defaults to sample_rate / 2

    @property
    def win_length(self) -> int:
        return int(self.window_size * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.window_stride * self.sample_rate)


@dataclass
class SpecAugmentConfig:
    """SpectrogramAugmentation equivalent (conformer_ctc_bpe.yaml:112-118)."""

    freq_masks: int = 2
    time_masks: int = 10
    freq_width: int = 27
    time_width: float = 0.05   # adaptive: fraction of sequence length
    mask_value: float = 0.0


@dataclass
class EncoderConfig:
    """ConformerEncoder equivalent (conformer_ctc_bpe.yaml:120-166).

    Defaults are the *small* (13M) variant used as the reference teacher
    (d_model 176, 16 layers, 4 heads — yaml size table :7-18).
    """

    feat_in: int = 80
    # optional output projection dim (NeMo ConformerEncoder feat_out);
    # -1 / d_model -> no projection
    feat_out: int = -1
    n_layers: int = 16
    d_model: int = 176
    n_heads: int = 4
    ff_expansion_factor: int = 4
    subsampling: str = "striding"
    subsampling_factor: int = 4
    subsampling_conv_channels: int = -1   # -1 -> d_model
    # 'xla' | 'pallas' | 'auto': fused whole-pre-encode Pallas kernel
    # (ops/pallas_subsampling.py; 1.53 vs 2.38 ms measured on v5e at
    # B=32 x 15 s). 'auto' -> pallas on TPU for striding x4 / 80 mels /
    # symmetric padding; XLA otherwise (and for the custom-VJP backward).
    subsampling_backend: str = "auto"
    self_attention_model: str = "rel_pos"
    att_context_size: Tuple[int, int] = (-1, -1)
    # 'regular' (sliding-window limited context) | 'chunked_limited' (aligned
    # chunks; right context = chunk lookahead) — NeMo conformer_encoder.py
    # att_context_style (mask construction :800-825)
    att_context_style: str = "regular"
    # streaming (cache-aware) options — NeMo conformer_encoder.py:523-546
    causal_downsampling: bool = False
    # None -> symmetric (k-1)//2 each side; 'causal' -> (k-1, 0); or (left, right)
    conv_context_size: Optional[Any] = None
    # longformer-style global attention (conformer_encoder.py:456-458)
    global_tokens: int = 0
    global_tokens_spacing: int = 1
    global_attn_separate: bool = False
    # mid-stack time reduction (conformer_encoder.py:395-404, applied :712-724):
    # None disables; 'pooling' (avg) or 'striding' (conv), applied after layer
    # `reduction_position` (-1 = after the last layer)
    reduction: Optional[str] = None
    reduction_factor: int = 1
    reduction_position: int = -1
    xscaling: bool = True
    untie_biases: bool = True
    pos_emb_max_len: int = 5000
    conv_kernel_size: int = 31
    conv_norm_type: str = "batch_norm"    # batch_norm | layer_norm
    dropout: float = 0.1
    dropout_pre_encoder: float = 0.1
    dropout_emb: float = 0.0
    dropout_att: float = 0.1
    stochastic_depth_drop_prob: float = 0.0
    stochastic_depth_mode: str = "linear"
    stochastic_depth_start_layer: int = 1
    # 'xla' | 'pallas' | 'auto' (pallas for deterministic passes on TPU)
    attention_backend: str = "auto"
    # conv-module backend: 'auto' fuses the whole module into one Pallas
    # kernel for deterministic (inference) passes on TPU (ops/pallas_conv.py)
    conv_backend: str = "auto"
    # FFN-sublayer backend: 'pallas' fuses LN + linear1 + SiLU + linear2 +
    # the 0.5 residual into one kernel for deterministic passes
    # (ops/pallas_ffn.py); 'auto' currently resolves to 'xla' pending a
    # measured win (the measured-not-assumed contract)
    ffn_backend: str = "auto"
    # post-training int8 serving: 'none' | 'int8'. 'int8' routes the FFN
    # sublayers of DETERMINISTIC (eval) passes through the MXU's int8 path
    # (per-channel weights, dynamic per-token activations, int32
    # accumulation — ops/quant.py): one fused Pallas kernel per sublayer on
    # TPU (ops/pallas_ffn.py::fused_ffn_sublayer_int8 — the quant chain
    # must stay in VMEM or its HBM traffic eats the 2x MXU rate; measured
    # notes there), the XLA int8_dense path elsewhere. Training, streaming,
    # attention, and the conv module are unaffected (conv: measured net
    # loss, see ConformerConvolution).
    quantization: str = "none"
    # rematerialize each conformer layer in the backward pass
    # (jax.checkpoint). On TPU this model is HBM-bandwidth-bound, so
    # recomputing the layer is FASTER than stashing+reloading activations
    # (measured v5e-1, B=32 x 15 s student: fwd+bwd 33.8 -> 27.1 ms; full
    # remat also beat the dots_saveable policies) — AND it gives O(1)
    # activation memory per layer. Default on; eval paths are unaffected
    # (checkpoint is a no-op without a backward).
    remat: bool = True

    @property
    def conv_channels(self) -> int:
        return self.d_model if self.subsampling_conv_channels == -1 else self.subsampling_conv_channels

    @property
    def conv_context(self) -> Tuple[int, int]:
        """(left, right) time context of the depthwise conv kernel."""
        k = self.conv_kernel_size
        if self.conv_context_size is None:
            return ((k - 1) // 2, (k - 1) // 2)
        if self.conv_context_size == "causal":
            return (k - 1, 0)
        l, r = self.conv_context_size
        if l + r + 1 != k:
            raise ValueError(f"conv_context_size {self.conv_context_size} != kernel {k}")
        return (int(l), int(r))

    @property
    def d_ff(self) -> int:
        return self.d_model * self.ff_expansion_factor


@dataclass
class DecoderConfig:
    """ConvASRDecoder equivalent (reference NeMo conv_asr.py:407-507): 1x1 conv + log_softmax."""

    feat_in: int = 176
    num_classes: int = 128       # vocab size (blank appended as last index)
    temperature: float = 1.0


@dataclass
class ModelConfig:
    sample_rate: int = 16000
    ctc_reduction: str = "mean_batch"
    skip_nan_grad: bool = False
    preprocessor: PreprocessorConfig = field(default_factory=PreprocessorConfig)
    spec_augment: Optional[SpecAugmentConfig] = field(default_factory=SpecAugmentConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    # numerics
    compute_dtype: str = "bfloat16"   # dtype for matmul-heavy compute; params stay fp32
    param_dtype: str = "float32"

    def to_dict(self):
        return _asdict(self)


def make_student_config(teacher: ModelConfig) -> ModelConfig:
    """Clone the teacher config and halve encoder.d_model / n_heads / decoder.feat_in.

    Mirrors the reference make_student_config (asr_train.py:178-206).
    """
    student = dataclasses.replace(
        teacher,
        encoder=dataclasses.replace(
            teacher.encoder,
            d_model=teacher.encoder.d_model // 2,
            n_heads=teacher.encoder.n_heads // 2,
        ),
        decoder=dataclasses.replace(
            teacher.decoder,
            feat_in=teacher.decoder.feat_in // 2,
        ),
    )
    return student


# ---------------------------------------------------------------------------
# Knowledge-distillation configs
# ---------------------------------------------------------------------------

@dataclass
class FlowMatchingConfig:
    """FlowMatchingModule config (reference asr_train.py:1220-1316 `flow_cfg`)."""

    meta_encoder_type: str = "mlp"     # mlp | cnn | swin | conformer | unet
    time_embed_dim: int = 32
    hidden_dim: int = 128
    training_sampling: int = 8
    inference_sampling: int = 8
    weight: float = 1.0
    student_dim: int = 88
    teacher_dim: int = 176
    student_head_num: int = 2
    teacher_head_num: int = 4
    shape_transform: str = "linear"    # identity | linear | conv1d
    loss: str = "mse"                  # mse | cosine
    # Euler-loop backend: 'xla' = masked nn.scan, 'pallas' = fused
    # VMEM-resident multi-step kernel (ops/pallas_fm.py, mlp meta encoder
    # only), 'auto' = pallas when eligible on TPU
    euler_backend: str = "auto"
    noise_schedule: str = "rectified"  # rectified | vp_ode | ve_ode
    # per-layer fixed step counts (len == n_layers) or None
    sampling_steps_per_layer: Optional[Tuple[int, ...]] = None
    # dynamic router
    use_dynamic_steps: bool = False
    router_strategy: str = "batch_mode"   # batch_mode | batch_avg | batch_median | group
    router_weight: float = 1.0
    router_max_sampling_steps: int = 16
    router_temperature: float = 1.0


@dataclass
class RouterConfig:
    """DynamicStepRouter config (reference asr_train.py:1021-1118)."""

    max_steps: int = 16
    min_steps: int = 1
    stu_dim: int = 88
    tch_dim: int = 176
    hidden_dim: int = 128
    proj_dim: int = 128
    use_layer_id: bool = True
    num_layers: int = 16
    layer_emb_dim: int = 32
    feature_reduce: str = "gap"
    temperature: float = 1.0
    budget_target: Optional[float] = 8.0
    budget_weight: float = 0.05
    entropy_weight: float = 0.001


@dataclass
class DiffKDConfig:
    """DiffKDModule config (reference asr_train.py:244-312 `diffkd_cfg`)."""

    steps: int = 5
    teacher_dim: int = 176
    student_dim: int = 88
    latent_dim: Optional[int] = None   # None -> min(teacher_dim, student_dim)

    @property
    def latent(self) -> int:
        return self.latent_dim if self.latent_dim is not None else min(self.teacher_dim, self.student_dim)


@dataclass
class DiffmConfig:
    """Latent AE+FM/diffusion pipeline config (reference asr_train_diffm.py:400-839)."""

    model_version: int = 1             # ver1..ver8
    latent_dim: int = 64
    student_dim: int = 88
    teacher_dim: int = 176
    fm: FlowMatchingConfig = field(default_factory=FlowMatchingConfig)


@dataclass
class DistillationConfig:
    """Loss-assembly config for the distil training step (asr_train.py:469-788)."""

    use_ctc: bool = True
    use_logit_distillation: bool = False
    kd_alpha: float = 0.1
    kd_temperature: float = 1.0
    use_layerwise_distillation: bool = False
    layer_kd_alpha: float = 1.0
    # 'all': per-layer MSE averaged over layers (DistilFlowMatchingCTCModelBPE,
    # asr_train.py:736-748); 'last': final-encoder-output MSE only
    # (DistilEncDecCTCModelBPE, asr_train.py:418-454 — the lastfeaturekd runs)
    layer_kd_scope: str = "all"
    # reference quirk (asr_train_diffm.py:767): the diffm trainer's layerwise
    # path draws a FRESH random, never-trained Linear projection on every call.
    diffm_fresh_layer_proj: bool = False
    use_flow_matching: bool = False
    flow: Optional[FlowMatchingConfig] = None
    router: Optional[RouterConfig] = None
    use_diffkd: bool = False
    diffkd: Optional[DiffKDConfig] = None
    use_diffm: bool = False
    diffm: Optional[DiffmConfig] = None
    # intermediate CTC (NeMo interCTC capture, conformer_encoder.py:726-738):
    # aux CTC losses on the listed student layers (same decoder), combined as
    # (1 - w) * main + (w / n_layers) * sum(aux)
    interctc_layers: Tuple[int, ...] = ()
    interctc_weight: float = 0.3


@dataclass
class OptimConfig:
    """Optimizer/scheduler (conformer_ctc_bpe.yaml:176-193)."""

    name: str = "adamw"
    lr: float = 2.0                    # Noam-normalized peak
    betas: Tuple[float, float] = (0.9, 0.98)
    weight_decay: float = 1.0e-3
    sched_name: str = "NoamAnnealing"
    d_model: int = 176
    warmup_steps: int = 10000
    min_lr: float = 1.0e-6
    max_steps: int = 100000
    gradient_clip_val: float = 0.0


@dataclass
class DataConfig:
    manifest_filepath: Optional[str] = None
    sample_rate: int = 16000
    batch_size: int = 32
    shuffle: bool = True
    max_duration: float = 16.7
    min_duration: float = 0.1
    num_buckets: int = 8
    # NeMo bucketing_batch_size (ctc_bpe_models.py:98-215 loader factory):
    # per-bucket batch sizes, one per bucket (list) or one int auto-scaled
    # inversely with the bucket's duration cap (shorter utterances -> bigger
    # batches, ~constant audio-seconds per batch). None = flat batch_size.
    bucketing_batch_size: Optional[Any] = None
    seed: int = 42
    # decoded-audio disk cache dir (data/dataset.py): repeated passes skip
    # the host mp3/flac/wav decode — the 1-core eval mitigation
    decode_cache_dir: Optional[str] = None


@dataclass
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    distillation: DistillationConfig = field(default_factory=DistillationConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train_ds: DataConfig = field(default_factory=DataConfig)
    validation_ds: DataConfig = field(default_factory=lambda: DataConfig(shuffle=False))
    test_ds: DataConfig = field(default_factory=lambda: DataConfig(shuffle=False))
    max_epochs: int = 100
    seed: int = 42
    # PRNG for training randomness (dropout/specaug/gumbel): 'rbg' is ~1.4x
    # faster per train step on TPU than 'threefry2x32' (hardware RNG; measured
    # 66.6 -> 47.5 ms/step on v5e) with adequate quality for dropout masks
    prng_impl: str = "rbg"
    # >1: run K optimizer steps per device dispatch (lax.scan over stacked
    # same-bucket batches; train/trainer.make_distil_multi_step) — amortizes
    # the host dispatch floor. max_steps granularity becomes K.
    steps_per_dispatch: int = 1
    # Teacher-feature cache: the frozen teacher consumes the UNAUGMENTED
    # signal in eval mode (asr_train.py:591-592), so its last-layer features
    # are deterministic per utterance. With this on, epoch 0 harvests them
    # (host RAM, fp16 under bf16 compute — a lossless widening) and later
    # epochs skip the whole teacher forward with identical loss semantics.
    # Only valid for logit KD / last-scope layerwise KD (the other KD modes
    # need all 16 teacher layers); ~150 KB x utterances of host RAM.
    cache_teacher: bool = False
    # ALL-layer teacher cache: harvest the full (L, T', Dt) per-layer teacher
    # feature stack per utterance instead of only the last layer — the same
    # determinism argument covers EVERY KD mode (FM, DiffKD, diffm,
    # full-layerwise). Cost: ~2.2 MB/utt fp16 at flagship dims (d176 x 16L x
    # T'=376) — set cache_teacher_dir to spill to disk (mmap reads) instead
    # of host RAM, and mind the host->device feed: the assembled
    # (B, L, T', Dt) tensor is ~70 MB/step at batch 32, so this pays only
    # where host->device bandwidth beats re-running the teacher (~11 ms of
    # TPU compute at flagship). Measured numbers in ROADMAP round-5.
    cache_teacher_all: bool = False
    cache_teacher_dir: Optional[str] = None
    # fault tolerance / observability (reference exp_manager optional
    # callbacks — straggler detection, FaultToleranceCallback simulated
    # faults, section heartbeats; utils/exp_manager.py):
    # every N steps log per-rank step-time means + straggler flags (0 off)
    straggler_report_every: int = 0
    # every N steps write this process's heartbeat file (0 off)
    heartbeat_every: int = 0
    # "rank_killed:<rank>:<step>" | "rank_hung:<rank>:<step>" (tests only)
    simulated_fault: Optional[str] = None
    # parallelism
    dp_size: int = -1      # -1: all devices on the data axis
    tp_size: int = 1
