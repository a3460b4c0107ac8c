"""DistilCTCModel: the PyTorch counterpart of
tpu_asr/models/distil_model.py: CTC, logit KD, layerwise KD, interCTC,
flow-matching KD (FM-KT) over all layers with fixed, per-layer or routed
step counts, DiffKD and the diffm latent pipeline.

- The frozen teacher `CTCModel(teacher_cfg)` is built when a KD loss needs
  it. It runs in eval mode under `torch.no_grad()` with its parameters
  `requires_grad_(False)` (JAX's stop-gradient at the teacher parameters):
  no gradient, no saved activations, no BatchNorm update, no dropout, and
  it reads the unaugmented signal (no dither, no SpecAugment). `train()`
  leaves it in eval mode. A teacher config with `quantization='int8'`
  (bench_train.py's flowkd_mlp8_int8_teacher) runs its FFN sublayers
  through the int8 serving path, which has no gradient and needs none
  here; the student trains in fp whatever its config says. In eval the
  teacher runs only for the dynamic step router's input.
- Flow matching (`_flow_matching_all_layers`): step counts per (layer,
  sample) from the router (`flow.use_dynamic_steps`: 'group' keeps them
  per sample with the group loss, 'batch_mode' / 'batch_avg' /
  'batch_median' aggregate each layer's counts, all at max_steps =
  `router_max_sampling_steps`), from `sampling_steps_per_layer` (at
  max_steps = its largest) or `training_sampling` (in eval too, as the
  JAX model passes it). With the `mlp` meta encoder the student and
  teacher layer features are stacked B-major (row = b * L + l) and one
  FlowMatchingModule call runs over (B * L, T', D_s) with `loss_layers=L`
  (the fused Euler kernel for CUDA tensors); any other meta encoder runs
  once per layer, as JAX's nn.vmap route does, since the conformer meta
  encoder's batch-statistics norm must see one layer's frames. The last
  layer's FM output replaces the decoder input in training and eval.
- Layerwise KD: scope 'last' (the final layer through the shared
  `layer_proj`) or 'all' (every layer through it, or, with
  `diffm_fresh_layer_proj`, through a fresh Linear per layer drawn from
  the `noise` generator, U(-1/sqrt(d_s), 1/sqrt(d_s)), never trained).
- interCTC: the student's decoder on each listed layer, CTC against the
  same targets, (1 - w) main + (w / n) sum of them; each in
  `metrics['interctc/layer{l}']`.
- DiffKD summed over layers; diffm on the B-major stacked rows with
  `loss_layers=L` (kd/diffkd.py, kd/diffm.py).
- Losses: 'ctc' (student_cfg.ctc_reduction, zero when use_ctc is off),
  'flow_matching' (FlowMatchingConfig.weight is not applied, as in the
  reference), 'router' (router_weight x the router loss), 'logit_kd'
  (kd_alpha x logit KL against the teacher's decoder on its last layer),
  'layer_kd' (layer_kd_alpha x layerwise MSE), 'diffkd', 'diffm/<loss>'
  and 'total'. Metrics: 'router/batch_mean_sampling_steps_mean' and the
  interCTC losses.

Training randomness comes from `rngs` (train/trainer.py::step_rngs):
'specaug' and 'dropout' for the student, 'gumbel' for the router's draw,
'noise' for diffm's noise and the fresh projection, 'dropout' also for a
meta encoder's dropout seeds.

Packed-segment training (`forward_packed_train`, JAX's method of that
name): the student's and the teacher's encoders run on packed rows of
several utterances (data/packing.train_pack_arrays), the student forward
and backward through the attention kernels' segment mode; the per-layer
features are gathered back to the bucketed (B, T', D) layout, so every
loss is computed as in the unpacked step (`forward_with_student_encode`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from tpu_asr_torch.config import DistillationConfig, ModelConfig
from tpu_asr_torch.kd.diffkd import DiffKDModule
from tpu_asr_torch.kd.diffm import LatentKDPipeline
from tpu_asr_torch.kd.flow_matching import FlowMatchingModule
from tpu_asr_torch.kd.losses import layerwise_mse_loss, logit_kl_loss
from tpu_asr_torch.kd.meta_encoders import dense
from tpu_asr_torch.kd.router import (STRATEGIES, DynamicStepRouter,
                                     aggregate_steps)
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.ops.ctc import ctc_loss
from tpu_asr_torch.parallel.mesh import batch_mean, utterance_rows


class DistilOutput(NamedTuple):
    log_probs: torch.Tensor       # (B, T', V+1)
    encoded_len: torch.Tensor     # (B,)
    greedy: torch.Tensor          # (B, T')
    losses: Dict[str, torch.Tensor]
    metrics: Dict[str, torch.Tensor]
    tch_last: Optional[torch.Tensor] = None    # (B, T', Dt) when it ran
    tch_feats: Optional[torch.Tensor] = None   # (L, B, T', Dt) when it ran


def check_config(d: DistillationConfig, n_layers: int) -> None:
    """Raise for a DistillationConfig the model cannot run with a student
    of `n_layers` layers (where JAX's model asserts or fails at trace)."""
    f = d.flow
    bad = []
    if d.use_flow_matching and f is None:
        bad.append("use_flow_matching without flow")
    if d.use_flow_matching and f is not None:
        if f.use_dynamic_steps and d.router is None:
            bad.append("flow.use_dynamic_steps without router")
        if f.use_dynamic_steps and f.router_strategy not in STRATEGIES:
            bad.append(f"flow.router_strategy {f.router_strategy!r}")
        if f.sampling_steps_per_layer is not None and \
                len(f.sampling_steps_per_layer) != n_layers:
            bad.append(f"flow.sampling_steps_per_layer of "
                       f"{len(f.sampling_steps_per_layer)} layers")
    if d.use_diffkd and d.diffkd is None:
        bad.append("use_diffkd without diffkd")
    if d.use_diffm and d.diffm is None:
        bad.append("use_diffm without diffm")
    if d.use_layerwise_distillation and d.layer_kd_scope not in ("last",
                                                                "all"):
        bad.append(f"layer_kd_scope {d.layer_kd_scope!r}")
    if any(not 0 <= l < n_layers for l in d.interctc_layers):
        bad.append(f"interctc_layers {d.interctc_layers}")
    if bad:
        raise ValueError(f"DistillationConfig for a {n_layers}-layer "
                         f"student: {'; '.join(bad)}")


def last_layer_cacheable(d: DistillationConfig) -> bool:
    """Whether the teacher's last layer is all that `d`'s losses read
    (logit KD, last-scope layerwise KD): the last-layer cache serves it."""
    return not (d.use_flow_matching or d.use_diffkd or d.use_diffm
                or (d.use_layerwise_distillation
                    and d.layer_kd_scope != "last"))


def fresh_layer_proj(generator: torch.Generator, n_layers: int, d_s: int,
                     d_t: int, dtype: torch.dtype, device):
    """diffm's never-trained per-layer projection (asr_train_diffm.py:767):
    weights (L, d_s, d_t), then biases (L, 1, 1, d_t), each uniform on
    [-1/sqrt(d_s), 1/sqrt(d_s)) from `generator` (torch's default Linear
    initialisation)."""
    bound = 1.0 / d_s ** 0.5
    draw = lambda *shape: (torch.rand(shape, generator=generator,
                                      device=device) * 2 - 1) * bound
    return draw(n_layers, d_s, d_t).to(dtype), draw(n_layers, 1, 1,
                                                     d_t).to(dtype)


class DistilCTCModel(nn.Module):
    """`ctc_backend` 'auto' runs the CTC kernels (ops/cuda_ctc.py) for CUDA
    tensors, 'scan' the plain recursion."""

    def __init__(self, student_cfg: ModelConfig, teacher_cfg: ModelConfig,
                 distill: Optional[DistillationConfig] = None):
        super().__init__()
        d = self.distill = distill or DistillationConfig()
        check_config(d, student_cfg.encoder.n_layers)
        self.student_cfg, self.teacher_cfg = student_cfg, teacher_cfg
        dtype = getattr(torch, student_cfg.compute_dtype)
        self.student = CTCModel(student_cfg)
        self.ctc_backend = "auto"
        self.needs_teacher = (d.use_logit_distillation
                              or d.use_layerwise_distillation
                              or d.use_flow_matching or d.use_diffkd
                              or d.use_diffm)
        self.routed = d.use_flow_matching and d.flow.use_dynamic_steps
        if self.needs_teacher:
            self.teacher = CTCModel(teacher_cfg).requires_grad_(False).eval()
        if d.use_flow_matching:
            self.flow_matching = FlowMatchingModule(d.flow, dtype)
            if self.routed:
                self.router = DynamicStepRouter(d.router, dtype)
        if d.use_diffkd:
            self.diffkd_mod = DiffKDModule(d.diffkd, dtype)
        if d.use_diffm:
            self.diffm_pipeline = LatentKDPipeline(d.diffm, dtype=dtype)
        # built where JAX's lazily created nn.Dense gets its parameters
        if d.use_layerwise_distillation and (
                d.layer_kd_scope == "last" or not d.diffm_fresh_layer_proj):
            self.layer_proj = nn.Linear(student_cfg.encoder.d_model,
                                        teacher_cfg.encoder.d_model)

    def train(self, mode: bool = True) -> "DistilCTCModel":
        super().train(mode)
        if self.needs_teacher:
            self.teacher.eval()
        return self

    def _teacher_runs(self, train: bool) -> bool:
        return self.needs_teacher if train else self.routed

    def _layer_steps(self, stu_feats, tch_feats, train, rngs, metrics):
        """((L, B) int32 step counts, max_steps, group loss?, router loss)
        of the flow matching over all layers."""
        f = self.distill.flow
        n_layers, b = stu_feats.shape[:2]
        dev = stu_feats.device
        if self.routed:
            steps, router_loss, _ = self.router(
                stu_feats, tch_feats, torch.arange(n_layers, device=dev),
                train, rngs.get("gumbel"))
            metrics["router/batch_mean_sampling_steps_mean"] = \
                batch_mean(steps.float())
            max_steps = f.router_max_sampling_steps
            if f.router_strategy == "group":
                return steps, max_steps, True, router_loss
            per_layer = aggregate_steps(steps, f.router_strategy, max_steps)
            return (per_layer[:, None].expand(n_layers, b), max_steps, False,
                    router_loss)
        per_layer = (f.sampling_steps_per_layer
                     or (f.training_sampling,) * n_layers)
        steps = torch.tensor(per_layer, dtype=torch.int32, device=dev)
        return (steps[:, None].expand(n_layers, b), max(per_layer), False,
                None)

    def _flow_matching_all_layers(self, stu_feats: torch.Tensor,
                                  tch_feats: Optional[torch.Tensor],
                                  train: bool, rngs, metrics):
        """(flow loss, router loss or None, last layer's FM output (B, T',
        Ds)) from (L, B, T', D) student and teacher features; the router's
        metric goes into `metrics`."""
        fm = self.flow_matching
        n_layers, b = stu_feats.shape[:2]
        steps, max_steps, group, router_loss = self._layer_steps(
            stu_feats, tch_feats, train, rngs, metrics)
        if fm.cfg.meta_encoder_type == "mlp":
            stack = lambda z: z.transpose(0, 1).reshape((b * n_layers,)
                                                        + z.shape[2:])
            loss, out = fm(stack(stu_feats),
                           stack(tch_feats) if train else None,
                           steps=steps.t().reshape(-1), max_steps=max_steps,
                           train=train, group_loss=group,
                           loss_layers=n_layers)
            return loss, router_loss, out.reshape(
                (b, n_layers) + out.shape[1:])[:, -1]
        # per layer; in eval (no loss) only the last layer's output is used
        gen = rngs.get("dropout")
        loss = torch.zeros((), device=stu_feats.device)
        for l in range(n_layers) if train else (n_layers - 1,):
            loss_l, out = fm(stu_feats[l], tch_feats[l] if train else None,
                             steps=steps[l], max_steps=max_steps,
                             train=train, group_loss=group, generator=gen)
            loss = loss + loss_l
        return loss, router_loss, out

    def forward(self, input_signal: torch.Tensor,
                input_signal_length: torch.Tensor,
                transcripts: Optional[torch.Tensor] = None,
                transcript_lengths: Optional[torch.Tensor] = None,
                train: bool = False,
                rngs: Optional[Dict[str, torch.Generator]] = None,
                tch_last_feat: Optional[torch.Tensor] = None,
                tch_all_feat: Optional[torch.Tensor] = None,
                packed: Optional[Dict[str, torch.Tensor]] = None
                ) -> DistilOutput:
        """`tch_last_feat` (B, T', Dt) / `tch_all_feat` (L, B, T', Dt):
        the teacher's cached features (train/loop.TeacherFeatureCache), as
        in `forward_with_student_encode`. `packed`: the plan arrays of
        `forward_packed_train` by their batch keys (PACK_KEYS of
        train/trainer.py, and `pk_utt`, `pk_n_utt` on a rank of a split
        plan), which runs instead: one entry point, so that the packed step
        too goes through DistributedDataParallel."""
        if packed is not None:
            return self.forward_packed_train(
                input_signal, input_signal_length, transcripts,
                transcript_lengths, train=train, rngs=rngs, **packed)
        encoded, encoded_len, stu_feats = self.student.encode(
            input_signal, input_signal_length, train, rngs)
        return self.forward_with_student_encode(
            encoded, encoded_len, stu_feats, input_signal,
            input_signal_length, transcripts, transcript_lengths, train,
            tch_last_feat=tch_last_feat, tch_all_feat=tch_all_feat,
            rngs=rngs)

    def forward_packed_train(self, input_signal: torch.Tensor,
                             input_signal_length: torch.Tensor,
                             transcripts: Optional[torch.Tensor],
                             transcript_lengths: Optional[torch.Tensor],
                             pk_src_utt: torch.Tensor,
                             pk_src_pos: torch.Tensor, pk_seg: torch.Tensor,
                             pk_row: torch.Tensor, pk_start: torch.Tensor,
                             train: bool = True,
                             rngs: Optional[Dict[str, torch.Generator]] = None,
                             pk_utt: Optional[torch.Tensor] = None,
                             pk_n_utt: Optional[int] = None
                             ) -> DistilOutput:
        """The packed-segment step's forward. The plan (data/packing.py::
        train_pack_arrays, on the model's device): `pk_src_utt`,
        `pk_src_pos`, `pk_seg` (R, Tp) — for each packed frame its
        utterance, its frame there and its segment id (0 = guard/pad) — and
        `pk_row`, `pk_start` (B,), where utterance b lies. The student
        featurizes and subsamples per utterance (with dither and SpecAugment
        when training), its frames are gathered into the packed rows and
        encoded there; its encoder output and per-layer features are
        gathered back to (B, T', D) and zeroed past each length. The frozen
        teacher encodes the same plan in eval. The losses then are those of
        the unpacked step on these tensors: at dropout 0 with a layer-norm
        conv module they equal it (BatchNorm's training statistics run over
        the packed frames, guards included, as JAX's do).

        On a rank of a plan split by rows (parallel/mesh.packed_rank_block)
        the batch holds the utterances of this rank's packed rows,
        `pk_utt` (B,) their places in the global batch of `pk_n_utt`: the
        per-utterance draws and the losses are taken at those places
        (mesh.utterance_rows), the packed rows' at the rank's row block."""
        ix = lambda z: torch.as_tensor(z, device=input_signal.device).long()
        src_utt, src_pos, seg, row, start = map(
            ix, (pk_src_utt, pk_src_pos, pk_seg, pk_row, pk_start))
        rows_of = lambda: (contextlib.nullcontext() if pk_utt is None else
                           utterance_rows(torch.as_tensor(pk_utt).cpu(),
                                          int(pk_n_utt)))
        with rows_of():
            x_src, enc_len = self.student.pre_encode_aug(
                input_signal, input_signal_length, train, rngs)
        t_prime, t_pack = x_src.shape[1], seg.shape[1]
        valid_rows = (seg > 0)[..., None]
        packed = torch.where(valid_rows, x_src[src_utt, src_pos], 0)
        encoded_p, _, stu_feats_p = self.student.encode_packed(
            packed, seg, train, rngs)

        # back to the bucketed per-utterance layout
        dev = x_src.device
        frames = torch.arange(t_prime, device=dev)
        pos_c = (start[:, None] + frames[None, :]).clamp(max=t_pack - 1)
        valid = (frames[None, :] < enc_len[:, None])[..., None]
        rows = row[:, None]
        encoded = torch.where(valid, encoded_p[rows, pos_c], 0)
        stu_feats = torch.where(valid, stu_feats_p[:, rows, pos_c], 0)

        tch_all = None
        if self._teacher_runs(train):
            with torch.no_grad():
                xt_src, _ = self.teacher.pre_encode_aug(input_signal,
                                                        input_signal_length)
                packed_t = torch.where(valid_rows, xt_src[src_utt, src_pos],
                                       0)
                _, _, tch_p = self.teacher.encode_packed(packed_t, seg)
                tch_all = torch.where(valid, tch_p[:, rows, pos_c], 0)
        with rows_of():
            return self.forward_with_student_encode(
                encoded, enc_len, stu_feats, input_signal,
                input_signal_length, transcripts, transcript_lengths, train,
                tch_all_feat=tch_all, rngs=rngs)

    def forward_with_student_encode(
            self, encoded: torch.Tensor, encoded_len: torch.Tensor,
            stu_feats: torch.Tensor, input_signal: torch.Tensor,
            input_signal_length: torch.Tensor,
            transcripts: Optional[torch.Tensor] = None,
            transcript_lengths: Optional[torch.Tensor] = None,
            train: bool = False,
            tch_all_feat: Optional[torch.Tensor] = None,
            rngs: Optional[Dict[str, torch.Generator]] = None,
            tch_last_feat: Optional[torch.Tensor] = None
            ) -> DistilOutput:
        """Everything after the student's encode: the frozen teacher (or
        its precomputed per-layer features `tch_all_feat` (L, B, T', Dt),
        as the packed step gathers them and the all-layer cache holds
        them, or its last layer's `tch_last_feat` (B, T', Dt) from the
        last-layer cache), flow matching, the decoder and the losses.
        Cached features are cast to the student's dtype and detached, and
        the teacher's encoder does not run (JAX's __call__: its input is
        the unaugmented signal in eval mode, so its features are a function
        of the utterance). `tch_last_feat` serves logit KD and last-scope
        layerwise KD only; with flow matching, DiffKD, diffm or all-scope
        layerwise KD it raises, as JAX does."""
        d = self.distill
        losses: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}
        rngs = rngs or {}
        zero = torch.zeros((), device=encoded.device)
        # contiguous as the teacher's own outputs are: the decoder's product
        # on a strided view of the all-layer batch rounds otherwise in bf16
        cached = lambda z: z.detach().to(encoded.dtype).contiguous()

        tch_feats = tch_last = None
        if tch_all_feat is not None:
            tch_feats = cached(tch_all_feat)
            tch_last = tch_feats[-1]
        elif tch_last_feat is not None:
            if not last_layer_cacheable(d):
                raise ValueError(
                    "cached teacher features (tch_last_feat) support only "
                    "logit KD and last-scope layerwise KD; FM/DiffKD/diffm/"
                    "full-layerwise need all 16 teacher layers")
            tch_last = cached(tch_last_feat)
        elif self._teacher_runs(train):
            with torch.no_grad():
                _, _, tch_feats = self.teacher.encode(input_signal,
                                                      input_signal_length)
            tch_last = tch_feats[-1]

        decoder_in = encoded
        if d.use_flow_matching:
            losses["flow_matching"], router_loss, decoder_in = \
                self._flow_matching_all_layers(stu_feats, tch_feats, train,
                                               rngs, metrics)
            if router_loss is not None:
                losses["router"] = d.flow.router_weight * router_loss

        log_probs = self.student.decode_logits(decoder_in)
        if transcripts is not None:
            ctc = lambda lp: ctc_loss(
                lp, transcripts, encoded_len, transcript_lengths,
                reduction=self.student_cfg.ctc_reduction,
                backend=self.ctc_backend)
            losses["ctc"] = ctc(log_probs) if d.use_ctc else zero
            if d.use_ctc and train and d.interctc_layers:
                aux_sum = zero
                for l in d.interctc_layers:
                    aux = ctc(self.student.decode_logits(stu_feats[l]))
                    metrics[f"interctc/layer{l}"] = aux
                    aux_sum = aux_sum + aux
                w = d.interctc_weight
                losses["ctc"] = ((1.0 - w) * losses["ctc"]
                                 + (w / len(d.interctc_layers)) * aux_sum)
        if train and d.use_logit_distillation:
            with torch.no_grad():
                tch_log_probs = self.teacher.decode_logits(tch_last)
            losses["logit_kd"] = d.kd_alpha * logit_kl_loss(
                log_probs, tch_log_probs, d.kd_temperature)
        if train and d.use_layerwise_distillation:
            losses["layer_kd"] = d.layer_kd_alpha * self._layer_kd(
                stu_feats, tch_feats, tch_last, rngs)
        if train and d.use_diffkd:
            n_l = stu_feats.shape[0]
            flat = lambda z: z.reshape((-1,) + z.shape[2:])
            losses["diffkd"] = self.diffkd_mod(flat(stu_feats),
                                               flat(tch_feats), n_l)
        if train and d.use_diffm:
            n_l, b = stu_feats.shape[:2]
            stack = lambda z: z.transpose(0, 1).reshape((b * n_l,)
                                                        + z.shape[2:])
            v_losses = self.diffm_pipeline(stack(stu_feats),
                                           stack(tch_feats), train=True,
                                           loss_layers=n_l, rngs=rngs)
            for key, val in v_losses.items():
                losses[f"diffm/{key}"] = val
        total = zero
        for v in losses.values():
            total = total + v
        losses["total"] = total
        return DistilOutput(log_probs, encoded_len, log_probs.argmax(dim=-1),
                            losses, metrics, tch_last, tch_feats)

    def _layer_kd(self, stu_feats, tch_feats, tch_last,
                  rngs) -> torch.Tensor:
        """Layerwise MSE: the last layer through `layer_proj` (scope
        'last'), or every layer through it or through a fresh projection
        (scope 'all'), averaged over layers."""
        d = self.distill
        if d.layer_kd_scope == "last":
            proj = dense(self.layer_proj, stu_feats[-1])[None]
            return layerwise_mse_loss(proj, tch_last[None])
        if d.diffm_fresh_layer_proj:
            n_l, d_s, d_t = (stu_feats.shape[0], stu_feats.shape[-1],
                             tch_feats.shape[-1])
            if rngs.get("noise") is None:
                raise ValueError("diffm_fresh_layer_proj needs the 'noise' "
                                 "generator")
            w, bias = fresh_layer_proj(rngs["noise"], n_l, d_s, d_t,
                                       stu_feats.dtype, stu_feats.device)
            proj = torch.einsum("lbts,lsd->lbtd", stu_feats, w) + bias
        else:
            proj = dense(self.layer_proj, stu_feats)
        return layerwise_mse_loss(proj, tch_feats)
