"""DistilCTCModel: the PyTorch counterpart of
tpu_asr/models/distil_model.py, for CTC, logit KD and flow-matching KD
(FM-KT over all layers with fixed step counts).

- The frozen teacher `CTCModel(teacher_cfg)` is built when a KD loss needs
  it. It runs in eval mode under `torch.no_grad()` with its parameters
  `requires_grad_(False)` (JAX's stop-gradient at the teacher parameters):
  no gradient, no saved activations, no BatchNorm update, no dropout, and
  it reads the unaugmented signal (no dither, no SpecAugment). `train()`
  leaves it in eval mode. A teacher config with `quantization='int8'`
  (bench_train.py's flowkd_mlp8_int8_teacher) runs its FFN sublayers
  through the int8 serving path, which has no gradient and needs none
  here; the student trains in fp whatever its config says.
- Flow matching: the student and teacher layer features are stacked
  B-major (row = b * L + l) and one FlowMatchingModule call runs over
  (B * L, T', D_s) with `loss_layers=L`; the last layer's FM output replaces
  the decoder input in training and eval. In eval the FM runs without the
  teacher, with `training_sampling` steps as the JAX model passes them.
- Losses: 'ctc' (student_cfg.ctc_reduction, zero when use_ctc is off),
  'flow_matching' (FlowMatchingConfig.weight is not applied, as in the
  reference), 'logit_kd' (kd_alpha x logit KL against the teacher's
  decoder on its last layer) and 'total'.

Packed-segment training (`forward_packed_train`, JAX's method of that
name): the student's and the teacher's encoders run on packed rows of
several utterances (data/packing.train_pack_arrays), the student forward
and backward through the attention kernels' segment mode; the per-layer
features are gathered back to the bucketed (B, T', D) layout, so every
loss is computed as in the unpacked step (`forward_with_student_encode`).

Layerwise KD, DiffKD, diffm, interCTC, the dynamic step router and
per-layer step counts raise until the port implements them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from tpu_asr_torch.config import DistillationConfig, ModelConfig
from tpu_asr_torch.kd.flow_matching import FlowMatchingModule
from tpu_asr_torch.kd.losses import logit_kl_loss
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.ops.ctc import ctc_loss


class DistilOutput(NamedTuple):
    log_probs: torch.Tensor       # (B, T', V+1)
    encoded_len: torch.Tensor     # (B,)
    greedy: torch.Tensor          # (B, T')
    losses: Dict[str, torch.Tensor]
    metrics: Dict[str, torch.Tensor]
    tch_last: Optional[torch.Tensor] = None    # (B, T', Dt) when it ran
    tch_feats: Optional[torch.Tensor] = None   # (L, B, T', Dt) when it ran


def check_supported(d: DistillationConfig) -> None:
    f = d.flow
    unsupported = {
        "use_layerwise_distillation": d.use_layerwise_distillation,
        "use_diffkd": d.use_diffkd,
        "use_diffm": d.use_diffm,
        "interctc_layers": bool(d.interctc_layers),
        "flow": d.use_flow_matching and f is None,
        "flow.use_dynamic_steps": d.use_flow_matching and f is not None
        and f.use_dynamic_steps,
        "flow.sampling_steps_per_layer": d.use_flow_matching
        and f is not None and f.sampling_steps_per_layer is not None,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"tpu_asr_torch does not implement "
                         f"DistillationConfig options {bad}")


class DistilCTCModel(nn.Module):
    """`ctc_backend` 'auto' runs the CTC kernels (ops/cuda_ctc.py) for CUDA
    tensors, 'scan' the plain recursion."""

    def __init__(self, student_cfg: ModelConfig, teacher_cfg: ModelConfig,
                 distill: Optional[DistillationConfig] = None):
        super().__init__()
        d = self.distill = distill or DistillationConfig()
        check_supported(d)
        self.student_cfg, self.teacher_cfg = student_cfg, teacher_cfg
        self.student = CTCModel(student_cfg)
        self.ctc_backend = "auto"
        self.needs_teacher = d.use_logit_distillation or d.use_flow_matching
        if self.needs_teacher:
            self.teacher = CTCModel(teacher_cfg).requires_grad_(False).eval()
        if d.use_flow_matching:
            self.flow_matching = FlowMatchingModule(
                d.flow, getattr(torch, student_cfg.compute_dtype))

    def train(self, mode: bool = True) -> "DistilCTCModel":
        super().train(mode)
        if self.needs_teacher:
            self.teacher.eval()
        return self

    def _flow_matching_all_layers(self, stu_feats: torch.Tensor,
                                  tch_feats: Optional[torch.Tensor],
                                  train: bool):
        """(flow loss, last layer's FM output (B, T', Ds)) from (L, B, T',
        D) student and teacher features."""
        f = self.distill.flow
        n_layers, b = stu_feats.shape[:2]
        stack = lambda z: z.transpose(0, 1).reshape((b * n_layers,)
                                                    + z.shape[2:])
        steps = torch.full((b * n_layers,), f.training_sampling,
                           dtype=torch.int32, device=stu_feats.device)
        loss, fm = self.flow_matching(
            stack(stu_feats), stack(tch_feats) if train else None,
            steps=steps, max_steps=f.training_sampling, train=train,
            loss_layers=n_layers)
        return loss, fm.reshape((b, n_layers) + fm.shape[1:])[:, -1]

    def forward(self, input_signal: torch.Tensor,
                input_signal_length: torch.Tensor,
                transcripts: Optional[torch.Tensor] = None,
                transcript_lengths: Optional[torch.Tensor] = None,
                train: bool = False,
                rngs: Optional[Dict[str, torch.Generator]] = None
                ) -> DistilOutput:
        encoded, encoded_len, stu_feats = self.student.encode(
            input_signal, input_signal_length, train, rngs)
        return self.forward_with_student_encode(
            encoded, encoded_len, stu_feats, input_signal,
            input_signal_length, transcripts, transcript_lengths, train)

    def forward_packed_train(self, input_signal: torch.Tensor,
                             input_signal_length: torch.Tensor,
                             transcripts: Optional[torch.Tensor],
                             transcript_lengths: Optional[torch.Tensor],
                             pk_src_utt: torch.Tensor,
                             pk_src_pos: torch.Tensor, pk_seg: torch.Tensor,
                             pk_row: torch.Tensor, pk_start: torch.Tensor,
                             train: bool = True,
                             rngs: Optional[Dict[str, torch.Generator]] = None
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
        the packed frames, guards included, as JAX's do)."""
        ix = lambda z: torch.as_tensor(z, device=input_signal.device).long()
        src_utt, src_pos, seg, row, start = map(
            ix, (pk_src_utt, pk_src_pos, pk_seg, pk_row, pk_start))
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
        if train and self.needs_teacher:
            with torch.no_grad():
                xt_src, _ = self.teacher.pre_encode_aug(input_signal,
                                                        input_signal_length)
                packed_t = torch.where(valid_rows, xt_src[src_utt, src_pos],
                                       0)
                _, _, tch_p = self.teacher.encode_packed(packed_t, seg)
                tch_all = torch.where(valid, tch_p[:, rows, pos_c], 0)
        return self.forward_with_student_encode(
            encoded, enc_len, stu_feats, input_signal, input_signal_length,
            transcripts, transcript_lengths, train, tch_all_feat=tch_all)

    def forward_with_student_encode(
            self, encoded: torch.Tensor, encoded_len: torch.Tensor,
            stu_feats: torch.Tensor, input_signal: torch.Tensor,
            input_signal_length: torch.Tensor,
            transcripts: Optional[torch.Tensor] = None,
            transcript_lengths: Optional[torch.Tensor] = None,
            train: bool = False,
            tch_all_feat: Optional[torch.Tensor] = None) -> DistilOutput:
        """Everything after the student's encode: the frozen teacher (or
        its precomputed per-layer features `tch_all_feat` (L, B, T', Dt),
        as the packed step gathers them), flow matching, the decoder and
        the losses."""
        d = self.distill
        losses: Dict[str, torch.Tensor] = {}
        zero = torch.zeros((), device=encoded.device)

        tch_feats = tch_last = None
        if train and self.needs_teacher:
            tch_feats = tch_all_feat
            if tch_feats is None:
                with torch.no_grad():
                    _, _, tch_feats = self.teacher.encode(
                        input_signal, input_signal_length)
            tch_last = tch_feats[-1]

        decoder_in = encoded
        if d.use_flow_matching:
            losses["flow_matching"], decoder_in = \
                self._flow_matching_all_layers(stu_feats, tch_feats, train)

        log_probs = self.student.decode_logits(decoder_in)
        if transcripts is not None:
            losses["ctc"] = (ctc_loss(
                log_probs, transcripts, encoded_len, transcript_lengths,
                reduction=self.student_cfg.ctc_reduction,
                backend=self.ctc_backend) if d.use_ctc else zero)
        if train and d.use_logit_distillation:
            with torch.no_grad():
                tch_log_probs = self.teacher.decode_logits(tch_last)
            losses["logit_kd"] = d.kd_alpha * logit_kl_loss(
                log_probs, tch_log_probs, d.kd_temperature)
        total = zero
        for v in losses.values():
            total = total + v
        losses["total"] = total
        return DistilOutput(log_probs, encoded_len, log_probs.argmax(dim=-1),
                            losses, {}, tch_last, tch_feats)
