"""DistilCTCModel: the PyTorch counterpart of
tpu_asr/models/distil_model.py, for the CTC-only student path
(`DistillationConfig()`: use_ctc, no KD loss, no interCTC).

Every knowledge-distillation option (logit KD, layerwise KD, flow
matching, DiffKD, diffm, interCTC) raises until the port implements it, so
the teacher is never built here; `teacher_cfg` is kept for the configs
that will need it. Losses: 'ctc' (the student's CTC loss with
`student_cfg.ctc_reduction`, zero when use_ctc is off) and 'total'.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from tpu_asr_torch.config import DistillationConfig, ModelConfig
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.ops.ctc import ctc_loss


class DistilOutput(NamedTuple):
    log_probs: torch.Tensor       # (B, T', V+1)
    encoded_len: torch.Tensor     # (B,)
    greedy: torch.Tensor          # (B, T')
    losses: Dict[str, torch.Tensor]
    metrics: Dict[str, torch.Tensor]


def check_supported(d: DistillationConfig) -> None:
    unsupported = {
        "use_logit_distillation": d.use_logit_distillation,
        "use_layerwise_distillation": d.use_layerwise_distillation,
        "use_flow_matching": d.use_flow_matching,
        "use_diffkd": d.use_diffkd,
        "use_diffm": d.use_diffm,
        "interctc_layers": bool(d.interctc_layers),
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
        self.distill = distill or DistillationConfig()
        check_supported(self.distill)
        self.student_cfg, self.teacher_cfg = student_cfg, teacher_cfg
        self.student = CTCModel(student_cfg)
        self.ctc_backend = "auto"

    def forward(self, input_signal: torch.Tensor,
                input_signal_length: torch.Tensor,
                transcripts: Optional[torch.Tensor] = None,
                transcript_lengths: Optional[torch.Tensor] = None,
                train: bool = False,
                rngs: Optional[Dict[str, torch.Generator]] = None
                ) -> DistilOutput:
        encoded, encoded_len, _ = self.student.encode(
            input_signal, input_signal_length, train, rngs)
        log_probs = self.student.decode_logits(encoded)
        losses: Dict[str, torch.Tensor] = {}
        zero = torch.zeros((), device=log_probs.device)
        if transcripts is not None:
            losses["ctc"] = (ctc_loss(
                log_probs, transcripts, encoded_len, transcript_lengths,
                reduction=self.student_cfg.ctc_reduction,
                backend=self.ctc_backend) if self.distill.use_ctc else zero)
        total = zero
        for v in losses.values():
            total = total + v
        losses["total"] = total
        return DistilOutput(log_probs, encoded_len, log_probs.argmax(dim=-1),
                            losses, {})
