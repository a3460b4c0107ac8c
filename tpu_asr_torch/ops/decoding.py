"""CTC decoding with the greedy strategy: the PyTorch counterpart of
tpu_asr/ops/decoding.py::CTCDecoding (greedy only) and a minimal
Hypothesis."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from tpu_asr_torch.ops.ctc import ctc_greedy_decode


@dataclass
class Hypothesis:
    score: float
    y_sequence: List[int]
    text: Optional[str] = None


class CTCDecoding:
    def __init__(self, tokenizer, strategy: str = "greedy"):
        if strategy != "greedy":
            raise ValueError(f"the port decodes greedily only, got "
                             f"strategy={strategy!r}")
        self.tokenizer = tokenizer
        self.strategy = strategy

    def decode_tokens_to_str(self, tokens: Sequence[int]) -> str:
        return self.tokenizer.ids_to_text(list(tokens))

    def ctc_decoder_predictions_tensor(self, greedy: torch.Tensor,
                                       decoder_lengths: torch.Tensor,
                                       blank: int,
                                       return_hypotheses: bool = False):
        """(B, T) frame-wise argmax ids (`CTCModelOutput.greedy`), (B,)
        lengths and the blank id -> texts, or Hypothesis objects with
        `return_hypotheses`."""
        tokens, n_tokens = ctc_greedy_decode(greedy, decoder_lengths, blank)
        tokens, n_tokens = tokens.cpu().numpy(), n_tokens.cpu().numpy()
        hyps = []
        for i in range(tokens.shape[0]):
            ids = tokens[i, :n_tokens[i]].tolist()
            hyps.append(Hypothesis(0.0, ids, self.decode_tokens_to_str(ids)))
        if return_hypotheses:
            return hyps
        return [h.text for h in hyps]
