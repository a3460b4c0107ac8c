"""Host-side code the port shares with the JAX package, imported unchanged:
the dataclass config tree, the tokenizers and audio loading. None of these
three modules imports JAX (tests/test_torch_contract.py checks that no
`tpu_asr_torch` module pulls JAX in); the JAX package's `ops`, `models` and
`convert` do, so nothing in the port imports from them."""

from tpu_asr.config import (DecoderConfig, EncoderConfig, ModelConfig,
                            PreprocessorConfig)
from tpu_asr.data.audio import load_audio
from tpu_asr.data.tokenizer import SentencePieceBPETokenizer, train_bpe

__all__ = ["DecoderConfig", "EncoderConfig", "ModelConfig",
           "PreprocessorConfig", "SentencePieceBPETokenizer", "load_audio",
           "train_bpe"]
