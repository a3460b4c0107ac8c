"""Port parity for the rest of the serving surface: ChunkedTranscriber,
Transcriber(timestamps=True) and the beam strategies through Transcriber,
change_vocabulary / change_decoding_strategy (models/vocab.py), and the
CharTokenizer, WordPieceTokenizer and AggregateTokenizer copies, against
the JAX package's on the CPU, fp32, with JAX's weights carried by the
bridge (convert/from_jax.py) and waveforms made with numpy from a seed.

Tolerances: texts, ids, offsets and timestamp seconds exact; log-probs
within 1e-4."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_streaming import seeded_params
from tpu_asr.config import (DecoderConfig, EncoderConfig, ModelConfig,
                            PreprocessorConfig)
from tpu_asr.data import tokenizer as jtokz
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr.models.transcribe import ChunkedTranscriber as JaxChunked
from tpu_asr.models.transcribe import Transcriber as JaxTranscriber
from tpu_asr.models.vocab import change_vocabulary as jax_change_vocabulary
from tpu_asr_torch.convert.from_jax import jax_to_state_dict
from tpu_asr_torch.data import tokenizer as tokz
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.models.transcribe import ChunkedTranscriber, Transcriber
from tpu_asr_torch.models.vocab import (change_decoding_strategy,
                                        change_vocabulary)
from tpu_asr_torch.ops.decoding import CTCDecoding

CFG = ModelConfig(
    preprocessor=PreprocessorConfig(features=24), spec_augment=None,
    encoder=EncoderConfig(feat_in=24, n_layers=2, d_model=32, n_heads=4,
                          conv_kernel_size=7, conv_norm_type="layer_norm",
                          dropout=0.0, dropout_pre_encoder=0.0,
                          dropout_att=0.0),
    decoder=DecoderConfig(feat_in=32, num_classes=16),
    compute_dtype="float32")
TEXTS = ["a b c d e f g h", "hi yo. ok? abba c", "c abba cc! hi"]
TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    """(JAX model, variables, port model, the JAX and port BPE
    tokenizers)."""
    jmodel = JaxCTCModel(CFG)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8000)),
        jnp.asarray([8000], jnp.int32)))
    params = seeded_params(shapes["params"], np.random.default_rng(0))
    variables = {"params": params, "batch_stats": {}}
    port = CTCModel(CFG).eval()
    port.load_state_dict(jax_to_state_dict(params, {}, CFG), strict=True)
    return (jmodel, variables, port, jtokz.train_bpe(TEXTS[:1], 16),
            tokz.train_bpe(TEXTS[:1], 16))


def _wave(seed, seconds):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=int(seconds * 16000)) * 0.05).astype(np.float32)


@pytest.mark.parametrize("seconds", [3.0, 11.0])
def test_chunked_transcriber_matches_jax(setup, seconds):
    """A clip shorter than a chunk (one forward) and one several chunks
    long (overlapping windows stitched by JAX's frame arithmetic)."""
    jmodel, variables, port, jtok, tok = setup
    x = _wave(int(seconds), seconds)
    got = ChunkedTranscriber(port, tok, chunk_seconds=4.0,
                             overlap_seconds=0.5, device="cpu")
    want = JaxChunked(jmodel, variables, jtok, chunk_seconds=4.0,
                      overlap_seconds=0.5)
    text = got.transcribe(x)
    assert text == want.transcribe(x)
    assert text, "an empty text compares nothing"
    for n in (1, 3999, 16000, 40000):
        assert got._frames_for_samples(n) == want._frames_for_samples(n)
    with pytest.raises(ValueError, match="overlaps"):
        ChunkedTranscriber(port, tok, chunk_seconds=2.0, overlap_seconds=1.0,
                           device="cpu")


def test_transcriber_timestamps_and_beam_match_jax(setup):
    """Transcriber(timestamps=True): JAX's hypotheses with their offset
    dicts in frames and seconds; the beam strategies: JAX's host beam's
    texts (W=16: 2W covers the 17 classes, so the host search's pruning
    keeps every token and the device search gives its texts too)."""
    jmodel, variables, port, jtok, tok = setup
    waves = [_wave(s, n) for s, n in ((1, 1.0), (2, 2.5), (3, 1.5))]
    got = Transcriber(port, tok, batch_size=2, device="cpu").transcribe(
        waves, timestamps=True)
    jtr = JaxTranscriber(jmodel, variables, jtok, batch_size=2)
    want = jtr.transcribe(waves, timestamps=True)
    for g, w in zip(got, want, strict=True):
        assert (g.text, g.y_sequence, g.timestamp) == \
            (w.text, w.y_sequence, w.timestamp)
    assert any(g.timestamp["word"] for g in got)
    from tpu_asr.ops.decoding import CTCDecoding as JaxCTCDecoding
    jtr.decoding = JaxCTCDecoding(jtok, "beam", beam_width=16)
    want = jtr.transcribe(waves)
    for strategy in ("beam", "beam_batch"):
        tr = Transcriber(port, tok, batch_size=2, device="cpu",
                         decoding=change_decoding_strategy(
                             tok, strategy, beam_width=16))
        assert not tr.decoding.plain_greedy
        assert tr.transcribe(waves) == want


def test_change_vocabulary_through_the_bridge(setup):
    """The port's change_vocabulary keeps the encoder and draws a head of
    the new width from the generator; JAX's new head, bridged into it,
    gives JAX's log-probs."""
    jmodel, variables, port, jtok, tok = setup
    new_jtok = jtokz.train_bpe(TEXTS, 24)
    new_tok = tokz.train_bpe(TEXTS, 24)
    assert new_tok.vocab_size == new_jtok.vocab_size != tok.vocab_size
    new_cfg, new = change_vocabulary(port, new_tok,
                                     torch.Generator().manual_seed(0))
    _, again = change_vocabulary(port, new_tok,
                                 torch.Generator().manual_seed(0))
    assert new_cfg.decoder.num_classes == new_tok.vocab_size
    assert not new.training
    head = new.decoder.decoder_layers[0]
    assert head.weight.shape == (new_tok.vocab_size + 1, 32, 1)
    assert torch.equal(head.weight, again.decoder.decoder_layers[0].weight)
    assert torch.all(head.bias == 0)
    old_sd = port.state_dict()
    for k, v in new.state_dict().items():
        if k.startswith("encoder."):
            assert torch.equal(v, old_sd[k])
    box = {}

    def jax_change(params, key):      # jitted: an eager init takes seconds
        box["cfg"], new_params = jax_change_vocabulary(CFG, params, new_jtok,
                                                       key)
        return new_params

    jparams = jax.jit(jax_change)(variables["params"], jax.random.PRNGKey(3))
    jcfg = box["cfg"]
    assert jcfg.decoder.num_classes == new_cfg.decoder.num_classes
    new.load_state_dict(jax_to_state_dict(jparams, {}, jcfg), strict=True)
    x = _wave(5, 2.0)
    want = jax.jit(lambda p, a, n: JaxCTCModel(jcfg).apply({"params": p}, a,
                                                            n))(
        jparams, jnp.asarray(x[None]), jnp.asarray([len(x)], jnp.int32))
    with torch.no_grad():
        got = new(torch.from_numpy(x[None]), torch.tensor([len(x)]))
    np.testing.assert_allclose(got.log_probs.numpy(),
                               np.asarray(want.log_probs), rtol=TOL,
                               atol=TOL)


SAMPLES = ["hi yo. ok? abba", "unknown zebra", "", "c  abba!! hi", "ABBA cc"]


@pytest.mark.parametrize("kind", ["char", "wpe", "aggregate"])
def test_tokenizers_match_jax(kind, tmp_path):
    """ids, texts, vocabularies and the saved files' round trip of the
    three tokenizer copies, against JAX's."""
    if kind == "char":
        got = tokz.CharTokenizer.from_corpus(TEXTS)
        want = jtokz.CharTokenizer.from_corpus(TEXTS)
    elif kind == "wpe":
        got = tokz.WordPieceTokenizer.from_corpus(TEXTS, 30)
        want = jtokz.WordPieceTokenizer.from_corpus(TEXTS, 30)
    else:
        got = tokz.AggregateTokenizer({
            "en": tokz.train_bpe(TEXTS[:2], 24),
            "xx": tokz.CharTokenizer.from_corpus(TEXTS)})
        want = jtokz.AggregateTokenizer({
            "en": jtokz.train_bpe(TEXTS[:2], 24),
            "xx": jtokz.CharTokenizer.from_corpus(TEXTS)})
    assert got.vocab == want.vocab and got.vocab_size == want.vocab_size
    for text in SAMPLES:
        ids = got.text_to_ids(text)
        assert ids == want.text_to_ids(text)
        assert got.ids_to_text(ids) == want.ids_to_text(ids)
        assert got.ids_to_text(ids + [got.vocab_size + 3]) == \
            want.ids_to_text(ids + [want.vocab_size + 3])
    if kind == "aggregate":
        for text in SAMPLES:
            ids = got.text_to_ids(text, "xx")
            assert ids == want.text_to_ids(text, "xx")
            mixed = got.text_to_ids("hi", "en") + ids
            assert got.ids_to_text(mixed) == want.ids_to_text(mixed)
        return
    got.save(tmp_path / "tok.json")
    back = type(want).from_file(tmp_path / "tok.json")
    assert back.vocab == got.vocab
    assert type(got).from_file(tmp_path / "tok.json").vocab == got.vocab
    assert CTCDecoding(got)._is_char_mode() == (kind == "char")
