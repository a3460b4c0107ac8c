"""Port parity for the CTC decoding layer: tpu_asr_torch's ops/ctc.py greedy
decodes, ops/confidence.py, ops/decoding.py (greedy with the full payload,
the host prefix search with its LM hook, word bonus and lexicon, the
strategies and their refusals) against the JAX package's on the CPU, on
numpy inputs from a seed.

Tolerances: tokens, frames, labels, offsets and texts exact; confidences
within 1e-5; prefix-search scores within 1e-9 (the same float64 host
arithmetic)."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import numpy as np
import pytest
import torch

from tpu_asr.data.tokenizer import CharTokenizer as JaxChar
from tpu_asr.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from tpu_asr.data.tokenizer import train_bpe as jax_train_bpe
from tpu_asr.ops import confidence as jconf
from tpu_asr.ops import ctc as jctc
from tpu_asr.ops import decoding as jdec
from tpu_asr.ops.ngram_lm import NgramLM as JaxNgramLM
from tpu_asr_torch.data.tokenizer import (CharTokenizer, WordPieceTokenizer,
                                          train_bpe)
from tpu_asr_torch.ops import confidence as conf
from tpu_asr_torch.ops import ctc
from tpu_asr_torch.ops import decoding as dec
from tpu_asr_torch.ops.ngram_lm import NgramLM

CONF_TOL = 1e-5
CORPUS = ["hi yo. ok? abba c", "c abba cc. hi", "yo ok abba! hi c"]


def _logsm(x):
    x = np.asarray(x, np.float64)
    m = x.max(-1, keepdims=True)
    return (x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))).astype(
        np.float32)


@pytest.mark.parametrize("v", [3, 5, 129])
def test_greedy_decodes_match_jax(v):
    """ctc_greedy_decode, _with_timestamps and _full on log-probs: tokens,
    counts, starts, ends and labels equal to JAX's; few classes make
    repeats, blanks and runs into the length boundary frequent."""
    rng = np.random.default_rng(v)
    lp = _logsm(rng.normal(scale=2.0, size=(4, 40, v)))
    lens = np.asarray([40, 23, 1, 0], np.int32)
    got = ctc.ctc_greedy_decode_full(torch.from_numpy(lp),
                                     torch.from_numpy(lens))
    want = jctc.ctc_greedy_decode_full(lp, lens)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for fn, jfn in ((ctc.ctc_greedy_decode, jctc.ctc_greedy_decode),
                    (ctc.ctc_greedy_decode_with_timestamps,
                     jctc.ctc_greedy_decode_with_timestamps)):
        for g, w in zip(fn(torch.from_numpy(lp), torch.from_numpy(lens)),
                        jfn(lp, lens), strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ids_path = ctc.ctc_greedy_decode_ids(torch.from_numpy(lp).argmax(-1),
                                         torch.from_numpy(lens), v - 1)
    for g, w in zip(ids_path, want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _measure_inputs(vocab):
    rng = np.random.default_rng(vocab)
    one_hot = np.full((2, vocab), -1e4)
    one_hot[0, 0] = one_hot[1, vocab - 3] = 0.0
    uniform = np.full((1, vocab), np.log(1.0 / vocab))
    rand = _logsm(rng.uniform(0, 1, (3, vocab)))
    peaked = rng.uniform(0, 1, (2, vocab))
    peaked[:, 1] += 8.0
    return np.concatenate([one_hot, uniform, rand, _logsm(peaked)])


@pytest.mark.parametrize("vocab", [100, 1000])
@pytest.mark.parametrize("alpha", [0.25, 0.5, 1.0, 0.33, 2.0])
@pytest.mark.parametrize("name", sorted(conf.get_confidence_measure_bank()))
def test_measure_matches_jax(name, alpha, vocab):
    """Every measure at every alpha on one-hot, uniform, random and peaked
    rows, float32 as frame_confidence_fn computes it."""
    x = _measure_inputs(vocab).astype(np.float32)
    got = conf.get_confidence_measure_bank()[name](torch.from_numpy(x),
                                                   vocab, alpha)
    want = jconf.get_confidence_measure_bank()[name](x, vocab, alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=CONF_TOL, rtol=CONF_TOL)
    fn = conf.frame_confidence_fn(conf.ConfidenceMethodConfig(
        **_method(name), alpha=alpha), vocab)
    jfn = jconf.frame_confidence_fn(jconf.ConfidenceMethodConfig(
        **_method(name), alpha=alpha), vocab)
    np.testing.assert_allclose(fn(torch.from_numpy(x[None])).numpy(),
                               np.asarray(jfn(x[None])), atol=CONF_TOL,
                               rtol=CONF_TOL)


def _method(name):
    if name == "max_prob":
        return {"name": "max_prob"}
    _, kind, norm = name.split("_")
    return {"name": "entropy", "entropy_type": kind, "entropy_norm": norm}


def test_aggregations_and_method_names_match_jax():
    bank, jbank = (conf.get_confidence_aggregation_bank(),
                   jconf.get_confidence_aggregation_bank())
    assert sorted(bank) == sorted(jbank)
    rng = np.random.default_rng(0)
    for xs in ([], [0.0, 0.5, 1.0], [0.5, 0.5], rng.uniform(size=7)):
        for k in bank:
            assert bank[k](xs) == jbank[k](xs)
    for kw in ({}, {"name": "max_prob"},
               {"entropy_type": "renyi", "entropy_norm": "lin"},
               {"entropy_type": "gibbs"}):
        assert conf.ConfidenceMethodConfig(**kw).measure_name() == \
            jconf.ConfidenceMethodConfig(**kw).measure_name()
    for bad in ({"name": "nope"}, {"entropy_type": "shannon"}):
        with pytest.raises(ValueError):
            conf.ConfidenceMethodConfig(**bad).measure_name()


def _tokenizers(kind):
    """(port tokenizer, JAX tokenizer) of one kind over CORPUS."""
    if kind == "bpe":
        return train_bpe(CORPUS, 32), jax_train_bpe(CORPUS, 32)
    if kind == "char":
        return CharTokenizer.from_corpus(CORPUS), JaxChar.from_corpus(CORPUS)
    return (WordPieceTokenizer.from_corpus(CORPUS, 40),
            JaxWordPiece.from_corpus(CORPUS, 40))


def _spoken(tok, texts, t, rng):
    """(B, T, V+1) log-probs whose argmax spells each text's ids with
    repeats and blanks between, noise on top, and the lengths."""
    v = tok.vocab_size + 1
    lp = rng.normal(scale=1.0, size=(len(texts), t, v))
    lens = []
    for b, text in enumerate(texts):
        frames = []
        for i in tok.text_to_ids(text):
            frames += [i] * int(rng.integers(1, 3))
            frames += [v - 1] * int(rng.integers(0, 3))
        frames = frames[:t]
        for f, c in enumerate(frames):
            lp[b, f, c] += 6.0
        lp[b, len(frames):, v - 1] += 6.0
        lens.append(min(t, len(frames) + int(rng.integers(0, 3))))
    return _logsm(lp), np.asarray(lens, np.int32)


FULL = {"compute_timestamps": True, "preserve_alignments": True}


@pytest.mark.parametrize("kind", ["bpe", "char", "wpe"])
@pytest.mark.parametrize("exclude_blank,aggregation,extra", [
    (True, "min", {}), (False, "mean", {"segment_gap_threshold": 2}),
    (True, "prod", {"word_seperator": "c"}),
])
def test_greedy_full_hypotheses_match_jax(kind, exclude_blank, aggregation,
                                          extra):
    """_greedy_full: the timestamp dict (timestep, char, word and segment
    offsets), alignments and every confidence of JAX's hypotheses, for
    BPE, char and WordPiece tokenizers."""
    tok, jtok = _tokenizers(kind)
    rng = np.random.default_rng(len(kind))
    lp, lens = _spoken(tok, ["hi yo. ok? abba", "c abba cc! hi"], 48, rng)
    cfgs = [m.ConfidenceConfig(
        preserve_frame_confidence=True, preserve_token_confidence=True,
        preserve_word_confidence=True, exclude_blank=exclude_blank,
        aggregation=aggregation) for m in (conf, jconf)]
    got = dec.CTCDecoding(tok, "greedy", confidence_cfg=cfgs[0], **FULL,
                          **extra).ctc_decoder_predictions_tensor(
        torch.from_numpy(lp), torch.from_numpy(lens), return_hypotheses=True)
    want = jdec.CTCDecoding(jtok, "greedy", confidence_cfg=cfgs[1], **FULL,
                            **extra).ctc_decoder_predictions_tensor(
        lp, lens, return_hypotheses=True)
    for g, w in zip(got, want, strict=True):
        assert g.y_sequence == w.y_sequence and g.text == w.text
        assert g.timestamp == w.timestamp
        assert g.timestamp["word"], "no word offsets to compare"
        np.testing.assert_array_equal(g.alignments[0], w.alignments[0])
        np.testing.assert_array_equal(g.alignments[1], w.alignments[1])
        for field in ("frame_confidence", "token_confidence",
                      "word_confidence"):
            np.testing.assert_allclose(getattr(g, field), getattr(w, field),
                                       atol=CONF_TOL, rtol=CONF_TOL)


def test_word_offsets_match_jax():
    """get_words_offsets on char offsets (delimiters ' ' and '.') and on
    encoded BPE offsets (ids, [id] and piece strings)."""
    tok, jtok = _tokenizers("char")
    chars = [{"char": c, "start_offset": 2 * j, "end_offset": 2 * j + 1}
             for j, c in enumerate("hi yo . a b.c ok?")]
    for delim in (" ", "."):
        kw = dict(char_offsets=chars, word_delimiter_char=delim,
                  supported_punctuation={".", "!", "?"})
        assert dec.CTCDecoding(tok).get_words_offsets(**kw) == \
            jdec.CTCDecoding(jtok).get_words_offsets(**kw)
    tok, jtok = _tokenizers("bpe")
    ids = tok.text_to_ids("abba c abba hi")
    assert ids == jtok.text_to_ids("abba c abba hi")
    for wrap in (lambda i: i, lambda i: [i], lambda i: tok.vocab[i]):
        enc = [{"char": wrap(i), "start_offset": j, "end_offset": j}
               for j, i in enumerate(ids)]
        for delim in (" ", "c"):
            kw = dict(encoded_char_offsets=enc, word_delimiter_char=delim)
            assert dec.CTCDecoding(tok).get_words_offsets(**kw) == \
                jdec.CTCDecoding(jtok).get_words_offsets(**kw)


def _assert_hyps_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.y_sequence == w.y_sequence
        assert g.score == pytest.approx(w.score, abs=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_beam_search_matches_jax(seed):
    """The host prefix search with no LM, an n-gram LM hook (each package's
    own NgramLM trained on the same sequences), a word bonus and a
    lexicon: every hypothesis and score equal to JAX's."""
    rng = np.random.default_rng(seed)
    v = 7
    lp = _logsm(rng.normal(scale=2.0, size=(20, v)))
    seqs = [rng.integers(0, v - 1, size=rng.integers(2, 9)).tolist()
            for _ in range(30)]
    lm, jlm = NgramLM.train(seqs, order=3), JaxNgramLM.train(seqs, order=3)
    lex, jlex = (dec.Lexicon([[0, 1], [2], [3, 4, 5]]),
                 jdec.Lexicon([[0, 1], [2], [3, 4, 5]]))
    for kw, jkw in (({}, {}),
                    ({"lm_score_fn": lm.lm_score_fn(), "lm_weight": 0.5},
                     {"lm_score_fn": jlm.lm_score_fn(), "lm_weight": 0.5}),
                    ({"word_bonus": 0.7}, {"word_bonus": 0.7}),
                    ({"lexicon": lex}, {"lexicon": jlex})):
        _assert_hyps_equal(
            dec.ctc_prefix_beam_search(lp, 17, beam_width=6, **kw),
            jdec.ctc_prefix_beam_search(lp, 17, beam_width=6, **jkw))


def test_ctc_decoding_strategies_match_jax():
    """greedy, greedy_batch, beam (with an n-gram LM path, a word bonus,
    lexicon words) and their aliases give JAX's texts and scores; the
    ids fast path gives the log-probs path's texts."""
    tok, jtok = _tokenizers("bpe")
    rng = np.random.default_rng(3)
    lp, lens = _spoken(tok, ["hi abba", "c ok? yo"], 30, rng)
    lm_seqs = [tok.text_to_ids(t) for t in CORPUS]
    for strategy, kw in (("greedy", {}), ("greedy_batch", {}),
                         ("beam", {"beam_width": 4}),
                         ("pyctcdecode", {"beam_width": 4,
                                          "word_bonus": 0.3}),
                         ("flashlight", {"beam_width": 4, "lexicon_words": [
                             "hi", "abba", "c", "ok?", "yo"]})):
        got = dec.CTCDecoding(tok, strategy, **kw)
        want = jdec.CTCDecoding(jtok, strategy, **kw)
        assert got.strategy == want.strategy
        _assert_hyps_equal(
            got.ctc_decoder_predictions_tensor(lp, lens, True),
            want.ctc_decoder_predictions_tensor(lp, lens, True))
    got = dec.CTCDecoding(tok, "beam", ngram_lm=NgramLM.train(lm_seqs),
                          beam_width=4)
    want = jdec.CTCDecoding(jtok, "beam", ngram_lm=JaxNgramLM.train(lm_seqs),
                            beam_width=4)
    assert got.lm_weight == want.lm_weight == 1.0
    assert got.ctc_decoder_predictions_tensor(lp, lens) == \
        want.ctc_decoder_predictions_tensor(lp, lens)
    greedy = dec.CTCDecoding(tok)
    assert greedy.plain_greedy
    ids = torch.from_numpy(lp).argmax(-1)
    assert greedy.greedy_ids_predictions(
        ids, torch.from_numpy(lens), lp.shape[-1] - 1) == \
        greedy.ctc_decoder_predictions_tensor(lp, lens)


@pytest.mark.parametrize("strategy,kw,match", [
    ("flashlight", {}, "lexicon_words"),
    ("wfst", {}, "unknown decoding strategy"),
    ("beam_batch", {"lm_score_fn": lambda p, c: 0.0}, "beam_batch"),
    ("beam_batch", {"lexicon_words": ["a"]}, "beam_batch"),
    ("beam", {"confidence_cfg": "frame"}, "greedy"),
    ("beam_batch", {"confidence_cfg": "frame"}, "greedy"),
])
def test_ctc_decoding_refusals_match_jax(strategy, kw, match):
    tok, jtok = _tokenizers("bpe")
    for t, m in ((tok, conf), (jtok, jconf)):
        args = dict(kw)
        if args.get("confidence_cfg") == "frame":
            args["confidence_cfg"] = m.ConfidenceConfig(
                preserve_frame_confidence=True)
        cls = dec.CTCDecoding if t is tok else jdec.CTCDecoding
        with pytest.raises(ValueError, match=match):
            cls(t, strategy, **args)
